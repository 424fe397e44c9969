"""`lint --fix`: the two mechanically safe rewrites.

* D003 — wrap the set iterable in `sorted(...)`: same elements,
  deterministic order. (Sorting cost is irrelevant off the device hot
  path, and a set that reaches a `for` is host code by construction.)
* D005 — add `ordered=True` to `jax.debug.callback`/`io_callback`
  calls (or flip an explicit `ordered=False`); the JAX package's rewrite,
  byte for byte.

Everything else needs judgment (what IS the right seed source?), so it
stays a finding. Edits are computed from AST spans against the current
source and applied bottom-up so earlier spans stay valid; the caller
re-lints after fixing.
"""

from __future__ import annotations

import ast
from typing import List, Tuple

from .astutils import ImportMap, resolve_call
from .drules import IO_CALLBACKS, UNORDERED_CALLBACKS, _is_set_expr


def _span(source_lines: List[str], node: ast.expr) -> Tuple[int, int]:
    """(start, end) absolute character offsets of a node."""
    starts = [0]
    for line in source_lines:
        starts.append(starts[-1] + len(line) + 1)
    start = starts[node.lineno - 1] + node.col_offset
    end = starts[node.end_lineno - 1] + node.end_col_offset
    return start, end


def fix_source(source: str, path: str) -> Tuple[str, int]:
    """Apply the mechanical fixes; returns (new_source, n_edits)."""
    tree = ast.parse(source, filename=path)
    imports = ImportMap(tree)
    lines = source.split("\n")
    edits: List[Tuple[int, int, str]] = []  # (start, end, replacement)

    for node in ast.walk(tree):
        iter_expr = None
        if isinstance(node, ast.For):
            iter_expr = node.iter
        elif isinstance(node, ast.comprehension):
            iter_expr = node.iter
        if iter_expr is not None and _is_set_expr(iter_expr, imports):
            start, end = _span(lines, iter_expr)
            edits.append((start, end, f"sorted({source[start:end]})"))
            continue

        if isinstance(node, ast.Call):
            name = resolve_call(node, imports)
            if name in UNORDERED_CALLBACKS or name in IO_CALLBACKS:
                ordered_kw = next(
                    (kw for kw in node.keywords if kw.arg == "ordered"), None
                )
                if ordered_kw is None:
                    # insert before the closing paren of the call
                    start, end = _span(lines, node)
                    inner = source[start:end]
                    close = inner.rfind(")")
                    if close > 0:
                        sep = "" if inner[:close].rstrip().endswith("(") else ", "
                        edits.append((
                            start + close, start + close, f"{sep}ordered=True"
                        ))
                elif (
                    isinstance(ordered_kw.value, ast.Constant)
                    and ordered_kw.value.value is not True
                ):
                    start, end = _span(lines, ordered_kw.value)
                    edits.append((start, end, "True"))

    # apply bottom-up; drop overlapping edits (outer wins are fine for
    # the rare nested case — the re-lint catches anything left)
    edits.sort(key=lambda e: e[0], reverse=True)
    out = source
    last_start = len(source) + 1
    applied = 0
    for start, end, repl in edits:
        if end > last_start:
            continue
        out = out[:start] + repl + out[end:]
        last_start = start
        applied += 1
    return out, applied
