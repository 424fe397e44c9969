"""C-rules: Machine authoring-contract checks.

Two halves. The AST half is free (no imports, runs on any file):

C001  `self.*` mutation inside a pure handler (`on_message`/`on_timer`/
      `invariant`/`is_done`/`summary`/`coverage_projection`) — handler
      state MUST live in the `nodes` tree; instance state survives
      across steps and is shared by every lane of the batch, which is
      exactly the cross-lane leak the lane-batched model cannot
      tolerate (the message is the JAX package's word for word; its
      "under vmap" reads "across the lane batch" here)
C005  a voter/ack-bitmask tally without the 31-node cap assertion —
      int32 one-hot bitmasks alias beyond bit 30 (sign bit), so any
      class shifting `1 << node` into a mask must loudly refuse
      num_nodes > 31 (the discipline both raft variants keep)

The import half instantiates each Machine subclass (constructors must
be fully defaulted — every shipped model is) and verifies, WITHOUT
running a simulation:

C002  `durable_spec()` congruent with `init()`'s tree structure, every
      leaf a python bool
C003  `torn_spec()` congruent with `init()`'s structure, every leaf a
      legal atomicity class (TORN_ATOMIC/TORN_LOSE/TORN_PREFIX), and
      never declared without the `durable_spec()` it refines
C004  `coverage_projection(nodes, now_us)` returns one integer word per
      lane (shape `(L,)`, integer dtype) — the coverage hash folds
      exactly one word per lane and step

The port's `Machine.init` is batched (`rng_key [L, 2]`, every leaf
`[L, NUM_NODES, ...]`), so the half evaluates each model on the CPU at
one lane (`L = 1`) and reads only tree structure (the port's own tree
walk, `utils.tree_map`), shapes and dtypes — the counterpart of the JAX
package's abstract `jax.eval_shape`; it builds no engine, targets no
device, and importing a model builds no CUDA kernel. It is the only
lint pass allowed to import torch (models are torch programs);
`--no-import-check` skips it for torch-free pre-commit runs. Engine
construction re-validates C002/C003 at runtime — the lint pass exists
so the contract breaks in review, not in the first hunt.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Tuple

from .astutils import PURE_HANDLERS, class_methods, machine_classes
from .findings import Finding, Severity


# -- AST half ----------------------------------------------------------------


def _self_mutations(fn: ast.FunctionDef) -> List[ast.AST]:
    """Statements that rebind/mutate `self.*` inside `fn`."""

    def is_self_attr(node: ast.AST) -> bool:
        return (
            isinstance(node, (ast.Attribute, ast.Subscript))
            and _root_is_self(node)
        )

    def _root_is_self(node: ast.AST) -> bool:
        while isinstance(node, (ast.Attribute, ast.Subscript)):
            node = node.value
        return isinstance(node, ast.Name) and node.id == "self"

    hits: List[ast.AST] = []
    for node in ast.walk(fn):
        if isinstance(node, ast.Assign):
            if any(is_self_attr(t) for t in node.targets):
                hits.append(node)
        elif isinstance(node, (ast.AugAssign, ast.AnnAssign)):
            if is_self_attr(node.target):
                hits.append(node)
        elif isinstance(node, ast.Delete):
            if any(is_self_attr(t) for t in node.targets):
                hits.append(node)
        elif isinstance(node, ast.Call):
            # self.x.append(...) / self.x.update(...): container mutation
            if isinstance(node.func, ast.Attribute) and node.func.attr in (
                "append", "extend", "add", "update", "insert", "pop",
                "remove", "clear", "setdefault",
            ):
                if _root_is_self(node.func.value):
                    hits.append(node)
    return hits


_MASK_NAME_HINTS = ("vote", "ack", "grant", "voter")


def _bitmask_tally_lines(cls: ast.ClassDef) -> List[int]:
    """Lines where the class shifts a one-hot bit into a named
    vote/ack mask — the dup-safe tally idiom the 31-node cap guards."""
    lines: List[int] = [
        node.lineno
        for node in ast.walk(cls)
        if isinstance(node, ast.BinOp) and isinstance(node.op, ast.LShift)
    ]
    if not lines:
        return []
    # require a mask-ish attribute/name in the class at all; otherwise
    # shifts are generic bit math (clog words, coverage packing)
    for node in ast.walk(cls):
        name = None
        if isinstance(node, ast.Attribute):
            name = node.attr.lower()
        elif isinstance(node, ast.Name):
            name = node.id.lower()
        if name and "mask" in name and any(h in name for h in _MASK_NAME_HINTS):
            return lines
    return []


def _has_31_cap(cls: ast.ClassDef) -> bool:
    """An assert/raise-bearing comparison against the 31/32 node cap
    anywhere in the class."""
    for node in ast.walk(cls):
        if isinstance(node, ast.Constant) and node.value in (31, 32):
            return True
    return False


def check_module(tree: ast.Module, source: str, path: str) -> List[Finding]:
    findings: List[Finding] = []
    for cls in machine_classes(tree).values():
        for fn in class_methods(cls):
            if fn.name not in PURE_HANDLERS:
                continue
            for hit in _self_mutations(fn):
                findings.append(Finding(
                    rule="C001", severity=Severity.ERROR, path=path,
                    line=hit.lineno, col=hit.col_offset,
                    message=f"`self.*` mutation inside pure handler "
                            f"`{cls.name}.{fn.name}` — handler state must "
                            f"live in the `nodes` pytree (instance state "
                            f"leaks across lanes under vmap and across "
                            f"steps in trace order)",
                ))
        tally_lines = _bitmask_tally_lines(cls)
        if tally_lines and not _has_31_cap(cls):
            findings.append(Finding(
                rule="C005", severity=Severity.ERROR, path=path,
                line=tally_lines[0], col=0,
                message=f"`{cls.name}` tallies a voter/ack bitmask but "
                        f"never asserts the 31-node cap — int32 one-hot "
                        f"bits alias at bit 31 (sign); refuse "
                        f"num_nodes > 31 in __init__",
            ))
    return findings


# -- import half -------------------------------------------------------------


def _method_lines(tree: ast.Module) -> Dict[str, Dict[str, int]]:
    """{class: {method: lineno, "": class lineno}} for finding anchors."""
    out: Dict[str, Dict[str, int]] = {}
    for name, cls in machine_classes(tree).items():
        out[name] = {"": cls.lineno}
        for fn in class_methods(cls):
            out[name][fn.name] = fn.lineno
    return out


def _import_module_from(path: str):
    import importlib.util
    import os
    import sys

    # inside the package tree, import canonically (respects relative
    # imports); otherwise load by file path
    norm = os.path.abspath(path)
    parts = norm.replace(os.sep, "/").split("/")
    if "madsim_tpu_torch" in parts:
        rel = parts[parts.index("madsim_tpu_torch"):]
        if rel[-1].endswith(".py"):
            rel[-1] = rel[-1][:-3]
        if rel[-1] == "__init__":
            rel = rel[:-1]
        import importlib
        return importlib.import_module(".".join(rel))
    import re

    modname = "_madsim_lint_" + re.sub(r"\W", "_", norm.strip("/"))
    spec = importlib.util.spec_from_file_location(modname, norm)
    if spec is None or spec.loader is None:
        raise ImportError(f"cannot load {path}")
    mod = importlib.util.module_from_spec(spec)
    sys.modules[modname] = mod
    spec.loader.exec_module(mod)
    return mod


def _skeleton(tree, tree_map):
    """The tree's structure: every leaf replaced by one marker, through
    the port's own tree walk (dataclasses, dicts, tuples)."""
    return tree_map(lambda _leaf: "*", tree)


def _leaves(tree, tree_map) -> list:
    out: list = []
    tree_map(out.append, tree)
    return out


def check_module_contracts(
    tree: ast.Module, source: str, path: str
) -> Tuple[List[Finding], List[str]]:
    """The import half for one file. Returns (findings, skipped-notes).
    Imports torch — call only when the caller opted into import checks."""
    anchors = _method_lines(tree)
    if not anchors:
        return [], []

    # This function IS the gate the layer map (L003) asks about: the C
    # import half is the one lint pass allowed to import torch (models
    # are torch programs), and callers opt in via --no-import-check.
    import torch  # madsim: allow(L003) — the documented import-check gate

    # madsim: allow(L003) — same gate (engine.machine hosts the Machine
    # base class the contract checks instantiate)
    from ..engine.machine import (
        Machine,
        TORN_ATOMIC,
        TORN_LOSE,
        TORN_PREFIX,
    )
    from ..ops.threefry import prng_key, split  # madsim: allow(L003) — same gate
    from ..utils import tree_map  # madsim: allow(L003) — same gate

    findings: List[Finding] = []
    skipped: List[str] = []
    try:
        mod = _import_module_from(path)
    except Exception as exc:  # pragma: no cover - import environment issues
        skipped.append(f"{path}: import failed ({exc!r}); C002-C004 skipped")
        return findings, skipped

    def anchor(cls_name: str, method: str) -> int:
        per = anchors.get(cls_name, {})
        return per.get(method) or per.get("") or 0

    # one lane on the CPU: the engine's own init key derivation
    lane_key = split(prng_key(torch.zeros(1, dtype=torch.int64)), 3)[:, 1]
    now_us = torch.zeros(1, dtype=torch.int32)

    for cls_name in anchors:
        obj = getattr(mod, cls_name, None)
        if obj is None or not isinstance(obj, type) or not issubclass(obj, Machine):
            continue
        if obj is Machine:
            continue
        try:
            machine = obj()
        except Exception as exc:
            skipped.append(
                f"{path}: {cls_name}() not default-constructible ({exc!r}); "
                f"C002-C004 skipped"
            )
            continue

        def emit(rule: str, method: str, message: str) -> None:
            findings.append(Finding(
                rule=rule, severity=Severity.ERROR, path=path,
                line=anchor(cls_name, method), col=0, message=message,
            ))

        try:
            nodes = machine.init(lane_key)
        except Exception as exc:
            skipped.append(f"{path}: {cls_name}.init() raised {exc!r}; C002-C004 skipped")
            continue
        node_shape = _skeleton(nodes, tree_map)

        spec = None
        try:
            spec = machine.durable_spec()
        except Exception as exc:
            emit("C002", "durable_spec", f"{cls_name}.durable_spec() raised {exc!r}")
        if spec is not None:
            if _skeleton(spec, tree_map) != node_shape:
                emit("C002", "durable_spec",
                     f"{cls_name}.durable_spec() is not tree-congruent "
                     f"with init(): {_skeleton(spec, tree_map)!r} vs "
                     f"{node_shape!r}")
            else:
                bad = [
                    type(leaf).__name__
                    for leaf in _leaves(spec, tree_map)
                    if not isinstance(leaf, bool)
                ]
                if bad:
                    emit("C002", "durable_spec",
                         f"{cls_name}.durable_spec() leaves must be python "
                         f"bools (durable yes/no), got {sorted(set(bad))}")

        tspec = None
        try:
            tspec = machine.torn_spec()
        except Exception as exc:
            emit("C003", "torn_spec", f"{cls_name}.torn_spec() raised {exc!r}")
        if tspec is not None:
            if spec is None:
                emit("C003", "torn_spec",
                     f"{cls_name}.torn_spec() without durable_spec() — the "
                     f"atomicity contract refines the durable contract; "
                     f"torn restarts would be refused at engine build")
            if _skeleton(tspec, tree_map) != node_shape:
                emit("C003", "torn_spec",
                     f"{cls_name}.torn_spec() is not tree-congruent with "
                     f"init(): {_skeleton(tspec, tree_map)!r} vs {node_shape!r}")
            else:
                legal = (TORN_ATOMIC, TORN_LOSE, TORN_PREFIX)
                bad_vals = sorted({
                    repr(leaf) for leaf in _leaves(tspec, tree_map)
                    if not (isinstance(leaf, int) and leaf in legal)
                })
                if bad_vals:
                    emit("C003", "torn_spec",
                         f"{cls_name}.torn_spec() leaves must be TORN_ATOMIC/"
                         f"TORN_LOSE/TORN_PREFIX, got {bad_vals}")

        try:
            with torch.inference_mode():
                proj = machine.coverage_projection(nodes, now_us)
        except Exception as exc:
            emit("C004", "coverage_projection",
                 f"{cls_name}.coverage_projection(nodes, now_us) failed to "
                 f"evaluate: {exc!r}")
        else:
            shape = tuple(proj.shape) if isinstance(proj, torch.Tensor) else None
            dtype = getattr(proj, "dtype", None)
            integer = isinstance(dtype, torch.dtype) and not (
                dtype.is_floating_point or dtype.is_complex or dtype == torch.bool
            )
            if shape != (1,) or not integer:
                emit("C004", "coverage_projection",
                     f"{cls_name}.coverage_projection must return one "
                     f"integer word per lane (shape (L,), integer dtype); "
                     f"got shape {shape} at L = 1, dtype {dtype} — the "
                     f"coverage hash folds exactly one word per lane and "
                     f"step")
    return findings, skipped
