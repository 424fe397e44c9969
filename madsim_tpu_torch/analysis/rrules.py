"""R-rules: the static RNG-ledger auditor.

G008 checks the manifest's *shape* — `StepRngLayout`'s field order
against `ops/rng_layout.manifest`. That catches a reordered dataclass,
but the dataclass is only the ledger's cover page: the actual word
budget lives in `layout_for`'s cursor arithmetic (which section starts
where, how wide it is) and in the consumption sites that slice the
step block (`step_words[layout.drop_off : layout.drop_off + M]`). A
drifted *consumer* — a site reading past its section into the next
one, or a cursor walk that hands out sections in a different order
than the manifest records — shifts every recorded stream while G008
stays green. These rules check the CODE against the manifest:

R001  every word-block section the code materializes or consumes has a
      manifest row (an unrecorded section is unreviewable growth), and
      every manifest row still exists in the code (a ghost row means
      the ledger describes a stream nobody derives)
R002  no consumption site reads past its section: for each slice
      `words[X_off + a : X_off + b]` (or scalar read `words[X_off]`),
      `b` must fit inside section X's width as derived from the
      `layout_for` cursor walk — symbolically, in units of
      (max_msgs, words), so `spike_off + 2*M` vs width `2*M` checks
      without knowing M
R003  the v3 cursor walk hands out sections in exactly the manifest
      order — tail growth is append-only in the CODE, not just in the
      dataclass declaration (the same corpus contract G008 words:
      moving an existing offset is a corpus-breaking event that must
      ship as a new rng_stream version)

Sections are audited in `ops/step_rng.py` (the layout + the v3
restart-tail read) and `engine/core.py` (the step-block consumers). The
port's blocks are lane-batched `[L, W]`, so a site reads
`words[:, X_off : X_off + n]`; the lane slice is skipped and the word
index audited as the JAX package's `words[X_off : X_off + n]`.
The `lat` section has no cursor statement — it is the fixed head at
offset `h` with width `max_msgs`, recovered from the walk's seed
statement `cursor = h + m`. All stdlib-`ast`; widths that cannot be
resolved symbolically are skipped, not guessed.
"""

from __future__ import annotations

import ast
import os
from typing import Dict, List, Optional, Tuple

from .findings import Finding, Severity

STEP_RNG_PY = "madsim_tpu_torch/ops/step_rng.py"
CORE_PY = "madsim_tpu_torch/engine/core.py"
MANIFEST = "madsim_tpu_torch/ops/rng_layout.manifest"

# a symbolic word count: (coefficient on max_msgs, constant words)
Width = Tuple[int, int]


def _finding(rule: str, path: str, line: int, message: str) -> Finding:
    return Finding(
        rule=rule, severity=Severity.ERROR, path=path, line=line, col=0,
        message=message,
    )


def _is_msgs_unit(node: ast.expr) -> bool:
    """`m` / `max_msgs` / `<anything>.MAX_MSGS` — the per-step message
    slot count, the one symbolic unit in the block layout."""
    if isinstance(node, ast.Name):
        return node.id in ("m", "max_msgs")
    if isinstance(node, ast.Attribute):
        return node.attr in ("MAX_MSGS", "max_msgs")
    return False


def _width_of(node: ast.expr) -> Optional[Width]:
    """Resolve an expression to a symbolic width a*M + b, else None."""
    if isinstance(node, ast.Constant) and isinstance(node.value, int):
        return (0, node.value)
    if _is_msgs_unit(node):
        return (1, 0)
    if isinstance(node, ast.BinOp):
        if isinstance(node.op, ast.Mult):
            left, right = node.left, node.right
            if isinstance(left, ast.Constant) and _is_msgs_unit(right):
                return (left.value, 0)
            if isinstance(right, ast.Constant) and _is_msgs_unit(left):
                return (right.value, 0)
        if isinstance(node.op, ast.Add):
            a = _width_of(node.left)
            b = _width_of(node.right)
            if a is not None and b is not None:
                return (a[0] + b[0], a[1] + b[1])
    return None


def _fits(read: Width, width: Width) -> bool:
    """read <= width for all max_msgs >= 1 (coefficient-wise; a read
    trading a constant for an M coefficient is out of budget)."""
    return read[0] <= width[0] and read[1] <= width[1] + (width[0] - read[0])


# -- the cursor walk ---------------------------------------------------------


def _cursor_walk(tree: ast.Module) -> Tuple[List[Tuple[str, Width, int]], Optional[int]]:
    """Ordered (section, width, lineno) from `layout_for`'s v3 cursor
    arithmetic, with `lat` recovered from the seed statement. Returns
    ([], None) when layout_for is missing."""
    fn = None
    for node in ast.walk(tree):
        if isinstance(node, ast.FunctionDef) and node.name == "layout_for":
            fn = node
            break
    if fn is None:
        return [], None

    sections: List[Tuple[str, Width, int]] = []
    pending: Optional[Tuple[str, int]] = None  # (section, lineno) awaiting width

    def doc_order(n):
        # ast.walk is breadth-first; the cursor idiom is sequential
        for child in ast.iter_child_nodes(n):
            yield child
            yield from doc_order(child)

    for node in doc_order(fn):
        if (
            isinstance(node, ast.Assign)
            and len(node.targets) == 1
            and isinstance(node.targets[0], ast.Name)
        ):
            tgt = node.targets[0].id
            if tgt == "cursor" and not sections and pending is None:
                # seed statement `cursor = h + m`: the implicit handler
                # head (h) plus the lat section (m)
                w = _width_of_tail(node.value)
                if w is not None:
                    sections.append(("lat", w, node.lineno))
                continue
            if (
                tgt.endswith("_off")
                and isinstance(node.value, ast.Name)
                and node.value.id == "cursor"
            ):
                pending = (tgt[: -len("_off")], node.lineno)
        elif (
            isinstance(node, ast.AugAssign)
            and isinstance(node.target, ast.Name)
            and node.target.id == "cursor"
            and isinstance(node.op, ast.Add)
            and pending is not None
        ):
            w = _width_of(node.value)
            sections.append((pending[0], w if w is not None else (0, 0), pending[1]))
            pending = None
    return sections, fn.lineno


def _width_of_tail(node: ast.expr) -> Optional[Width]:
    """`h + m` -> the lat width (m); the handler head is not a layout
    section (it has no offset field and no manifest row)."""
    if isinstance(node, ast.BinOp) and isinstance(node.op, ast.Add):
        if isinstance(node.left, ast.Name) and node.left.id in ("h", "handler_words"):
            return _width_of(node.right)
    return None


# -- consumption sites -------------------------------------------------------


def _off_section(node: ast.expr) -> Optional[Tuple[str, bool]]:
    """(section, is_layout_attr) when `node` is `<...>.X_off` or
    `X_off`. Attribute form (`layout.drop_off`) is the strong signal;
    a bare local Name ending in `_off` may be unrelated arithmetic
    (`b_off`, `slot_off` in the fault scheduler), so unknown sections
    are only reported for the attribute form."""
    if isinstance(node, ast.Attribute) and node.attr.endswith("_off"):
        return node.attr[: -len("_off")], True
    if isinstance(node, ast.Name) and node.id.endswith("_off"):
        return node.id[: -len("_off")], False
    return None


def _bound_relative(node: ast.expr) -> Optional[Tuple[str, Width, bool]]:
    """`X_off` -> (X, (0,0), attr?); `X_off + E` -> (X, width(E), attr?)."""
    sec = _off_section(node)
    if sec is not None:
        return sec[0], (0, 0), sec[1]
    if isinstance(node, ast.BinOp) and isinstance(node.op, ast.Add):
        sec = _off_section(node.left)
        if sec is not None:
            w = _width_of(node.right)
            if w is not None:
                return sec[0], w, sec[1]
    return None


def _consumption_sites(tree: ast.Module) -> List[Tuple[str, Width, int, bool]]:
    """(section, read-extent-past-offset, lineno, is_layout_attr) for
    every subscript that indexes a word block by a layout offset."""
    out: List[Tuple[str, Width, int, bool]] = []
    for node in ast.walk(tree):
        if not isinstance(node, ast.Subscript):
            continue
        sl = node.slice
        if (
            isinstance(sl, ast.Tuple) and len(sl.elts) == 2
            and isinstance(sl.elts[0], ast.Slice)
            and sl.elts[0].lower is None and sl.elts[0].upper is None
            and sl.elts[0].step is None
        ):
            # the lane-batched read `words[:, X]` of a [L, W] block
            sl = sl.elts[1]
        if isinstance(sl, ast.Slice):
            lo = _bound_relative(sl.lower) if sl.lower is not None else None
            hi = _bound_relative(sl.upper) if sl.upper is not None else None
            if hi is None:
                continue
            sec, extent, attr = hi
            if lo is not None and lo[0] != sec:
                continue  # cross-section slice: not this rule's shape
            out.append((sec, extent, node.lineno, attr))
        else:
            direct = _off_section(sl)
            if direct is None and isinstance(sl, ast.BinOp):
                b = _bound_relative(sl)
                if b is not None:
                    out.append((b[0], (b[1][0], b[1][1] + 1), node.lineno, b[2]))
                continue
            if direct is not None:
                out.append((direct[0], (0, 1), node.lineno, direct[1]))
    return out


# -- the audit ---------------------------------------------------------------


def check_repo(root: str) -> List[Finding]:
    findings: List[Finding] = []

    def read(rel: str) -> Optional[str]:
        path = os.path.join(root, rel)
        if not os.path.isfile(path):
            return None
        with open(path, "r", encoding="utf-8") as fh:
            return fh.read()

    manifest_src = read(MANIFEST)
    rng_src = read(STEP_RNG_PY)
    if manifest_src is None or rng_src is None:
        # G008 already reports the missing ledger/layout loudly
        return findings
    manifest = [
        line.strip() for line in manifest_src.splitlines()
        if line.strip() and not line.strip().startswith("#")
    ]
    try:
        rng_tree = ast.parse(rng_src, filename=STEP_RNG_PY)
    except SyntaxError:
        return findings  # D000 owns it

    sections, anchor = _cursor_walk(rng_tree)
    if anchor is None or not sections:
        return [_finding(
            "R001", STEP_RNG_PY, anchor or 0,
            "cannot statically resolve layout_for's v3 cursor walk — the "
            "RNG-ledger audit needs the `X_off = cursor; cursor += W` "
            "idiom to reconstruct section widths",
        )]
    widths: Dict[str, Width] = {name: w for name, w, _ln in sections}
    code_order = [name for name, _w, _ln in sections]

    # R001 half one: every code section has a manifest row
    for name, _w, ln in sections:
        if name not in manifest:
            findings.append(_finding(
                "R001", STEP_RNG_PY, ln,
                f"layout_for materializes section `{name}` with no row in "
                f"{MANIFEST} — appending the row is the ritual that makes "
                f"word-budget growth reviewable",
            ))
    # R001 half two: every manifest row still derived by the code
    for name in manifest:
        if name not in widths:
            findings.append(_finding(
                "R001", MANIFEST, 0,
                f"manifest row `{name}` has no section in layout_for's "
                f"cursor walk — the ledger describes a stream the code no "
                f"longer derives; removing a section is corpus-breaking "
                f"and must ship as a new rng_stream version",
            ))

    # R003: append-only order — the code's walk must equal the manifest
    # restricted to recorded rows, in manifest order
    recorded_in_code = [n for n in code_order if n in manifest]
    manifest_in_code = [n for n in manifest if n in widths]
    if recorded_in_code != manifest_in_code:
        findings.append(_finding(
            "R003", STEP_RNG_PY, sections[0][2],
            f"layout_for's cursor walk hands out sections in order "
            f"{code_order}, but {MANIFEST} records {manifest} — a "
            f"reordered section moves every later offset (recorded "
            f"streams replay under the wrong words); restore the order "
            f"or ship a new rng_stream version",
        ))

    # R002: consumption sites across the layout module and the engine
    for rel, src in ((STEP_RNG_PY, rng_src), (CORE_PY, read(CORE_PY))):
        if src is None:
            continue
        try:
            tree = ast.parse(src, filename=rel)
        except SyntaxError:
            continue
        for sec, extent, ln, attr in _consumption_sites(tree):
            if sec not in widths:
                if sec in manifest or not attr:
                    continue
                findings.append(_finding(
                    "R001", rel, ln,
                    f"consumption site reads section `{sec}` which neither "
                    f"the layout_for cursor walk nor {MANIFEST} knows — "
                    f"every consumed word needs a manifest row",
                ))
                continue
            if not _fits(extent, widths[sec]):
                findings.append(_finding(
                    "R002", rel, ln,
                    f"read of {extent[0]}*max_msgs+{extent[1]} words past "
                    f"`{sec}_off` exceeds the `{sec}` section's width "
                    f"{widths[sec][0]}*max_msgs+{widths[sec][1]} — the "
                    f"site reads into the NEXT section's words (silent "
                    f"stream corruption with the next flag on)",
                ))
    return findings
