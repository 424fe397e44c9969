"""G-rules: gate-discipline cross-checks over the whole repo (no torch).

The chaos palette's growth (6 -> 11 kinds) spread load-bearing mirrors
of one table across eight files; "every new kind keeps the
gate-off-bit-identical discipline" would otherwise rest on reviewers
remembering all of them. These rules make the checklist machine-run. `madsim_tpu_torch/kinds.py` is the source of truth (itself
parsed STATICALLY — pure tuple literals and `+`-concatenations, so a
drifted consumer cannot corrupt the reference the check compares
against); each consumer must either bind its table from `kinds` or
carry a literal equal to it:

G001  flight-recorder counter mirror (runtime/metrics.py)
G002  coverage band mirrors (ops/coverage.py, runtime/coverage.py):
      equal tables, and every kind (plus dup/amnesia) owns a band
G003  shrink's ablation table covers the whole vocabulary
G004  CLI `--fault-kinds` vocabulary (__main__.py)
G005  every non-default chaos flag exercised in the port's gate-off
      matrix, tests/test_torch_gates.py
G006  every chaos flag pinned in the port's golden-pin mirror,
      tests/test_torch_rng.py
G007  engine/core.py K_* indices match FAULT_KIND_NAMES order, the
      FaultPlan has one bool flag per kind, and enabled_kinds() maps
      flag -> K_* in table order
G008  RNG-layout manifest audit (ops/rng_layout.manifest): the
      StepRngLayout section order is append-only — tail-only growth is
      the invariant that keeps every recorded stream byte-stable
G009  guided-search escalation ladder (search/bias.py): every rung
      must be DERIVED from kinds.FAULT_KIND_NAMES (slices /
      concatenations of the bound table, never a literal mirror),
      rungs must strictly widen, and the final rung must cover the
      full CLI vocabulary — recorded guided trails name these rungs,
      so a drifted ladder would silently re-key every recorded hunt

All findings are repo-level (line 0 or the defining line) — inline
suppressions don't apply; fix the drift or version the contract.
"""

from __future__ import annotations

import ast
import os
import re
from typing import Dict, List, Optional, Sequence, Tuple

from .findings import Finding, Severity

# files, relative to repo root
KINDS_PY = "madsim_tpu_torch/kinds.py"
CORE_PY = "madsim_tpu_torch/engine/core.py"
METRICS_PY = "madsim_tpu_torch/runtime/metrics.py"
OPS_COV_PY = "madsim_tpu_torch/ops/coverage.py"
RT_COV_PY = "madsim_tpu_torch/runtime/coverage.py"
SHRINK_PY = "madsim_tpu_torch/engine/shrink.py"
MAIN_PY = "madsim_tpu_torch/__main__.py"
STEP_RNG_PY = "madsim_tpu_torch/ops/step_rng.py"
MANIFEST = "madsim_tpu_torch/ops/rng_layout.manifest"
SEARCH_BIAS_PY = "madsim_tpu_torch/search/bias.py"
GATES_TEST = "tests/test_torch_gates.py"
GOLDEN_TEST = "tests/test_torch_rng.py"


def find_repo_root(start: str) -> Optional[str]:
    """Walk up from `start` to the directory holding the madsim_tpu_torch
    package (identified by the engine core, not just the name)."""
    cur = os.path.abspath(start)
    if os.path.isfile(cur):
        cur = os.path.dirname(cur)
    while True:
        if os.path.isfile(os.path.join(cur, CORE_PY)):
            return cur
        parent = os.path.dirname(cur)
        if parent == cur:
            return None
        cur = parent


# -- static literal resolution ----------------------------------------------


class ModuleFacts:
    """Module-level bindings of one parsed file: literal values where
    statically resolvable, plus which names were imported from the
    kinds module (the 'binds the source of truth' evidence)."""

    def __init__(self, tree: ast.Module):
        self.assigns: Dict[str, ast.expr] = {}
        self.from_kinds: Dict[str, str] = {}  # local name -> kinds attr
        self.kinds_aliases: List[str] = []  # module aliases for kinds
        for node in tree.body:
            if isinstance(node, ast.Assign) and len(node.targets) == 1:
                tgt = node.targets[0]
                if isinstance(tgt, ast.Name):
                    self.assigns[tgt.id] = node.value
            elif isinstance(node, ast.AnnAssign) and node.value is not None:
                if isinstance(node.target, ast.Name):
                    self.assigns[node.target.id] = node.value
            elif isinstance(node, ast.ImportFrom):
                mod = node.module or ""
                if mod.split(".")[-1] == "kinds":
                    # from ..kinds import NAME [as ALIAS]
                    for alias in node.names:
                        self.from_kinds[alias.asname or alias.name] = alias.name
                else:
                    # from .. import kinds [as _kinds]
                    for alias in node.names:
                        if alias.name == "kinds":
                            self.kinds_aliases.append(alias.asname or "kinds")
            elif isinstance(node, ast.Import):
                for alias in node.names:
                    if alias.name.split(".")[-1] == "kinds":
                        self.kinds_aliases.append(alias.asname or alias.name)

    def resolve(self, name: str, depth: int = 0) -> Optional[tuple]:
        """Statically resolve `name` to a tuple of constants, following
        in-module Name references and `+` concatenations."""
        if depth > 8 or name not in self.assigns:
            return None
        return self.resolve_expr(self.assigns[name], depth)

    def resolve_expr(self, node: ast.expr, depth: int = 0) -> Optional[tuple]:
        if isinstance(node, ast.Tuple):
            out = []
            for elt in node.elts:
                if isinstance(elt, ast.Constant):
                    out.append(elt.value)
                elif isinstance(elt, ast.Tuple):
                    inner = self.resolve_expr(elt, depth + 1)
                    if inner is None:
                        return None
                    out.append(inner)
                else:
                    return None
            return tuple(out)
        if isinstance(node, ast.Constant) and isinstance(node.value, tuple):
            return node.value
        if isinstance(node, ast.BinOp) and isinstance(node.op, ast.Add):
            left = self.resolve_expr(node.left, depth + 1)
            right = self.resolve_expr(node.right, depth + 1)
            if left is None or right is None:
                return None
            return left + right
        if isinstance(node, ast.Name):
            return self.resolve(node.id, depth + 1)
        if isinstance(node, ast.Attribute) and isinstance(node.value, ast.Name):
            # _kinds.FAULT_KIND_NAMES style — resolved by the caller
            # against the kinds facts when node.value.id is an alias
            return None
        return None

    def binding_of(self, name: str) -> Optional[Tuple[str, str]]:
        """If `name` is bound (directly or via one rebind) to an
        attribute of the kinds module, return ("kinds", attrname)."""
        if name in self.from_kinds:
            return ("kinds", self.from_kinds[name])
        node = self.assigns.get(name)
        if isinstance(node, ast.Name):
            return self.binding_of(node.id)
        if (
            isinstance(node, ast.Attribute)
            and isinstance(node.value, ast.Name)
            and node.value.id in self.kinds_aliases
        ):
            return ("kinds", node.attr)
        return None


class _Repo:
    def __init__(self, root: str):
        self.root = root
        self._trees: Dict[str, ast.Module] = {}
        self._facts: Dict[str, ModuleFacts] = {}
        self._sources: Dict[str, str] = {}

    def source(self, rel: str) -> Optional[str]:
        if rel not in self._sources:
            path = os.path.join(self.root, rel)
            if not os.path.isfile(path):
                return None
            with open(path, "r", encoding="utf-8") as fh:
                self._sources[rel] = fh.read()
        return self._sources[rel]

    def tree(self, rel: str) -> Optional[ast.Module]:
        if rel not in self._trees:
            src = self.source(rel)
            if src is None:
                return None
            self._trees[rel] = ast.parse(src, filename=rel)
        return self._trees[rel]

    def facts(self, rel: str) -> Optional[ModuleFacts]:
        if rel not in self._facts:
            tree = self.tree(rel)
            if tree is None:
                return None
            self._facts[rel] = ModuleFacts(tree)
        return self._facts[rel]


def _mirror_value(
    repo: _Repo, rel: str, local_name: str, kinds: Dict[str, tuple]
) -> Tuple[Optional[tuple], Optional[str]]:
    """The effective value of `local_name` in file `rel`: a literal if
    one is there, else the kinds table it binds. Returns (value,
    how) where how is 'literal' / 'kinds:<attr>' / None."""
    facts = repo.facts(rel)
    if facts is None:
        return None, None
    bound = facts.binding_of(local_name)
    if bound is not None:
        attr = bound[1]
        return kinds.get(attr), f"kinds:{attr}"
    value = facts.resolve(local_name)
    if value is not None:
        return value, "literal"
    return None, None


def _kinds_tables(repo: _Repo) -> Optional[Dict[str, tuple]]:
    facts = repo.facts(KINDS_PY)
    if facts is None:
        return None
    out = {}
    for name in (
        "FAULT_KIND_NAMES", "FR_EXTRA_NAMES", "KIND_TO_FLAG",
        "EXTRA_FLAGS", "CLI_KIND_TO_FLAG", "COV_BAND_NAMES",
        "COV_BAND_NAMES_V2",
    ):
        val = facts.resolve(name)
        if val is None:
            return None
        out[name] = val
    return out


def _finding(rule: str, path: str, message: str, line: int = 0) -> Finding:
    return Finding(
        rule=rule, severity=Severity.ERROR, path=path, line=line, col=0,
        message=message,
    )


def check_repo(root: str) -> List[Finding]:
    repo = _Repo(root)
    findings: List[Finding] = []

    kinds = _kinds_tables(repo)
    if kinds is None:
        return [_finding(
            "G001", KINDS_PY,
            "cannot statically resolve the kind tables in "
            "madsim_tpu_torch/kinds.py — they must stay pure tuple literals "
            "(the G-pass refuses to trust a computed source of truth)",
        )]

    kind_names = kinds["FAULT_KIND_NAMES"]
    extra_names = kinds["FR_EXTRA_NAMES"]
    kind_flags = kinds["KIND_TO_FLAG"]
    extra_flags = kinds["EXTRA_FLAGS"]
    cli_flags = kinds["CLI_KIND_TO_FLAG"]

    # in-file consistency of kinds.py itself (literal duplication inside
    # the single file is allowed — this is what guards it)
    if tuple(n for n, _f in kind_flags) != kind_names:
        findings.append(_finding(
            "G007", KINDS_PY,
            f"kinds.KIND_TO_FLAG names {tuple(n for n, _ in kind_flags)} "
            f"!= FAULT_KIND_NAMES {kind_names} (same table, same order)",
        ))
    if set(n for n, _f in cli_flags) != set(kind_names) | {"dup"}:
        findings.append(_finding(
            "G004", KINDS_PY,
            f"kinds.CLI_KIND_TO_FLAG must cover every scheduled kind plus "
            f"'dup'; got {sorted(n for n, _ in cli_flags)} vs "
            f"{sorted(set(kind_names) | {'dup'})}",
        ))
    flag_by_name = dict(kind_flags) | dict(extra_flags)
    for name, field in cli_flags:
        if flag_by_name.get(name) != field:
            findings.append(_finding(
                "G004", KINDS_PY,
                f"kinds.CLI_KIND_TO_FLAG maps {name!r} -> {field!r} but "
                f"KIND_TO_FLAG/EXTRA_FLAGS say {flag_by_name.get(name)!r}",
            ))
    band_names_v1 = ("timer", "msg") + tuple(
        n.replace("-", "_") for n in kind_names[:6]
    )
    if kinds["COV_BAND_NAMES"] != band_names_v1:
        findings.append(_finding(
            "G002", KINDS_PY,
            f"kinds.COV_BAND_NAMES {kinds['COV_BAND_NAMES']} != "
            f"('timer','msg') + the first six kinds {band_names_v1}",
        ))
    v2 = kinds["COV_BAND_NAMES_V2"]
    missing_bands = [
        n for n in tuple(kind_names) + tuple(extra_names)
        if n.replace("-", "_") not in v2
    ]
    if missing_bands:
        findings.append(_finding(
            "G002", KINDS_PY,
            f"kinds.COV_BAND_NAMES_V2 is missing bands for "
            f"{missing_bands} — every kind and chaos channel needs a "
            f"decodable coverage band",
        ))

    # G001: flight-recorder mirror
    for local, attr, want in (
        ("FR_FAULT_KINDS", "FAULT_KIND_NAMES", kind_names),
        ("FR_EXTRAS", "FR_EXTRA_NAMES", extra_names),
    ):
        value, how = _mirror_value(repo, METRICS_PY, local, kinds)
        if value is None:
            findings.append(_finding(
                "G001", METRICS_PY,
                f"cannot find {local} as a kinds binding or literal in "
                f"runtime/metrics.py — the fr counter decoder must mirror "
                f"kinds.{attr}",
            ))
        elif tuple(value) != tuple(want):
            findings.append(_finding(
                "G001", METRICS_PY,
                f"{local} ({how}) = {value} drifted from kinds.{attr} = "
                f"{want} — harvested fr vectors would decode under wrong "
                f"labels",
            ))

    # G002: coverage band mirrors
    for rel in (OPS_COV_PY, RT_COV_PY):
        for local in ("COV_BAND_NAMES", "COV_BAND_NAMES_V2"):
            value, how = _mirror_value(repo, rel, local, kinds)
            if value is None:
                findings.append(_finding(
                    "G002", rel,
                    f"cannot find {local} as a kinds binding or literal in "
                    f"{rel}",
                ))
            elif tuple(value) != tuple(kinds[local]):
                findings.append(_finding(
                    "G002", rel,
                    f"{local} ({how}) = {value} drifted from kinds.{local} "
                    f"= {kinds[local]}",
                ))

    # G003: shrink ablation table
    ablation, how = _mirror_value(repo, SHRINK_PY, "ABLATION_ORDER", kinds)
    if ablation is None:
        # legacy literal form: ABLATABLE_KINDS as (name, field) pairs
        pairs, how = _mirror_value(repo, SHRINK_PY, "ABLATABLE_KINDS", kinds)
        ablation = tuple(p[0] for p in pairs) if pairs else None
        if pairs:
            for name, field in pairs:
                if flag_by_name.get(name) != field:
                    findings.append(_finding(
                        "G003", SHRINK_PY,
                        f"ABLATABLE_KINDS maps {name!r} -> {field!r}; the "
                        f"kinds table says {flag_by_name.get(name)!r}",
                    ))
    if ablation is None:
        findings.append(_finding(
            "G003", SHRINK_PY,
            "cannot resolve shrink's ablation table (ABLATION_ORDER or "
            "literal ABLATABLE_KINDS)",
        ))
    else:
        want_abl = set(kind_names) | {"dup", "strict-restart"}
        got_abl = set(ablation)
        if got_abl != want_abl:
            missing = sorted(want_abl - got_abl)
            extra = sorted(got_abl - want_abl)
            findings.append(_finding(
                "G003", SHRINK_PY,
                f"shrink ablation table out of sync with the vocabulary: "
                f"missing {missing}, unknown {extra} — a kind shrink "
                f"cannot ablate silently survives into every minimal "
                f"repro",
            ))

    # G004: CLI vocabulary
    main_facts = repo.facts(MAIN_PY)
    if main_facts is None:
        findings.append(_finding("G004", MAIN_PY, "cannot parse __main__.py"))
    else:
        main_src = repo.source(MAIN_PY) or ""
        binds_cli = "CLI_KIND_TO_FLAG" in main_src and ".kinds import" in main_src
        if not binds_cli:
            findings.append(_finding(
                "G004", MAIN_PY,
                "__main__.py no longer binds CLI_KIND_TO_FLAG from "
                "madsim_tpu_torch/kinds.py — --fault-kinds parsing and the "
                "shrink repro printer must share the one vocabulary table",
            ))

    # G005/G006: gate matrix and golden pins must exercise the flags.
    # Flags whose FaultPlan default is True (the legacy pair/kill) are
    # on in every config, so the gate matrix exercises them implicitly;
    # golden pins must name every flag explicitly.
    defaults = _faultplan_defaults(repo)
    all_flags = tuple(f for _n, f in kind_flags) + tuple(f for _n, f in extra_flags)
    for rel, rule, exempt_default_true in (
        (GATES_TEST, "G005", True),
        (GOLDEN_TEST, "G006", False),
    ):
        src = repo.source(rel)
        if src is None:
            findings.append(_finding(rule, rel, f"{rel} not found"))
            continue
        missing = [
            f for f in all_flags
            if not re.search(rf"\b{re.escape(f)}\b", src)
            and not (exempt_default_true and defaults.get(f) is True)
        ]
        if missing:
            what = (
                "gate-off bit-identity matrix" if rule == "G005"
                else "golden-stream pins"
            )
            findings.append(_finding(
                rule, rel,
                f"chaos flags {missing} never appear in the {what} "
                f"({rel}) — every kind ships gate-off-bit-identical and "
                f"stream-pinned, or it doesn't ship",
            ))

    # G007: core.py K_* indices + FaultPlan fields + source binding
    findings.extend(_check_core(repo, kinds, defaults))

    # G008: RNG layout manifest
    findings.extend(_check_rng_layout(repo))

    # G009: guided-search escalation ladder
    findings.extend(_check_escalation_ladder(repo, kinds))

    return findings


def _faultplan_defaults(repo: _Repo) -> Dict[str, bool]:
    tree = repo.tree(CORE_PY)
    out: Dict[str, bool] = {}
    if tree is None:
        return out
    for node in ast.walk(tree):
        if isinstance(node, ast.ClassDef) and node.name == "FaultPlan":
            for stmt in node.body:
                if (
                    isinstance(stmt, ast.AnnAssign)
                    and isinstance(stmt.target, ast.Name)
                    and isinstance(stmt.value, ast.Constant)
                    and isinstance(stmt.value.value, bool)
                ):
                    out[stmt.target.id] = stmt.value.value
    return out


def _check_core(
    repo: _Repo, kinds: Dict[str, tuple], defaults: Dict[str, bool]
) -> List[Finding]:
    findings: List[Finding] = []
    tree = repo.tree(CORE_PY)
    facts = repo.facts(CORE_PY)
    if tree is None or facts is None:
        return [_finding("G007", CORE_PY, "cannot parse engine/core.py")]
    kind_names = kinds["FAULT_KIND_NAMES"]

    for local, attr in (
        ("FAULT_KIND_NAMES", "FAULT_KIND_NAMES"),
        ("FR_EXTRA_NAMES", "FR_EXTRA_NAMES"),
    ):
        value, how = _mirror_value(repo, CORE_PY, local, kinds)
        if value is None or tuple(value) != tuple(kinds[attr]):
            findings.append(_finding(
                "G007", CORE_PY,
                f"core.{local} must bind or equal kinds.{attr} "
                f"(got {value!r} via {how})",
            ))

    # K_<NAME> == index in FAULT_KIND_NAMES
    k_consts: Dict[str, int] = {}
    for node in tree.body:
        if (
            isinstance(node, ast.Assign)
            and len(node.targets) == 1
            and isinstance(node.targets[0], ast.Name)
            and node.targets[0].id.startswith("K_")
            and isinstance(node.value, ast.Constant)
            and isinstance(node.value.value, int)
        ):
            k_consts[node.targets[0].id] = node.value.value
    for idx, name in enumerate(kind_names):
        kname = "K_" + name.upper().replace("-", "_")
        if k_consts.get(kname) != idx:
            findings.append(_finding(
                "G007", CORE_PY,
                f"{kname} should be {idx} (= FAULT_KIND_NAMES.index"
                f"({name!r})), got {k_consts.get(kname)!r} — recorded "
                f"fault schedules bake these indices",
            ))

    # FaultPlan carries one bool flag per kind + the extras
    for _name, field in tuple(kinds["KIND_TO_FLAG"]) + tuple(kinds["EXTRA_FLAGS"]):
        if field not in defaults:
            findings.append(_finding(
                "G007", CORE_PY,
                f"FaultPlan has no bool field {field!r} (or its default "
                f"is not a bool literal) — the kinds table maps "
                f"{_name!r} to it",
            ))

    # enabled_kinds(): the If(allow_X) -> append(K_Y) ladder must walk
    # the table in order
    ladder: List[Tuple[str, str]] = []
    for node in ast.walk(tree):
        if isinstance(node, ast.FunctionDef) and node.name == "enabled_kinds":
            for stmt in ast.walk(node):
                if not isinstance(stmt, ast.If):
                    continue
                flag = None
                t = stmt.test
                if isinstance(t, ast.Attribute) and isinstance(t.value, ast.Name):
                    if t.value.id == "self":
                        flag = t.attr
                kconst = None
                for sub in ast.walk(stmt):
                    if (
                        isinstance(sub, ast.Call)
                        and isinstance(sub.func, ast.Attribute)
                        and sub.func.attr == "append"
                        and sub.args
                        and isinstance(sub.args[0], ast.Name)
                    ):
                        kconst = sub.args[0].id
                if flag and kconst:
                    ladder.append((flag, kconst))
    want_ladder = [
        (field, "K_" + name.upper().replace("-", "_"))
        for name, field in kinds["KIND_TO_FLAG"]
    ]
    if ladder and ladder != want_ladder:
        findings.append(_finding(
            "G007", CORE_PY,
            f"FaultPlan.enabled_kinds() ladder {ladder} != the kinds "
            f"table order {want_ladder} — schedule derivation draws kinds "
            f"by this order",
        ))
    return findings


def _check_escalation_ladder(
    repo: _Repo, kinds: Dict[str, tuple]
) -> List[Finding]:
    """G009: `search/bias.py`'s ESCALATION_LADDER must be DERIVED from
    the kinds tables (slices / `+`-concatenations of names bound from
    madsim_tpu_torch/kinds.py — a literal kind-name tuple here is exactly
    the mirror class every other G-rule exists to refuse), each rung
    must strictly widen the previous one, and the final rung must
    cover the full CLI vocabulary."""
    facts = repo.facts(SEARCH_BIAS_PY)
    if facts is None:
        return [_finding(
            "G009", SEARCH_BIAS_PY,
            f"{SEARCH_BIAS_PY} not found — the guided-search escalation "
            f"ladder is a recorded contract and must stay auditable",
        )]
    node = facts.assigns.get("ESCALATION_LADDER")
    if node is None or not isinstance(node, ast.Tuple):
        return [_finding(
            "G009", SEARCH_BIAS_PY,
            "ESCALATION_LADDER must be a module-level tuple literal of "
            "kinds-derived rungs (it is the recorded escalation "
            "contract guided trails reference by step index)",
        )]

    used_binding = [False]

    def resolve(expr: ast.expr) -> Optional[tuple]:
        """Resolve a rung against the kinds tables: bound names,
        constant-slice subscripts of bound names, literal tuples and
        `+`-concatenations."""
        if isinstance(expr, ast.Name):
            bound = facts.binding_of(expr.id)
            if bound is not None:
                used_binding[0] = True
                return kinds.get(bound[1])
            return facts.resolve(expr.id)
        if isinstance(expr, ast.Tuple):
            out = []
            for elt in expr.elts:
                if not isinstance(elt, ast.Constant):
                    return None
                out.append(elt.value)
            return tuple(out)
        if isinstance(expr, ast.BinOp) and isinstance(expr.op, ast.Add):
            left, right = resolve(expr.left), resolve(expr.right)
            if left is None or right is None:
                return None
            return left + right
        if isinstance(expr, ast.Subscript):
            base = resolve(expr.value)
            if base is None:
                return None
            sl = expr.slice
            if isinstance(sl, ast.Slice):
                lo = sl.lower.value if isinstance(sl.lower, ast.Constant) else None
                hi = sl.upper.value if isinstance(sl.upper, ast.Constant) else None
                if sl.step is None and (sl.lower is None or lo is not None) \
                        and (sl.upper is None or hi is not None):
                    return base[lo:hi]
            return None
        return None

    rungs = [resolve(elt) for elt in node.elts]
    if any(r is None for r in rungs) or not rungs:
        return [_finding(
            "G009", SEARCH_BIAS_PY,
            "cannot statically resolve every ESCALATION_LADDER rung "
            "from the kinds tables (rungs must be slices or "
            "`+`-concatenations of names bound from madsim_tpu_torch/kinds.py)",
        )]
    findings: List[Finding] = []
    if not used_binding[0]:
        findings.append(_finding(
            "G009", SEARCH_BIAS_PY,
            "ESCALATION_LADDER does not bind madsim_tpu_torch/kinds.py — a "
            "hand-maintained mirror of the kind vocabulary here is "
            "exactly the drift class the kinds table exists to prevent",
        ))
    cli_names = set(n for n, _f in kinds["CLI_KIND_TO_FLAG"])
    prev: set = set()
    for i, rung in enumerate(rungs):
        cur = set(rung)
        if not cur <= cli_names:
            findings.append(_finding(
                "G009", SEARCH_BIAS_PY,
                f"ESCALATION_LADDER rung {i} names unknown kinds "
                f"{sorted(cur - cli_names)} (vocabulary: "
                f"{sorted(cli_names)})",
            ))
        if not prev < cur:
            findings.append(_finding(
                "G009", SEARCH_BIAS_PY,
                f"ESCALATION_LADDER rung {i} does not strictly widen "
                f"rung {i - 1} — escalation must always ADD kinds "
                f"(recorded trails reference rungs by index)",
            ))
        prev = cur
    if prev != cli_names:
        findings.append(_finding(
            "G009", SEARCH_BIAS_PY,
            f"ESCALATION_LADDER's final rung must cover the full CLI "
            f"vocabulary {sorted(cli_names)}; got {sorted(prev)} — a "
            f"kind the ladder never reaches is a scenario class no "
            f"plateau can unlock",
        ))
    return findings


def _layout_sections(repo: _Repo) -> Optional[List[str]]:
    """StepRngLayout's `*_off` fields in declaration order — the block
    section order (the implicit handler head carries no offset)."""
    tree = repo.tree(STEP_RNG_PY)
    if tree is None:
        return None
    for node in ast.walk(tree):
        if isinstance(node, ast.ClassDef) and node.name == "StepRngLayout":
            fields = []
            for stmt in node.body:
                if isinstance(stmt, ast.AnnAssign) and isinstance(stmt.target, ast.Name):
                    name = stmt.target.id
                    if name.endswith("_off"):
                        fields.append(name[: -len("_off")])
            return fields
    return None


def _check_rng_layout(repo: _Repo) -> List[Finding]:
    sections = _layout_sections(repo)
    if sections is None:
        return [_finding(
            "G008", STEP_RNG_PY,
            "cannot find StepRngLayout in ops/step_rng.py for the "
            "layout-manifest audit",
        )]
    manifest_src = repo.source(MANIFEST)
    if manifest_src is None:
        return [_finding(
            "G008", MANIFEST,
            f"RNG layout manifest {MANIFEST} is missing — it records the "
            f"step-block section order so growth stays tail-only",
        )]
    manifest = [
        line.strip() for line in manifest_src.splitlines()
        if line.strip() and not line.strip().startswith("#")
    ]
    if sections[: len(manifest)] != manifest:
        return [_finding(
            "G008", STEP_RNG_PY,
            f"StepRngLayout section order {sections} no longer starts "
            f"with the manifest order {manifest} — a section was "
            f"inserted, removed or reordered. That moves recorded "
            f"stream offsets (corpus-breaking); ship a new rng_stream "
            f"version instead",
        )]
    if len(sections) > len(manifest):
        new = sections[len(manifest):]
        return [_finding(
            "G008", MANIFEST,
            f"StepRngLayout grew new tail section(s) {new} not recorded "
            f"in {MANIFEST} — append them (tail growth is legal; "
            f"unrecorded growth is not reviewable)",
        )]
    return []
