"""S-rules: sharding readiness — the lane-axis contract, machine-checked.

The port shards `run_stream` over `torch.distributed` ranks along the
lane axis of `StreamCarry` (`parallel/`). That is only cheap while
per-lane state never crosses ranks except at a few designed
collectives; these rules make it a blocking, ENUMERATED contract over
the `axes.py` lane-axis dataflow:

S001  a cross-lane reduction/gather/scan/reshape (a `dim=0` sum, a
      dim-less `x.any()`, a `bitwise_or.reduce`, a lane-indexed gather,
      a lane-axis cumsum, a reshape that drops the lane axis) outside
      the declared whitelist. Every designed collective carries an
      inline ``# madsim: collective(<name>, reduce=...)`` annotation
      naming an entry in `COLLECTIVES` below — the registry IS the
      collective plan `parallel/` implements (its helpers run each under
      the registry's name). Also S001: an annotation naming an
      unregistered collective, an annotation whose `reduce=` disagrees
      with the registry or with the op the analysis sees, a registry
      entry no annotation references (stale plan), and an annotation on
      a line where the analysis finds nothing cross-lane (dead
      annotation).
S002  `StreamCarry` axis discipline: every leaf of the carry (and of
      `LaneState`/`BatchResult`) is declared lane-leading or global in
      `CARRY_AXES`; a new leaf without a declaration, a declaration
      without a leaf, or a rebuild site (`StreamCarry(...)`,
      `dataclasses.replace(carry, ...)`) that feeds a LANE-carrying
      value into a global-declared leaf (smuggling per-lane data into
      what the mesh will replicate = an implicit gather) all fail. The
      zero-length gate-off specializations (`fr_metrics`, `cov_map`,
      `fail_provs`) are global by design — a `[0]`-shaped leaf shards
      trivially.
S003  lane-axis-dependent Python control flow (if/while/assert/ternary,
      `len()`, iteration) in the step path — under a mesh every such
      read forces a cross-rank gather to one host; the designed pattern
      is to fold through a registered collective first.
S004  collective placement: a cross-lane op in the per-event inner loop
      (the `step` region — `step_batch` / `run_segment` bodies) rather
      than at segment/poll boundaries, or an annotated collective used
      in a region its registry entry does not allow. This is the perf
      half of the contract: scaling over ranks is plausible only if
      collectives fire per SEGMENT, not per event. (The one designed
      exception, the done-mask, is registered with placement "step": a
      one-element all-reduce per event step is the early-exit check's
      irreducible cost.)

Same two-pass shape as `trules`: the interpreter (`axes.py`) walks the
entry contexts below over the `projectmodel` call graph; this module
owns policy — the registry, the carry axis tables, the entrypoints —
and turns the interpreter's events into findings. The port has no
`vmap`: its batched per-lane step is walked with everything else and
must show its lane-parallelism op by op.
"""

from __future__ import annotations

import ast
import dataclasses
from typing import Dict, List, Optional, Sequence, Set, Tuple

from . import axes
from .axes import CARRY, FREE, LANE, AxisEngine, EntryPoint, laneish
from .findings import Finding, Severity
from .projectmodel import ProjectModel

# -- the collective registry --------------------------------------------------
#
# One entry per designed cross-lane op. `reduce` is the combining op the
# mesh implements it with (`any` -> a one-element MAX all-reduce, sums ->
# SUM all-reduces, gathers -> the host-side ring drain / all_gather of
# failing lanes only); `placement` is where in the executor the op is
# allowed to fire (S004); `note` is the sharding plan, reviewed in this
# diff. The JAX package's registry also has `cov-buffer-fold` (the
# port's segment-exit flush runs unconditionally, with no guard to fold)
# and `multihost-fail-ranks` / `multihost-fail-ring` (the port's
# multihost harvest runs the ring-append collectives, which therefore
# also allow the final region).

REDUCE_KINDS = ("or", "sum", "any", "max", "min", "gather", "scan")
REGIONS = ("step", "segment", "init", "final")


@dataclasses.dataclass(frozen=True)
class Collective:
    reduce: str  # one of REDUCE_KINDS
    placement: Tuple[str, ...]  # allowed regions
    note: str  # the all-reduce plan for the mesh rebuild


COLLECTIVES: Dict[str, Collective] = {
    "segment-done-any": Collective(
        "any", ("step",),
        "early-exit mask (`Engine._any_live`): a one-element MAX "
        "all-reduce (`parallel.any_rank`) per event step of a buffered "
        "segment and per chunk of `run_batch`; keep — it is what lets a "
        "finished shard stop",
    ),
    "refill-count": Collective(
        "sum", ("segment",),
        "harvested-lane count for the refill: per-rank sum, then the "
        "total of the gathered [world] counts "
        "(`parallel.exclusive_count`) at segment start",
    ),
    "refill-ranks": Collective(
        "scan", ("segment",),
        "gapless seed assignment ranks: a per-rank scan over the done "
        "mask plus the exclusive scan of the ranks' counts",
    ),
    "harvest-completed": Collective(
        "sum", ("segment",),
        "completed-lane fold into the device-resident counter: a SUM "
        "all-reduce (`parallel.all_sum`) per segment",
    ),
    "ring-append-ranks": Collective(
        "scan", ("segment", "final"),
        "failing/abandoned-lane ring ranks (`parallel.compact`, then "
        "the gathered counts of `parallel.gather_masked`); the final "
        "region's is the multihost failing-lane harvest",
    ),
    "ring-append-gather": Collective(
        "gather", ("segment", "final"),
        "append failing lanes into the result ring: gathers ONLY "
        "masked lanes (the ring drain contract — never a full [L] "
        "all-gather); the final region's is the multihost harvest",
    ),
    "fr-fold": Collective(
        "sum", ("segment",),
        "flight-recorder totals of lanes finishing this segment: a SUM "
        "all-reduce of small int64 vectors",
    ),
    "fr-hwm": Collective(
        "max", ("segment",),
        "flight-recorder high-water marks: a MAX all-reduce per segment",
    ),
    "cov-map-or": Collective(
        "or", ("segment",),
        "global coverage map fold: bitwise OR of the packed [W] words "
        "per segment. Executed as ops/coverage.cov_fold_words: a "
        "rank-local bit-unpacked `any` fold, then an all-gather of the "
        "ranks' [W] words folded the same way (`parallel.or_words`; "
        "NCCL has no bitwise-or reduction); exact either way",
    ),
    "seed-counter-init": Collective(
        "gather", ("init",),
        "next_seed = last seed + 1 at stream start: one scalar gather "
        "from the last lane, once per stream",
    ),
    "final-fail-gather": Collective(
        "gather", ("final",),
        "failing-lane (seed, code) harvest after the run: gathers only "
        "failing lanes to the host",
    ),
    "final-abandoned-gather": Collective(
        "gather", ("final",),
        "abandoned-lane seed harvest after the run (host-side)",
    ),
    "final-prov-gather": Collective(
        "gather", ("final",),
        "violation-provenance words of failing lanes, same drain as "
        "final-fail-gather",
    ),
    "final-cov-or": Collective(
        "or", ("final",),
        "host-side OR of per-lane coverage maps in the fixed-batch "
        "path: becomes the same or-all-reduce as cov-map-or",
    ),
    "multihost-completed-sum": Collective(
        "sum", ("final",),
        "completion count across processes: a SUM all-reduce "
        "(`parallel.all_sum`) of each rank's count",
    ),
}

# -- carry axis tables (S002) -------------------------------------------------
#
# Every leaf of the streaming structs, declared: "lane" = lane-leading
# [L, ...] (sharded over the ranks), "global" = replicated device
# state (scalars, rings, the OR-folded coverage map). The class-def
# audit refuses a new leaf without a row here, and a row without a
# leaf — adding carry state FORCES an axis decision in this diff.

CARRY_AXES: Dict[str, Dict[str, str]] = {
    "StreamCarry": {
        "state": "lane",
        "seeds": "lane",
        "done": "lane",
        "next_seed": "global",
        "completed": "global",
        "segments": "global",
        "fail_seeds": "global",
        "fail_codes": "global",
        "fail_provs": "global",
        "fail_count": "global",
        "ab_seeds": "global",
        "ab_count": "global",
        "counters": "global",
        "fr_metrics": "global",
        "cov_map": "global",
    },
    "LaneState": {
        **{
            f: "lane"
            for f in (
                "now_us", "next_seq", "step", "rng_key", "done", "failed",
                "fail_code", "horizon_hit", "msg_count", "storm_loss",
                "delay_spike", "eq_time", "eq_seq", "eq_kind", "eq_node",
                "eq_src", "eq_payload", "eq_valid", "clogged", "killed",
                "paused_until", "skew_q10", "node_prov", "eq_prov",
                "fail_prov", "nodes", "ring", "fr", "cov",
            )
        },
        # dotted rows: documented sub-leaves of a dict-typed leaf (the
        # parent field must exist; the class-def audit skips them, see
        # check_model). The buffered-coverage slot ring and its count
        # are per-lane [L, C]/[L] state — they shard with the lane axis
        # like the map they flush into.
        "cov.map": "lane",
        "cov.buf": "lane",
        "cov.buf_n": "lane",
    },
    "BatchResult": {
        f: "lane"
        for f in (
            "seeds", "done", "failed", "fail_code", "fail_prov", "now_us",
            "steps", "msg_count", "summary", "ring", "fr", "cov",
        )
    },
}

# classes whose class-def field list is audited against CARRY_AXES
AUDITED_CLASSES: Tuple[Tuple[str, str], ...] = (
    ("madsim_tpu_torch.engine.core", "StreamCarry"),
    ("madsim_tpu_torch.engine.core", "LaneState"),
    ("madsim_tpu_torch.engine.core", "BatchResult"),
)

# field -> axis lookup tables for the interpreter (derived from the
# axis tables; "state" is itself a classified struct)
CARRY_FIELDS: Set[str] = {"state"}


def _field_tables() -> Tuple[Set[str], Set[str]]:
    lane: Set[str] = set()
    free: Set[str] = set()
    for table in CARRY_AXES.values():
        for field, axis in table.items():
            # dotted sub-leaf rows document dict internals; the
            # interpreter's field lookup is by attribute name only
            if field in CARRY_FIELDS or "." in field:
                continue
            (lane if axis == "lane" else free).add(field)
    return lane, free


LANE_FIELDS, FREE_FIELDS = _field_tables()

# -- entry contexts -----------------------------------------------------------
#
# The streaming step path (the segment and harvest code `run_stream`'s
# executor calls), plus the fixed-batch and multihost harvest paths.

_CORE = "madsim_tpu_torch.engine.core"

STREAM_ENTRYPOINTS: Tuple[EntryPoint, ...] = (
    EntryPoint(_CORE, "Engine.step_batch", "step", {"state": CARRY}),
    EntryPoint(_CORE, "Engine.run_segment", "step", {"state": CARRY}),
    EntryPoint(_CORE, "Engine._init_carry", "init", {"seeds": LANE}),
    EntryPoint(_CORE, "Engine._segment", "segment", {"c": CARRY, "go": FREE}),
    EntryPoint(_CORE, "Engine._run_stream_impl.<locals>.drain", "segment",
               {"c": CARRY}),
    EntryPoint(_CORE, "Engine.run_batch", "final", {"seeds": LANE}),
    EntryPoint(_CORE, "Engine.run_seed_batch", "final", {},
               pinned={"res": CARRY}),
    EntryPoint(_CORE, "Engine.failing_seeds", "final", {"result": CARRY}),
    EntryPoint("madsim_tpu_torch.parallel.multihost", "run_batch_global",
               "final", {}, pinned={"res": CARRY}),
)

# functions whose bodies ARE the per-event inner loop, whatever region
# the caller walked in from (S004's "step" scope)
REGION_OVERRIDES: Dict[Tuple[str, str], str] = {
    (_CORE, "Engine.step_batch"): "step",
    (_CORE, "Engine.run_segment"): "step",
    (_CORE, "Engine._any_live"): "step",
}

CARRY_CLASSES: Set[str] = {"StreamCarry", "LaneState", "BatchResult"}


# -- policy: events -> findings ----------------------------------------------


def _chain(chain: Tuple[str, ...]) -> str:
    return " -> ".join(chain)


def check_model(
    model: ProjectModel,
    *,
    entrypoints: Optional[Sequence[EntryPoint]] = None,
    collectives: Optional[Dict[str, Collective]] = None,
    carry_axes: Optional[Dict[str, Dict[str, str]]] = None,
    audited_classes: Optional[Sequence[Tuple[str, str]]] = None,
    carry_classes: Optional[Set[str]] = None,
    carry_fields: Optional[Set[str]] = None,
    region_overrides: Optional[Dict[Tuple[str, str], str]] = None,
    audit_registry: bool = True,
) -> List[Finding]:
    entrypoints = tuple(entrypoints if entrypoints is not None
                        else STREAM_ENTRYPOINTS)
    collectives = collectives if collectives is not None else COLLECTIVES
    carry_axes = carry_axes if carry_axes is not None else CARRY_AXES
    audited = tuple(audited_classes if audited_classes is not None
                    else AUDITED_CLASSES)
    carry_classes = carry_classes if carry_classes is not None else set(carry_axes)
    carry_fields = carry_fields if carry_fields is not None else CARRY_FIELDS

    lane_fields: Set[str] = set()
    free_fields: Set[str] = set()
    for table in carry_axes.values():
        for field, axis in table.items():
            if field in carry_fields:
                continue
            (lane_fields if axis == "lane" else free_fields).add(field)

    engine = AxisEngine(
        model,
        lane_fields=lane_fields,
        free_fields=free_fields,
        carry_fields=carry_fields,
        carry_classes=carry_classes,
        region_overrides=(region_overrides if region_overrides is not None
                          else REGION_OVERRIDES),
    )
    engine.run(entrypoints)

    findings: List[Finding] = []
    seen_names: Set[str] = set()

    # S001 / S004: cross-lane ops vs the registry
    for op in engine.cross_ops:
        ann = op.annotation
        if ann is None:
            findings.append(Finding(
                rule="S001", severity=Severity.ERROR, path=op.rel,
                line=op.line, col=op.col,
                message=(
                    f"cross-lane {op.kind}: {op.detail} — under "
                    f"a mesh this is a cross-rank collective; "
                    f"either make it lane-parallel or declare it with "
                    f"`# madsim: collective(<name>, reduce={op.reduce})` "
                    f"and a registry entry (the mesh plan) "
                    f"[chain: {_chain(op.chain)}]"
                ),
            ))
            if op.region == "step":
                findings.append(Finding(
                    rule="S004", severity=Severity.WARNING, path=op.rel,
                    line=op.line, col=op.col,
                    message=(
                        f"cross-lane {op.kind} in the per-event inner "
                        f"loop (`step` region) — collectives belong at "
                        f"segment/poll boundaries; per-event cross-rank "
                        f"traffic sinks the near-linear scaling target "
                        f"[chain: {_chain(op.chain)}]"
                    ),
                ))
            continue
        entry = collectives.get(ann.name)
        if entry is None:
            findings.append(Finding(
                rule="S001", severity=Severity.ERROR, path=op.rel,
                line=op.line, col=op.col,
                message=(
                    f"collective annotation `{ann.name}` names no entry "
                    f"in the registry (analysis/srules.py COLLECTIVES) — "
                    f"the registry is the reviewed collective plan; add "
                    f"the entry or fix the name"
                ),
            ))
            continue
        seen_names.add(ann.name)
        if ann.reduce != entry.reduce:
            findings.append(Finding(
                rule="S001", severity=Severity.ERROR, path=op.rel,
                line=op.line, col=op.col,
                message=(
                    f"collective `{ann.name}` annotated reduce="
                    f"{ann.reduce} but the registry declares "
                    f"{entry.reduce} — the annotation and the plan "
                    f"disagree"
                ),
            ))
        elif op.reduce not in ("?", ann.reduce) and not (
            # or/any are the same 1-bit fold family, and gather/scan
            # events are legitimate parts of composite collectives (a
            # ring append is a scan + a gather under one name)
            {op.reduce, ann.reduce} <= {"or", "any"}
            or op.reduce in ("gather", "scan")
        ):
            findings.append(Finding(
                rule="S001", severity=Severity.ERROR, path=op.rel,
                line=op.line, col=op.col,
                message=(
                    f"collective `{ann.name}` annotated reduce="
                    f"{ann.reduce} but the op the analysis sees is a "
                    f"{op.reduce} — annotation drift"
                ),
            ))
        if op.region not in entry.placement:
            findings.append(Finding(
                rule="S004", severity=Severity.WARNING, path=op.rel,
                line=op.line, col=op.col,
                message=(
                    f"collective `{ann.name}` fires in the `{op.region}` "
                    f"region but the registry allows "
                    f"{'/'.join(entry.placement)} — a collective drifting "
                    f"into a tighter loop is a silent scaling regression "
                    f"[chain: {_chain(op.chain)}]"
                ),
            ))

    # S001: stale registry entries (plan rows nothing implements)
    if audit_registry:
        for name in sorted(set(collectives) - seen_names):
            findings.append(Finding(
                rule="S001", severity=Severity.ERROR,
                path="madsim_tpu_torch/analysis/srules.py", line=0, col=0,
                message=(
                    f"registry entry `{name}` is referenced by no "
                    f"collective annotation the analysis reaches — a "
                    f"stale collective plan row; delete it or fix the "
                    f"annotation"
                ),
            ))
        # dead annotations: a collective(...) comment the analysis never
        # consumed claims a cross-lane op that does not exist (or moved)
        for mod in sorted(engine.walked_modules):
            mi = model.modules.get(mod)
            if mi is None:
                continue
            for ann in engine.annotations_of(mi).all:
                if (mi.rel, ann.lineno) not in engine.consumed_annotations:
                    findings.append(Finding(
                        rule="S001", severity=Severity.WARNING,
                        path=mi.rel, line=ann.lineno, col=0,
                        message=(
                            f"collective annotation `{ann.name}` is not "
                            f"anchored to any cross-lane op the analysis "
                            f"sees — dead annotation (the op moved, or "
                            f"the line placement is wrong)"
                        ),
                    ))

    # S002: rebuild sites — a LANE value into a global-declared leaf
    for rb in engine.rebuilds:
        table = carry_axes.get(rb.cls)
        if table is None:
            continue  # replace() on an unresolved receiver: skip
        declared = table.get(rb.field)
        if declared is None:
            findings.append(Finding(
                rule="S002", severity=Severity.ERROR, path=rb.rel,
                line=rb.line, col=rb.col,
                message=(
                    f"`{rb.cls}.{rb.field}` has no axis declaration in "
                    f"analysis/srules.py CARRY_AXES — every carry leaf "
                    f"must be declared lane-leading or global before "
                    f"the mesh rebuild can shard it "
                    f"[chain: {_chain(rb.chain)}]"
                ),
            ))
        elif declared == "global" and laneish(rb.axis):
            findings.append(Finding(
                rule="S002", severity=Severity.ERROR, path=rb.rel,
                line=rb.line, col=rb.col,
                message=(
                    f"`{rb.cls}.{rb.field}` is declared global "
                    f"(replicated under the mesh) but this rebuild "
                    f"feeds it a lane-axis value — smuggling per-lane "
                    f"state into a replicated leaf is an implicit "
                    f"gather; fold through a registered collective "
                    f"first [chain: {_chain(rb.chain)}]"
                ),
            ))

    # S002: class-def audit — leaves vs the declared table
    for module, cls_name in audited:
        mi = model.modules.get(module)
        if mi is None:
            continue
        cls = mi.classes.get(cls_name)
        if cls is None:
            continue
        table = carry_axes.get(cls_name, {})
        fields = [
            item.target.id
            for item in cls.body
            if isinstance(item, ast.AnnAssign)
            and isinstance(item.target, ast.Name)
        ]
        for field in fields:
            if field not in table:
                findings.append(Finding(
                    rule="S002", severity=Severity.ERROR, path=mi.rel,
                    line=cls.lineno, col=0,
                    message=(
                        f"`{cls_name}.{field}` is a new carry leaf with "
                        f"no axis declaration in analysis/srules.py "
                        f"CARRY_AXES — declare it lane-leading or "
                        f"global (the sharding contract is per-leaf)"
                    ),
                ))
        for field in sorted(set(table) - set(fields)):
            if "." in field and field.split(".", 1)[0] in fields:
                # documented sub-leaf of a dict-typed leaf (e.g.
                # LaneState.cov.buf): the parent leaf exists as an
                # AnnAssign; the inner dict's keys have no class-level
                # declaration to match, so the row is documentation,
                # not a ghost
                continue
            findings.append(Finding(
                rule="S002", severity=Severity.ERROR, path=mi.rel,
                line=cls.lineno, col=0,
                message=(
                    f"CARRY_AXES declares `{cls_name}.{field}` but the "
                    f"class has no such leaf — ghost axis declaration"
                ),
            ))

    # S003: lane-dependent python control flow / iteration
    for sink in engine.host_sinks:
        findings.append(Finding(
            rule="S003", severity=Severity.ERROR, path=sink.rel,
            line=sink.line, col=sink.col,
            message=(
                f"{sink.what} in the step path — under a mesh this "
                f"forces a cross-rank gather to one host per read; "
                f"fold through a registered collective (counters) "
                f"instead [chain: {_chain(sink.chain)}]"
            ),
        ))

    # stable order + dedup: positional for line-anchored findings (the
    # same op reached from several entry contexts reports once — the
    # shortest chain sorts first), message-keyed for repo-level rows
    seen = set()
    out: List[Finding] = []
    for f in sorted(
        findings,
        key=lambda f: (f.path, f.line, f.col, f.rule, len(f.message)),
    ):
        key = (
            (f.rule, f.path, f.line, f.col) if f.line
            else (f.rule, f.path, f.message)
        )
        if key in seen:
            continue
        seen.add(key)
        out.append(f)
    return out
