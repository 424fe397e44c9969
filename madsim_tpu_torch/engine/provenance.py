"""Causal provenance: decoding "why did this seed fail?".

The port of `madsim_tpu/engine/provenance.py`. With
`EngineConfig.provenance` the lane step tags every queued event and
every node with a 32-bit lineage word: bit f marks "the effects of
scheduled fault f are in this value's causal past", bits 30 and 31 the
two unscheduled chaos channels (strict-restart wipes, duplicate
deliveries). Words OR along deliveries, and a failing lane keeps its
violation's word, harvested with the failure ring. This module is the
host half:

  * `fault_schedule(engine, seed)` re-derives the seed's fault schedule
    (kind, virtual time, target) from the same `init_batch` derivation
    the device ran, on the engine's device: the decode table of the
    word's bits;
  * `implicated(engine, seed, word)` names the faults and kinds the word
    convicts, and `kind_counts` their marginals over a hunt's finds;
  * `replay_with_lineage(engine, seed)` replays one seed and rebuilds
    its event-level causality from the queue sequence numbers (each
    step's push watermark says which step enqueued which seq), so
    `past_cone` cuts a trace to the violation's causal past: what
    `render_why` prints and the export's flow arrows draw. The lineage
    needs only the sequence numbers, so it works with the gate off too.

The device word over-approximates the cause set (a fault that touched a
node marks everything the node later influences), never under-
approximates it for effects that flow through state and messages. So
shrink uses attribution only to order its candidates, each still
verified by a replay, and `why` prints the word beside the decoded
faults.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Set, Tuple

from .core import (
    F_CLOG_DIR,
    F_CLOG_GROUP,
    F_CLOG_PAIR,
    F_DELAY_END,
    F_DELAY_SPIKE,
    F_HASYM,
    F_HASYM_HEAL,
    F_LOSS_END,
    F_LOSS_STORM,
    F_UNCLOG_DIR,
    F_UNCLOG_GROUP,
    F_UNCLOG_PAIR,
    FAULT_KIND_NAMES,
    PROV_BIT_AMNESIA,
    PROV_BIT_DUP,
    PROV_FAULT_BITS,
    Engine,
)
from .replay import ReplayResult, TraceEvent, replay

# fault ops that touch both payload endpoints / every node (the host's
# copy of the lane step's touched classes)
_PAIR_OPS = {
    F_CLOG_PAIR, F_UNCLOG_PAIR, F_CLOG_DIR, F_UNCLOG_DIR,
    F_HASYM, F_HASYM_HEAL,
}
_GLOBAL_OPS = {
    F_CLOG_GROUP, F_UNCLOG_GROUP, F_LOSS_STORM, F_LOSS_END,
    F_DELAY_SPIKE, F_DELAY_END,
}

# attribution pseudo-kinds of the unscheduled chaos bits, named like the
# command-line flags that enable them, so an implicated kind set compares
# directly with shrink's minimal `--fault-kinds` / `--strict-restart`
KIND_DUP = "dup"
KIND_AMNESIA = "strict-restart"

_U32 = 0xFFFFFFFF


@dataclasses.dataclass(frozen=True)
class ScheduledFault:
    """One drawn fault of a lane's schedule, decoded to host values."""

    index: int  # schedule position (provenance bit = min(index, 29))
    kind: int  # K_* index
    kind_name: str  # FAULT_KIND_NAMES[kind]
    t_apply_us: int
    t_undo_us: int
    arg1: int  # payload[1] of the apply op (node a / mask lo / rate)
    arg2: int  # payload[2] (node b / mask hi / q10 / damage mask)
    t_heal2_us: Optional[int] = None  # heal-asym second-direction heal time

    @property
    def bit(self) -> int:
        return min(self.index, PROV_FAULT_BITS - 1)

    @property
    def target(self) -> str:
        k = self.kind_name
        if k in ("pair", "heal-asym"):
            return f"nodes {self.arg1}<->{self.arg2}"
        if k == "dir":
            return f"link {self.arg1}->{self.arg2}"
        if k == "group":
            return f"group mask 0x{(self.arg2 << 30) | self.arg1:x}"
        if k == "storm":
            return f"loss {self.arg1}/65536 (all links)"
        if k == "delay":
            return "all links"
        return f"node {self.arg1}"

    def describe(self) -> str:
        extra = ""
        if self.t_heal2_us is not None:
            extra = f", heal2 t={self.t_heal2_us}us"
        return (
            f"fault #{self.index} [bit {self.bit}]: {self.kind_name} on "
            f"{self.target}, apply t={self.t_apply_us}us, "
            f"undo t={self.t_undo_us}us{extra}"
        )


def _sched_fn(engine: Engine):
    """`seeds -> (times [S, F'], payload heads [S, F', 3], valid [S, F'])`
    of the fault slots, run on the engine's device, cached on the machine
    object per (faults, queue, provenance, stream, device), as the
    reference caches its compiled function: shrink and hunts build many
    engines over one machine, and each keeps the first one's."""
    import numpy as np

    cache = engine.machine.__dict__.setdefault("_prov_sched_cache", {})
    cfg = engine.config
    key = (cfg.faults, cfg.queue_capacity, cfg.provenance, cfg.rng_stream, str(engine.device))
    if key not in cache:
        n = engine.machine.NUM_NODES
        lo, hi = n, n + cfg.faults.slots_per_fault * cfg.faults.n_faults

        def sched(seeds):
            s = engine.init_batch(np.asarray(seeds, dtype=np.uint32))
            return tuple(t.cpu().numpy() for t in (
                s.eq_time[:, lo:hi], s.eq_payload[:, lo:hi, :3], s.eq_valid[:, lo:hi]))

        cache[key] = sched
    return cache[key]


def fault_schedules(engine: Engine, seeds) -> List[List[ScheduledFault]]:
    """`fault_schedule` of several seeds, from one `init_batch` of them."""
    fp = engine.config.faults
    seeds = list(seeds)
    if fp.n_faults == 0 or not seeds:
        return [[] for _ in seeds]
    times, pays, valids = _sched_fn(engine)(seeds)
    spf = fp.slots_per_fault
    out = []
    for lane in range(len(seeds)):
        sched = []
        for f in range(fp.n_faults):
            op, a1, a2 = (int(x) for x in pays[lane, spf * f])
            heal2 = None
            if fp.allow_heal_asym and bool(valids[lane, spf * f + 2]):
                heal2 = int(times[lane, spf * f + 2])
            sched.append(ScheduledFault(
                index=f,
                kind=op // 2,
                kind_name=FAULT_KIND_NAMES[op // 2],
                t_apply_us=int(times[lane, spf * f]),
                t_undo_us=int(times[lane, spf * f + 1]),
                arg1=a1,
                arg2=a2,
                t_heal2_us=heal2,
            ))
        out.append(sched)
    return out


def fault_schedule(engine: Engine, seed: int) -> List[ScheduledFault]:
    """The fault schedule lane `seed` ran under: the decode table of its
    provenance bits, read from the fault slots of the same `init_batch`
    derivation the device ran."""
    return fault_schedules(engine, [seed])[0]


@dataclasses.dataclass
class Attribution:
    """A violation provenance word decoded against its fault schedule."""

    word: int
    faults: List[ScheduledFault]  # scheduled faults the word implicates
    kinds: Tuple[str, ...]  # implicated kind names (sorted), with the
    #                         dup / strict-restart pseudo-kinds
    aliased: bool  # more than 30 scheduled faults: bit 29 is shared

    def describe(self) -> List[str]:
        lines = [f.describe() for f in self.faults]
        if (self.word >> PROV_BIT_AMNESIA) & 1:
            lines.append(
                f"crash-with-amnesia wipe in lineage [bit {PROV_BIT_AMNESIA}]"
            )
        if (self.word >> PROV_BIT_DUP) & 1:
            lines.append(
                f"duplicate delivery in lineage [bit {PROV_BIT_DUP}]"
            )
        if self.aliased:
            lines.append(
                f"(schedule has more than {PROV_FAULT_BITS} faults: "
                f"bit {PROV_FAULT_BITS - 1} aliases the tail)"
            )
        return lines


def _attribution(sched: List[ScheduledFault], word: int) -> Attribution:
    word = int(word) & _U32  # an int32 bit pattern reads as its uint32 value
    faults = [f for f in sched if (word >> f.bit) & 1]
    kinds: Set[str] = {f.kind_name for f in faults}
    if (word >> PROV_BIT_AMNESIA) & 1:
        kinds.add(KIND_AMNESIA)
    if (word >> PROV_BIT_DUP) & 1:
        kinds.add(KIND_DUP)
    return Attribution(word=word, faults=faults, kinds=tuple(sorted(kinds)), aliased=len(sched) > PROV_FAULT_BITS)


def implicated(engine: Engine, seed: int, word: int) -> Attribution:
    """Decode a violation provenance word: which scheduled faults (and
    which unscheduled chaos channels) are in the violation's past."""
    return _attribution(fault_schedule(engine, seed), word)


def kind_counts(engine: Engine, prov_by_seed: Dict[int, int]) -> Dict[str, int]:
    """Per-kind fault attribution over a hunt's finds: how many failures
    implicate each chaos kind (a find counts once a kind). The schedules
    of every find come from one `init_batch`."""
    seeds = list(prov_by_seed)
    counts: Dict[str, int] = {}
    for seed, sched in zip(seeds, fault_schedules(engine, seeds)):
        for k in _attribution(sched, prov_by_seed[seed]).kinds:
            counts[k] = counts.get(k, 0) + 1
    return dict(sorted(counts.items()))


# -- event-level lineage (the `why` cone) ------------------------------------


@dataclasses.dataclass
class Lineage:
    """Exact event-level causality of one replayed seed.

    `parents[i]` are trace indices that causally precede trace event i
    by one hop: the step that ENQUEUED it (send -> delivery, arm -> fire,
    schedule -> injection), plus the previous step at each node the event
    touched (program order: the state it read). `seq_pusher` maps queue
    sequence numbers to the trace index that pushed them."""

    trace: List[TraceEvent]
    parents: List[Set[int]]
    seq_pusher: Dict[int, int]
    # per-step next_seq watermarks (after each step): step i pushed the
    # seqs in [watermark[i-1], watermark[i])
    next_seq_after: List[int] = dataclasses.field(default_factory=list)

    def past_cone(self, target: int) -> List[int]:
        """Trace indices in the causal past of trace event `target`
        (inclusive), ascending."""
        seen = {target}
        frontier = [target]
        while frontier:
            nxt = []
            for i in frontier:
                for p in self.parents[i]:
                    if p not in seen:
                        seen.add(p)
                        nxt.append(p)
            frontier = nxt
        return sorted(seen)

    def message_flows(self) -> List[Tuple[int, int]]:
        """(sender trace index, delivery trace index) pairs for every
        delivered message with a known pusher: the export's flow
        arrows."""
        out = []
        for j, ev in enumerate(self.trace):
            if ev.kind == "msg" and ev.seq in self.seq_pusher:
                out.append((self.seq_pusher[ev.seq], j))
        return out


def _touched_nodes(ev: TraceEvent, num_nodes: int) -> List[int]:
    """The nodes an event touches (the lane step's touched mask): its own
    for a handler event; for a fault, every node, both endpoints or its
    target, by op."""
    if ev.kind != "fault":
        return [ev.node]
    op = ev.payload[0]
    if op in _GLOBAL_OPS:
        return list(range(num_nodes))
    if op in _PAIR_OPS:
        return sorted({ev.payload[1], ev.payload[2]})
    return [ev.payload[1]]


def build_lineage(engine: Engine, trace: List[TraceEvent], next_seq_after: List[int]) -> Lineage:
    """Reconstruct event-level causality from a replayed trace plus the
    per-step `next_seq` watermarks (`replay_with_lineage` captures
    them)."""
    n = engine.machine.NUM_NODES
    fp = engine.config.faults
    init_seq = n + fp.slots_per_fault * fp.n_faults
    horizon = engine.config.horizon_us
    seq_pusher: Dict[int, int] = {}
    prev = init_seq
    for i, after in enumerate(next_seq_after):
        for q in range(prev, after):
            seq_pusher[q] = i
        prev = after
    parents: List[Set[int]] = []
    last_touch: Dict[int, int] = {}
    for i, ev in enumerate(trace):
        ps: Set[int] = set()
        if ev.seq in seq_pusher and seq_pusher[ev.seq] < i:
            ps.add(seq_pusher[ev.seq])
        touched = _touched_nodes(ev, n)
        for node in touched:
            if node in last_touch:
                ps.add(last_touch[node])
        parents.append(ps)
        if ev.time_us < horizon:  # horizon-hit pops are never processed
            for node in touched:
                last_touch[node] = i
    return Lineage(trace=trace, parents=parents, seq_pusher=seq_pusher, next_seq_after=list(next_seq_after))


def replay_with_lineage(engine: Engine, seed: int, max_steps: int = 10_000) -> Tuple[ReplayResult, Lineage]:
    """Traced replay of one seed (on the engine's device) plus its exact
    lineage: the watermark is read after every popped event through
    `replay`'s `on_step` hook. With the gate on, every TraceEvent also
    carries its provenance word and the final state `fail_prov`."""
    marks: List[int] = []

    def hook(_ev, state) -> None:
        marks.append(int(state.next_seq))

    rp = replay(engine, seed, max_steps=max_steps, on_step=hook)
    return rp, build_lineage(engine, rp.trace, marks)


def render_why(
    engine: Engine,
    seed: int,
    rp: ReplayResult,
    lineage: Lineage,
    cone: List[int],
    attribution: Attribution,
    max_events: int = 0,
) -> str:
    """The `why <seed>` text report: the verdict line, the decoded
    implicated faults, then the violation's past cone as an annotated
    event list (implicated-fault injections flagged, message hops
    shown)."""
    lines = [
        f"seed {seed} fails with code {rp.fail_code} at "
        f"t={int(rp.state.now_us)}us after {len(lineage.trace)} events",
        f"violation provenance word: 0x{attribution.word:08x}",
        "implicated faults:",
    ]
    lines += ["  " + d for d in attribution.describe()] or [
        "  none (violation is fault-free)"
    ]
    lines.append("implicated kinds: " + (",".join(attribution.kinds) or "none"))
    shown = cone if not max_events else cone[-max_events:]
    lines.append(
        f"causal past cone: {len(cone)} of {len(lineage.trace)} events"
        + (f" (last {len(shown)} shown)" if len(shown) < len(cone) else "")
    )
    implicated_steps = {
        lineage.trace[i].step
        for i in cone
        if lineage.trace[i].kind == "fault"
    }
    for i in shown:
        ev = lineage.trace[i]
        mark = "!" if ev.step in implicated_steps else " "
        hop = ""
        if ev.kind == "msg" and ev.seq in lineage.seq_pusher:
            hop = f"  <= #{lineage.trace[lineage.seq_pusher[ev.seq]].step}"
        lines.append(f" {mark} {ev!r}{hop}")
    return "\n".join(lines)
