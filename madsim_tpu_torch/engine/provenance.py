"""Message lineage of a replayed seed: the event-level causality the
trace export draws as flow arrows.

The lineage half of `madsim_tpu/engine/provenance.py`. A replay records,
after every popped event, the lane's `next_seq` watermark: step i pushed
exactly the queue sequence numbers in [watermark[i-1], watermark[i]), so
every later pop of such a seq has step i as its enqueueing parent. With
the previous event at each node an event touched (program order), that
gives `Lineage.parents`, the violation's `past_cone` and the
send -> delivery pairs of `message_flows`. It needs only the sequence
numbers, so it works with the provenance gate off, which is the only
way the port runs: the device-side lineage word and its decoders
(`fault_schedule`, `implicated`, `kind_counts`, `render_why`) are not
ported.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Set, Tuple

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
    Engine,
)
from .replay import ReplayResult, TraceEvent, replay

# fault ops that touch both payload endpoints / every node
_PAIR_OPS = {
    F_CLOG_PAIR, F_UNCLOG_PAIR, F_CLOG_DIR, F_UNCLOG_DIR,
    F_HASYM, F_HASYM_HEAL,
}
_GLOBAL_OPS = {
    F_CLOG_GROUP, F_UNCLOG_GROUP, F_LOSS_STORM, F_LOSS_END,
    F_DELAY_SPIKE, F_DELAY_END,
}


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
    """The nodes an event touches: its own for a handler event; for a
    fault, every node, both endpoints or its target, by op."""
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
    `replay`'s `on_step` hook."""
    marks: List[int] = []

    def hook(_ev, state) -> None:
        marks.append(int(state.next_seq))

    rp = replay(engine, seed, max_steps=max_steps, on_step=hook)
    return rp, build_lineage(engine, rp.trace, marks)
