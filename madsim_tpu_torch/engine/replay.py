"""Single-lane replay of one seed, event by event: the debugger path.

The port of `madsim_tpu/engine/replay.py`. A hunt explores thousands of
seeds in lanes; a failing seed is re-run here as one lane, with a full
event trace the user can print, filter or step through. The replay runs
the same lane step as the batch, on the engine's device (the card
unless the engine was built for the CPU), so its outcome is the lane's
outcome bit for bit, on either device and against the JAX package: the
property madsim gets from reproduce-by-seed
(madsim/src/sim/runtime/mod.rs:205-210).

Each traced event's slot comes from the pop kernel
(`ops.kernels.pop_earliest_batch`); the event and the lane's stop
condition cross to the host in one small read a step.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional

import numpy as np
import torch

from ..ops.kernels import pop_earliest_batch
from .core import EV_FAULT, EV_MSG, EV_TIMER, Engine, LaneState

_KIND_NAMES = {EV_TIMER: "timer", EV_MSG: "msg", EV_FAULT: "fault"}

# steps between the host's looks at the lane in a traceless replay
_OUTCOME_CHUNK = 64


@dataclasses.dataclass
class TraceEvent:
    step: int
    time_us: int
    kind: str
    node: int
    src: int
    payload: tuple
    # the event's queue sequence number (unique per lane, assigned at
    # push time)
    seq: int = -1
    # the event's causal-provenance word as a uint32 value
    # (EngineConfig.provenance; 0 with the gate off)
    prov: int = 0

    def __repr__(self) -> str:
        src = f" src={self.src}" if self.kind == "msg" else ""
        return (
            f"[{self.time_us:>10}us] #{self.step:<5} {self.kind:<5} "
            f"node={self.node}{src} payload={list(self.payload)}"
        )


@dataclasses.dataclass
class ReplayResult:
    state: LaneState  # the one lane, every leaf [1, ...]
    trace: List[TraceEvent]

    @property
    def failed(self) -> bool:
        return bool(self.state.failed)

    @property
    def fail_code(self) -> int:
        return int(self.state.fail_code)

    @property
    def fail_prov(self) -> int:
        """The violation's provenance word as a uint32 value (the state
        holds it as an int32 bit pattern); 0 with the gate off."""
        return int(self.state.fail_prov.sum()) & 0xFFFFFFFF


def replay_diff(
    engine: Engine,
    seed_a: int,
    seed_b: int,
    max_steps: int = 10_000,
    context: int = 3,
) -> Optional[int]:
    """Replay two seeds and report the first step where their event
    streams diverge (printing `context` events around it). Returns the
    diverging step index, or None if the shorter trace is a prefix of
    the longer."""
    ra = replay(engine, seed_a, max_steps=max_steps)
    rb = replay(engine, seed_b, max_steps=max_steps)

    def key(ev: TraceEvent):
        return (ev.time_us, ev.kind, ev.node, ev.src, ev.payload)

    for i, (ea, eb) in enumerate(zip(ra.trace, rb.trace)):
        if key(ea) != key(eb):
            lo = max(0, i - context)
            print(f"traces diverge at step {i}:")
            for j in range(lo, min(i + context + 1, min(len(ra.trace), len(rb.trace)))):
                marker = ">>" if j == i else "  "
                print(f"{marker} seed {seed_a}: {ra.trace[j]}")
                print(f"{marker} seed {seed_b}: {rb.trace[j]}")
            return i
    la, lb = len(ra.trace), len(rb.trace)
    if la != lb:
        print(f"trace of seed {seed_a} ({la} events) is a prefix-match of "
              f"seed {seed_b} ({lb} events); no per-event divergence")
    else:
        print(f"seeds {seed_a} and {seed_b} produced identical {la}-event traces")
    return None


def decode_ring(lane_ring) -> List[TraceEvent]:
    """One lane's on-device event ring (`Engine.ring_trace`; leaves [R]
    and payload [R, P]) as TraceEvents, oldest first. Slots with step < 0
    are unused."""
    cols = {k: v.cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v) for k, v in lane_ring.items()}
    step = cols["step"]
    order = np.argsort(step, kind="stable")
    order = order[step[order] >= 0]
    return [
        TraceEvent(step=int(step[i]), time_us=int(cols["time"][i]), kind=_KIND_NAMES.get(int(cols["kind"][i]), "?"),
                   node=int(cols["node"][i]), src=int(cols["src"][i]),
                   payload=tuple(int(x) for x in cols["payload"][i]))
        for i in order
    ]


def _frozen(state: LaneState) -> torch.Tensor:
    return state.done | state.failed


@torch.inference_mode()
def replay_outcome(engine: Engine, seed: int, max_steps: int = 10_000) -> ReplayResult:
    """Traceless replay of one seed: the same final state as `replay`,
    with one host read every few dozen steps instead of one a step. Once
    the lane freezes it passes through untouched, as in the reference's
    single compiled loop, so the stopping step's state is the result."""
    state = engine.init_batch([seed])
    done_steps = 0
    while done_steps < max_steps:
        k = min(_OUTCOME_CHUNK, max_steps - done_steps)
        for _ in range(k):
            # `running`: a frozen lane makes no write at all
            state = engine.step_batch(state, running=~_frozen(state)[0])
        done_steps += k
        if bool(_frozen(state)[0]):
            break
    return ReplayResult(state=state, trace=[])


@torch.inference_mode()
def replay(
    engine: Engine,
    seed: int,
    max_steps: int = 10_000,
    on_step: Optional[Callable[[TraceEvent, LaneState], None]] = None,
    trace: bool = True,
) -> ReplayResult:
    """Replay one seed event by event with a full event trace.

    `on_step(event, state)` is the debugging hook: it runs as plain
    Python after every event. With `trace=False` and no hook the replay
    is `replay_outcome`: the same final state, without the per-event
    reads."""
    if not trace and on_step is None:
        return replay_outcome(engine, seed, max_steps=max_steps)
    state = engine.init_batch([seed])
    events: List[TraceEvent] = []
    prov_on = int(engine.config.provenance)
    for step in range(max_steps):
        idx, any_valid = pop_earliest_batch(state.eq_time, state.eq_seq, state.eq_valid)
        at = idx.to(torch.int64)[:, None]
        planes = (state.eq_time, state.eq_kind, state.eq_node, state.eq_src, state.eq_seq)
        if prov_on:
            planes += (state.eq_prov,)
        fields = [torch.take_along_dim(plane, at, dim=1)[0] for plane in planes]
        payload = torch.take_along_dim(state.eq_payload, at[:, :, None], dim=1)[0, 0]
        # one read a step: the lane's stop flag, whether it pops, the event
        row = torch.cat([_frozen(state).to(torch.int32), any_valid.to(torch.int32), *fields, payload]).tolist()
        if row[0]:
            break
        ev = None
        if row[1]:
            time_us, kind, node, src, seq = row[2:7]
            prov = row[7] & 0xFFFFFFFF if prov_on else 0
            ev = TraceEvent(step=step, time_us=time_us, kind=_KIND_NAMES.get(kind, "?"), node=node,
                            src=src, payload=tuple(row[7 + prov_on:]), seq=seq, prov=prov)
        state = engine.step_batch(state)
        if ev is not None:
            if trace:
                events.append(ev)
            if on_step is not None:
                on_step(ev, state)
    return ReplayResult(state=state, trace=events)
