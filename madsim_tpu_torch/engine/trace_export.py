"""Trace export: Perfetto / Chrome trace_event JSON and JSONL.

The port of `madsim_tpu/engine/trace_export.py`. A replayed seed's
trace is a virtual-time timeline: every popped event names the node that
handled it and the virtual microsecond it ran at. The trace_event export
maps it onto the profiler UI's model (one process per seed, one thread
row per node, 1 us slices at virtual timestamps), so `chrome://tracing`
or https://ui.perfetto.dev renders a seed's schedule like a CPU profile.
Send -> delivery pairs given as `flows` become flow arrows bound to the
slices, and fault injections get globally scoped instant markers named
by fault kind. The JSONL export is one JSON object an event, with stable
keys. The files are byte for byte the JAX package's for the same trace.
"""

from __future__ import annotations

import json
from typing import List, Optional, Sequence, Set, Tuple

from ..kinds import FAULT_KIND_NAMES
from .replay import TraceEvent

# payload[0] of a fault event -> human name (apply ops are even, the
# matching undo odd, op = 2*kind: engine/core.py's op numbering)
def _fault_op_name(op: int) -> str:
    kind = op // 2
    name = (
        FAULT_KIND_NAMES[kind] if 0 <= kind < len(FAULT_KIND_NAMES)
        else f"op{op}"
    )
    return f"{name}{'+' if op % 2 == 0 else '-'}"


def trace_event_dict(
    events: List[TraceEvent],
    *,
    machine: str = "machine",
    seed: int = 0,
    num_nodes: Optional[int] = None,
    flows: Optional[Sequence[Tuple[TraceEvent, TraceEvent]]] = None,
    highlight: Optional[Set[int]] = None,
) -> dict:
    """The Chrome trace_event JSON object (a dict) of one replayed seed.
    Timestamps are virtual microseconds (trace_event's own unit, so the
    UI's time axis reads as simulation time).

    `flows` are (send event, delivery event) pairs: each becomes a flow
    arrow from the sender's slice to the delivery's, keyed by the
    delivery's queue seq. `highlight` is a set of step numbers to tag
    with `"cone": true`, filterable in the UI."""
    pid = 0
    out: List[dict] = [
        {
            "ph": "M",
            "pid": pid,
            "name": "process_name",
            "args": {"name": f"{machine} seed {seed}"},
        }
    ]
    nodes = sorted({ev.node for ev in events})
    if num_nodes is not None:
        nodes = sorted(set(nodes) | set(range(num_nodes)))
    for n in nodes:
        out.append(
            {
                "ph": "M",
                "pid": pid,
                "tid": n,
                "name": "thread_name",
                "args": {"name": f"node {n}"},
            }
        )
        # sort_index keeps node rows in id order (tracing UIs otherwise
        # order threads by first event)
        out.append(
            {
                "ph": "M",
                "pid": pid,
                "tid": n,
                "name": "thread_sort_index",
                "args": {"sort_index": n},
            }
        )
    for ev in events:
        name = ev.kind
        if ev.kind == "msg":
            name = f"msg<-{ev.src}"
        elif ev.kind == "fault":
            name = f"fault {_fault_op_name(ev.payload[0])}"
        elif ev.kind == "timer":
            name = f"timer id={ev.payload[0]}"
        args = {
            "step": ev.step,
            "src": ev.src,
            "payload": list(ev.payload),
        }
        if ev.seq >= 0:
            args["seq"] = ev.seq
        if ev.prov:
            args["prov"] = f"0x{ev.prov & 0xFFFFFFFF:08x}"
        if highlight is not None and ev.step in highlight:
            args["cone"] = True
        out.append(
            {
                "ph": "X",  # 1µs slice: flows can bind, instants cannot
                "dur": 1,
                "pid": pid,
                "tid": ev.node,
                "ts": ev.time_us,
                "name": name,
                "args": args,
            }
        )
        if ev.kind == "fault":
            # globally-scoped instant: fault injections draw a full-
            # height marker so chaos windows are visible at any zoom
            out.append(
                {
                    "ph": "i",
                    "s": "g",
                    "pid": pid,
                    "tid": ev.node,
                    "ts": ev.time_us,
                    "name": f"inject {_fault_op_name(ev.payload[0])}",
                    "args": {"step": ev.step},
                }
            )
    for send, recv in flows or ():
        fid = recv.seq if recv.seq >= 0 else (send.step << 16) | recv.step
        common = {"pid": pid, "cat": "msg", "name": "send", "id": fid}
        out.append(
            {"ph": "s", "tid": send.node, "ts": send.time_us, **common}
        )
        out.append(
            {"ph": "f", "bp": "e", "tid": recv.node, "ts": recv.time_us, **common}
        )
    return {"traceEvents": out, "displayTimeUnit": "ms"}


def write_perfetto(
    path: str,
    events: List[TraceEvent],
    *,
    machine: str = "machine",
    seed: int = 0,
    num_nodes: Optional[int] = None,
    flows: Optional[Sequence[Tuple[TraceEvent, TraceEvent]]] = None,
    highlight: Optional[Set[int]] = None,
) -> int:
    """Write the Perfetto/Chrome trace_event JSON file. Returns the
    number of trace events written (excluding metadata records)."""
    doc = trace_event_dict(
        events, machine=machine, seed=seed, num_nodes=num_nodes,
        flows=flows, highlight=highlight,
    )
    with open(path, "w") as f:
        json.dump(doc, f)
        f.write("\n")
    return len(events)


def write_jsonl(
    path: str,
    events: List[TraceEvent],
    *,
    machine: str = "machine",
    seed: int = 0,
) -> int:
    """Write one JSON object per trace event: {"machine", "seed",
    "step", "t_us", "kind", "node", "src", "payload"} plus "seq" (and
    "prov" when an event carries a provenance word). Returns the number
    of lines written."""
    with open(path, "w") as f:
        for ev in events:
            row = {
                "machine": machine,
                "seed": seed,
                "step": ev.step,
                "t_us": ev.time_us,
                "kind": ev.kind,
                "node": ev.node,
                "src": ev.src,
                "payload": list(ev.payload),
            }
            if ev.seq >= 0:
                row["seq"] = ev.seq
            if ev.prov:
                row["prov"] = ev.prov & 0xFFFFFFFF
            f.write(json.dumps(row))
            f.write("\n")
    return len(events)
