"""The port's batched engine: `Engine`, its configs and the Machine
contract, single-lane replay, and the triage path a found bug takes:
the on-device trace ring (`EngineConfig(trace_ring=R)`,
`Engine.ring_trace`), `shrink`, the corpus (`corpus.add`, `save`) with
its digest trails (`audit.record_entry`, `audit_entry`), the trace
export (`trace_export`), and causal provenance
(`EngineConfig(provenance=True)`, decoded by `provenance`)."""

from . import audit, corpus, provenance, trace_export
from .core import (
    EV_FAULT, EV_MSG, EV_TIMER, FAULT_KIND_NAMES, OVERFLOW, BatchResult, Engine, EngineConfig, FaultPlan, LaneState,
    StreamCarry,
)
from .machine import BOOT, Machine, Outbox, empty_outbox, send, send_if, set_timer, set_timer_if, update_node
from .replay import ReplayResult, TraceEvent, decode_ring, replay, replay_diff
from .shrink import ShrinkResult, shrink

__all__ = [
    "BatchResult", "Engine", "EngineConfig", "FaultPlan", "LaneState", "StreamCarry", "Machine", "Outbox", "BOOT",
    "empty_outbox", "send", "send_if", "set_timer", "set_timer_if", "update_node", "replay", "replay_diff",
    "decode_ring", "shrink", "corpus", "ShrinkResult", "ReplayResult", "TraceEvent", "EV_TIMER", "EV_MSG",
    "EV_FAULT", "FAULT_KIND_NAMES", "OVERFLOW", "audit", "trace_export", "provenance",
]
