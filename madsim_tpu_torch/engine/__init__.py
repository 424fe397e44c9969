"""The port's batched engine: `Engine`, its configs and the Machine contract."""

from .core import BatchResult, Engine, EngineConfig, FaultPlan, LaneState, StreamCarry
from .machine import BOOT, Machine, Outbox

__all__ = [
    "BOOT", "BatchResult", "Engine", "EngineConfig", "FaultPlan", "LaneState",
    "Machine", "Outbox", "StreamCarry",
]
