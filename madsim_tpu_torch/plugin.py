"""Simulator plugin framework (reference: madsim/src/sim/plugin.rs).

Simulators are type-indexed singletons created per Runtime, with node
lifecycle hooks `create_node` / `reset_node` invoked on node build and
kill/restart (reference: plugin.rs:18-40 + sim/task/mod.rs:368-370).
"""

from __future__ import annotations

from typing import TYPE_CHECKING, Type, TypeVar

from . import _context

if TYPE_CHECKING:
    from .config import Config
    from .rand import GlobalRng
    from .time import TimeHandle

S = TypeVar("S", bound="Simulator")


class Simulator:
    """Base class for pluggable simulators (NetSim, FsSim, user-defined)."""

    def __init__(self, rng: "GlobalRng", time: "TimeHandle", config: "Config"):
        self.rng = rng
        self.time = time
        self.config = config

    def create_node(self, node_id: int) -> None:
        pass

    def reset_node(self, node_id: int) -> None:
        pass


def simulator(cls: Type[S]) -> S:
    """Get the current Runtime's instance of `cls`
    (reference: plugin.rs:45 `simulator::<S>()`)."""
    executor = _context.current().executor
    sims = getattr(executor, "simulators", None)
    if sims is None or cls not in sims:
        raise RuntimeError(f"simulator {cls.__name__} is not registered on this Runtime")
    return sims[cls]
