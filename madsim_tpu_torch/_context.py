"""Thread-local simulation context.

Reference parity: madsim/src/sim/runtime/context.rs — a TLS slot holding
the current runtime `Handle` plus the currently-polled task. One OS
thread hosts at most one simulation at a time; the multi-seed harness
(`runtime.builder`) runs each seed's runtime on its own thread, exactly
like the reference (madsim/src/sim/runtime/builder.rs:121-160).
"""

from __future__ import annotations

import threading
from typing import TYPE_CHECKING, Optional

if TYPE_CHECKING:
    from .rand import GlobalRng
    from .task.executor import Executor, TaskEntry
    from .time import TimeHandle

_tls = threading.local()


class SimContext:
    """Everything the currently-running simulation exposes via TLS."""

    def __init__(self, executor: "Executor"):
        self.executor = executor
        self.current_task: Optional["TaskEntry"] = None


def enter(ctx: SimContext) -> None:
    if getattr(_tls, "ctx", None) is not None:
        raise RuntimeError("a simulation is already running on this thread")
    _tls.ctx = ctx


def exit() -> None:
    _tls.ctx = None


def try_current() -> Optional[SimContext]:
    return getattr(_tls, "ctx", None)


def _not_in_sim() -> RuntimeError:
    return RuntimeError(
        "this API must be called from within a madsim_tpu simulation "
        "(inside `Runtime().block_on(...)`)"
    )


def current() -> SimContext:
    ctx = getattr(_tls, "ctx", None)
    if ctx is None:
        raise _not_in_sim()
    return ctx


def current_rng() -> "GlobalRng":
    ctx = getattr(_tls, "ctx", None)
    if ctx is None:
        raise _not_in_sim()
    return ctx.executor.rng


def current_time() -> "TimeHandle":
    ctx = getattr(_tls, "ctx", None)
    if ctx is None:
        raise _not_in_sim()
    return ctx.executor.time


def try_time_ns() -> Optional[int]:
    ctx = getattr(_tls, "ctx", None)
    if ctx is None:
        return None
    return ctx.executor.time.now_ns()


def current_task() -> "TaskEntry":
    ctx = getattr(_tls, "ctx", None)
    if ctx is None:
        raise _not_in_sim()
    task = ctx.current_task
    if task is None:
        raise RuntimeError("this API must be called from within a spawned task")
    return task
