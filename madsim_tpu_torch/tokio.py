"""tokio-facade: the ecosystem-API shim layer (reference: madsim-tokio).

The reference republishes tokio's API and swaps in sim implementations
under `cfg(madsim)` (madsim-tokio/src/lib.rs:1-51). The Python analogue:
`import madsim_tpu_torch.tokio as tokio` gives code written against a
tokio-shaped surface the simulated task/time/sync/net/signal modules.

Includes the fake `runtime.Builder`/`Runtime`/`Handle` whose `spawn`
forwards to the current simulation node and whose `block_on` is
unavailable inside a simulation (reference: madsim-tokio/src/sim/
runtime.rs:6-120, block_on `unimplemented!`).
"""

from __future__ import annotations

from typing import Any, Coroutine, List

from . import net, signal, sync, task, time
from .select import select
from .task import JoinHandle, spawn, yield_now

__all__ = [
    "spawn",
    "spawn_blocking",
    "yield_now",
    "select",
    "sleep",
    "timeout",
    "interval",
    "time",
    "sync",
    "net",
    "signal",
    "task",
    "runtime",
    "JoinSet",
]

sleep = time.sleep
timeout = time.timeout
interval = time.interval
spawn_blocking = task.spawn_blocking


class JoinSet:
    """tokio::task::JoinSet subset: spawn many, join as they finish."""

    def __init__(self) -> None:
        self._handles: List[JoinHandle] = []

    def spawn(self, coro: Coroutine) -> None:
        self._handles.append(spawn(coro))

    def len(self) -> int:
        return len(self._handles)

    async def join_next(self) -> Any:
        """Wait for any remaining task (FIFO-poll order, deterministic).

        A task that raised is removed from the set before its exception
        propagates, so the remaining tasks stay joinable."""
        if not self._handles:
            return None
        idx, outcome = await _join_any(self._handles)
        self._handles.pop(idx)
        status, value = outcome
        if status == "err":
            raise value
        return value

    def abort_all(self) -> None:
        for h in self._handles:
            h.abort()
        self._handles.clear()


async def _join_any(handles: List[JoinHandle]):
    """Race join handles, capturing per-handle exceptions with the index."""
    from .future import PENDING, Pollable, Ready, await_

    class _JoinAny(Pollable):
        def poll(self, waker):
            for i, h in enumerate(handles):
                try:
                    r = h.poll(waker)
                except Exception as exc:  # noqa: BLE001 - JoinError/panic path
                    return Ready((i, ("err", exc)))
                if r is not PENDING:
                    return Ready((i, ("ok", r.value)))
            return PENDING

    return await await_(_JoinAny())


class runtime:
    """Fake tokio::runtime (reference: madsim-tokio/src/sim/runtime.rs)."""

    class Handle:
        @staticmethod
        def current() -> "runtime.Handle":
            return runtime.Handle()

        def spawn(self, coro: Coroutine) -> JoinHandle:
            return spawn(coro)

        def block_on(self, coro: Coroutine) -> Any:
            raise NotImplementedError(
                "cannot block_on inside a simulation — spawn or await instead "
                "(reference: madsim-tokio block_on is unimplemented in sim)"
            )

    class Runtime:
        def __init__(self) -> None:
            self._spawned: List[JoinHandle] = []

        def handle(self) -> "runtime.Handle":
            return runtime.Handle()

        def spawn(self, coro: Coroutine) -> JoinHandle:
            h = spawn(coro)
            self._spawned.append(h)
            return h

        def block_on(self, coro: Coroutine) -> Any:
            raise NotImplementedError(
                "cannot block_on inside a simulation — spawn or await instead"
            )

        def shutdown(self) -> None:
            """Abort everything this fake runtime spawned (reference:
            tasks aborted on Runtime drop)."""
            for h in self._spawned:
                h.abort()
            self._spawned.clear()

    class Builder:
        @staticmethod
        def new_multi_thread() -> "runtime.Builder":
            return runtime.Builder()

        @staticmethod
        def new_current_thread() -> "runtime.Builder":
            return runtime.Builder()

        def worker_threads(self, _n: int) -> "runtime.Builder":
            return self

        def enable_all(self) -> "runtime.Builder":
            return self

        def build(self) -> "runtime.Runtime":
            return runtime.Runtime()
