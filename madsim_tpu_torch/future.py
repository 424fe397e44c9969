"""Poll-based futures — the bridge between Python coroutines and the executor.

The reference builds on Rust's poll/waker model (`async-task` crate). A
Python coroutine cannot be polled without running it, so this module
defines a small `Pollable` protocol that *primitives* (timers, channels,
join handles, network sockets) implement; arbitrary user coroutines are
driven as tasks and composed via `JoinHandle`, mirroring how Rust user
futures compose over leaf futures.

A suspended `await` point re-polls its pollable on every wake, so
spurious wakeups are harmless (same contract as Rust futures).
Cancellation (node kill / task abort -> `coro.close()`) raises
`GeneratorExit` at the await point; `_Await.__await__` then calls
`pollable.drop()` so registered wakers are deregistered — the Python
equivalent of Rust's `Drop` on a pending future
(reference kill path: madsim/src/sim/task/mod.rs:133-140).
"""

from __future__ import annotations

from typing import Any, Callable, Generator, List, Optional

from . import _context
from .errors import RecvError

__all__ = ["PENDING", "Pollable", "Ready", "await_", "OneShotCell", "yield_now"]

# Native __await__ iterator — resolved lazily on first await so that a
# bare `import madsim_tpu` never triggers the g++ build of hostcore.
_AwaitIter = None
_await_iter_resolved = False


def _resolve_await_iter():
    global _AwaitIter, _await_iter_resolved
    _await_iter_resolved = True
    from . import _native

    mod = _native.get_mod()
    if mod is not None:
        _AwaitIter = mod.AwaitIter
    return _AwaitIter


class _Pending:
    __slots__ = ()

    def __repr__(self) -> str:  # pragma: no cover
        return "PENDING"


PENDING = _Pending()


class Ready:
    __slots__ = ("value",)

    def __init__(self, value: Any = None):
        self.value = value


class Pollable:
    """Protocol: poll(waker) -> Ready(v) | PENDING; drop() deregisters."""

    def poll(self, waker: Callable[[], None]):  # pragma: no cover - interface
        raise NotImplementedError

    def drop(self) -> None:
        pass


class _Await:
    __slots__ = ("pollable",)

    def __init__(self, pollable: Pollable):
        self.pollable = pollable

    def __await__(self) -> Generator[None, None, Any]:
        it = _AwaitIter
        if it is None and not _await_iter_resolved:
            it = _resolve_await_iter()
        if it is not None:
            return it(self.pollable)  # native iterator, same protocol
        return self._await_py()

    def _await_py(self) -> Generator[None, None, Any]:
        p = self.pollable
        try:
            while True:
                task = _context.current_task()
                r = p.poll(task.waker)
                if r is not PENDING:
                    return r.value
                task.pending_on = p
                try:
                    yield
                finally:
                    task.pending_on = None
        finally:
            p.drop()


def await_(pollable: Pollable):
    """Turn a Pollable into an awaitable: ``value = await await_(p)``.

    With the native core, the AwaitIter IS the awaitable (its type has
    am_await = self), skipping the _Await wrapper object per await."""
    it = _AwaitIter
    if it is None and not _await_iter_resolved:
        it = _resolve_await_iter()
    if it is not None:
        return it(pollable)
    return _Await(pollable)


class OneShotCell(Pollable):
    """A set-once cell that wakes registered waiters; building block for
    timers, oneshot channels and join handles."""

    __slots__ = ("_value", "_set", "_closed", "_wakers")

    def __init__(self) -> None:
        self._value: Any = None
        self._set = False
        self._closed = False
        self._wakers: List[Callable[[], None]] = []

    def set(self, value: Any = None) -> bool:
        if self._set or self._closed:
            return False
        self._value = value
        self._set = True
        self._wake_all()
        return True

    def close(self) -> None:
        """Close without a value: waiters see RecvError."""
        if not self._set and not self._closed:
            self._closed = True
            self._wake_all()

    def _wake_all(self) -> None:
        wakers, self._wakers = self._wakers, []
        for w in wakers:
            w()

    def is_set(self) -> bool:
        return self._set

    def peek(self) -> Any:
        return self._value

    def poll(self, waker: Callable[[], None]):
        if self._set:
            return Ready(self._value)
        if self._closed:
            raise RecvError("oneshot closed")
        if waker not in self._wakers:
            self._wakers.append(waker)
        return PENDING

    # Note: no waker cleanup on drop — a stale waker is harmless (the task
    # re-polls and re-parks), whereas removing could drop another waiter's
    # registration. Same policy as naive-timer in the reference.


class _YieldNow(Pollable):
    __slots__ = ("_polled",)

    def __init__(self) -> None:
        self._polled = False

    def poll(self, waker: Callable[[], None]):
        if self._polled:
            return Ready(None)
        self._polled = True
        waker()
        return PENDING


async def yield_now() -> None:
    """Re-enqueue the current task once (reference: tokio `yield_now`)."""
    await await_(_YieldNow())
