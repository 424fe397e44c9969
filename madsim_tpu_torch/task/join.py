"""JoinHandle / AbortHandle (reference: madsim/src/sim/task/join.rs)."""

from __future__ import annotations

from typing import Any, Callable

from ..future import PENDING, Pollable, Ready
from .executor import TaskEntry


class AbortHandle:
    """Cancel a task without owning its result (join.rs `AbortHandle`)."""

    def __init__(self, task: TaskEntry):
        self._task = task

    def abort(self) -> None:
        self._task.cancel()

    def is_finished(self) -> bool:
        return self._task.finished


class JoinHandle(Pollable):
    """Awaitable handle to a spawned task (join.rs `JoinHandle`).

    Dropping it detaches the task (tokio semantics). Awaiting returns the
    task's value; a cancelled task raises `JoinError(cancelled)`.
    """

    def __init__(self, task: TaskEntry):
        self._task = task

    @property
    def id(self) -> int:
        return self._task.id

    def abort(self) -> None:
        self._task.cancel()

    def abort_handle(self) -> AbortHandle:
        return AbortHandle(self._task)

    def is_finished(self) -> bool:
        return self._task.finished

    def poll(self, waker: Callable[[], None]):
        r = self._task.cell.poll(waker)
        if r is PENDING:
            return PENDING
        value, exc = r.value
        if exc is not None:
            raise exc
        return Ready(value)

    def drop(self) -> None:
        self._task.cell.drop()

    def __await__(self):
        from ..future import await_

        return await_(self).__await__()
