"""Task spawning API (reference: madsim/src/sim/task/mod.rs public surface).

`spawn` puts a coroutine on the *current node* — the simulated process
whose task is running right now — exactly like the reference's
`task::spawn` spawning onto the current `NodeInfo`.
"""

from __future__ import annotations

import sys
from typing import Any, Coroutine, Optional

from .. import _context
from ..future import yield_now
from .executor import Executor, NodeInfo, TaskEntry, MAIN_NODE_ID
from .join import AbortHandle, JoinHandle

__all__ = [
    "spawn",
    "spawn_blocking",
    "yield_now",
    "JoinHandle",
    "AbortHandle",
    "Builder",
    "TaskLocal",
    "NodeId",
    "current_node_id",
]

NodeId = int


def _caller_location(depth: int = 2):
    """Spawn-site key. A (filename, lineno) tuple, NOT a formatted
    string: spawns are the RPC hot path (handler-per-request), and the
    f-string format was measurable; metrics format it at report time."""
    frame = sys._getframe(depth)
    return (frame.f_code.co_filename, frame.f_lineno)


def spawn(coro: Coroutine, *, name: str = "") -> JoinHandle:
    """Spawn a task onto the current node (reference: task::spawn)."""
    ctx = _context.current()
    node = ctx.current_task.node if ctx.current_task is not None else ctx.executor.main_node
    task = ctx.executor.spawn(coro, node, location=_caller_location(), name=name)
    return JoinHandle(task)


def spawn_blocking(fn, *args: Any) -> JoinHandle:
    """Run a sync function "blocking-style".

    In simulation everything is one thread, so this just runs `fn` inside
    a task (reference: spawn_blocking is spawn in sim mode).
    """

    async def runner():
        return fn(*args)

    ctx = _context.current()
    node = ctx.current_task.node if ctx.current_task is not None else ctx.executor.main_node
    task = ctx.executor.spawn(runner(), node, location=_caller_location(), name="blocking")
    return JoinHandle(task)


def current_node_id() -> NodeId:
    """ID of the node the current task runs on."""
    ctx = _context.current()
    if ctx.current_task is not None:
        return ctx.current_task.node.id
    return ctx.executor.main_node.id


class TaskLocal:
    """Task-local storage (reference: madsim-tokio keeps tokio's
    `task_local!`; here it is provided natively).

        REQUEST_ID = TaskLocal()
        with REQUEST_ID.scope(42):
            ...  # REQUEST_ID.get() == 42 inside this task
    """

    def __init__(self) -> None:
        # weak-keyed by the TaskEntry itself: values cannot bleed into a
        # different Runtime's task that reuses an id, and entries vanish
        # with the task (no leak for tasks still in scope at teardown)
        import weakref

        self._values: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()

    class _Scope:
        def __init__(self, local: "TaskLocal", value: Any):
            self.local = local
            self.value = value
            self.task = None
            self.had_prev = False
            self.prev: Any = None

        def __enter__(self):
            self.task = _context.current_task()
            self.had_prev = self.task in self.local._values
            self.prev = self.local._values.get(self.task)
            self.local._values[self.task] = self.value
            return self.value

        def __exit__(self, *exc):
            if self.had_prev:
                self.local._values[self.task] = self.prev
            else:
                self.local._values.pop(self.task, None)

    def scope(self, value: Any) -> "TaskLocal._Scope":
        return TaskLocal._Scope(self, value)

    def get(self) -> Any:
        task = _context.current_task()
        if task not in self._values:
            raise LookupError("task-local value not set in this task")
        return self._values[task]

    def try_get(self, default: Any = None) -> Any:
        task = _context.current_task()
        return self._values.get(task, default)


class Builder:
    """Named-task builder (reference: sim/task/builder.rs)."""

    def __init__(self) -> None:
        self._name = ""

    def name(self, name: str) -> "Builder":
        self._name = name
        return self

    def spawn(self, coro: Coroutine) -> JoinHandle:
        ctx = _context.current()
        node = ctx.current_task.node if ctx.current_task is not None else ctx.executor.main_node
        task = ctx.executor.spawn(coro, node, location=_caller_location(), name=self._name)
        return JoinHandle(task)
