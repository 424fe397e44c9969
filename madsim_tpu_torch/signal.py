"""Simulated ctrl-c signal (reference: madsim/src/sim/signal.rs).

Each node has a list of ctrl-c subscribers; `Handle.send_ctrl_c` either
delivers to them or, with no subscriber, kills the node
(reference: sim/task/mod.rs:106-111,:166-175,:426-441).
"""

from __future__ import annotations

from typing import Callable

from . import _context
from .future import OneShotCell, Pollable, await_


class _CtrlCFuture(Pollable):
    """Deregisters its watcher cell when the waiter goes away, so a
    cancelled `ctrl_c()` does not swallow a later signal."""

    __slots__ = ("node", "cell")

    def __init__(self, node, cell: OneShotCell):
        self.node = node
        self.cell = cell

    def poll(self, waker: Callable[[], None]):
        return self.cell.poll(waker)

    def drop(self) -> None:
        try:
            self.node.ctrl_c_watchers.remove(self.cell)
        except ValueError:
            pass


async def ctrl_c() -> None:
    """Complete when ctrl-c is sent to the current node."""
    task = _context.current_task()
    cell = OneShotCell()
    task.node.ctrl_c_watchers.append(cell)
    await await_(_CtrlCFuture(task.node, cell))
