"""select — race multiple futures, first ready wins.

The reference keeps real tokio's `select!` (deterministic given the
deterministic scheduler; madsim-tokio/src/lib.rs keeps tokio `select`).
Python has no macro, so `select` takes pollables/coroutines and returns
(index, value); coroutines are spawned as tasks and losers are aborted —
the same cancel-on-loss semantics as `select!` dropping futures.
"""

from __future__ import annotations

import inspect
from typing import Any, Tuple

from .future import PENDING, Pollable, Ready, await_


class _Race(Pollable):
    __slots__ = ("pollables",)

    def __init__(self, pollables):
        self.pollables = pollables

    def poll(self, waker):
        for i, p in enumerate(self.pollables):
            r = p.poll(waker)
            if r is not PENDING:
                return Ready((i, r.value))
        return PENDING

    def drop(self) -> None:
        for p in self.pollables:
            p.drop()


async def select(*futures: Any) -> Tuple[int, Any]:
    """Await the first of `futures` (pollables or coroutines) to finish.

    Returns (winner_index, value). Losing coroutine-tasks are aborted.
    """
    from .task import spawn

    pollables = []
    spawned = []
    for f in futures:
        if isinstance(f, Pollable):
            pollables.append(f)
        elif inspect.iscoroutine(f):
            h = spawn(f)
            spawned.append(h)
            pollables.append(h)
        else:
            raise TypeError(f"select: cannot race {type(f).__name__}")
    try:
        idx, value = await await_(_Race(pollables))
    finally:
        for h in spawned:
            if not h.is_finished():
                h.abort()
    return idx, value
