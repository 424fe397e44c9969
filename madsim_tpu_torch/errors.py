"""Error types of the simulation framework.

Reference parity: madsim panics (Rust) become typed exceptions here —
e.g. the executor's "all tasks will block forever" panic
(reference: madsim/src/sim/task/mod.rs:250) is `Deadlock`, the
determinism checker's "non-determinism detected" panic
(reference: madsim/src/sim/rand.rs:65-90) is `NonDeterminism`.
"""

from __future__ import annotations


class SimError(Exception):
    """Base class for all framework errors."""


class Deadlock(SimError):
    """No runnable task and no pending timer while the main future is alive.

    Reference: madsim/src/sim/task/mod.rs:250 "all tasks will block forever".
    """


class TimeLimitExceeded(SimError):
    """Virtual time passed the limit set by `Runtime.set_time_limit`.

    Reference: madsim/src/sim/runtime/mod.rs:148 + builder time_limit.
    """


class NonDeterminism(SimError):
    """The RNG draw log diverged between two runs of the same seed.

    Reference: madsim/src/sim/rand.rs:65-90 ("non-determinism detected").
    """


class JoinError(SimError):
    """Awaiting a JoinHandle of a task that was cancelled or panicked.

    Reference: madsim/src/sim/task/join.rs.
    """

    def __init__(self, message: str, *, cancelled: bool = False, cause: BaseException | None = None):
        super().__init__(message)
        self.cancelled = cancelled
        self.cause = cause

    def is_cancelled(self) -> bool:
        return self.cancelled

    def is_panic(self) -> bool:
        return not self.cancelled


class SendError(SimError):
    """Channel send on a closed channel."""


class RecvError(SimError):
    """Channel receive on a closed-and-drained channel."""


class TryRecvError(SimError):
    """Non-blocking receive found no message."""

    def __init__(self, message: str = "empty", *, disconnected: bool = False):
        super().__init__(message)
        self.disconnected = disconnected
