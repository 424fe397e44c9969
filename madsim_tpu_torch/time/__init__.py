"""Virtual time — event-queue clock, timers, sleep/timeout/interval.

Reference parity (madsim/src/sim/time/):
  * `TimeHandle` over a timer heap; `advance_to_next_event` jumps the
    clock to the nearest timer (mod.rs:45-59)
  * random base wall-time around year 2022 (mod.rs:26-31), so code that
    bakes in "now" assumptions gets fuzzed
  * `Sleep` registers a timer-wake on poll, re-registering on every poll
    like the reference's naive-timer usage (sleep.rs:47-55)
  * tokio-compatible `interval` with `MissedTickBehavior` (interval.rs)
  * `advance()` manual clock jump (mod.rs:185-190)
  * simulated `Instant` / `SystemTime` — the reference does this by libc
    clock interposition (system_time.rs); in Python, user code instead
    imports these types (API discipline, checked by the determinism log).

All arithmetic is integer nanoseconds — a hard requirement for
bit-identical agreement with the TPU engine (no float latency math).
"""

from __future__ import annotations

import heapq
from typing import Any, Awaitable, Callable, List, Optional, Tuple, Union

from .. import _context
from ..errors import SimError
from ..future import PENDING, Pollable, Ready, await_

__all__ = [
    "TimeHandle",
    "Instant",
    "SystemTime",
    "UNIX_EPOCH",
    "sleep",
    "Sleep",
    "sleep_until",
    "timeout",
    "interval",
    "interval_at",
    "Interval",
    "MissedTickBehavior",
    "advance",
    "now",
    "now_ns",
    "monotonic",
    "to_ns",
]

NS = 1
US = 1_000
MS = 1_000_000
SEC = 1_000_000_000

# 2022-01-01T00:00:00Z in ns since unix epoch.
_JAN_2022_NS = 1_640_995_200 * SEC


# Native sleep pollable — resolved lazily on first sleep so that a bare
# `import madsim_tpu` never triggers the g++ build of hostcore.
_SleepGate = None
_sleep_gate_resolved = False


def _resolve_sleep_gate():
    global _SleepGate, _sleep_gate_resolved
    _sleep_gate_resolved = True
    from .. import _native

    mod = _native.get_mod()
    if mod is not None:
        _SleepGate = mod.SleepGate
    return _SleepGate


def to_ns(duration: Union[int, float]) -> int:
    """Convert seconds (int/float) to integer nanoseconds.

    The single place float durations enter; everything downstream is int.
    """
    if isinstance(duration, int):
        return duration * SEC
    return int(round(duration * SEC))


class TimeHandle:
    """The virtual clock + timer heap of one simulation.

    Reference: madsim/src/sim/time/mod.rs `TimeRuntime`/`TimeHandle`.
    """

    def __init__(self, rng) -> None:
        self._now_ns = 0
        self._heap: List[Tuple[int, int, Callable[[], None]]] = []
        self._seq = 0  # FIFO tie-break for equal deadlines (deterministic)
        # Native clock + timer heap (hostcore.TimeCore) when available —
        # the same (deadline, seq) ordering as the heapq fallback, with
        # callbacks held natively (no id->callback dict round trip).
        from .. import _native

        self._core = _native.make_time_core() if _native.available() else None
        # Random base wall clock ~year 2022 + up to one year of offset
        # (reference: sim/time/mod.rs:26-31).
        self.base_system_ns = _JAN_2022_NS + rng.gen_range(0, 365 * 24 * 3600) * SEC

    # -- clock --------------------------------------------------------------

    def now_ns(self) -> int:
        core = self._core
        return core.now_ns() if core is not None else self._now_ns

    def elapsed(self) -> float:
        return self.now_ns() / SEC

    def system_now_ns(self) -> int:
        return self.base_system_ns + self.now_ns()

    def advance_ns(self, delta_ns: int) -> None:
        """Manually jump the clock forward (reference: mod.rs:185-190)."""
        core = self._core
        if core is not None:
            core.advance_ns(delta_ns)
        else:
            self._now_ns += delta_ns

    # -- timers -------------------------------------------------------------

    def add_timer_ns(self, deadline_ns: int, callback: Callable[[], None]) -> None:
        core = self._core
        if core is not None:
            core.push(deadline_ns, callback)
        else:
            self._seq += 1
            heapq.heappush(self._heap, (deadline_ns, self._seq, callback))

    def next_event_ns(self) -> Optional[int]:
        core = self._core
        if core is not None:
            return core.peek()
        return self._heap[0][0] if self._heap else None

    def advance_to_next_event(self) -> bool:
        """Pop the nearest timer, jump the clock to it, fire the callback.

        Returns False when no timer is pending (deadlock, unless the main
        future completed). Reference: sim/time/mod.rs:45-59.
        """
        core = self._core
        if core is not None:
            return core.advance_to_next_event()
        if not self._heap:
            return False
        deadline, _seq, callback = heapq.heappop(self._heap)
        if deadline > self._now_ns:
            self._now_ns = deadline
        callback()
        return True


# -- Instant / SystemTime ---------------------------------------------------


class Instant:
    """Monotonic simulated instant (reference: system_time.rs `Instant`)."""

    __slots__ = ("_ns",)

    def __init__(self, ns: int):
        self._ns = ns

    @staticmethod
    def now() -> "Instant":
        return Instant(_context.current_time().now_ns())

    def elapsed(self) -> float:
        return (_context.current_time().now_ns() - self._ns) / SEC

    def elapsed_ns(self) -> int:
        return _context.current_time().now_ns() - self._ns

    def duration_since(self, earlier: "Instant") -> float:
        return (self._ns - earlier._ns) / SEC

    def __add__(self, secs: Union[int, float]) -> "Instant":
        return Instant(self._ns + to_ns(secs))

    def __sub__(self, other: "Instant") -> float:
        return (self._ns - other._ns) / SEC

    def __eq__(self, other: Any) -> bool:
        return isinstance(other, Instant) and self._ns == other._ns

    def __lt__(self, other: "Instant") -> bool:
        return self._ns < other._ns

    def __le__(self, other: "Instant") -> bool:
        return self._ns <= other._ns

    def __hash__(self) -> int:
        return hash(("Instant", self._ns))

    def __repr__(self) -> str:
        return f"Instant({self._ns}ns)"


class SystemTime:
    """Simulated wall clock (reference: system_time.rs `SystemTime`)."""

    __slots__ = ("_ns",)

    def __init__(self, ns_since_epoch: int):
        self._ns = ns_since_epoch

    @staticmethod
    def now() -> "SystemTime":
        return SystemTime(_context.current_time().system_now_ns())

    def duration_since(self, earlier: "SystemTime") -> float:
        if earlier._ns > self._ns:
            raise SimError("SystemTime earlier than reference point")
        return (self._ns - earlier._ns) / SEC

    def elapsed(self) -> float:
        return SystemTime.now().duration_since(self)

    def ns_since_epoch(self) -> int:
        return self._ns

    def __add__(self, secs: Union[int, float]) -> "SystemTime":
        return SystemTime(self._ns + to_ns(secs))

    def __eq__(self, other: Any) -> bool:
        return isinstance(other, SystemTime) and self._ns == other._ns

    def __lt__(self, other: "SystemTime") -> bool:
        return self._ns < other._ns

    def __hash__(self) -> int:
        return hash(("SystemTime", self._ns))

    def __repr__(self) -> str:
        return f"SystemTime({self._ns}ns)"


UNIX_EPOCH = SystemTime(0)


# -- sleep / timeout --------------------------------------------------------


class SleepFuture(Pollable):
    """Registers a timer-wake on first poll (reference: sleep.rs:47-55).

    One timer per future: re-polls before the deadline (e.g. a race
    partner's wake) don't push duplicate timers — the armed timer fires
    at the deadline regardless (a pollable has a single awaiting task)."""

    __slots__ = ("deadline_ns", "_armed")

    def __init__(self, deadline_ns: int):
        self.deadline_ns = deadline_ns
        self._armed = False

    def poll(self, waker: Callable[[], None]):
        th = _context.current_time()
        if th.now_ns() >= self.deadline_ns:
            return Ready(None)
        if not self._armed:
            self._armed = True
            th.add_timer_ns(self.deadline_ns, waker)
        return PENDING


class Sleep(Pollable):
    """Named, resettable sleep — tokio's `Sleep` handle (reference:
    sim/time/sleep.rs `deadline`/`is_elapsed`/`reset`). Useful for
    event-driven deadline patterns (election timers, idle timeouts)
    that would otherwise be polling loops:

        timer = Sleep.after(0.15)
        ...
        timer.reset_after(0.15)   # heartbeat arrived: push the deadline
        await timer               # fires at the (latest) deadline

    A reset to an *earlier* deadline while a task is parked re-arms
    immediately; a reset to a later one turns the old timer into a
    harmless spurious wake (re-poll re-arms). After firing it can be
    reset and awaited again.
    """

    __slots__ = ("_deadline_ns", "_armed_for", "_waker")

    def __init__(self, deadline_ns: int):
        self._deadline_ns = deadline_ns
        self._armed_for: Optional[int] = None
        self._waker: Optional[Callable[[], None]] = None

    @staticmethod
    def after(duration: Union[int, float]) -> "Sleep":
        th = _context.current_time()
        return Sleep(th.now_ns() + to_ns(duration))

    @staticmethod
    def until(deadline: "Instant") -> "Sleep":
        return Sleep(deadline._ns)

    def deadline(self) -> "Instant":
        return Instant(self._deadline_ns)

    def is_elapsed(self) -> bool:
        return _context.current_time().now_ns() >= self._deadline_ns

    def reset(self, deadline: "Instant") -> None:
        self.reset_ns(deadline._ns)

    def reset_after(self, duration: Union[int, float]) -> None:
        self.reset_ns(_context.current_time().now_ns() + to_ns(duration))

    def reset_ns(self, deadline_ns: int) -> None:
        self._deadline_ns = deadline_ns
        if self._waker is not None and (
            self._armed_for is None or deadline_ns < self._armed_for
        ):
            # a parked task would otherwise sleep to the OLD (later)
            # deadline; arm the earlier one now
            self._armed_for = deadline_ns
            _context.current_time().add_timer_ns(deadline_ns, self._wake)

    def _wake(self) -> None:
        w = self._waker
        if w is not None:
            w()  # re-poll decides readiness; stale timers are spurious wakes

    def poll(self, waker: Callable[[], None]):
        th = _context.current_time()
        if th.now_ns() >= self._deadline_ns:
            self._waker = None
            return Ready(None)
        self._waker = waker
        if self._armed_for != self._deadline_ns:
            self._armed_for = self._deadline_ns
            th.add_timer_ns(self._deadline_ns, self._wake)
        return PENDING

    def drop(self) -> None:
        self._waker = None

    def __await__(self):
        return await_(self).__await__()


def _sleep_pollable(th: "TimeHandle", deadline_ns: int):
    """The sleep pollable: native gate (poll fully in C) when the clock
    core is native, else the Python SleepFuture — same semantics."""
    core = th._core
    if core is not None:
        gate = _SleepGate
        if gate is None and not _sleep_gate_resolved:
            gate = _resolve_sleep_gate()
        if gate is not None:
            return gate(deadline_ns, core)
    return SleepFuture(deadline_ns)


def sleep(duration: Union[int, float]):
    """Sleep for `duration` seconds of virtual time.

    Returns an awaitable directly (not a coroutine): sleeps are the
    single most frequent await in host sims, and skipping the coroutine
    frame per call is measurable. `await sim_time.sleep(x)` is
    unchanged for callers."""
    th = _context.current_time()
    return await_(_sleep_pollable(th, th.now_ns() + to_ns(duration)))


def sleep_ns(duration_ns: int):
    """Sleep for an integer-nanosecond duration (the framework-internal
    form; chaos latencies are always drawn in ns)."""
    th = _context.current_time()
    return await_(_sleep_pollable(th, th.now_ns() + duration_ns))


def sleep_until(deadline: Instant):
    th = _context.current_time()
    return await_(_sleep_pollable(th, deadline._ns))


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


class _InlineFuture(Pollable):
    """Drive an arbitrary awaitable inline within the *current* task.

    This is how the reference's `timeout` works (sim/time/mod.rs:125-140
    `select_biased!` polls the future in place): no helper task, inner
    panics propagate to the caller, and dropping on expiry cancels the
    whole future tree via GeneratorExit. It also removes a task spawn
    from every `call_timeout` — the RPC hot path.
    """

    __slots__ = ("_it", "_step")

    def __init__(self, aw):
        # coroutines drive directly; other awaitables via __await__()
        self._it = aw if hasattr(aw, "send") else aw.__await__()
        # coroutines are not iterators (no __next__) — step via send;
        # plain __await__ iterators (e.g. the native AwaitIter) via next
        send = getattr(self._it, "send", None)
        self._step = (lambda: send(None)) if send is not None else self._it.__next__

    def poll(self, waker):
        # the inner awaitable's own leaf pollables register the current
        # task's waker (re-poll-on-wake contract makes that sound)
        try:
            self._step()
        except StopIteration as e:
            return Ready(e.value)
        return PENDING

    def drop(self) -> None:
        close = getattr(self._it, "close", None)
        if close is not None:
            close()


async def timeout(duration: Union[int, float], fut: Union[Pollable, Awaitable]) -> Any:
    """Await `fut` for at most `duration` virtual seconds.

    Raises built-in `TimeoutError` on expiry (reference `timeout` returns
    `Err(Elapsed)`; sim/time/mod.rs:125-140 `select_biased`). The future
    is polled inline — expiry or surrounding cancellation drops it,
    cascading through nested timeouts (reference/tokio drop semantics).
    """
    th = _context.current_time()
    deadline = _sleep_pollable(th, th.now_ns() + to_ns(duration))
    inner = fut if isinstance(fut, Pollable) else _InlineFuture(fut)
    idx, value = await await_(_Race([inner, deadline]))
    if idx == 0:
        return value
    raise TimeoutError(f"timed out after {duration}s (virtual)")


# -- interval ---------------------------------------------------------------


class MissedTickBehavior:
    """Tokio-compatible (reference: sim/time/interval.rs)."""

    Burst = "burst"
    Delay = "delay"
    Skip = "skip"


class Interval:
    def __init__(self, start_ns: int, period_ns: int):
        if period_ns <= 0:
            raise ValueError("interval period must be > 0")
        self.period_ns = period_ns
        self.missed_tick_behavior = MissedTickBehavior.Burst
        self._deadline_ns = start_ns

    async def tick(self) -> Instant:
        th = _context.current_time()
        await await_(_sleep_pollable(th, self._deadline_ns))
        now = th.now_ns()
        fired = self._deadline_ns
        b = self.missed_tick_behavior
        if b == MissedTickBehavior.Burst:
            self._deadline_ns = fired + self.period_ns
        elif b == MissedTickBehavior.Delay:
            self._deadline_ns = now + self.period_ns
        else:  # Skip: next multiple of period after now
            missed = max(0, (now - fired) // self.period_ns)
            self._deadline_ns = fired + (missed + 1) * self.period_ns
        return Instant(fired)

    def reset(self) -> None:
        th = _context.current_time()
        self._deadline_ns = th.now_ns() + self.period_ns


def interval(period: Union[int, float]) -> Interval:
    """First tick completes immediately (tokio semantics)."""
    th = _context.current_time()
    return Interval(th.now_ns(), to_ns(period))


def interval_at(start: Instant, period: Union[int, float]) -> Interval:
    return Interval(start._ns, to_ns(period))


# -- module-level clock access ----------------------------------------------


def advance(duration: Union[int, float]) -> None:
    """Manually advance virtual time (reference: mod.rs:185-190)."""
    _context.current_time().advance_ns(to_ns(duration))


def now() -> float:
    """Virtual seconds since simulation start."""
    return _context.current_time().elapsed()


def monotonic() -> float:
    """Monotonic seconds for elapsed-time measurement. In the simulator
    the virtual clock is monotonic by construction; the real-mode twin
    maps to time.monotonic() (immune to NTP steps)."""
    return _context.current_time().elapsed()


def now_ns() -> int:
    return _context.current_time().now_ns()
