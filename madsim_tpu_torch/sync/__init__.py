"""Deterministic async synchronization primitives.

The reference keeps *real* tokio `sync` under simulation because tokio's
channels/locks are deterministic given a deterministic single-threaded
scheduler (reference: madsim-tokio/src/lib.rs:1-51). Python has no tokio
to borrow, so this module provides the same surface natively: oneshot,
mpsc (bounded/unbounded), watch, broadcast, Mutex, RwLock, Semaphore,
Notify, Barrier. All wake-ups are FIFO, hence deterministic.
"""

from __future__ import annotations

from collections import deque
from typing import Any, Callable, Deque, Generic, List, Optional, Tuple, TypeVar

from ..errors import RecvError, SendError, TryRecvError
from ..future import PENDING, Pollable, Ready, await_

T = TypeVar("T")

__all__ = [
    "Lagged",
    "oneshot_channel",
    "mpsc_channel",
    "mpsc_unbounded_channel",
    "watch_channel",
    "broadcast_channel",
    "Mutex",
    "RwLock",
    "Semaphore",
    "Notify",
    "Barrier",
]


class _WakerSet:
    """FIFO waker registry (deterministic wake order)."""

    __slots__ = ("_wakers",)

    def __init__(self) -> None:
        self._wakers: Deque[Callable[[], None]] = deque()

    def register(self, waker: Callable[[], None]) -> None:
        if waker not in self._wakers:
            self._wakers.append(waker)

    def remove(self, waker: Callable[[], None]) -> None:
        try:
            self._wakers.remove(waker)
        except ValueError:
            pass

    def wake_one(self) -> None:
        if self._wakers:
            self._wakers.popleft()()

    def wake_all(self) -> None:
        while self._wakers:
            self._wakers.popleft()()


# -- oneshot ----------------------------------------------------------------


class OneshotSender(Generic[T]):
    def __init__(self, shared: dict):
        self._shared = shared

    def send(self, value: T) -> None:
        sh = self._shared
        if sh["done"]:
            raise SendError("oneshot receiver dropped or value already sent")
        sh["value"] = value
        sh["done"] = True
        sh["has_value"] = True
        sh["wakers"].wake_all()

    def close(self) -> None:
        sh = self._shared
        if not sh["done"]:
            sh["done"] = True
            sh["wakers"].wake_all()


class OneshotReceiver(Pollable, Generic[T]):
    def __init__(self, shared: dict):
        self._shared = shared

    def poll(self, waker: Callable[[], None]):
        sh = self._shared
        if sh["has_value"]:
            return Ready(sh["value"])
        if sh["done"]:
            raise RecvError("oneshot sender dropped without sending")
        sh["wakers"].register(waker)
        return PENDING

    def try_recv(self) -> T:
        sh = self._shared
        if sh["has_value"]:
            return sh["value"]
        raise TryRecvError(disconnected=sh["done"])

    def __await__(self):
        return await_(self).__await__()


def oneshot_channel() -> Tuple[OneshotSender, OneshotReceiver]:
    shared = {"value": None, "has_value": False, "done": False, "wakers": _WakerSet()}
    return OneshotSender(shared), OneshotReceiver(shared)


# -- mpsc -------------------------------------------------------------------


class _MpscShared:
    __slots__ = ("buf", "capacity", "closed", "recv_wakers", "send_wakers", "senders")

    def __init__(self, capacity: Optional[int]):
        self.buf: Deque[Any] = deque()
        self.capacity = capacity
        self.closed = False
        self.recv_wakers = _WakerSet()
        self.send_wakers = _WakerSet()
        self.senders = 1


class _RecvFuture(Pollable):
    __slots__ = ("sh",)

    def __init__(self, sh: _MpscShared):
        self.sh = sh

    def poll(self, waker: Callable[[], None]):
        sh = self.sh
        if sh.buf:
            value = sh.buf.popleft()
            sh.send_wakers.wake_all()
            return Ready(value)
        if sh.closed or sh.senders == 0:
            raise RecvError("channel closed")
        sh.recv_wakers.register(waker)
        return PENDING


class _SendFuture(Pollable):
    __slots__ = ("sh", "value")

    def __init__(self, sh: _MpscShared, value: Any):
        self.sh = sh
        self.value = value

    def poll(self, waker: Callable[[], None]):
        sh = self.sh
        if sh.closed:
            raise SendError("channel closed")
        if sh.capacity is None or len(sh.buf) < sh.capacity:
            sh.buf.append(self.value)
            sh.recv_wakers.wake_all()
            return Ready(None)
        sh.send_wakers.register(waker)
        return PENDING


class MpscSender(Generic[T]):
    def __init__(self, sh: _MpscShared):
        self._sh = sh

    async def send(self, value: T) -> None:
        await await_(_SendFuture(self._sh, value))

    def try_send(self, value: T) -> None:
        sh = self._sh
        if sh.closed:
            raise SendError("channel closed")
        if sh.capacity is not None and len(sh.buf) >= sh.capacity:
            raise SendError("channel full")
        sh.buf.append(value)
        sh.recv_wakers.wake_all()

    def clone(self) -> "MpscSender[T]":
        self._sh.senders += 1
        return MpscSender(self._sh)

    def close(self) -> None:
        sh = self._sh
        sh.senders = max(0, sh.senders - 1)
        if sh.senders == 0:
            sh.recv_wakers.wake_all()

    def is_closed(self) -> bool:
        return self._sh.closed


class MpscReceiver(Generic[T]):
    def __init__(self, sh: _MpscShared):
        self._sh = sh

    async def recv(self) -> T:
        """Receive the next value; raises `RecvError` once the channel is
        closed and drained (Rust returns None there)."""
        return await await_(_RecvFuture(self._sh))

    def try_recv(self) -> T:
        sh = self._sh
        if sh.buf:
            value = sh.buf.popleft()
            sh.send_wakers.wake_all()
            return value
        raise TryRecvError(disconnected=sh.closed or sh.senders == 0)

    def close(self) -> None:
        self._sh.closed = True
        self._sh.send_wakers.wake_all()
        self._sh.recv_wakers.wake_all()

    def __len__(self) -> int:
        return len(self._sh.buf)


def mpsc_channel(capacity: int) -> Tuple[MpscSender, MpscReceiver]:
    if capacity <= 0:
        raise ValueError("capacity must be > 0")
    sh = _MpscShared(capacity)
    return MpscSender(sh), MpscReceiver(sh)


def mpsc_unbounded_channel() -> Tuple[MpscSender, MpscReceiver]:
    sh = _MpscShared(None)
    return MpscSender(sh), MpscReceiver(sh)


# -- watch ------------------------------------------------------------------


class _WatchShared:
    __slots__ = ("value", "version", "closed", "wakers")

    def __init__(self, value: Any):
        self.value = value
        self.version = 0
        self.closed = False
        self.wakers = _WakerSet()


class WatchSender(Generic[T]):
    def __init__(self, sh: _WatchShared):
        self._sh = sh

    def send(self, value: T) -> None:
        if self._sh.closed:
            raise SendError("watch closed")
        self._sh.value = value
        self._sh.version += 1
        self._sh.wakers.wake_all()

    def send_modify(self, fn: Callable[[T], T]) -> None:
        self.send(fn(self._sh.value))

    def borrow(self) -> T:
        return self._sh.value

    def close(self) -> None:
        self._sh.closed = True
        self._sh.wakers.wake_all()


class _ChangedFuture(Pollable):
    __slots__ = ("sh", "seen")

    def __init__(self, sh: _WatchShared, seen: int):
        self.sh = sh
        self.seen = seen

    def poll(self, waker: Callable[[], None]):
        if self.sh.version != self.seen:
            return Ready(None)
        if self.sh.closed:
            raise RecvError("watch sender dropped")
        self.sh.wakers.register(waker)
        return PENDING


class WatchReceiver(Generic[T]):
    def __init__(self, sh: _WatchShared):
        self._sh = sh
        self._seen = sh.version

    def borrow(self) -> T:
        return self._sh.value

    def borrow_and_update(self) -> T:
        self._seen = self._sh.version
        return self._sh.value

    def has_changed(self) -> bool:
        return self._seen != self._sh.version

    async def changed(self) -> None:
        await await_(_ChangedFuture(self._sh, self._seen))
        self._seen = self._sh.version

    def clone(self) -> "WatchReceiver[T]":
        rx = WatchReceiver(self._sh)
        rx._seen = self._seen
        return rx


def watch_channel(initial: T) -> Tuple[WatchSender, WatchReceiver]:
    sh = _WatchShared(initial)
    return WatchSender(sh), WatchReceiver(sh)


# -- broadcast --------------------------------------------------------------


class _BroadcastShared:
    __slots__ = ("receivers", "closed")

    def __init__(self) -> None:
        self.receivers: List["BroadcastReceiver"] = []
        self.closed = False


class BroadcastSender(Generic[T]):
    def __init__(self, sh: _BroadcastShared, capacity: int):
        self._sh = sh
        self._capacity = capacity

    def send(self, value: T) -> int:
        n = 0
        for rx in self._sh.receivers:
            if len(rx._buf) >= self._capacity:
                rx._buf.popleft()  # lagging receiver loses oldest (tokio semantics)
                rx._lagged += 1
            rx._buf.append(value)
            rx._wakers.wake_all()
            n += 1
        return n

    def subscribe(self) -> "BroadcastReceiver[T]":
        rx = BroadcastReceiver(self._sh)
        self._sh.receivers.append(rx)
        return rx

    def close(self) -> None:
        self._sh.closed = True
        for rx in self._sh.receivers:
            rx._wakers.wake_all()


class Lagged(RecvError):
    """A slow broadcast receiver lost `skipped` oldest messages
    (tokio `RecvError::Lagged` semantics)."""

    def __init__(self, skipped: int):
        super().__init__(f"lagged: skipped {skipped} messages")
        self.skipped = skipped


class BroadcastReceiver(Pollable, Generic[T]):
    def __init__(self, sh: _BroadcastShared):
        self._sh = sh
        self._buf: Deque[Any] = deque()
        self._lagged = 0
        self._wakers = _WakerSet()

    def poll(self, waker: Callable[[], None]):
        if self._lagged:
            n, self._lagged = self._lagged, 0
            raise Lagged(n)
        if self._buf:
            return Ready(self._buf.popleft())
        if self._sh.closed:
            raise RecvError("broadcast channel closed")
        self._wakers.register(waker)
        return PENDING

    async def recv(self) -> T:
        return await await_(self)

    def close(self) -> None:
        """Unsubscribe: stop receiving (and stop buffering) messages."""
        try:
            self._sh.receivers.remove(self)
        except ValueError:
            pass


def broadcast_channel(capacity: int) -> Tuple[BroadcastSender, BroadcastReceiver]:
    sh = _BroadcastShared()
    tx = BroadcastSender(sh, capacity)
    return tx, tx.subscribe()


# -- locks ------------------------------------------------------------------


class _AcquireFuture(Pollable):
    __slots__ = ("try_acquire", "wakers")

    def __init__(self, try_acquire: Callable[[], bool], wakers: _WakerSet):
        self.try_acquire = try_acquire
        self.wakers = wakers

    def poll(self, waker: Callable[[], None]):
        if self.try_acquire():
            return Ready(None)
        self.wakers.register(waker)
        return PENDING


class MutexGuard:
    def __init__(self, mutex: "Mutex"):
        self._mutex = mutex

    def __enter__(self) -> "MutexGuard":
        return self

    def __exit__(self, *exc: Any) -> None:
        self._mutex.release()


class Mutex(Generic[T]):
    """Deterministic async mutex (FIFO handoff)."""

    def __init__(self, value: T = None):
        self.value = value
        self._locked = False
        self._wakers = _WakerSet()

    async def lock(self) -> MutexGuard:
        def try_acquire() -> bool:
            if not self._locked:
                self._locked = True
                return True
            return False

        await await_(_AcquireFuture(try_acquire, self._wakers))
        return MutexGuard(self)

    def try_lock(self) -> Optional[MutexGuard]:
        if self._locked:
            return None
        self._locked = True
        return MutexGuard(self)

    def release(self) -> None:
        self._locked = False
        self._wakers.wake_all()


class RwLock(Generic[T]):
    def __init__(self, value: T = None):
        self.value = value
        self._readers = 0
        self._writer = False
        self._wakers = _WakerSet()

    async def read(self) -> "RwLockReadGuard":
        def try_acquire() -> bool:
            if not self._writer:
                self._readers += 1
                return True
            return False

        await await_(_AcquireFuture(try_acquire, self._wakers))
        return RwLockReadGuard(self)

    async def write(self) -> "RwLockWriteGuard":
        def try_acquire() -> bool:
            if not self._writer and self._readers == 0:
                self._writer = True
                return True
            return False

        await await_(_AcquireFuture(try_acquire, self._wakers))
        return RwLockWriteGuard(self)

    def _release_read(self) -> None:
        self._readers -= 1
        if self._readers == 0:
            self._wakers.wake_all()

    def _release_write(self) -> None:
        self._writer = False
        self._wakers.wake_all()


class RwLockReadGuard:
    def __init__(self, lock: RwLock):
        self._lock = lock

    def __enter__(self) -> "RwLockReadGuard":
        return self

    def __exit__(self, *exc: Any) -> None:
        self._lock._release_read()


class RwLockWriteGuard:
    def __init__(self, lock: RwLock):
        self._lock = lock

    def __enter__(self) -> "RwLockWriteGuard":
        return self

    def __exit__(self, *exc: Any) -> None:
        self._lock._release_write()


class Semaphore:
    def __init__(self, permits: int):
        self._permits = permits
        self._wakers = _WakerSet()

    @property
    def available_permits(self) -> int:
        return self._permits

    async def acquire(self, n: int = 1) -> "SemaphorePermit":
        def try_acquire() -> bool:
            if self._permits >= n:
                self._permits -= n
                return True
            return False

        await await_(_AcquireFuture(try_acquire, self._wakers))
        return SemaphorePermit(self, n)

    def try_acquire(self, n: int = 1) -> Optional["SemaphorePermit"]:
        if self._permits >= n:
            self._permits -= n
            return SemaphorePermit(self, n)
        return None

    def add_permits(self, n: int) -> None:
        self._permits += n
        self._wakers.wake_all()


class SemaphorePermit:
    def __init__(self, sem: Semaphore, n: int):
        self._sem = sem
        self._n = n
        self._released = False

    def release(self) -> None:
        if not self._released:
            self._released = True
            self._sem.add_permits(self._n)

    def forget(self) -> None:
        self._released = True

    def __enter__(self) -> "SemaphorePermit":
        return self

    def __exit__(self, *exc: Any) -> None:
        self.release()


class Notify(Pollable):
    """tokio::sync::Notify semantics: one stored permit."""

    def __init__(self) -> None:
        self._permit = False
        self._wakers = _WakerSet()

    def notify_one(self) -> None:
        self._permit = True
        self._wakers.wake_all()  # woken tasks re-poll; exactly one consumes the permit

    def notify_waiters(self) -> None:
        self._wakers.wake_all()

    async def notified(self) -> None:
        await await_(_NotifiedFuture(self))


class _NotifiedFuture(Pollable):
    __slots__ = ("notify",)

    def __init__(self, notify: Notify):
        self.notify = notify

    def poll(self, waker: Callable[[], None]):
        if self.notify._permit:
            self.notify._permit = False
            return Ready(None)
        self.notify._wakers.register(waker)
        return PENDING


class Barrier:
    def __init__(self, n: int):
        self._n = n
        self._count = 0
        self._generation = 0
        self._wakers = _WakerSet()

    async def wait(self) -> bool:
        """Returns True for exactly one "leader" waiter per generation."""
        gen = self._generation
        self._count += 1
        if self._count == self._n:
            self._count = 0
            self._generation += 1
            self._wakers.wake_all()
            return True

        def done() -> bool:
            return self._generation != gen

        await await_(_AcquireFuture(done, self._wakers))
        return False
