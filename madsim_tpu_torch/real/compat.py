"""Real-mode equivalents of the sim task/time/rand surfaces used by the
L5 service clients/servers — so `services.etcd/kafka/s3` run unmodified
in `MADSIM_TPU_MODE=real` over asyncio (the reference's real half of the
dual build re-exports tokio + the real client crates; here the same
service code binds to asyncio primitives instead of the simulator's).

Only the APIs the services actually use are provided: spawn/abort,
sleep/timeout/interval/now, and a thread_rng with the GlobalRng draw
surface (non-deterministic by design — this is production mode).
"""

from __future__ import annotations

import asyncio
import random as _pyrandom
# madsim: allow-file(D001) — this module IS the real-mode shim: in
# MADSIM_TPU_MODE=real the OS clock is the contract, not a hazard.
import time as _pytime
from typing import Any, Awaitable, Optional, Union


class task:
    """Namespace mirroring madsim_tpu_torch.task (the parts services use)."""

    class JoinHandle:
        def __init__(self, t: asyncio.Task):
            self._task = t

        def __await__(self):
            return self._task.__await__()

        def abort(self) -> None:
            self._task.cancel()

        def is_finished(self) -> bool:
            return self._task.done()

    @staticmethod
    def spawn(coro: Awaitable[Any], *, name: str = "") -> "task.JoinHandle":
        return task.JoinHandle(asyncio.ensure_future(coro))


class time:
    """Namespace mirroring madsim_tpu_torch.time (the parts services use)."""

    @staticmethod
    async def sleep(duration: Union[int, float]) -> None:
        await asyncio.sleep(duration)

    @staticmethod
    async def timeout(duration: Union[int, float], fut: Awaitable[Any]) -> Any:
        # builtin TimeoutError, same as the sim spelling
        return await asyncio.wait_for(fut, timeout=duration)

    class Interval:
        def __init__(self, period: float):
            self.period = period
            # first tick completes immediately — tokio/sim parity
            # (madsim_tpu_torch.time.interval docstring guarantees it)
            self._next = _pytime.monotonic()

        async def tick(self) -> None:
            delay = self._next - _pytime.monotonic()
            if delay > 0:
                await asyncio.sleep(delay)
            self._next += self.period

    @staticmethod
    def interval(period: Union[int, float]) -> "time.Interval":
        return time.Interval(float(period))

    @staticmethod
    def now() -> float:
        # wall clock, NOT monotonic: services stamp kafka message
        # timestamps / S3 last_modified with this, which must be epoch
        # time comparable across hosts in production mode
        return _pytime.time()

    @staticmethod
    def now_ns() -> int:
        return _pytime.time_ns()

    @staticmethod
    def monotonic() -> float:
        # for elapsed-time measurement (deadlines): immune to NTP steps
        return _pytime.monotonic()


class _RealRng:
    """GlobalRng draw surface over the stdlib RNG (production mode —
    deliberately non-deterministic, like the reference's real half)."""

    def __init__(self, rng: Optional[_pyrandom.Random] = None):
        self._r = rng or _pyrandom.SystemRandom()

    def random(self) -> float:
        return self._r.random()

    def next_u32(self) -> int:
        return self._r.getrandbits(32)

    def next_u64(self) -> int:
        return self._r.getrandbits(64)

    def gen_range(self, low: int, high: int) -> int:
        return self._r.randrange(low, high)

    def gen_bool(self, p: float) -> bool:
        return self._r.random() < p

    def choice(self, seq):
        return self._r.choice(seq)


class rand:
    """Namespace mirroring madsim_tpu_torch.rand."""

    _rng = _RealRng()

    @staticmethod
    def thread_rng() -> _RealRng:
        return rand._rng
