"""Deterministic global RNG — every source of randomness in a simulation.

Reference parity (madsim/src/sim/rand.rs):
  * one global RNG per Runtime seeded from the test seed (:28-62)
  * a determinism *log/check* mode: each draw records a hash of
    (draw value, virtual time); a second run in check mode compares and
    raises on divergence (:65-117, surfaced as `NonDeterminism`)
  * buggify probability draws (:119-135)
  * `thread_rng()` / `random()` user API (rand crate surface)

Architectural difference (TPU-first): the generator is counter-based
Philox (see `philox.py`) rather than shared-mutation Xoshiro, so the
same draw sequence can be produced lane-parallel on device. libc
interposition (reference :197 `getrandom` override) has no Python
equivalent — determinism instead comes from API discipline plus this
draw-log checker, which catches code that consulted an outside RNG and
then influenced the schedule.
"""

from __future__ import annotations

from typing import Iterable, List, MutableSequence, Optional, Sequence, TypeVar

from .. import _context
from ..errors import NonDeterminism
from .philox import philox4x32, splitmix64

T = TypeVar("T")

__all__ = [
    "GlobalRng",
    "thread_rng",
    "random",
    "philox4x32",
    "splitmix64",
]


class GlobalRng:
    """The per-Runtime deterministic RNG (reference: sim/rand.rs:28)."""

    def __init__(self, seed: int):
        self.seed = seed & 0xFFFFFFFFFFFFFFFF
        # Key schedule: mix the seed so nearby seeds give unrelated streams.
        mixed = splitmix64(self.seed)
        self._key = (mixed & 0xFFFFFFFF, (mixed >> 32) & 0xFFFFFFFF)
        self._counter = 0  # next philox block index
        self._buf: List[int] = []  # leftover uint32 words, drained LIFO-stable (pop from end? no: FIFO)
        self._buf_pos = 0
        # determinism log/check (reference: sim/rand.rs:65-117)
        self._log: Optional[List[int]] = None
        self._check: Optional[List[int]] = None
        self._check_pos = 0
        self._draw_index = 0
        # buggify state (reference: sim/buggify.rs + sim/rand.rs:119-135)
        self.buggify_enabled = False
        # The reference's native draw stream (hostcore.Rng) and its
        # in-core draw observation wait for the port of its C++ core
        # (ROADMAP item 15, `_native/`); the word sequence is the same.

    # -- core draws ---------------------------------------------------------

    @property
    def recording(self) -> bool:
        """True while the determinism log/check observes every draw."""
        return self._log is not None or self._check is not None

    def _refill(self) -> None:
        """Refill the word buffer."""
        c = self._counter
        self._buf = list(
            philox4x32(self._key, (c & 0xFFFFFFFF, (c >> 32) & 0xFFFFFFFF, 0, 0))
        )
        self._counter += 1
        self._buf_pos = 0

    def next_u32(self) -> int:
        if self._buf_pos >= len(self._buf):
            self._refill()
        v = self._buf[self._buf_pos]
        self._buf_pos += 1
        if self._log is not None or self._check is not None:
            self._record(v)
        return v

    def next_u64(self) -> int:
        lo = self.next_u32()
        hi = self.next_u32()
        return (hi << 32) | lo

    def _record(self, value: int) -> None:
        """Draw-log hashing (reference: sim/rand.rs:65-90).

        The hash folds in virtual time so a draw happening at a different
        sim-time is also flagged, matching the reference's
        `hash(rng_peek ^ sim_time_nanos)` scheme.
        """
        log = self._log
        check = self._check
        if log is None and check is None:
            return
        t = _context.try_time_ns()
        h = splitmix64((self._draw_index << 32) ^ value ^ (t if t is not None else 0))
        self._draw_index += 1
        if log is not None:
            log.append(h)
        if check is not None:
            if self._check_pos >= len(check) or check[self._check_pos] != h:
                raise NonDeterminism(
                    f"non-determinism detected at draw #{self._draw_index - 1}, "
                    f"sim time {t} ns: the same seed produced a different "
                    f"randomness sequence. Check for use of outside RNGs, wall "
                    f"clocks, real threads, or iteration over unordered sets."
                )
            self._check_pos += 1

    # -- log / check control (reference: sim/rand.rs:103-117) ---------------

    def enable_log(self) -> None:
        self._log = []
        self._draw_index = 0

    def take_log(self) -> List[int]:
        log = self._log or []
        self._log = None
        return log

    def enable_check(self, log: List[int]) -> None:
        self._check = log
        self._check_pos = 0
        self._draw_index = 0

    def finish_check(self) -> None:
        """Assert the checked run consumed the WHOLE draw log — a run that
        diverges by drawing fewer values is also non-deterministic."""
        if self._check is not None and self._check_pos != len(self._check):
            raise NonDeterminism(
                f"non-determinism detected: second run made {self._check_pos} "
                f"RNG draws but the first made {len(self._check)}"
            )

    # -- user-facing draws --------------------------------------------------

    def random(self) -> float:
        """Uniform float64 in [0, 1) with 53 bits, identical across engines."""
        return (self.next_u64() >> 11) * (2.0**-53)

    def gen_range(self, low: int, high: int) -> int:
        """Uniform integer in [low, high). Deterministic (64-bit modulo).

        Bias for spans far below 2^64 is negligible and, crucially,
        reproducible on both engines.
        """
        if high <= low:
            raise ValueError(f"empty range [{low}, {high})")
        span = high - low
        return low + self.next_u64() % span

    def gen_bool(self, p: float) -> bool:
        return self.random() < p

    def gen_bytes(self, n: int) -> bytes:
        out = bytearray()
        while len(out) < n:
            out += self.next_u32().to_bytes(4, "little")
        return bytes(out[:n])

    def shuffle(self, seq: MutableSequence[T]) -> None:
        for i in range(len(seq) - 1, 0, -1):
            j = self.gen_range(0, i + 1)
            seq[i], seq[j] = seq[j], seq[i]

    def choice(self, seq: Sequence[T]) -> T:
        return seq[self.gen_range(0, len(seq))]

    # -- buggify draws (reference: sim/rand.rs:119-135) ---------------------

    def buggify_with_prob(self, p: float) -> bool:
        if not self.buggify_enabled:
            return False
        return self.gen_bool(p)


def thread_rng() -> GlobalRng:
    """The current simulation's RNG (reference: rand crate `thread_rng`).

    Must be called from inside a running simulation.
    """
    return _context.current_rng()


def random() -> float:
    """Uniform float in [0,1) from the simulation RNG."""
    return thread_rng().random()
