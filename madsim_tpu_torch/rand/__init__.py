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
        from .. import _native

        # Native draw stream (hostcore.Rng) — the SAME stream object the
        # native executor loop draws from, so scheduling draws and user
        # draws interleave identically to the pure-Python loop.
        self._core = (
            _native.make_rng(self._key[0], self._key[1])
            if _native.available()
            else None
        )
        self._native_obs = False

    # -- core draws ---------------------------------------------------------

    @property
    def recording(self) -> bool:
        """True while the determinism log/check observes every draw.

        With a native core, observation happens INSIDE the core
        (hostcore `rng_observe`): the executor keeps using the native drive loop and the loop's
        own scheduling draws are hashed too — check mode validates the
        loop that actually ran. Without the core, the executor routes
        through its Python loop so `_record` sees every draw."""
        return self._log is not None or self._check is not None or self._native_obs

    @property
    def native_observing(self) -> bool:
        """Observation handled by the native core (executor may stay on
        the native drive loop)."""
        return self._native_obs

    def _refill(self) -> None:
        """Refill the pure-Python word buffer (native builds draw from
        `_core` instead; the word *sequence* is identical either way)."""
        c = self._counter
        self._buf = list(
            philox4x32(self._key, (c & 0xFFFFFFFF, (c >> 32) & 0xFFFFFFFF, 0, 0))
        )
        self._counter += 1
        self._buf_pos = 0

    def next_u32(self) -> int:
        core = self._core
        if core is not None:
            v = core.next_u32()
        else:
            if self._buf_pos >= len(self._buf):
                self._refill()
            v = self._buf[self._buf_pos]
            self._buf_pos += 1
        if self._log is not None or self._check is not None:
            self._record(v)
        return v

    def next_u64(self) -> int:
        # native fast path: one C call for both words; draw observation
        # (log/check hashing) happens inside the core either way
        core = self._core
        if core is not None:
            return core.next_u64()
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
        if self._core is not None:
            self._core.observe_log()
            self._native_obs = True
            return
        self._log = []
        self._draw_index = 0

    def take_log(self) -> List[int]:
        if self._native_obs:
            self._native_obs = False
            return self._core.take_obs()
        log = self._log or []
        self._log = None
        return log

    def enable_check(self, log: List[int]) -> None:
        if self._core is not None:
            self._core.observe_check(log)
            self._native_obs = True
            return
        self._check = log
        self._check_pos = 0
        self._draw_index = 0

    def raise_native_mismatch(self) -> None:
        """Raise for a divergence the native core recorded (executor
        drive code 4, or finish_check below)."""
        _mode, _draws, _pos, _expected, mm_idx, mm_t = self._core.obs_status()
        raise NonDeterminism(
            f"non-determinism detected at draw #{mm_idx}, sim time {mm_t} ns: "
            f"the same seed produced a different randomness sequence. Check "
            f"for use of outside RNGs, wall clocks, real threads, or "
            f"iteration over unordered sets."
        )

    def finish_check(self) -> None:
        """Assert the checked run consumed the WHOLE draw log — a run that
        diverges by drawing fewer values is also non-deterministic."""
        if self._native_obs:
            _mode, draws, pos, expected, mm_idx, _t = self._core.obs_status()
            self._native_obs = False
            self._core.observe_off()
            if mm_idx >= 0:
                self.raise_native_mismatch()
            if pos != expected:
                raise NonDeterminism(
                    f"non-determinism detected: second run made {pos} "
                    f"RNG draws but the first made {expected}"
                )
            return
        if self._check is not None and self._check_pos != len(self._check):
            raise NonDeterminism(
                f"non-determinism detected: second run made {self._check_pos} "
                f"RNG draws but the first made {len(self._check)}"
            )

    # -- user-facing draws --------------------------------------------------

    def random(self) -> float:
        """Uniform float64 in [0, 1) with 53 bits, identical across engines."""
        core = self._core
        if core is not None:
            return core.random()  # same (u64 >> 11) * 2^-53, one C call
        return (self.next_u64() >> 11) * (2.0**-53)

    def gen_range(self, low: int, high: int) -> int:
        """Uniform integer in [low, high). Deterministic (64-bit modulo).

        Bias for spans far below 2^64 is negligible and, crucially,
        reproducible on both engines.
        """
        if high <= low:
            raise ValueError(f"empty range [{low}, {high})")
        span = high - low
        core = self._core
        # fast path only within int64 bounds AND span: the C parser is
        # int64 and signed high-low must not overflow — out-of-range
        # bounds take the bignum path (identical draw sequence: it pulls
        # next_u64 from the same core stream)
        if (
            core is not None
            and -0x8000000000000000 <= low
            and high <= 0x7FFFFFFFFFFFFFFF
            and span <= 0x7FFFFFFFFFFFFFFF
        ):
            return core.gen_range(low, high)  # same low + u64 % span
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
