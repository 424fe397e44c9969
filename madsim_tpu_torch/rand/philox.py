"""Philox4x32-10 counter-based RNG — the shared determinism substrate.

The reference uses a *stateful* Xoshiro256++ behind a mutex
(reference: madsim/src/sim/rand.rs:28 `GlobalRng`). A mutated-state RNG
cannot be replayed lane-parallel on TPU, so this framework uses a
*counter-based* generator instead: draw ``i`` of seed ``s`` is the pure
function ``philox4x32(key=s, counter=i)``, evaluated here in pure
Python ints: the same words as the reference package's host engine.

Philox4x32-10 constants per Salmon et al., "Parallel random numbers: as
easy as 1, 2, 3" (SC'11).
"""

from __future__ import annotations

from typing import Tuple

PHILOX_M0 = 0xD2511F53
PHILOX_M1 = 0xCD9E8D57
PHILOX_W0 = 0x9E3779B9
PHILOX_W1 = 0xBB67AE85
_M32 = 0xFFFFFFFF
ROUNDS = 10


def philox4x32(key: Tuple[int, int], ctr: Tuple[int, int, int, int]) -> Tuple[int, int, int, int]:
    """One Philox4x32-10 block: (k0,k1) x (c0..c3) -> 4 uint32 words.

    Pure-Python implementation, word for word the reference package's
    (`tests/test_torch_host_vs_jax.py`).
    """
    k0, k1 = key[0] & _M32, key[1] & _M32
    c0, c1, c2, c3 = (c & _M32 for c in ctr)
    for _ in range(ROUNDS):
        p0 = PHILOX_M0 * c0
        p1 = PHILOX_M1 * c2
        hi0, lo0 = (p0 >> 32) & _M32, p0 & _M32
        hi1, lo1 = (p1 >> 32) & _M32, p1 & _M32
        c0, c1, c2, c3 = (
            (hi1 ^ c1 ^ k0) & _M32,
            lo1,
            (hi0 ^ c3 ^ k1) & _M32,
            lo0,
        )
        k0 = (k0 + PHILOX_W0) & _M32
        k1 = (k1 + PHILOX_W1) & _M32
    return c0, c1, c2, c3


def splitmix64(x: int) -> int:
    """64-bit mixer used for draw-log hashing and seed derivation.

    Same constants as the public-domain splitmix64; also implemented in
    jax by the TPU engine for on-device draw logging.
    """
    x = (x + 0x9E3779B97F4A7C15) & 0xFFFFFFFFFFFFFFFF
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & 0xFFFFFFFFFFFFFFFF
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & 0xFFFFFFFFFFFFFFFF
    return x ^ (x >> 31)
