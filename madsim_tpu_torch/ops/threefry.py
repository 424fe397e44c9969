"""Threefry-2x32 and the three `jax.random` calls the engine makes,
reproduced bit-exactly under the `jax_threefry_partitionable=True`
lowering the stream contract pins (`madsim_tpu/ops/step_rng.py`).

Keys are int64 tensors `[..., 2]` holding uint32 values (see `u32.py`);
everything is batched over leading dimensions.

  * `prng_key(seed)`: a uint32 seed gives the key `[0, seed]`.
  * `split(key, n)`: row i is `threefry2x32(key, (0, i))`.
  * `bits32(key)`: `y0 ^ y1` of `threefry2x32(key, (0, 0))`.
  * `bits(key, n)`: word i is `y0 ^ y1` of `threefry2x32(key, (0, i))`.
"""

from __future__ import annotations

import torch

from .u32 import MASK, rotl

# Rotation schedule and key-schedule parity constant of Random123's
# Threefry-2x32, 20 rounds (the same constants the TPU kernel unrolls).
ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
PARITY = 0x1BD11BDA


def threefry2x32(k0, k1, x0, x1):
    """Threefry-2x32 on broadcastable int64 uint32-valued tensors:
    20 ARX rounds with the key schedule injected every 4."""
    ks = (k0, k1, k0 ^ k1 ^ PARITY)
    x0 = (x0 + ks[0]) & MASK
    x1 = (x1 + ks[1]) & MASK
    for i in range(5):
        for r in ROTATIONS[i % 2]:
            x0 = (x0 + x1) & MASK
            x1 = rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & MASK
    return x0, x1


def prng_key(seed: torch.Tensor) -> torch.Tensor:
    """`jax.random.PRNGKey` of uint32 seeds: [..., 2] = [0, seed]."""
    seed = seed.to(torch.int64) & MASK
    return torch.stack([torch.zeros_like(seed), seed], dim=-1)


def split(key: torch.Tensor, n: int) -> torch.Tensor:
    """`jax.random.split(key, n)`: [..., 2] -> [..., n, 2]."""
    i = torch.arange(n, device=key.device, dtype=torch.int64)
    y0, y1 = threefry2x32(key[..., :1], key[..., 1:], torch.zeros_like(i), i)
    return torch.stack([y0, y1], dim=-1)


def bits32(key: torch.Tensor) -> torch.Tensor:
    """`jax.random.bits(key, (), uint32)`: [..., 2] -> [...]."""
    zero = torch.zeros_like(key[..., 0])
    y0, y1 = threefry2x32(key[..., 0], key[..., 1], zero, zero)
    return y0 ^ y1


def bits(key: torch.Tensor, n: int) -> torch.Tensor:
    """`jax.random.bits(key, (n,), uint32)`: [..., 2] -> [..., n]."""
    i = torch.arange(n, device=key.device, dtype=torch.int64)
    y0, y1 = threefry2x32(key[..., :1], key[..., 1:], torch.zeros_like(i), i)
    return y0 ^ y1
