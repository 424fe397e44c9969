"""uint32 word arithmetic on int64 tensors.

PyTorch's `uint32` has almost no arithmetic (`>>`, `+`, `%`, `<` and
`min` raise), and `>>` on int32 is arithmetic. So the plain code carries
every 32-bit word as an int64 holding its unsigned value in
[0, 2**32), and masks after each operation that can leave that range.
Products are split so that no intermediate exceeds 2**63: signed
overflow is never relied on.

On the device, words live as int32 bit patterns (`to_i32` / `from_i32`
convert), the dtype rule `interop.py` states.
"""

from __future__ import annotations

import torch

MASK = 0xFFFFFFFF


def from_i32(x: torch.Tensor) -> torch.Tensor:
    """int32 bit pattern (or any int tensor) -> its uint32 value in int64."""
    return x.to(torch.int64) & MASK


def to_i32(x: torch.Tensor) -> torch.Tensor:
    """uint32 value held in int64 -> the int32 with the same bits."""
    x = x & MASK
    return torch.where(x >= 2**31, x - 2**32, x).to(torch.int32)


def mul(a: torch.Tensor, b) -> torch.Tensor:
    """(a * b) mod 2**32 for a, b in [0, 2**32): the product is taken as
    a * b_lo + ((a * b_hi) mod 2**16) << 16 with 16-bit halves of b, so
    every intermediate stays below 2**49."""
    lo = a * (b & 0xFFFF)
    hi = ((a * (b >> 16)) & 0xFFFF) << 16
    return (lo + hi) & MASK


def rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) & MASK) | (x >> (32 - r))


def popcount(x: torch.Tensor) -> torch.Tensor:
    """Number of set bits of each 32-bit word (any int dtype), as int32."""
    bits = torch.arange(32, device=x.device, dtype=torch.int64)
    return ((x.to(torch.int64)[..., None] >> bits) & 1).sum(-1).to(torch.int32)
