"""Batched event-queue primitives: the hot ops of the engine, over
`[L, Q]` lane-by-slot planes.

Each lane keeps a fixed-capacity unsorted slot array; the pop is a
lexicographic (time, seq) argmin over its valid slots with a FIFO
tie-break on insertion seq. Times and seqs must be < 2**31-1:
`INT32_MAX` is the masking sentinel.
"""

from __future__ import annotations

from typing import Tuple

import torch

INT32_MAX = 2**31 - 1


def pop_earliest(eq_time, eq_seq, eq_valid) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per lane, the index of the earliest (time, seq) valid slot and
    whether any slot is valid. An all-invalid lane gives index 0."""
    t_masked = torch.where(eq_valid, eq_time, INT32_MAX)
    tmin = t_masked.amin(dim=1, keepdim=True)
    tie = eq_valid & (eq_time == tmin)
    s_masked = torch.where(tie, eq_seq, INT32_MAX)
    return s_masked.argmin(dim=1), eq_valid.any(dim=1)


def find_free_slot(eq_valid) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per lane, the first free slot index and whether one exists."""
    free = ~eq_valid
    return free.to(torch.uint8).argmax(dim=1), free.any(dim=1)
