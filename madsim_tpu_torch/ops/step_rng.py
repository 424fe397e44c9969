"""Per-step RNG word derivation: the versioned stream contract.

The port's copy of `madsim_tpu/ops/step_rng.py`. Two stream versions:

  * v2 (legacy split-chain, the engine's default): the lane key evolves
    by a 3-way split every step and the block is drawn from the step key,

        key, k_step, k_restart = split(rng_key, 3)
        words = bits(k_step, (W2,))      # W2 = H + (4 if delay else 2)*M

  * v3 (counter-based): the lane key is immutable and the step index is
    the counter,

        words(lane_key, step) = threefry2x32(lane_key, step*W + iota(W))

    with jax's packing of an odd-length counter vector (pad one zero,
    split in halves, concatenate the two outputs, trim).

The block layout (`StepRngLayout`) is shared by both versions:

    [ handler H | latency M | drop M? | spike M? | spike_mag M? | restart 2? | dup 2M? | torn 1? ]

v2 always materializes the drop words, even where loss is inert.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from .threefry import bits, split, threefry2x32
from .u32 import MASK

RNG_STREAM_LEGACY = 2
RNG_STREAM_COUNTER = 3
RNG_STREAM_VERSIONS = (RNG_STREAM_LEGACY, RNG_STREAM_COUNTER)


@dataclasses.dataclass(frozen=True)
class StepRngLayout:
    """Static word-block layout for one (config, machine) pair. Offsets
    are None when the section is not materialized in this stream;
    `*_active` are the compute-elision flags."""

    version: int
    handler_words: int
    max_msgs: int
    lat_off: int
    drop_off: Optional[int]
    spike_off: Optional[int]  # gate words; magnitude words follow at +max_msgs
    restart_off: Optional[int]  # v3 only; v2 takes k_restart from the split
    total_words: int
    loss_active: bool
    spike_active: bool
    restart_active: bool
    dup_off: Optional[int] = None
    dup_active: bool = False
    torn_off: Optional[int] = None
    torn_active: bool = False


def layout_for(
    version: int,
    handler_words: int,
    max_msgs: int,
    *,
    loss_possible: bool,
    spike_possible: bool,
    delay_enabled: bool,
    restart_possible: bool,
    dup_possible: bool = False,
    torn_possible: bool = False,
) -> StepRngLayout:
    """Build the block layout (both versions, field for field the
    reference's). `delay_enabled` is the raw `FaultPlan.allow_delay`
    flag; `spike_possible` additionally requires n_faults > 0."""
    h, m = handler_words, max_msgs
    if version == RNG_STREAM_LEGACY:
        legacy_total = h + (4 if delay_enabled else 2) * m
        dup_end = legacy_total + (2 * m if dup_possible else 0)
        return StepRngLayout(
            version=version,
            handler_words=h,
            max_msgs=m,
            lat_off=h,
            drop_off=h + m,
            spike_off=h + 2 * m if delay_enabled else None,
            restart_off=None,
            total_words=dup_end + (1 if torn_possible else 0),
            loss_active=loss_possible,
            spike_active=delay_enabled and spike_possible,
            restart_active=restart_possible,
            dup_off=legacy_total if dup_possible else None,
            dup_active=dup_possible,
            torn_off=dup_end if torn_possible else None,
            torn_active=torn_possible,
        )
    if version != RNG_STREAM_COUNTER:
        raise ValueError(f"unknown rng_stream version {version!r}")
    # the sections in manifest order (ops/rng_layout.manifest), each
    # written as `X_off = cursor; cursor += width`: the lint R-pass
    # reads this walk to audit the ledger, so keep the idiom
    cursor = h + m
    drop_off = None
    if loss_possible:
        drop_off = cursor
        cursor += m
    spike_off = None
    if spike_possible:
        spike_off = cursor
        cursor += 2 * m
    restart_off = None
    if restart_possible:
        restart_off = cursor
        cursor += 2
    dup_off = None
    if dup_possible:
        dup_off = cursor
        cursor += 2 * m
    torn_off = None
    if torn_possible:
        torn_off = cursor
        cursor += 1
    return StepRngLayout(
        version=version,
        handler_words=h,
        max_msgs=m,
        lat_off=h,
        drop_off=drop_off,
        spike_off=spike_off,
        restart_off=restart_off,
        total_words=cursor,
        loss_active=loss_possible,
        spike_active=spike_possible,
        restart_active=restart_possible,
        dup_off=dup_off,
        dup_active=dup_possible,
        torn_off=torn_off,
        torn_active=torn_possible,
    )


def counter_words(key: torch.Tensor, step: torch.Tensor, total_words: int) -> torch.Tensor:
    """The v3 word block: key [L, 2] and step [L] (int64 uint32 values,
    or int32 bit patterns) -> words [L, W] as int64 uint32 values.

    Odd W: jax pads the counter vector with one zero before splitting it
    into the two Threefry inputs, so the pad position's counter is 0,
    not step*W + W."""
    w = total_words
    half = (w + 1) // 2
    key = key.to(torch.int64) & MASK
    base = ((step.to(torch.int64) & MASK) * w)[:, None]
    i0 = torch.arange(half, device=key.device, dtype=torch.int64)
    i1 = i0 + half
    c0 = (base + i0) & MASK
    c1 = torch.where(i1 < w, (base + i1) & MASK, torch.zeros_like(c0))
    y0, y1 = threefry2x32(key[:, :1], key[:, 1:], c0, c1)
    return torch.cat([y0, y1], dim=-1)[:, :w]


def step_words_v3(rng_key: torch.Tensor, step: torch.Tensor, layout: StepRngLayout) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Counter-based step draw, batched over lanes. Returns (new_key,
    words[L, total_words], k_restart[L, 2]); new_key is the unchanged
    lane key, and the restart key, when materialized, is the block's
    restart slice (zeros when restart is statically unreachable)."""
    words = counter_words(rng_key, step, layout.total_words)
    return rng_key, words, restart_key(words, layout)


def restart_key(words: torch.Tensor, layout: StepRngLayout) -> torch.Tensor:
    """The v3 restart key: the block's restart slice [L, 2], or zeros when
    restart is statically unreachable (the key is then never used)."""
    if layout.restart_off is None:
        return torch.zeros_like(words[:, :2])
    return words[:, layout.restart_off : layout.restart_off + 2]


def step_words_v2(rng_key: torch.Tensor, layout: StepRngLayout) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Legacy split-chain step draw, batched over lanes: key [L, 2]
    (int64 uint32 values, or int32 bit patterns) -> (new_key [L, 2],
    words [L, total_words], k_restart [L, 2]), int64 uint32 values. The
    restart key is its own split, never a consumed key."""
    keys = split(rng_key.to(torch.int64) & MASK, 3)
    return keys[:, 0], bits(keys[:, 1], layout.total_words), keys[:, 2]


def step_words(rng_key: torch.Tensor, step: torch.Tensor, layout: StepRngLayout):
    """The step draw of the layout's stream version: (new_key, words,
    k_restart)."""
    if layout.version == RNG_STREAM_COUNTER:
        return step_words_v3(rng_key, step, layout)
    return step_words_v2(rng_key, layout)
