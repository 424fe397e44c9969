"""Scenario-coverage map: the AFL-style hit map the step feeds.

The port's copy of `madsim_tpu/ops/coverage.py`, batched over lanes.
Every popped event hashes (abstract-state projection, event kind, fault
context) into one slot of a per-lane bit map, packed 32 slots to an
int32 word (slot s lives in word s >> 5, bit s & 31). The slot layout
is banded so the host can decode it (`runtime/coverage.py`):

    v1 (3 band bits): slot = [ band:3 | phase:3 | mix:(slots_log2-6) ]
    v2 (4 band bits): slot = [ band:4 | phase:3 | mix:(slots_log2-7) ]

The buffered regime (`EngineConfig.cov_buffer > 0`) appends each step's
slot index to a small per-lane buffer (`cov_push`) and folds the buffer
into the map on a fixed cadence (`cov_flush`; the CUDA kernel in
`ops/kernels.py` does the same fold on the card). `cov_buffer=0` folds
each popped event's slot into the map at once (`cov_fold`).
"""

from __future__ import annotations

import torch

from .. import kinds as _kinds
from . import u32

COV_SLOTS_LOG2_DEFAULT = 14
COV_WORD_BITS = 32
COV_BAND_BITS = 3
COV_BAND_BITS_V2 = 4
COV_PHASE_BITS = 3
COV_BAND_NAMES = _kinds.COV_BAND_NAMES
COV_BAND_NAMES_V2 = _kinds.COV_BAND_NAMES_V2
COV_BAND_DUP = 10
COV_BAND_AMNESIA = 11
COV_KIND_BAND_SHIFT_AT = 8
COV_BUFFER_DEFAULT = 16

# mix constants: murmur3 fmix / Weyl (odd multipliers)
_MIX_SEED = 0x9E3779B9
_MIX_M = 0x85EBCA6B


def cov_mix(words) -> torch.Tensor:
    """xor-multiply-xorshift fold of a list of [L] integer tensors (each
    taken as its uint32 bit pattern) into one uint32 word per lane,
    returned as int64."""
    h = _MIX_SEED
    for w in words:
        h = u32.mul(h ^ u32.from_i32(w), _MIX_M)
        h = h ^ (h >> 13)
    return h


def cov_band(ev_kind, op_word, band_bits: int = COV_BAND_BITS) -> torch.Tensor:
    """Band of a popped event: timer 0 / msg 1 / fault 2+kind (kinds
    past the synthetic dup/amnesia bands map to 4+kind in the 4-bit
    layout)."""
    ev_kind = ev_kind.to(torch.int32)
    bands = 1 << band_bits
    kind = torch.div(op_word.to(torch.int32), 2, rounding_mode="floor")
    if band_bits <= COV_BAND_BITS:
        fault_band = 2 + kind.clamp(0, bands - 3)
    else:
        fault_band = torch.where(
            kind >= COV_KIND_BAND_SHIFT_AT,
            4 + kind.clamp(COV_KIND_BAND_SHIFT_AT, bands - 5),
            2 + kind.clamp(0, COV_KIND_BAND_SHIFT_AT - 1),
        )
    return torch.where(ev_kind == 2, fault_band, ev_kind.clamp(0, 1)).to(torch.int32)


def cov_slot(
    abstract, ev_kind, ev_node, op_word, fault_ctx,
    slots_log2: int, band_bits: int = COV_BAND_BITS, band=None,
) -> torch.Tensor:
    """Map each lane's popped event to its slot index (int32 in
    [0, 2**slots_log2)). `abstract` is the model's projection word,
    `op_word` the event discriminant, `fault_ctx` the packed
    fault-environment word; `band`, when given, overrides the
    event-derived band."""
    if band is None:
        band = cov_band(ev_kind, op_word, band_bits)
    abstract = u32.from_i32(abstract)
    phase = abstract & ((1 << COV_PHASE_BITS) - 1)
    mix_bits = slots_log2 - band_bits - COV_PHASE_BITS
    h = cov_mix([abstract, ev_kind, ev_node, op_word, fault_ctx])
    mix = h & ((1 << mix_bits) - 1)
    slot = (band.to(torch.int64) << (slots_log2 - band_bits)) | (phase << mix_bits) | mix
    return slot.to(torch.int32)


def cov_fold(cov_map, slot, hit) -> torch.Tensor:
    """Set each lane's slot bit in its packed map [L, W] where `hit`;
    elsewhere the word ORs in 0, so a frozen lane's map stays as it was.
    One word gather and one word scatter per lane; returns a new map."""
    w = (slot >> 5).to(torch.int64)[:, None]
    bit = torch.bitwise_left_shift(torch.ones_like(slot), slot & 31) * hit.to(slot.dtype)
    return cov_map.scatter(1, w, cov_map.gather(1, w) | bit[:, None].to(cov_map.dtype))


def cov_push(buf, n, slot, hit, write=None):
    """Append `slot` to each lane's buffer [L, C] where `hit`, else write
    a masked 0 into the current tail position (the same write either
    way); `n` [L] counts live entries and only hits advance it.
    `write` (a scalar bool tensor), when given, gates the whole write:
    the segment loop passes False once every lane is frozen, where the
    reference's early-exit loop runs no step at all."""
    hit_i = hit.to(torch.int32)
    pos = n.clamp(0, buf.shape[1] - 1)
    at = torch.arange(buf.shape[1], device=buf.device) == pos[:, None]
    if write is not None:
        at = at & write
    new_buf = torch.where(at, (slot.to(torch.int32) * hit_i)[:, None], buf)
    return new_buf, n + hit_i


def cov_flush(cov_map, buf, n) -> torch.Tensor:
    """Fold each lane's buffered slot prefix buf[:, :n] into its packed
    bit map [L, W]; returns a new map. An unrolled sequence of one-word
    read-modify-writes per lane (entry i contributes only where i < n):
    OR commutes and is idempotent, so the result equals folding each
    slot at its own event. Entries whose word lies outside the map are
    dropped, as the TPU kernel drops them."""
    lanes, words = cov_map.shape
    out = cov_map.clone()
    for i in range(buf.shape[1]):
        slot = buf[:, i]
        w = slot >> 5
        inside = (i < n) & (w >= 0) & (w < words)
        bit = torch.where(
            inside, torch.bitwise_left_shift(torch.ones_like(slot), slot & 31), 0
        )
        w = w.clamp(0, words - 1)[:, None].to(torch.int64)
        out.scatter_(1, w, out.gather(1, w) | bit[:, None])
    return out


def cov_fold_words(lane_maps: torch.Tensor, chunk: int = 1024, mesh=None) -> torch.Tensor:
    """OR-fold the per-lane packed maps [L, W] into one word vector [W]:
    the `cov-map-or` collective of the stream harvest. PyTorch has no
    bitwise-or reduction, so each chunk of lanes is bit-unpacked,
    reduced with `any` (a boolean or) and the hit bits repacked by
    summing disjoint single-bit words, which is exactly the or. Chunks
    bound the unpacked intermediate to chunk x W x 32.

    Under a `mesh` (`parallel`) the maps are this rank's lanes: their
    fold is then OR-ed with every other rank's, an all-gather of the
    ranks' [W] partials folded the same way (NCCL has no bitwise-or
    reduction). OR is associative and idempotent,
    so the [W] vector is the unsharded one for any split of the lanes."""
    if mesh is not None:
        from ..parallel import or_words

        return or_words(mesh, cov_fold_words(lane_maps, chunk), lambda parts: cov_fold_words(parts, chunk))
    words = lane_maps.shape[1]
    bits = torch.arange(COV_WORD_BITS, device=lane_maps.device, dtype=torch.int32)
    masks = torch.bitwise_left_shift(torch.ones_like(bits), bits)
    hit = torch.zeros((words, COV_WORD_BITS), dtype=torch.bool, device=lane_maps.device)
    for start in range(0, lane_maps.shape[0], chunk):
        part = lane_maps[start : start + chunk]
        hit |= ((part[:, :, None] & masks) != 0).any(dim=0)  # madsim: collective(cov-map-or, reduce=or)
    return u32.to_i32((hit.to(torch.int64) << bits.to(torch.int64)).sum(dim=1))


def empty_cov_map(lanes: int, slots_log2: int, device=None) -> torch.Tensor:
    """Zeroed per-lane hit maps: int32[lanes, 2**slots_log2 / 32]."""
    return torch.zeros((lanes, (1 << slots_log2) // COV_WORD_BITS), dtype=torch.int32, device=device)
