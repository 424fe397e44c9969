"""Host-side coverage decoding: the port's copy of the parts of
`madsim_tpu/runtime/coverage.py` that `run_stream`'s stats need."""

from __future__ import annotations

import numpy as np

from ..kinds import COV_BAND_NAMES, COV_BAND_NAMES_V2

COV_BAND_BITS = 3


def band_names(band_bits: int = COV_BAND_BITS) -> tuple:
    if band_bits == 3:
        return COV_BAND_NAMES
    if band_bits == 4:
        return COV_BAND_NAMES_V2
    raise ValueError(f"unknown coverage band layout: band_bits={band_bits}")


def unpack_map(words, slots_log2: int) -> np.ndarray:
    """Packed bit map (int32[..., 2^slots_log2/32], slot s in word s >> 5,
    bit s & 31) -> bool[..., 2^slots_log2]."""
    w = np.asarray(words).astype(np.uint32)
    if w.shape[-1] * 32 != 1 << slots_log2:
        raise ValueError(
            f"packed map has {w.shape[-1]} words, expected "
            f"{(1 << slots_log2) // 32} for 2^{slots_log2} slots"
        )
    bits = (w[..., :, None] >> np.arange(32, dtype=np.uint32)) & 1
    return bits.reshape(*w.shape[:-1], 1 << slots_log2).astype(bool)


def coverage_dict(map_arr, slots_log2: int, band_bits: int = COV_BAND_BITS) -> dict:
    """Slots hit, fraction, and per-band marginals of a global map."""
    m = np.asarray(map_arr)
    m = m if m.dtype == bool else m > 0
    total = 1 << slots_log2
    if m.size != total:
        raise ValueError(f"map has {m.size} slots, expected {total}")
    per_band = m.reshape(1 << band_bits, -1).sum(axis=1)
    hit = int(m.sum())
    return {
        "slots_hit": hit,
        "slots_total": total,
        "fraction": round(hit / total, 6),
        "by_band": {name: int(k) for name, k in zip(band_names(band_bits), per_band)},
    }
