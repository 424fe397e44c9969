"""Host-side scenario-coverage decoding, plateau detection, persistence:
the port's copy of `madsim_tpu/runtime/coverage.py`.

The device half (`ops/coverage.py`) folds popped events into per-lane
hit maps and OR-reduces them into one `bool[2^slots_log2]` vector at
stream harvest. Everything downstream of that vector lives here,
numpy-only, so the `coverage` subcommand needs no card:

  * `coverage_dict`: the summary `run_stream` stats embed (slots hit,
    fraction, per-band marginals);
  * `cell_table` / `top_uncovered`: the (band, phase) cell decode the
    command line's report ranks;
  * `PlateauDetector`: the `--stop-on-plateau` policy (N consecutive
    batches adding no new slot);
  * `make_coverage_doc` / `save_coverage_doc` / `load_coverage_doc` /
    `diff_maps`: the `hunt --coverage-out` document (base64 maps keyed
    by machine, written byte for byte as the JAX package writes it) and
    cross-run diffing.

Slot layout (as `ops/coverage.py`):

    v1 (band_bits=3):  slot = [ band:3 | phase:3 | mix:(slots_log2-6) ]
    v2 (band_bits=4):  slot = [ band:4 | phase:3 | mix:(slots_log2-7) ]

Docs carry `band_bits` when it is 4, so every 3-bit doc keeps rendering.
"""

from __future__ import annotations

import base64
import json
from typing import Dict, Optional

import numpy as np

COV_BAND_BITS = 3
COV_PHASE_BITS = 3
COV_BANDS = 1 << COV_BAND_BITS
COV_PHASES = 1 << COV_PHASE_BITS
# band 0/1: event class; 2..: fault kind (the port's `kinds.py` tables)
from ..kinds import COV_BAND_NAMES, COV_BAND_NAMES_V2

# doc v1: band_bits implicitly 3; v2 carries an explicit band_bits field
COV_DOC_VERSION = 2
_ACCEPTED_DOC_VERSIONS = (1, 2)


def band_names(band_bits: int = COV_BAND_BITS) -> tuple:
    if band_bits == 3:
        return COV_BAND_NAMES
    if band_bits == 4:
        return COV_BAND_NAMES_V2
    raise ValueError(f"unknown coverage band layout: band_bits={band_bits}")


def _as_bool_map(map_arr) -> np.ndarray:
    m = np.asarray(map_arr)
    return m if m.dtype == bool else m > 0


def unpack_map(words, slots_log2: int) -> np.ndarray:
    """Decode the device's packed bit map (int32[..., 2^slots_log2/32],
    slot s in word s >> 5, bit s & 31) to bool[..., 2^slots_log2].
    Works on a single map or a [lanes, words] batch."""
    w = np.asarray(words).astype(np.uint32)
    if w.shape[-1] * 32 != 1 << slots_log2:
        raise ValueError(
            f"packed map has {w.shape[-1]} words, expected "
            f"{(1 << slots_log2) // 32} for 2^{slots_log2} slots"
        )
    bits = (w[..., :, None] >> np.arange(32, dtype=np.uint32)) & 1
    return bits.reshape(*w.shape[:-1], 1 << slots_log2).astype(bool)


def coverage_dict(map_arr, slots_log2: int, band_bits: int = COV_BAND_BITS) -> dict:
    """Summarize a global coverage vector: total slots hit, fraction,
    and the per-band marginals (how much of each event class / fault
    kind's slot space has been reached)."""
    m = _as_bool_map(map_arr)
    total = 1 << slots_log2
    if m.size != total:
        raise ValueError(f"map has {m.size} slots, expected {total}")
    per_band = m.reshape(1 << band_bits, -1).sum(axis=1)
    hit = int(m.sum())
    return {
        "slots_hit": hit,
        "slots_total": total,
        "fraction": round(hit / total, 6),
        "by_band": {
            name: int(n) for name, n in zip(band_names(band_bits), per_band)
        },
    }


def cell_table(map_arr, slots_log2: int, band_bits: int = COV_BAND_BITS) -> np.ndarray:
    """[bands, COV_PHASES] hit counts — the fault/event-class x
    model-phase cell grid. Each cell owns
    2^(slots_log2-band_bits-3) mix slots."""
    m = _as_bool_map(map_arr)
    return m.reshape(1 << band_bits, COV_PHASES, -1).sum(axis=2)


def top_uncovered(
    map_arr, slots_log2: int, top: int = 8, band_bits: int = COV_BAND_BITS
) -> list:
    """The `top` least-covered (band, phase) cells that have been
    TOUCHED at least once, plus every never-touched cell, ranked
    emptiest-first. A touched-but-thin cell is a reachable scenario
    class the hunt has barely explored — the steering signal a
    coverage-guided search would consume. Reserved v2 bands are
    skipped (nothing can ever land there)."""
    cells = cell_table(map_arr, slots_log2, band_bits=band_bits)
    cell_size = 1 << (slots_log2 - band_bits - COV_PHASE_BITS)
    names = band_names(band_bits)
    out = []
    for b in range(1 << band_bits):
        if names[b].startswith("reserved"):
            continue
        for p in range(COV_PHASES):
            out.append(
                {
                    "band": names[b],
                    "phase": p,
                    "hit": int(cells[b, p]),
                    "fraction": round(int(cells[b, p]) / cell_size, 4),
                }
            )
    out.sort(key=lambda c: (c["hit"], c["band"], c["phase"]))
    return out[:top]


class PlateauDetector:
    """Saturation policy for `--stop-on-plateau N`: fire after N
    consecutive observations that added zero new slots to the
    cumulative total. Feed it the RUNNING total (monotone), not deltas —
    it derives deltas itself, so a poll/batch boundary mismatch can't
    double-count."""

    def __init__(self, patience: int):
        if patience < 1:
            raise ValueError("plateau patience must be >= 1")
        self.patience = patience
        self.best = 0
        self.batches = 0
        self.streak = 0

    def update(self, slots_hit_total: int) -> bool:
        """Observe one batch's cumulative slots-hit; returns True when
        the plateau policy says stop."""
        self.batches += 1
        new = max(0, int(slots_hit_total) - self.best)
        self.best = max(self.best, int(slots_hit_total))
        self.streak = self.streak + 1 if new == 0 else 0
        return self.plateaued

    @property
    def plateaued(self) -> bool:
        return self.streak >= self.patience


# -- persistence (`hunt --coverage-out`) -------------------------------------


def encode_map(map_arr) -> str:
    """bool map -> base64 of packed bits (2^14 slots -> ~2.7 KiB)."""
    m = _as_bool_map(map_arr)
    return base64.b64encode(np.packbits(m).tobytes()).decode("ascii")


def decode_map(b64: str, slots_log2: int) -> np.ndarray:
    raw = np.frombuffer(base64.b64decode(b64), dtype=np.uint8)
    return np.unpackbits(raw)[: 1 << slots_log2].astype(bool)


def make_coverage_doc(
    maps: Dict[str, np.ndarray],
    slots_log2: int,
    meta: Optional[dict] = None,
    band_bits: int = COV_BAND_BITS,
) -> dict:
    """Build the JSON document `hunt --coverage-out` writes: one map per
    machine name (the per-model breakdown the report renders). 3-band-bit
    maps are written as version-1 docs (byte-compatible with every
    pre-existing consumer); the 4-bit layout bumps the doc version and
    records band_bits explicitly."""
    version = 1 if band_bits == COV_BAND_BITS else COV_DOC_VERSION
    doc = {
        "version": version,
        "slots_log2": slots_log2,
        "meta": dict(meta or {}),
        "maps": {
            name: {
                "map_b64": encode_map(m),
                **coverage_dict(m, slots_log2, band_bits=band_bits),
            }
            for name, m in sorted(maps.items())
        },
    }
    if version != 1:
        doc["band_bits"] = band_bits
    return doc


def save_coverage_doc(path: str, doc: dict) -> None:
    """Write the doc atomically, in the JAX package's bytes."""
    from .atomicio import atomic_write_json

    atomic_write_json(path, doc, indent=1, sort_keys=True)


def load_coverage_doc(path: str) -> dict:
    with open(path) as f:
        doc = json.load(f)
    if doc.get("version") not in _ACCEPTED_DOC_VERSIONS:
        raise ValueError(
            f"{path}: coverage doc version {doc.get('version')!r}, "
            f"expected one of {_ACCEPTED_DOC_VERSIONS}"
        )
    return doc


def doc_band_bits(doc: dict) -> int:
    """The banded layout a doc was written under (v1 docs predate the
    field and are always 3-bit)."""
    return int(doc.get("band_bits", COV_BAND_BITS))


def doc_maps(doc: dict) -> Dict[str, np.ndarray]:
    L = doc["slots_log2"]
    return {
        name: decode_map(entry["map_b64"], L)
        for name, entry in doc["maps"].items()
    }


def diff_maps(a: np.ndarray, b: np.ndarray) -> dict:
    """Cross-run comparison: slots only run A reached, only run B,
    both. The "did 10k more seeds buy anything" answer in three ints."""
    a, b = _as_bool_map(a), _as_bool_map(b)
    return {
        "only_a": int((a & ~b).sum()),
        "only_b": int((~a & b).sum()),
        "both": int((a & b).sum()),
    }


def render_report(doc: dict, top: int = 8, diff_doc: Optional[dict] = None) -> str:
    """Human-readable coverage report for one (optionally two) docs."""
    L = doc["slots_log2"]
    bb = doc_band_bits(doc)
    lines = []
    other = doc_maps(diff_doc) if diff_doc is not None else {}
    for name, m in doc_maps(doc).items():
        d = coverage_dict(m, L, band_bits=bb)
        lines.append(
            f"{name}: {d['slots_hit']}/{d['slots_total']} slots "
            f"({100 * d['fraction']:.2f}%)"
        )
        band_txt = ", ".join(
            f"{k}={v}" for k, v in d["by_band"].items() if v
        )
        lines.append(f"  by band: {band_txt or 'none'}")
        cells = top_uncovered(m, L, top=top, band_bits=bb)
        worst = ", ".join(
            f"{c['band']}x{c['phase']}={c['hit']}" for c in cells
        )
        lines.append(f"  thinnest band x phase cells: {worst}")
        if name in other:
            dd = diff_maps(other[name], m)
            lines.append(
                f"  vs baseline: +{dd['only_b']} new slots, "
                f"-{dd['only_a']} lost, {dd['both']} shared"
            )
    if not lines:
        lines.append("(coverage doc has no maps)")
    return "\n".join(lines)
