"""Hunt/explore checkpointing: resume an interrupted streaming run
exactly. The port's copy of `madsim_tpu/runtime/checkpoint.py`.

`hunt --checkpoint PATH` persists per-batch progress of the chunked
streaming driver (`__main__._stream_batches`): the seed cursor, the
completed/failing/infra/abandoned aggregates, the cumulative coverage
map and the plateau-detector state. A run killed between batches
resumes from the last completed batch ("resumed at batch k/n") and the
final report equals the uninterrupted run's: batch i always consumes
the same seed range, so the cursor and the aggregates are the whole
state, recorded atomically after every batch.

The checkpoint carries a FINGERPRINT of every argument that shapes the
seed schedule or the failure semantics; a resume with a different
command line is refused. Pure host-side JSON, in the JAX package's
bytes.
"""

from __future__ import annotations

import json
import os
from typing import Optional

CKPT_VERSION = 1

#: keys every complete checkpoint carries (the strict loader below
#: validates only the version)
CKPT_REQUIRED_KEYS = frozenset({
    "fingerprint", "batch", "planned", "cursor", "completed",
    "seeds_consumed", "failing", "infra", "abandoned", "done",
})

# args fields that must match for a resume to be sound: anything that
# changes which seeds run, in what order, or what they mean.
_FINGERPRINT_FIELDS = (
    "machine",
    "nodes",
    "seed",
    "seeds",
    "batch",
    "max_steps",
    "horizon",
    "loss",
    "faults",
    "fault_tmax",
    "fault_kinds",
    "rng_stream",
    "strict_restart",
    "coverage",
    "stop_on_plateau",
    # guided mode reshapes the seed schedule
    "guided",
)


def fingerprint_from_args(args) -> dict:
    return {f: getattr(args, f, None) for f in _FINGERPRINT_FIELDS}


def save_checkpoint(path: str, state: dict) -> None:
    """Atomic write (`runtime/atomicio`: tmp + fsync + rename +
    dir-fsync): a kill mid-write leaves the previous checkpoint intact,
    never a truncated JSON. Rides the host timeline as a
    `checkpoint_write` span when a PerfRecorder is active."""
    from ..perf.recorder import maybe_span
    from .atomicio import atomic_write_json

    doc = {"version": CKPT_VERSION, **state}
    with maybe_span("checkpoint_write"):
        atomic_write_json(path, doc)


def load_checkpoint(path: str) -> Optional[dict]:
    """Load a checkpoint, or None when the file doesn't exist (a fresh
    run). A malformed or wrong-version file raises — silently starting
    over would throw away a long hunt's progress."""
    if not os.path.exists(path):
        return None
    with open(path) as f:
        doc = json.load(f)
    if doc.get("version") != CKPT_VERSION:
        raise ValueError(
            f"{path}: checkpoint version {doc.get('version')!r}, "
            f"expected {CKPT_VERSION}"
        )
    return doc


def check_fingerprint(ckpt: dict, args) -> Optional[str]:
    """None when the checkpoint belongs to this command line; otherwise
    a human-readable description naming EVERY field that differs
    (model, kinds, gates, lanes, ...): a drifted resume usually drifts
    several fields at once."""
    want = fingerprint_from_args(args)
    got = ckpt.get("fingerprint", {})
    diffs = [
        f"{field} (checkpoint {got.get(field)!r} != this run "
        f"{want.get(field)!r})"
        for field in _FINGERPRINT_FIELDS
        if got.get(field) != want.get(field)
    ]
    if not diffs:
        return None
    return (
        "checkpoint belongs to a different run — refusing to resume; "
        "differing: " + ", ".join(diffs)
    )
