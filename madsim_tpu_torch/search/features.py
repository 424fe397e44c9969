"""Candidate-seed schedule features — the host-side peek at what a
seed WOULD do.

The port of `madsim_tpu/search/features.py`. A lane's fault schedule is
a pure function of (seed, FaultPlan), derived by the same `init_batch`
code the lanes run, so the bias layer scores a whole candidate pool
without running a simulation: one `init_batch` of the candidate seed
vector gives every candidate's drawn (kind, apply-time, target) triples,
bit-equal to what those seeds would run. The slots are the ones
`engine/provenance.py` decodes lineage words against, read by its
schedule function, which is cached on the machine per (FaultPlan,
queue, stream, device): guided hunts build several escalated Engines
over one machine.
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np

from ..engine.provenance import _sched_fn


def schedule_features(engine, seeds: Sequence[int]) -> Dict[str, np.ndarray]:
    """Per-seed fault-schedule features for a seed vector: int32 arrays
    of shape [len(seeds), n_faults] — "kinds" (K_* indices), "t_apply"
    (virtual us), "targets" (payload arg1: the node / pair-a / mask-lo
    the fault lands on). Empty [n, 0] arrays when the plan schedules
    no faults (guidance then has nothing to score — selection falls
    back to the first candidate)."""
    fp = engine.config.faults
    n_seeds = len(seeds)
    if fp.n_faults == 0 or n_seeds == 0:
        empty = np.zeros((n_seeds, 0), np.int32)
        return {"kinds": empty, "t_apply": empty, "targets": empty}
    # child seeds span the whole uint32 range: int64 values, never int32
    times, pays, _valid = _sched_fn(engine)(np.asarray(list(seeds), dtype=np.int64) & 0xFFFFFFFF)
    apply_slots = np.arange(fp.n_faults) * fp.slots_per_fault
    return {
        # the apply slot's op encodes the kind: op = 2*kind (+1 = undo)
        "kinds": (pays[:, apply_slots, 0] // 2).astype(np.int32),
        "t_apply": times[:, apply_slots].astype(np.int32),
        "targets": pays[:, apply_slots, 1].astype(np.int32),
    }


def kind_name_rows(engine, kinds: np.ndarray) -> list:
    """Map a [n, F] kind-index array to per-seed kind-name tuples (the
    shape `BiasState.score_kinds` consumes)."""
    from ..kinds import FAULT_KIND_NAMES

    return [
        tuple(FAULT_KIND_NAMES[int(k)] for k in row) for row in kinds
    ]
