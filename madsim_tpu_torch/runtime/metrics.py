"""Host-side decoder of the flight-recorder metrics vector
(`StreamCarry.fr_metrics`): the port's copy of
`madsim_tpu/runtime/metrics.py::fr_metrics_dict`."""

from __future__ import annotations

from typing import Dict, Sequence

from ..kinds import FAULT_KIND_NAMES as FR_FAULT_KINDS
from ..kinds import FR_EXTRA_NAMES as FR_EXTRAS


def fr_metrics_dict(vec: Sequence[int]) -> Dict[str, object]:
    """Per-kind fault injection totals, the non-scheduled chaos counters,
    then queue / clogged-link / killed-node high-water marks."""
    v = [int(x) for x in vec]
    nk, ne = len(FR_FAULT_KINDS), len(FR_EXTRAS)
    if len(v) != nk + ne + 3:
        raise ValueError(f"expected {nk + ne + 3} metric words, got {len(v)}")
    return {
        "faults_injected": dict(zip(FR_FAULT_KINDS, v[:nk])),
        "dup_injected": v[nk],
        "amnesia_restarts": v[nk + 1],
        "queue_hwm": v[nk + ne],
        "clog_links_hwm": v[nk + ne + 1],
        "killed_hwm": v[nk + ne + 2],
    }
