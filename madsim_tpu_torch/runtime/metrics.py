"""Runtime metrics (reference: madsim/src/sim/runtime/metrics.rs), and
the host-side decoder of the flight-recorder metrics vector
(`StreamCarry.fr_metrics`): the port's copy of
`madsim_tpu/runtime/metrics.py`'s `RuntimeMetrics` and
`fr_metrics_dict`."""

from __future__ import annotations

from typing import TYPE_CHECKING, Dict, Sequence

if TYPE_CHECKING:
    from ..task.executor import Executor

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


class RuntimeMetrics:
    """Live task census (reference: metrics.rs:6-40)."""

    def __init__(self, executor: "Executor"):
        self._executor = executor

    def num_nodes(self) -> int:
        return len(self._executor.nodes)

    def num_tasks(self) -> int:
        return sum(len(n.tasks) for n in self._executor.nodes.values())

    def num_tasks_by_node(self) -> Dict[str, int]:
        return {
            n.name: len(n.tasks)
            for n in self._executor.nodes.values()
            if n.tasks
        }

    def num_tasks_by_node_by_spawn(self) -> Dict[str, Dict[str, int]]:
        out: Dict[str, Dict[str, int]] = {}
        for n in self._executor.nodes.values():
            if not n.tasks:
                continue
            per: Dict[str, int] = {}
            for t in n.tasks:
                loc = t.location
                if isinstance(loc, tuple):  # (filename, lineno) spawn key
                    loc = f"{loc[0]}:{loc[1]}"
                per[loc] = per.get(loc, 0) + 1
            out[n.name] = per
        return out
