"""Multi-tenant lane allocator — pack work units by warm-compile key.

A work unit is one seed batch of one job. On a 1-core box the worker
runs exactly one unit at a time (never two engine configs in flight),
so the scheduling question is purely *ordering* — and the dominant cost
to order around is engine set-up: switching engine configs pays a build
and a warm-up segment, while staying
within one `cache_subkey` group reuses the live engine for free. So the
allocator is deliberately sticky:

* units from jobs sharing the in-flight job's `cache_subkey` are packed
  back-to-back (round-robin WITHIN the group, so concurrent tenants on
  the same compile all make batch-by-batch progress and their live
  feeds stream together);
* the worker only switches subkey groups when the current group drains,
  or when a strictly higher-priority job is waiting in another group
  (priority is allowed to pay the compile switch; fairness inside a
  priority level is not);
* which group starts first is decided by (priority desc, earliest
  deadline, submit order) over each group's best job;
* WITHIN the chosen group's equal-priority ring, the coverage-feedback
  scheduler (`fleet/scheduler.py`) reallocates lane-time: jobs whose
  live stats feed still shows new coverage slots (or that have no
  signal yet) are served before stalled ones — lane-time goes where
  bugs still hide, and a stalled job gets its lanes back the moment
  the active set drains.

Pure host-side policy over `Job` records + the optional momentum map
the worker reads for it — no torch, no IO here; the worker owns all
store writes. Unit-testable in microseconds.
"""

from __future__ import annotations

from typing import Dict, List, Optional

from .store import Job

_FAR_FUTURE = float("inf")


def _job_rank(job: Job) -> tuple:
    """Lower ranks run earlier: priority desc, deadline asc, id asc."""
    return (
        -job.priority,
        job.deadline_ts if job.deadline_ts is not None else _FAR_FUTURE,
        job.id,
    )


class LaneAllocator:
    """Stateful picker: remembers the in-flight subkey (stickiness) and
    the last job served per subkey (round-robin within the group)."""

    def __init__(self):
        self.current_subkey: Optional[str] = None
        self._last_served: dict = {}  # subkey -> job id

    def pick(self, candidates: List[Job],
             momentum: Optional[Dict[str, dict]] = None) -> Optional[Job]:
        """Choose the job whose next batch-sized unit runs now, or None
        when there is nothing runnable. `candidates` are jobs the
        worker can lease (non-terminal, lease available); `momentum`
        is the coverage-feedback map from `scheduler.momentum_for` —
        when present, active jobs (still finding new slots / no signal
        yet) outrank stalled ones within the equal-priority ring."""
        if not candidates:
            return None
        groups: dict = {}
        for job in candidates:
            groups.setdefault(job.subkey, []).append(job)
        best_of = {
            sk: min(jobs, key=_job_rank) for sk, jobs in groups.items()
        }
        # the globally best-ranked job defines the priority bar
        target_sk = min(best_of, key=lambda sk: _job_rank(best_of[sk]))
        sk = self.current_subkey
        if sk in groups and (
            best_of[target_sk].priority <= best_of[sk].priority
        ):
            # sticky: stay on the warm compile unless a strictly
            # higher-priority tenant waits elsewhere
            target_sk = sk
        self.current_subkey = target_sk
        group = sorted(groups[target_sk], key=_job_rank)
        top_priority = group[0].priority
        ring = [j for j in group if j.priority == top_priority]
        if momentum is not None:
            # lane-time goes where bugs still hide: serve the active
            # front; stalled jobs wait until the actives drain
            active = [
                j for j in ring
                if momentum.get(j.id, {}).get("active", True)
            ]
            if active:
                ring = active
        # round-robin within the (active front of the) equal-priority
        # ring, so concurrent productive tenants interleave
        last = self._last_served.get(target_sk)
        ids = [j.id for j in ring]
        if last in ids and len(ids) > 1:
            chosen = ring[(ids.index(last) + 1) % len(ids)]
        else:
            chosen = ring[0]
        self._last_served[target_sk] = chosen.id
        return chosen
