"""The coverage-feedback fleet scheduler — spend lane-time where bugs
still hide.

The allocator orders work purely by (warm-compile subkey,
priority, deadline); every job then runs its budget flat. This module
adds the missing signal: each job's LIVE search state, read from the
artifacts the worker already writes (the per-batch StatsEmitter JSONL
feed and the job document's progress mirror) — no new wire, no torch.

`job_momentum` distills a job to one record:

  * `new_slots_recent` — coverage slots added over the last
    `RECENT_BATCHES` batch rows of its stats feed (the "is this hunt
    still finding new scenarios" derivative);
  * `plateau` — the detector has fired and (for guided jobs) the
    escalation ladder is exhausted;
  * `escalation` — the guided vocabulary rung the job is on;
  * `active` — the allocation verdict: a job still adding slots, or
    one that has not produced a feed yet (it must get lane-time to
    bootstrap), or one that does not emit coverage at all (no signal
    is not a death sentence), outranks a stalled one.

`LaneAllocator.pick(..., momentum=...)` consumes these: within the
sticky warm-compile group's equal-priority ring, active jobs are
served before stalled ones (round-robin among actives, so concurrent
productive tenants still interleave). A stalled job is only starved
while some active job wants the lanes — exactly the reallocation the
a farm wants. Stalled jobs regain lanes the
moment the active set drains, so every budget still completes.

Determinism: a momentum read is a pure function of the on-disk feed +
job docs at poll time; the chaos harness's byte-identical-recovery
invariants are unaffected (allocation order was never part of a job's
recorded result — each job's report is a pure function of its own
(fingerprint, seed schedule)).
"""

from __future__ import annotations

from typing import Dict, List

from .store import Job, JobStore

#: feed rows (batches) the momentum derivative looks back over
RECENT_BATCHES = 5


def job_momentum(store: JobStore, job: Job) -> dict:
    """Distill one job's live search state from its stats feed + doc."""
    feed = store.read_feed(job.id, last=RECENT_BATCHES)
    batch_rows = [
        r for r in feed
        if str(r.get("kind", "")).endswith("_batch")
    ]
    new_slots = sum(
        int((r.get("coverage") or {}).get("new_slots", 0))
        for r in batch_rows
    )
    emits_coverage = any("coverage" in r for r in batch_rows)
    plateau = bool(job.progress.get("plateau"))
    escalation = job.progress.get("escalation")
    active = (not plateau) and (
        not batch_rows          # not started: bootstrap it
        or not emits_coverage   # no signal: never punish a blind job
        or new_slots > 0        # still finding new scenarios
    )
    return {
        "new_slots_recent": new_slots,
        "batches_seen": len(batch_rows),
        "plateau": plateau,
        "escalation": escalation,
        "active": active,
    }


def momentum_for(store: JobStore, jobs: List[Job]) -> Dict[str, dict]:
    """One momentum read per candidate job (the worker calls this once
    per lease poll and hands the result to the allocator)."""
    return {job.id: job_momentum(store, job) for job in jobs}
