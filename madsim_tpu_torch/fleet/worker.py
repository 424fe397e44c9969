"""The fleet worker — lease, slice, checkpoint, shrink, file.

`python -m madsim_tpu_torch fleet worker --root DIR` turns the store's
queue into engine time on the CUDA card (`--device cpu`: on the CPU).
The port of `madsim_tpu/fleet/worker.py`: it leases from the same store
a JAX worker does, writes the same checkpoint and result documents, and
files the same corpus entries, so a job can move between a JAX worker,
the port's worker on the card and the port's worker on the CPU. The
loop:

1. **Lease.** Scan the store for leasable jobs (queued, or mid-flight
   with an expired/own lease — crash recovery), refuse any whose spec
   drifted from its recorded fingerprint (the checkpoint-refusal
   discipline, surfaced verbatim as the job's `failed` reason), and let
   the `LaneAllocator` pick the next work unit — packed by
   `cache_subkey` so tenants sharing an engine shape run back-to-back
   on the worker's live engine.
2. **Run one unit.** One unit = one seed batch, driven through the SAME
   chunked streaming driver the `hunt` CLI uses
   (`__main__._stream_batches` with `stop_after_batches = done + 1`):
   the job's fingerprinted `--checkpoint` file advances atomically
   after every batch, so a `kill -9` anywhere loses at most one batch
   and the resumed job's final report is byte-identical to an
   uninterrupted run. Per-batch stats stream to the job's own
   StatsEmitter feed (label-namespaced for the fleet /metrics).
3. **Finalize.** On budget exhaustion / coverage plateau / deadline /
   cancel, close the lifecycle: no finds -> `exhausted`/`plateaued`;
   finds -> `found` -> `shrink` one representative per distinct fail
   code (provenance-guided when the gate rode the hunt) -> `shrunk` ->
   file each as a corpus entry carrying filed-by-job metadata + its
   minimal repro line + `why` attribution -> `filed`.

Engine reuse: one live Engine per `engine_key` (model + vocabulary +
gates + lane shape), dropped when the allocator switches subkey groups
— never two engine configs in flight at once on a 1-core box. A
PerfRecorder session (`--perf-timeline`) wraps every unit in a
`fleet_unit` span with the job id, so engine reuse is readable straight
off the host timeline (the second tenant's unit contains no
`engine_build` span at all).

Self-healing (the failure taxonomy — every path seeded-fault-tested by
`fleet chaos`):

* **Lease deaths.** Every lease poll starts with the store's
  `reclaim_expired` sweep: a job whose worker lease expired is requeued
  (checkpoint preserved — the next worker resumes at <=1 lost batch)
  with exponential backoff, or quarantined after `--max-attempts`
  consecutive deaths.
* **Hard failures** (engine raise): one poison attempt each —
  requeue/quarantine as above, with exception + batch index + exact
  repro command recorded on the job.
* **OOM-class failures**: lane-count backoff first — halve `batch`,
  re-derive the warm-compile subkey, record the degradation, reset the
  (now fingerprint-mismatched) checkpoint — before burning poison
  attempts; below MIN_DEGRADED_BATCH lanes OOM counts as hard.
* **Deterministic refusals** (fingerprint drift, SystemExit contract
  violations, such as a mesh job asking for more cards than the
  machine has) go straight to `failed`: retrying cannot help.
* **Torn checkpoints** (external corruption — the fsync'd atomic
  writes never produce one) are quarantined to `*.corrupt` and the
  stream restarts from batch 0 instead of wedging in a refusal loop.
"""

from __future__ import annotations

# madsim: allow-file(D001) — the worker is host-side service code: it
# reads the wall clock only for lease renewal, deadline enforcement,
# idle polling and per-unit throughput logs. Nothing feeds simulation
# state; a job's results are a pure function of (fingerprint, seed
# schedule).
import contextlib
import importlib
import json
import logging
import os
import random
import time
from typing import Callable, List, Optional, Tuple

from .allocator import LaneAllocator
from .store import (
    CANCELLED,
    COMPILING,
    EXHAUSTED,
    FAILED,
    FILED,
    FOUND,
    LEASABLE,
    MAX_ATTEMPTS,
    PLATEAUED,
    QUARANTINED,
    QUEUED,
    REQUEUE_BACKOFF_BASE_S,
    RUNNING,
    SHRUNK,
    CorruptJobFile,
    FencedWrite,
    Job,
    JobStore,
    engine_key,
    repro_cmd,
    spec_to_args,
)

_LOG = logging.getLogger("madsim_tpu_torch.fleet.worker")

#: substrings marking an allocation-class failure (torch raises
#: `torch.OutOfMemoryError`, "CUDA out of memory. Tried to allocate
#: ..."; a JAX worker's RESOURCE_EXHAUSTED stays listed); these get the
#: lane-count backoff retry instead of burning poison attempts
_OOM_MARKERS = ("RESOURCE_EXHAUSTED", "out of memory", "Out of memory",
                "OutOfMemory")

#: below this lane count OOM stops degrading and counts as a hard
#: failure — halving forever just hides a leak
MIN_DEGRADED_BATCH = 8


class FleetWorker:
    def __init__(self, root: str, *, worker_id: str = "w0",
                 lease_ttl_s: float = 60.0, poll_s: float = 0.5,
                 max_attempts: int = MAX_ATTEMPTS,
                 backoff_base_s: float = REQUEUE_BACKOFF_BASE_S,
                 driver: Optional[Callable] = None,
                 reclaim: bool = True, device: str = "cuda"):
        self.store = JobStore(root)
        self.alloc = LaneAllocator()
        self.worker_id = worker_id
        self.lease_ttl_s = lease_ttl_s
        self.poll_s = poll_s
        self.max_attempts = max_attempts
        self.backoff_base_s = backoff_base_s
        #: where this worker's engines run: "cuda" (the card) or "cpu".
        #: Never part of a job's fingerprint: a job moves between the
        #: card, the CPU and a JAX worker
        self.device = device
        #: optional batch-unit driver `(worker, job, args) -> None` that
        #: replaces the engine's `_stream_batches` path — the chaos
        #: harness's torch-free synthetic driver plugs in here; it must
        #: drive the SAME checkpoint + stats machinery
        self.driver = driver
        #: run the lease-reclamation sweep before every lease poll, so
        #: a farm whose only live component is a worker still requeues
        #: (the `fleet serve` sweep thread covers the other deployment)
        self.reclaim = reclaim
        self._engines: dict = {}          # engine_key -> Engine
        self._engine_subkey: Optional[str] = None
        #: fencing token for the unit in flight: the lease generation
        #: captured at claim time and threaded through every store
        #: mutation this worker makes for that job, so a write from a
        #: reclaimed (zombie) hold is refused instead of applied
        self._unit_gen: Optional[int] = None
        #: contention counters, mirrored to workers/<id>.json so the
        #: control plane (`fleet top`, /healthz, /metrics) can report
        #: per-worker claim-conflict and fenced-write tallies without
        #: ever taking a job lock
        self.claim_conflicts = 0
        self.fenced_writes = 0
        self.units_done = 0

    def _note_fenced(self, exc: "FencedWrite") -> None:
        """Count and surface a refused zombie write, then move on —
        abandoning the unit IS the correct recovery (the store already
        kept the new holder's state intact)."""
        self.fenced_writes += 1
        self._write_stats()
        print(f"worker {self.worker_id}: {exc}", flush=True)

    def _write_stats(self) -> None:
        with contextlib.suppress(OSError, ValueError):
            self.store.write_worker_stats(self.worker_id, {
                "worker": self.worker_id,
                "claim_conflicts": self.claim_conflicts,
                "fenced_writes": self.fenced_writes,
                "units_done": self.units_done,
                "ts": round(time.time(), 3),
            })

    # -- main loop -----------------------------------------------------------

    def run(self, *, drain: bool = False, max_units: int = 0) -> int:
        """Serve work units until stopped. `drain=True` exits once every
        job is terminal (waiting out foreign leases); `max_units=N`
        exits after N units (deterministic interruption for tests)."""
        units = 0
        while True:
            job = self._lease_next()
            if job is None:
                if drain and all(j.terminal for j in self.store.list()):
                    print(f"worker {self.worker_id}: drained", flush=True)
                    return 0
                time.sleep(self.poll_s)
                continue
            self._run_unit(job)
            self._unit_gen = None  # token never outlives its unit
            units += 1
            self.units_done = units
            self._write_stats()
            if max_units and units >= max_units:
                print(
                    f"worker {self.worker_id}: stopping after "
                    f"{units} unit(s) (--max-units)", flush=True,
                )
                return 0

    def _lease_next(self) -> Optional[Job]:
        if self.reclaim:
            for act in self.store.reclaim_expired(
                max_attempts=self.max_attempts,
                backoff_base_s=self.backoff_base_s,
                via_index=True,
            ):
                print(
                    f"reclaimed {act['job']} from dead worker "
                    f"{act['worker']} -> {act['outcome']} "
                    f"(attempt {act['attempt']})", flush=True,
                )
        now = time.time()
        # candidate filtering runs on the log-structured queue index:
        # one incremental read of queue.log's new tail, zero per-job
        # document opens for jobs the index already rules out. The
        # index is a hint, not an authority — survivors get their real
        # document re-checked, and `try_lease` arbitrates under the
        # job's lock anyway.
        cands = []
        for jid, row in sorted(self.store.queue_rows().items()):
            if row.get("state") not in LEASABLE:
                continue
            after = row.get("requeue_after_ts")
            if after and after > now:
                continue  # requeue backoff still running
            holder = row.get("worker")
            if (holder and holder != self.worker_id
                    and (row.get("lease_expires_ts") or 0) > now):
                continue  # someone else is (still) on it
            try:
                j = self.store.get(jid)
            except (KeyError, CorruptJobFile):
                continue  # stale index row; the serve sweep heals it
            if j.state not in LEASABLE:
                continue
            if j.requeue_after_ts and j.requeue_after_ts > now:
                continue
            lease = j.lease
            if (lease and lease["worker"] != self.worker_id
                    and lease["expires_ts"] > now):
                continue
            cands.append(j)
        # coverage-feedback reallocation: one momentum read per
        # candidate (its stats feed tail + progress mirror), so the
        # allocator serves jobs still finding new slots first
        from .scheduler import momentum_for

        picked = self.alloc.pick(cands, momentum=momentum_for(self.store, cands))
        if picked is None:
            return None
        info: dict = {}
        got = self.store.try_lease(
            picked.id, self.worker_id, self.lease_ttl_s, info=info)
        if got is not None:
            self._unit_gen = (got.lease or {}).get("gen")
            return got
        if info.get("outcome") == "claim-conflict":
            # lost the O_EXCL race: count it, tell the control plane,
            # and back off with seeded jitter so N losers do not
            # re-collide on the very next poll
            self.claim_conflicts += 1
            self._write_stats()
            print(
                f"worker {self.worker_id}: lost claim race for "
                f"{picked.id} to {info.get('holder')}", flush=True,
            )
            rng = random.Random(
                f"fleet-claim {self.worker_id} {picked.id} "
                f"{self.claim_conflicts}")
            time.sleep(min(self.poll_s, 0.05) * (0.5 + rng.random()))
        return None

    # -- one work unit -------------------------------------------------------

    def _run_unit(self, job: Job) -> None:
        import atexit
        import contextlib
        import signal
        import tempfile

        from ..perf import xprof
        from ..perf.recorder import PerfRecorder, current_recorder

        job = self.store.get(job.id)  # freshest doc (cancel flag, spec)
        lease = job.lease
        if lease and lease.get("worker") == self.worker_id:
            # fence token for every mutation this unit makes: the
            # generation of our OWN live hold at unit start. A job
            # entered without a lease (tests drive `_run_unit`
            # directly) keeps gen None — the store's legacy unfenced
            # semantics.
            self._unit_gen = lease.get("gen")
        # per-unit recorder: the job id doubles as the trace id, and
        # `wall_t0` anchors the recorder's perf_counter clock on the
        # wall clock so the control plane can merge these spans with
        # its lifecycle events (`fleet timeline`). An outer
        # `--perf-timeline` recorder still sees everything: the unit's
        # spans are absorbed back into it after the unit.
        outer = current_recorder()
        unit_rec = PerfRecorder(meta={
            "trace_id": job.id, "job": job.id, "worker": self.worker_id,
        })
        offset_us = outer._now_us() if outer is not None else 0.0
        wall_t0 = time.time()
        # crash flush: a SIGTERM'd (or atexit'd) worker dumps the
        # spans it has SO FAR — open spans materialized as partial —
        # before dying, so a killed unit's `fleet timeline` shows the
        # span it died inside instead of nothing. `dumped` makes the
        # flush once-only (the normal finally path is the same dump).
        dumped = [False]

        def _flush(signum=None, frame=None):
            if not dumped[0]:
                dumped[0] = True
                with contextlib.suppress(Exception):
                    self._dump_spans(job, unit_rec, wall_t0)
            if signum is not None:
                # restore the previous disposition and re-deliver so
                # the process still dies of SIGTERM (rc 143)
                signal.signal(signum, prev_term or signal.SIG_DFL)
                os.kill(os.getpid(), signum)

        prev_term = None
        try:  # signal() only works on the main thread; tests use threads
            prev_term = signal.signal(signal.SIGTERM, _flush)
        except ValueError:
            pass
        atexit.register(_flush)
        # device-profile capture (MADSIM_TPU_XPROF=1 units): the
        # profiler session must OUTLIVE the recorder so its multi-second
        # stop/export never lands on the measured host wall
        cap_dir = tempfile.mkdtemp(prefix="madsim-fleet-xprof-") \
            if xprof.enabled() else None
        try:
            # CUDA activity only where this unit's engine runs on the
            # card: a CPU or synthetic unit launches no kernel
            on_card = self.device != "cpu" and self.driver is None
            with (xprof.device_trace(cap_dir, cuda=on_card) if cap_dir
                  else contextlib.nullcontext()):
                with unit_rec:
                    with unit_rec.span("fleet_unit", job=job.id,
                                       subkey=job.subkey, trace_id=job.id):
                        self._run_unit_inner(job)
        except SystemExit as exc:
            # the streaming driver refuses drifted checkpoints (and
            # other contract violations) via sys.exit — deterministic
            # refusals, so retrying is pointless: surfaced verbatim as
            # the job's failed reason
            try:
                self._fail(job, str(exc) or "worker aborted (SystemExit)")
            except FencedWrite as fexc:
                self._note_fenced(fexc)
        except KeyboardInterrupt:
            raise
        except FencedWrite as exc:
            # the lease was reclaimed out from under this unit and the
            # store refused the zombie's write — the job belongs to a
            # newer generation now. Abandon the unit WITHOUT touching
            # the store again: _hard_failure's record_death would stomp
            # the new holder's lease.
            self._note_fenced(exc)
        except Exception as exc:  # one broken job must not kill the farm
            try:
                self._hard_failure(job, exc)
            except FencedWrite as fexc:
                self._note_fenced(fexc)
        finally:
            atexit.unregister(_flush)
            if prev_term is not None:
                signal.signal(signal.SIGTERM, prev_term)
            if outer is not None:
                outer.absorb(unit_rec, offset_us)
            if not dumped[0]:
                dumped[0] = True
                self._dump_spans(job, unit_rec, wall_t0)
            if cap_dir is not None:
                self._save_device_trace(job, cap_dir)

    def _run_unit_inner(self, job: Job) -> None:
        if job.cancel_requested:
            self._finalize_cancel(job)
            return
        drift = self.store.fingerprint_mismatch(job)
        if drift:
            self._fail(job, drift)
            return
        if job.deadline_ts is not None and time.time() > job.deadline_ts:
            self._finalize(job, stop_reason="deadline")
            return
        ck = self._load_ckpt(job)
        if ck is not None and ck.get("done"):
            # a previous worker died between the last batch and
            # finalization — nothing left to stream, just close out
            self._finalize(job)
            return
        self._stream_one_batch(job, ck)

    def _dump_spans(self, job: Job, rec, wall_t0: float) -> None:
        """Append the unit's span dump (one JSONL record per unit) to
        the store, for `fleet timeline`'s cross-process merge. Same
        torn-tolerant append discipline as the event log; disabled by
        the same switch, and never on the result path. Instants ride
        along with ``dur: null`` (the xprof clock-sync markers the
        /profile merge aligns on), and on the crash-flush path the
        recorder's still-open spans are materialized as partial."""
        from . import events as fleet_events
        from ..runtime.atomicio import append_text

        if not fleet_events.enabled():
            return
        spans_out = []
        for s in list(rec.spans) + rec.open_spans():
            spans_out.append(
                {"name": s["name"], "ts": round(s["ts"], 1),
                 "dur": None if s["dur"] is None else round(s["dur"], 1),
                 "depth": s["depth"], "args": s["args"]})
        if not spans_out:
            return
        doc = {
            "worker": self.worker_id,
            "job": job.id,
            "trace_id": job.id,
            "wall_t0": round(wall_t0, 6),
            "spans": spans_out,
            "counters": dict(sorted(rec.counters.items())),
        }
        try:
            append_text(self.store.spans_path(job.id),
                        json.dumps(doc, sort_keys=True,
                                   separators=(",", ":")) + "\n")
        except OSError:
            pass  # observability never takes a unit down

    def _save_device_trace(self, job: Job, cap_dir: str) -> None:
        """Move the unit's device-profile capture into the store
        (last-unit-wins — the /profile merge aligns whole-unit sync
        seqs, so mixing units would desynchronize the clocks). Never
        on the result path; the capture dir is always cleaned up."""
        import shutil

        from ..perf import xprof

        try:
            src = xprof.find_device_trace(cap_dir)
            if src:
                dst = self.store.device_trace_path(job.id)
                shutil.copyfile(src, dst + ".tmp")
                os.replace(dst + ".tmp", dst)
        except OSError:
            pass  # observability never takes a unit down
        finally:
            shutil.rmtree(cap_dir, ignore_errors=True)

    def _stream_one_batch(self, job: Job, ck: Optional[dict]) -> None:
        if job.state == QUEUED:
            job = self.store.transition(job.id, COMPILING,
                                        worker=self.worker_id,
                                        gen=self._unit_gen)
        t0 = time.perf_counter()
        batches_done = int(ck["batch"]) if ck else 0
        args = spec_to_args(
            job.spec,
            checkpoint=self.store.ckpt_path(job.id),
            stats=self.store.stats_base(job.id),
            stats_labels={"job": job.id},
            stop_after_batches=batches_done + 1,
            device=self.device,
        )
        if self.driver is not None:
            self.driver(self, job, args)
            eng, engine_label = None, "synthetic"
        else:
            from ..__main__ import _stream_batches

            eng, built = self._get_engine(job)
            _stream_batches(eng, args, purpose="fleet")
            engine_label = "built" if built else "cached"
        if job.state == COMPILING:
            job = self.store.transition(job.id, RUNNING,
                                        worker=self.worker_id,
                                        gen=self._unit_gen)
        prev_failing = int(job.progress.get("failing") or 0)
        ck = self._load_ckpt(job)
        progress = self._progress_from_ckpt(eng, ck)
        progress["engine"] = engine_label
        el = time.perf_counter() - t0
        device_count = int(job.spec.get("devices") or 0) or 1
        # one locked write: merge progress, reset the consecutive-
        # failure counter (this unit completed), renew the lease
        job = self.store.note_progress(
            job.id, self.worker_id, progress,
            gen=self._unit_gen,
            event_fields={
                "elapsed_s": round(el, 3),
                "seeds_per_sec": round(job.spec["batch"] / el, 1)
                if el > 0 else None,
                "device_count": device_count,
            })
        if progress["failing"] > prev_failing:
            # find-at-find-time: the event lands on the stream NOW,
            # while the job is still mid-flight — not at completion
            self.store.emit_job_event(
                job.id, "find", worker=self.worker_id,
                failing=progress["failing"],
                new_finds=progress["failing"] - prev_failing,
                batch=progress["batches_run"])
        print(
            f"unit {job.id}: batch {progress['batches_run']}"
            f"/{progress['batches_planned']}, "
            f"{progress['completed']} seeds total in {el:.1f}s, "
            f"engine {progress['engine']}, "
            f"{progress['failing']} failing so far",
            flush=True,
        )
        if ck and ck.get("done"):
            self._finalize(job)

    # -- engines -------------------------------------------------------------

    def _get_engine(self, job: Job) -> Tuple[object, bool]:
        """One live Engine per engine_key; the cache is flushed when the
        allocator moves to a different subkey group, so at most one
        compile family stays resident on the 1-core box."""
        if job.subkey != self._engine_subkey:
            self._engines.clear()
            self._engine_subkey = job.subkey
        key = engine_key(job.spec)
        eng = self._engines.get(key)
        if eng is not None:
            return eng, False
        from ..__main__ import _build_engine

        eng = _build_engine(spec_to_args(job.spec, device=self.device))
        self._engines[key] = eng
        return eng, True

    # -- checkpoint plumbing -------------------------------------------------

    def _load_ckpt(self, job: Job) -> Optional[dict]:
        """The FLEET's checkpoint reader is lenient by construction: a
        torn or schema-broken checkpoint (external corruption — the
        fsync'd atomic writes never produce one) is quarantined to
        `*.corrupt` and the job restarts its stream from batch 0,
        instead of wedging the farm in a refusal loop. The CLI's
        `--checkpoint` path keeps the strict loader — there the file
        was named deliberately and silence would throw away a hunt."""
        from ..runtime.checkpoint import CKPT_REQUIRED_KEYS, load_checkpoint

        path = self.store.ckpt_path(job.id)
        try:
            ck = load_checkpoint(path)
            if ck is not None and not CKPT_REQUIRED_KEYS <= ck.keys():
                missing = sorted(CKPT_REQUIRED_KEYS - ck.keys())
                raise ValueError(f"checkpoint missing keys {missing}")
        except (ValueError, json.JSONDecodeError) as exc:
            corrupt = path + ".corrupt"
            os.replace(path, corrupt)
            _LOG.error("job %s: checkpoint unreadable (%s) — quarantined "
                       "to %s", job.id, exc, corrupt)
            print(
                f"job {job.id}: checkpoint unreadable ({exc}) — "
                f"quarantined to {corrupt}; restarting the stream from "
                f"batch 0", flush=True,
            )
            return None
        return ck

    def _progress_from_ckpt(self, eng, ck: Optional[dict]) -> dict:
        if ck is None:
            return {"batches_run": 0, "batches_planned": None,
                    "completed": 0, "seeds_consumed": 0, "failing": 0,
                    "infra": 0, "abandoned": 0, "plateau": False,
                    "coverage_slots": None, "escalation": None}
        cov_slots = None
        if eng is not None and ck.get("cov_b64"):
            from ..runtime.coverage import decode_map

            cov_slots = int(
                decode_map(ck["cov_b64"], eng.config.cov_slots_log2).sum()
            )
        guided = ck.get("guided") or {}
        return {
            "batches_run": int(ck["batch"]),
            "batches_planned": int(ck["planned"]),
            "completed": int(ck["completed"]),
            "seeds_consumed": int(ck["seeds_consumed"]),
            "failing": len(ck["failing"]),
            "infra": len(ck["infra"]),
            "abandoned": len(ck["abandoned"]),
            "plateau": bool(ck.get("plateau", False)),
            "coverage_slots": cov_slots,
            # guided search state mirror (None for unguided jobs): the
            # escalation rung feeds `fleet status`/`queue` and the
            # scheduler's momentum read
            "escalation": (guided.get("bias") or {}).get("escalation"),
        }

    # -- finalization --------------------------------------------------------

    def _finalize_cancel(self, job: Job) -> None:
        ck = self._load_ckpt(job)
        report = self._report_from_ckpt(ck, "cancelled")
        self.store.transition(
            job.id, CANCELLED, result={"report": report, "finds": []},
            worker=self.worker_id, gen=self._unit_gen,
        )
        print(f"job {job.id}: cancelled "
              f"({report['completed']} seeds run)", flush=True)

    def _report_from_ckpt(self, ck: Optional[dict], stop_reason: str) -> dict:
        """The deterministic half of a job's result: everything here is
        a pure function of (fingerprint, seed schedule) — no wall
        times — so an interrupted+resumed job's report is byte-identical
        to an uninterrupted run's (asserted in tests and CI). Coverage
        slots are filled in by the caller when an engine exists to
        decode the map (cancel can land before any engine does)."""
        if ck is None:
            return {"batches_run": 0, "batches_planned": None,
                    "completed": 0, "seeds_consumed": 0, "failing": [],
                    "infra": [], "abandoned": 0, "plateau": False,
                    "coverage_slots": None, "stop_reason": stop_reason}
        report = {
            "batches_run": int(ck["batch"]),
            "batches_planned": int(ck["planned"]),
            "completed": int(ck["completed"]),
            "seeds_consumed": int(ck["seeds_consumed"]),
            "failing": sorted([int(s), int(c)] for s, c in ck["failing"]),
            "infra": sorted([int(s), int(c)] for s, c in ck["infra"]),
            "abandoned": len(ck["abandoned"]),
            "plateau": bool(ck.get("plateau", False)),
            "coverage_slots": None,
            "stop_reason": stop_reason,
        }
        if ck.get("guided"):
            # the (seed schedule, bias state) record rides the result:
            # a guided job is replayable from its result doc alone —
            # same contract as the checkpoint, surfaced to clients
            g = ck["guided"]
            report["guided"] = {
                "bias": g.get("bias"),
                "escalation": (g.get("bias") or {}).get("escalation"),
                "trail": g.get("trail", []),
            }
        return report

    def _finalize(self, job: Job, stop_reason: Optional[str] = None) -> None:
        ck = self._load_ckpt(job)
        if stop_reason is None:
            stop_reason = (
                "plateau" if (ck and ck.get("plateau")) else "exhausted"
            )
        report = self._report_from_ckpt(ck, stop_reason)
        failing = [(int(s), int(c)) for s, c in (ck["failing"] if ck else [])]
        if self.driver is None and ck and ck.get("cov_b64"):
            from ..runtime.coverage import decode_map

            eng, _built = self._get_engine(job)
            report["coverage_slots"] = int(
                decode_map(ck["cov_b64"], eng.config.cov_slots_log2).sum()
            )
        if job.state == QUEUED:
            # deadline hit before the first unit ever ran
            job = self.store.transition(job.id, COMPILING,
                                        worker=self.worker_id,
                                        gen=self._unit_gen)
        if job.state == COMPILING:
            job = self.store.transition(job.id, RUNNING,
                                        worker=self.worker_id,
                                        gen=self._unit_gen)
        if not failing:
            final = PLATEAUED if stop_reason == "plateau" else EXHAUSTED
            self.store.transition(
                job.id, final, result={"report": report, "finds": []},
                worker=self.worker_id, gen=self._unit_gen,
            )
            print(f"job {job.id}: {final} ({report['completed']} seeds, "
                  f"0 failing, stop={stop_reason})", flush=True)
            return
        job = self.store.transition(job.id, FOUND, progress={
            "failing": len(failing),
        }, worker=self.worker_id, gen=self._unit_gen)
        self.store.emit_job_event(
            job.id, "shrink_started", worker=self.worker_id,
            failing=len(failing))
        if self.driver is not None:
            # synthetic driver (chaos harness): exercise the found ->
            # shrunk -> filed lifecycle deterministically without an
            # engine — finds carry their repro line but are not filed
            # in the corpus (no EngineConfig exists to record)
            by_code: dict = {}
            for seed, code in failing:
                by_code.setdefault(int(code), []).append(int(seed))
            finds = [
                {"seed": seeds[0], "code": code,
                 "repro": repro_cmd(job.spec),
                 "note": "synthetic driver find (not filed)"}
                for code, seeds in sorted(by_code.items())
            ]
            self.store.emit_job_event(
                job.id, "shrink_done", worker=self.worker_id,
                finds=len(finds))
            job = self.store.transition(job.id, SHRUNK,
                                        worker=self.worker_id,
                                        gen=self._unit_gen)
            filed = 0
        else:
            eng, _built = self._get_engine(job)
            self._write_vtrace(job, eng, failing)
            finds = self._shrink_finds(job, eng, ck)
            self.store.emit_job_event(
                job.id, "shrink_done", worker=self.worker_id,
                finds=len(finds))
            job = self.store.transition(job.id, SHRUNK,
                                        worker=self.worker_id,
                                        gen=self._unit_gen)
            filed = self._file_finds(job, finds)
        self.store.transition(job.id, FILED, result={
            "report": report,
            "finds": finds,
            "corpus": self.store.corpus_path,
            "corpus_added": filed,
        }, worker=self.worker_id, gen=self._unit_gen)
        print(
            f"job {job.id}: filed {filed} corpus entr"
            f"{'y' if filed == 1 else 'ies'} from {len(failing)} failing "
            f"seeds (stop={stop_reason})", flush=True,
        )

    def _write_vtrace(self, job: Job, eng, failing: List[tuple]) -> None:
        """The third clock's fleet artifact: under MADSIM_TPU_XPROF=1 a
        job with finds gets its first failing seed's VIRTUAL-time
        Perfetto doc written to the store, so `/jobs/{id}/profile` can
        merge it (unshifted — simulated µs, never wall) with the host
        and device planes. Same observability contract as the span
        dump: failure here never takes the job down."""
        from ..perf import xprof

        if not xprof.enabled() or not failing:
            return
        try:
            from ..engine.replay import replay
            from ..engine.trace_export import trace_event_dict
            from ..runtime.atomicio import atomic_write_json

            seed = int(failing[0][0])
            rp = replay(eng, seed,
                        max_steps=int(job.spec.get("max_steps") or 10_000))
            doc = trace_event_dict(rp.trace, machine=job.spec["machine"],
                                   seed=seed,
                                   num_nodes=eng.machine.NUM_NODES)
            atomic_write_json(self.store.vtrace_path(job.id), doc)
        except Exception:
            _LOG.exception("job %s: virtual-trace export failed", job.id)

    # -- shrink + why + corpus ----------------------------------------------

    def _shrink_finds(self, job: Job, eng, ck: dict) -> List[dict]:
        """One representative per distinct fail code (the hunt CLI's
        dedup discipline), shrunk with the device-harvested provenance
        word seeding the candidate order, with `why`-style attribution
        decoded from the same word."""
        shrink_mod = importlib.import_module("madsim_tpu_torch.engine.shrink")
        from ..__main__ import fault_kinds_str

        spec = job.spec
        prov = {int(k): int(v) for k, v in (ck.get("prov") or {}).items()}
        esc_by_seed = {
            int(k): int(v)
            for k, v in ((ck.get("guided") or {})
                         .get("failing_escalation") or {}).items()
        }
        by_code: dict = {}
        for seed, code in ck["failing"]:
            by_code.setdefault(int(code), []).append(int(seed))
        reps = [(seeds[0], code) for code, seeds in sorted(by_code.items())]
        reps = reps[: spec["shrink_limit"]]
        finds: List[dict] = []
        for seed, code in reps:
            doc: dict = {"seed": seed, "code": code}
            # a guided find made under an escalated vocabulary only
            # reproduces under that vocabulary — shrink (and the filed
            # entry's config) start from the escalation step's engine
            shrink_eng = eng
            if esc_by_seed.get(seed):
                from ..search.guided import engine_for_escalation

                shrink_eng = engine_for_escalation(eng, esc_by_seed[seed])
                doc["escalation"] = esc_by_seed[seed]
            try:
                sr = shrink_mod.shrink(
                    shrink_eng, seed, max_steps=spec["max_steps"],
                    prov_word=prov.get(seed),
                )
            except ValueError as exc:
                # device-flagged but not reproducing on the host replay:
                # record the drift (itself a finding), keep the job going
                doc["error"] = str(exc)
                finds.append(doc)
                continue
            f = sr.shrunk.faults
            doc["note"] = sr.summary()
            doc["max_steps"] = sr.steps + 1
            doc["shrunk"] = sr.shrunk
            doc["repro"] = (
                f"python -m madsim_tpu_torch replay --machine {spec['machine']} "
                f"--seed {seed} --nodes {spec['nodes']} "
                f"--horizon {sr.shrunk.horizon_us / 1e6} "
                f"--queue {sr.shrunk.queue_capacity} "
                f"--faults {f.n_faults} --fault-tmax {f.t_max_us} "
                f"--loss {sr.shrunk.packet_loss_rate} "
                f"--max-steps {sr.steps} "
                f"--fault-kinds {fault_kinds_str(f)} "
                + ("--strict-restart " if f.strict_restart else "")
                + f"--rng-stream {sr.shrunk.rng_stream}"
            )
            if seed in prov:
                from ..engine.provenance import implicated

                att = implicated(shrink_eng, seed, prov[seed])
                doc["why"] = {
                    "prov_word": prov[seed],
                    "kinds": list(att.kinds),
                    "faults": [
                        {"index": ft.index, "kind": ft.kind_name,
                         "t_apply_us": ft.t_apply_us,
                         "t_undo_us": ft.t_undo_us, "target": ft.target}
                        for ft in att.faults
                    ],
                }
            finds.append(doc)
        return finds

    def _file_finds(self, job: Job, finds: List[dict]) -> int:
        """File each shrunk find as a corpus entry in the fleet corpus,
        carrying filed-by-job provenance in its meta (which
        `audit.record_entry` preserves alongside the environment
        fingerprint). Returns how many entries were added."""
        from ..engine import audit, corpus
        from ..models import build_machine

        added = 0
        with self.store._locked(".corpus"):
            entries = corpus.load(self.store.corpus_path)
            known = {e.key for e in entries}
            for doc in finds:
                sr_cfg = doc.pop("shrunk", None)
                if sr_cfg is None:
                    continue  # shrink refused (host-replay drift)
                entry = corpus.CorpusEntry(
                    machine=job.spec["machine"],
                    nodes=job.spec["nodes"],
                    seed=doc["seed"],
                    fail_code=doc["code"],
                    status=corpus.STATUS_OPEN,
                    config=sr_cfg,
                    max_steps=doc["max_steps"],
                    note=doc["note"],
                    meta={
                        "filed_by": {
                            "job": job.id,
                            "worker": self.worker_id,
                            "fingerprint_sha": job.fingerprint_sha,
                        },
                        "repro": doc["repro"],
                        **(
                            {"why_kinds": doc["why"]["kinds"]}
                            if "why" in doc else {}
                        ),
                    },
                )
                doc["corpus_key"] = list(entry.key)
                if entry.key in known:
                    doc["corpus_status"] = "duplicate"
                    continue
                entry, _trail = audit.record_entry(
                    entry, build_machine,
                    device="cpu" if self.device == "cpu" else None)
                known.add(entry.key)
                entries.append(entry)
                doc["corpus_status"] = "added"
                added += 1
            if added:
                corpus.save(self.store.corpus_path, entries)
        return added

    # -- failure taxonomy ----------------------------------------------------

    def _fail(self, job: Job, reason: str) -> None:
        """Deterministic refusal (fingerprint drift, contract
        violation): retrying cannot change the outcome, so the job goes
        straight to `failed` with the reason verbatim."""
        _LOG.error("job %s failed: %s", job.id, reason)
        print(f"job {job.id}: FAILED — {reason}", flush=True)
        job = self.store.get(job.id)
        if job.state in (QUEUED, COMPILING, RUNNING, FOUND, SHRUNK):
            self.store.transition(job.id, FAILED, error=reason,
                                  worker=self.worker_id,
                                  gen=self._unit_gen)

    @staticmethod
    def _is_oom(exc: BaseException) -> bool:
        return isinstance(exc, MemoryError) or any(
            m in str(exc) for m in _OOM_MARKERS
        )

    def _hard_failure(self, job: Job, exc: BaseException) -> None:
        """A worker-reported hard failure (engine raise, OOM) — the
        retryable class, unlike `_fail`'s deterministic refusals.
        OOM-class errors first get the lane-count backoff (halve lanes,
        re-derive the warm-compile subkey, record the degradation);
        everything else burns one poison attempt: requeue with
        exponential backoff, quarantine at the cap with exception +
        batch index + repro recorded."""
        err = f"{type(exc).__name__}: {exc}"
        _LOG.error("job %s unit failed: %s", job.id, err)
        batch_index = self.store._ckpt_batch(job.id)
        if self._is_oom(exc) and job.spec["batch"] > MIN_DEGRADED_BATCH:
            out = self.store.degrade_lanes(
                job.id, error=err, worker=self.worker_id,
                gen=self._unit_gen,
            )
            # the OOMing shape's engine may be the allocation itself —
            # drop the live cache before the smaller shape compiles
            self._engines.clear()
            self._engine_subkey = None
            print(
                f"job {job.id}: OOM-class failure ({err}); degraded "
                f"lanes {out.degraded[-1]['from_batch']} -> "
                f"{out.spec['batch']} and requeued (subkey re-derived, "
                f"checkpoint reset)", flush=True,
            )
            return
        out = self.store.record_death(
            job.id,
            reason="worker hard failure",
            worker=self.worker_id,
            error=err,
            batch_index=batch_index,
            max_attempts=self.max_attempts,
            backoff_base_s=self.backoff_base_s,
            gen=self._unit_gen,
        )
        if out is None:
            return  # raced a concurrent transition; nothing to record
        if out.state == QUARANTINED:
            print(
                f"job {job.id}: QUARANTINED after {out.attempt} "
                f"consecutive attempts — {err}\n"
                f"  died at batch index {out.quarantine['batch_index']}; "
                f"repro: {out.quarantine['repro']}", flush=True,
            )
        else:
            print(
                f"job {job.id}: attempt {out.attempt}/"
                f"{self.max_attempts} failed ({err}); requeued with "
                f"backoff", flush=True,
            )
