"""The fleet's flight recorder — an append-only job-lifecycle event log.

One ``jobs/<id>.events.jsonl`` per job: a typed, `seq`-monotonic,
wall-stamped record of every state-machine transition plus the
batch/find/shrink milestones in between. The store emits events at the
same call sites that already hold the per-job lock, so the log is the
authoritative *ordered* history of a job — what the 30 s long-poll can
only sample, the log records.

Three consumers ride on it (all torch-free, all host-side):

* **push, not poll** — `GET /jobs/{id}/events?since=SEQ` tails the log
  as Server-Sent Events, so a CI caller sees `find` at find-time;
* **cross-process trace correlation** — the job id doubles as a trace
  id; `timeline_doc` merges these lifecycle events with the worker's
  span dump into one Perfetto timeline spanning both processes;
* **SLO metrics** — `/metrics` histograms (queue wait, time to first
  find, lane-seconds and batches per find) are pure deltas over this
  log, computed at scrape time, never stored.

Durability discipline: records are appended with
`runtime.atomicio.append_text` (fsync'd, newline-healing). Appends are
deliberately NOT atomic — a crash mid-append leaves a torn line in the
real file. `read_events` skips torn records, `fleet fsck` verdicts the
file `torn-tail` without quarantining (same policy as stats feeds),
and `last_seq` re-anchors past the damage, so the sequence stays
monotonic across any number of mid-append deaths. That torn-tolerant
JSONL-not-a-DB shape is the point: the log must survive exactly the
crashes the fleet is built to inject.

Determinism: events are observability-class. Nothing here feeds specs,
fingerprints, seed schedules, the corpus, or job reports — a run with
events disabled (``MADSIM_TPU_FLEET_EVENTS=0``) produces byte-identical
reports to one with events enabled.
"""

# madsim: allow-file(D001) — wall timestamps ARE this module's contract
# (exactly like perf/recorder.py): every event carries the host wall
# clock so operators can correlate the log with CI logs, Prometheus
# scrapes and worker Perfetto dumps. No timestamp ever reaches a spec,
# a fingerprint, or a seed schedule.

from __future__ import annotations

import json
import os
import time
from typing import Dict, Iterator, List, Optional

from ..runtime.atomicio import append_text

#: the closed event taxonomy (ARCHITECTURE.md "Fleet observability").
#: Lifecycle events are named after the state-machine states they
#: enter; milestone events mark progress inside a state.
EVENT_TYPES = (
    # lifecycle (state entered)
    "submitted", "queued", "compiling", "running", "plateaued",
    "exhausted", "found", "shrunk", "filed", "cancelled", "failed",
    "quarantined",
    # lease / scheduling milestones ("fenced" = a write from a dead
    # lease generation was rejected and counted, never merged)
    "leased", "requeued", "degraded", "cancel_requested", "fenced",
    # progress milestones
    "batch_done", "plateau", "find", "shrink_started", "shrink_done",
)

#: lifecycle events that end a job (mirrors store.TERMINAL)
TERMINAL_EVENTS = frozenset({
    "plateaued", "exhausted", "filed", "cancelled", "failed",
    "quarantined",
})

#: lifecycle events that open a queue-wait interval (until next lease)
_QUEUE_EVENTS = ("submitted", "requeued")

#: events that open a named lifecycle slice in the merged timeline
_SLICE_OPENERS = frozenset({
    "leased", "compiling", "running", "plateaued", "exhausted", "found",
    "shrunk", "filed", "cancelled", "failed", "quarantined",
})

_TAIL_BYTES = 8192


def enabled() -> bool:
    """Event emission kill-switch. On by default; ``=0`` disables every
    append (the determinism acceptance test runs both ways and asserts
    byte-identical job reports)."""
    return os.environ.get("MADSIM_TPU_FLEET_EVENTS", "1") != "0"


def last_seq(path: str) -> int:
    """Highest `seq` recorded in the log (0 when absent/empty). Reads
    only the file tail and parses backwards, skipping torn records, so
    a mid-append crash never resets the sequence."""
    try:
        with open(path, "rb") as f:
            f.seek(0, os.SEEK_END)
            size = f.tell()
            f.seek(max(0, size - _TAIL_BYTES))
            tail = f.read().decode("utf-8", errors="replace")
    except OSError:
        return 0
    for line in reversed(tail.splitlines()):
        try:
            rec = json.loads(line)
            return int(rec["seq"])
        except (ValueError, KeyError, TypeError):
            continue
    return 0


def tail_event(path: str) -> Optional[dict]:
    """The last parseable event record (None when absent/empty) — a
    tail read, cheap enough for per-job queue summaries."""
    try:
        with open(path, "rb") as f:
            f.seek(0, os.SEEK_END)
            size = f.tell()
            f.seek(max(0, size - _TAIL_BYTES))
            tail = f.read().decode("utf-8", errors="replace")
    except OSError:
        return None
    for line in reversed(tail.splitlines()):
        try:
            rec = json.loads(line)
        except ValueError:
            continue
        if isinstance(rec, dict) and "seq" in rec:
            return rec
    return None


def emit_event(path: str, type_: str, *, job: Optional[str] = None,
               worker: Optional[str] = None, **fields) -> dict:
    """Append one event record and return it. `seq` continues from the
    log's current tail; `ts` is the host wall clock (observability
    only). Compact one-line JSON, fsync'd append."""
    assert type_ in EVENT_TYPES, f"unknown event type {type_!r}"
    rec: Dict[str, object] = {
        "seq": last_seq(path) + 1,
        "ts": round(time.time(), 3),
        "type": type_,
    }
    if job is not None:
        rec["job"] = job
    if worker is not None:
        rec["worker"] = worker
    for k, v in sorted(fields.items()):
        if v is not None:
            rec[k] = v
    append_text(path, json.dumps(rec, sort_keys=True,
                                 separators=(",", ":")) + "\n")
    return rec


def read_events(path: str, since: int = 0) -> List[dict]:
    """All events with `seq > since`, in file order. Torn or
    unparseable lines are skipped (they are expected append damage,
    never an error), as are records missing a usable `seq`."""
    out: List[dict] = []
    try:
        with open(path, "r") as f:
            lines = f.read().splitlines()
    except OSError:
        return out
    for line in lines:
        try:
            rec = json.loads(line)
            seq = int(rec["seq"])
        except (ValueError, KeyError, TypeError):
            continue
        if seq > since:
            out.append(rec)
    return out


def iter_jsonl(path: str) -> Iterator[dict]:
    """Lenient JSONL reader for sibling feeds (span dumps): yields each
    parseable dict line, skips torn records."""
    try:
        with open(path, "r") as f:
            lines = f.read().splitlines()
    except OSError:
        return
    for line in lines:
        try:
            rec = json.loads(line)
        except ValueError:
            continue
        if isinstance(rec, dict):
            yield rec


# -- SLO derivation (scrape-time deltas; nothing is ever stored) ----------


def slo_observations(events: List[dict]) -> Dict[str, float]:
    """Per-job SLO observations derived purely from event deltas.

    * ``queue_wait_s``      — first `submitted`/`requeued` → next `leased`
    * ``time_to_first_find_s`` — `submitted` → first `find`
    * ``lane_seconds_per_find`` — Σ batch elapsed × device_count up to
      the first find (the lane-time the find cost)
    * ``batches_per_find``  — batches dispatched up to the first find

    Keys are present only when the underlying events exist, so a job
    with no finds contributes nothing to the find histograms.
    """
    obs: Dict[str, float] = {}
    submitted_ts: Optional[float] = None
    waiting_since: Optional[float] = None
    lane_s = 0.0
    batches = 0
    for ev in events:
        t, ts = ev.get("type"), ev.get("ts")
        if not isinstance(ts, (int, float)):
            continue
        if t == "submitted":
            submitted_ts = submitted_ts if submitted_ts is not None else ts
            waiting_since = waiting_since if waiting_since is not None else ts
        elif t == "requeued":
            waiting_since = ts
        elif t == "leased":
            if waiting_since is not None and "queue_wait_s" not in obs:
                obs["queue_wait_s"] = max(0.0, ts - waiting_since)
            waiting_since = None
        elif t == "batch_done":
            batches += 1
            lane_s += (float(ev.get("elapsed_s") or 0.0)
                       * max(1, int(ev.get("device_count") or 1)))
        elif t == "find" and "time_to_first_find_s" not in obs:
            if submitted_ts is not None:
                obs["time_to_first_find_s"] = max(0.0, ts - submitted_ts)
            obs["lane_seconds_per_find"] = lane_s
            obs["batches_per_find"] = float(max(1, batches))
    return obs


# -- cross-process timeline merge (Perfetto / chrome://tracing) -----------


def _us(ts: float, t_base: float) -> int:
    return int(round((ts - t_base) * 1e6))


def timeline_doc(job_doc: dict, events: List[dict],
                 span_records: List[dict]) -> dict:
    """One Perfetto timeline per job across the serve/worker boundary.

    pid 0 is the control plane's view: lifecycle slices tiling
    submit → terminal (queue waits named ``queue_wait``, every other
    slice named after the state), per-batch slices reconstructed from
    `batch_done` deltas, shrink bracketed by its start/done events, and
    every event as an instant. pid 1..N are the workers' `PerfRecorder`
    span dumps, re-anchored from their wall_t0 onto the shared wall
    clock — the job id is the trace id that joins the two processes.

    The summary's ``attribution`` is the fraction of the job's wall
    clock covered by named lifecycle slices (the ≥90% bar, now
    spanning both processes).
    """
    traceEvents: List[dict] = []
    job_id = job_doc.get("id", "?")
    ts_events = [e for e in events if isinstance(e.get("ts"), (int, float))]
    if not ts_events:
        return {"traceEvents": [], "displayTimeUnit": "ms",
                "madsim_fleet_timeline_summary": {
                    "job": job_id, "attribution": 0.0, "wall_s": 0.0,
                    "events": 0, "worker_spans": 0}}
    t_base = ts_events[0]["ts"]
    t_end = ts_events[-1]["ts"]

    traceEvents.append({"ph": "M", "pid": 0, "tid": 0,
                        "name": "process_name",
                        "args": {"name": "fleet control plane"}})
    traceEvents.append({"ph": "M", "pid": 0, "tid": 0,
                        "name": "thread_name", "args": {"name": "lifecycle"}})
    traceEvents.append({"ph": "M", "pid": 0, "tid": 1,
                        "name": "thread_name", "args": {"name": "progress"}})

    # lifecycle slices: tile the wall clock with named intervals
    slices: List[tuple] = []  # (start_ts, end_ts, name, args)
    cursor: Optional[tuple] = None  # (start_ts, name, args)
    for ev in ts_events:
        t, ts = ev["type"], ev["ts"]
        if t in _QUEUE_EVENTS:
            nxt = ("queue_wait", {"cause": t})
        elif t in _SLICE_OPENERS:
            # a lease or a state-entry event opens the next interval
            # ("queued" is folded into the queue_wait its "submitted"
            # or "requeued" sibling already opened)
            nxt = (t, {k: v for k, v in ev.items()
                       if k not in ("seq", "ts", "type", "job")})
        else:
            nxt = None
        if nxt is not None:
            if cursor is not None:
                slices.append((cursor[0], ts, cursor[1], cursor[2]))
            cursor = (ts, nxt[0], nxt[1])
            if t in TERMINAL_EVENTS:
                cursor = None
    if cursor is not None:
        slices.append((cursor[0], t_end, cursor[1], cursor[2]))
    for start, end, name, args in slices:
        traceEvents.append({
            "ph": "X", "pid": 0, "tid": 0, "name": name, "cat": "lifecycle",
            "ts": _us(start, t_base), "dur": max(1, _us(end, t_base) -
                                                 _us(start, t_base)),
            "args": dict(args, trace_id=job_id)})

    # progress thread: batch slices (reconstructed from elapsed_s),
    # shrink bracket, and every event as an instant
    shrink_start: Optional[float] = None
    for ev in ts_events:
        t, ts = ev["type"], ev["ts"]
        if t == "batch_done":
            el = float(ev.get("elapsed_s") or 0.0)
            traceEvents.append({
                "ph": "X", "pid": 0, "tid": 1, "cat": "progress",
                "name": f"batch {ev.get('batch', '?')}",
                "ts": _us(ts - el, t_base), "dur": max(1, int(el * 1e6)),
                "args": {k: ev[k] for k in
                         ("seeds_per_sec", "coverage_slots", "escalation",
                          "device_count") if k in ev}})
        elif t == "shrink_started":
            shrink_start = ts
        elif t == "shrink_done" and shrink_start is not None:
            traceEvents.append({
                "ph": "X", "pid": 0, "tid": 1, "cat": "progress",
                "name": "shrink", "ts": _us(shrink_start, t_base),
                "dur": max(1, _us(ts, t_base) - _us(shrink_start, t_base)),
                "args": {k: ev[k] for k in ("finds", "shrunk") if k in ev}})
            shrink_start = None
        traceEvents.append({
            "ph": "i", "pid": 0, "tid": 1, "name": t, "cat": "event",
            "ts": _us(ts, t_base), "s": "t",
            "args": {"seq": ev.get("seq"), "worker": ev.get("worker")}})

    # worker span dumps, re-anchored via their wall_t0
    n_spans = 0
    workers: Dict[str, int] = {}
    for rec in span_records:
        wall_t0 = rec.get("wall_t0")
        if not isinstance(wall_t0, (int, float)):
            continue
        wid = str(rec.get("worker", "worker"))
        is_new = wid not in workers
        pid = workers.setdefault(wid, 1 + len(workers))
        offset = _us(wall_t0, t_base)
        if is_new:
            traceEvents.append({"ph": "M", "pid": pid, "tid": 0,
                                "name": "process_name",
                                "args": {"name": f"worker {wid}"}})
            traceEvents.append({"ph": "M", "pid": pid, "tid": 0,
                                "name": "thread_name",
                                "args": {"name": "host"}})
        for sp in rec.get("spans") or []:
            try:
                if sp.get("dur") is None:
                    # recorder instants (e.g. the xprof ``madsim.sync``
                    # clock-sync markers) ride along as ph "i" so the
                    # /profile merge can align the device clock on them
                    traceEvents.append({
                        "ph": "i", "s": "t", "pid": pid, "tid": 0,
                        "cat": "worker", "name": str(sp["name"]),
                        "ts": offset + int(sp["ts"]),
                        "args": dict(sp.get("args") or {},
                                     trace_id=job_id)})
                else:
                    traceEvents.append({
                        "ph": "X", "pid": pid, "tid": 0, "cat": "worker",
                        "name": str(sp["name"]),
                        "ts": offset + int(sp["ts"]),
                        "dur": max(1, int(sp["dur"])),
                        "args": dict(sp.get("args") or {},
                                     trace_id=job_id)})
                n_spans += 1
            except (KeyError, TypeError, ValueError):
                continue

    wall_s = max(0.0, t_end - t_base)
    covered = _interval_union_s(
        [(s, e) for s, e, _n, _a in slices]) if slices else 0.0
    attribution = 1.0 if wall_s <= 0 else min(1.0, covered / wall_s)
    return {
        "traceEvents": traceEvents,
        "displayTimeUnit": "ms",
        "madsim_fleet_timeline_summary": {
            "job": job_id,
            "trace_id": job_id,
            "attribution": round(attribution, 4),
            "wall_s": round(wall_s, 3),
            "events": len(ts_events),
            "worker_spans": n_spans,
            "state": job_doc.get("state"),
        },
    }


def _interval_union_s(intervals: List[tuple]) -> float:
    total = 0.0
    last_end = None
    for start, end in sorted(intervals):
        if last_end is None or start > last_end:
            total += max(0.0, end - start)
            last_end = end
        elif end > last_end:
            total += end - last_end
            last_end = end
    return total
