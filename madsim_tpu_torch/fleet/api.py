"""The fleet control plane — a torch-free stdlib HTTP API over the store.

Extends the `serve --service stats` pattern (plain `http.server`,
read-only files, no sim/torch imports) to a read/write job API::

    POST   /jobs             submit {"spec": {...}, "priority", "deadline_s",
                             "tenant"} (a bare spec object also works).
                             Admission-controlled: per-tenant token-bucket
                             rate limits ($MADSIM_TPU_FLEET_RATE_LIMIT /
                             _RATE_BURST), a queue-depth cap
                             ($MADSIM_TPU_FLEET_MAX_QUEUE_DEPTH) and a
                             load-shed threshold
                             ($MADSIM_TPU_FLEET_SHED_DEPTH) answer 429
                             with a `Retry-After` header and a
                             `retry_after_s` body field instead of
                             accepting work the farm can't absorb — the
                             write queue forms in the clients' seeded-
                             jitter retry loops, so every 201 the server
                             ever sent stays durable (zero accepted-job
                             loss).
    GET    /jobs             = /queue
    GET    /queue            state counts + per-job summaries
    GET    /jobs/{id}        full job doc + live feed (?feed=N batch rows
                             from the job's StatsEmitter JSONL; ?wait=S
                             long-polls — the response is held until the
                             job document or its feed changes, so
                             watchers stop busy-polling)
    GET    /jobs/{id}/result find + shrunk repro + `why` attribution
                             (409 until the job reaches a terminal state)
    GET    /jobs/{id}/events the job-lifecycle event log. Push, not
                             poll: a client sending `Accept:
                             text/event-stream` gets Server-Sent Events
                             tailed live from the log (?since=SEQ
                             resumes; the stream ends with `event: end`
                             at a terminal state, or closes at the
                             ?wait=S / WAIT_CAP_S window for the client
                             to reconnect). Plain GET returns the same
                             records as a one-shot JSON document
                             (?since=SEQ filter, ?wait=S parks until
                             new events arrive — same deadline
                             machinery as the /jobs/{id} long-poll).
    GET    /jobs/{id}/timeline  the merged Perfetto timeline: control-
                             plane lifecycle events + the worker's
                             PerfRecorder span dumps, joined by the job
                             id as trace id (queue-wait, compile,
                             per-batch dispatch, shrink — one picture
                             across both processes).
    GET    /jobs/{id}/profile   the three-clock merge: the timeline's
                             host plane + the worker's device-profile
                             dump and failing-lane virtual trace
                             (present when the worker ran under
                             MADSIM_TPU_XPROF=1), aligned by
                             `perf/xprof.py` clock-sync markers.
    DELETE /jobs/{id}        cancel (queued dies now; running at the next
                             unit boundary)
    GET    /metrics          Prometheus: fleet gauges (job states,
                             requeues/lease-reclaims/quarantine) +
                             every job's own StatsEmitter textfile,
                             label-namespaced
    GET    /healthz          liveness + store integrity (read-only fsck
                             scan: corrupt files, queue depth, stale
                             leases, quarantined jobs; 503 when the
                             store needs `fleet fsck` — and while the
                             farm is load-shedding writes, so a probe
                             sees the degradation). Also surfaces the
                             contention plane: per-worker claim-conflict
                             and fenced-write counts, queue-log lag, and
                             the shed state.

    While load-shedding, GET /jobs and /queue serve a degraded summary
    straight from the queue index (no per-job doc reads, no momentum) —
    reads stay cheap exactly when the farm is drowning.

Everything the API serves is an atomic-rename artifact (job docs,
StatsEmitter snapshots), so no response can observe a torn write — and
because the store is the wire, the API keeps answering while a worker
is mid-dispatch (they share only the filesystem).

`FleetAPI.handle()` is the whole router, separated from the socket so
handler tests run against a store in a tmpdir with zero networking.
"""

from __future__ import annotations

import http.server
import json
import logging
import math
import os
import re
import threading
import time
from typing import Callable, Dict, Iterator, List, Optional, Tuple

from . import events as fleet_events
from . import httpd
from .store import CorruptJobFile, JobStore, STATES, TERMINAL

_LOG = logging.getLogger("madsim_tpu_torch.fleet.api")

_JOB_RE = re.compile(
    r"^/jobs/([A-Za-z0-9._-]+)(/result|/events|/timeline|/profile)?$")


def _json(status: int, doc) -> Tuple[int, str, bytes]:
    body = (json.dumps(doc, indent=1, sort_keys=True) + "\n").encode()
    return status, "application/json", body


def _err(status: int, msg: str) -> Tuple[int, str, bytes]:
    return _json(status, {"error": msg})


def _query_int(query: str, key: str, default: int) -> int:
    m = re.search(rf"(?:^|&){key}=(\d+)", query)
    return int(m.group(1)) if m else default


def _query_wait(query: str, cap: float) -> float:
    m = re.search(r"(?:^|&)wait=([0-9.]+)", query)
    if not m:
        return 0.0
    try:
        return min(float(m.group(1)), cap)
    except ValueError:
        return 0.0


def _sse_frame(ev: dict) -> bytes:
    """One Server-Sent-Events frame per event record: `id` carries the
    seq (the client's reconnect cursor), `event` the type, `data` the
    full record."""
    data = json.dumps(ev, sort_keys=True, separators=(",", ":"))
    return (f"id: {ev.get('seq', 0)}\nevent: {ev.get('type', 'event')}\n"
            f"data: {data}\n\n").encode()


def _job_summary(job) -> dict:
    return {
        "id": job.id,
        "state": job.state,
        "machine": job.spec["machine"],
        "seeds": job.spec["seeds"],
        "priority": job.priority,
        "subkey": job.subkey,
        "cancel_requested": job.cancel_requested,
        "batches_run": job.progress.get("batches_run", 0),
        "batches_planned": job.progress.get("batches_planned"),
        "failing": job.progress.get("failing", 0),
        # live search state (the scheduler's inputs, surfaced): the
        # plateau verdict, the cumulative slots-hit count, and — for
        # guided jobs — the current escalation rung
        "plateau": bool(job.progress.get("plateau", False)),
        "coverage_slots": job.progress.get("coverage_slots"),
        "guided": bool(job.spec.get("guided", False)),
        "escalation": job.progress.get("escalation"),
        # worker liveness for `fleet top`: who holds the lease and when
        # it lapses (expired + non-terminal = the sweep's next customer)
        "worker": (job.lease or {}).get("worker"),
        "lease_expires_ts": (job.lease or {}).get("expires_ts"),
        "attempt": job.attempt,
    }


class _FileCache:
    """Parsed-artifact cache keyed by (mtime_ns, size): a /metrics
    scrape of an unchanged store does ZERO re-parses — the per-job
    Prometheus textfiles and event logs are only re-read when their
    stat signature moves. `parses` counts loader invocations (the unit
    tests pin it)."""

    def __init__(self) -> None:
        self._entries: Dict[str, tuple] = {}
        self.parses = 0

    def get(self, path: str, loader: Callable[[str], object]):
        try:
            st = os.stat(path)
        except OSError:
            self._entries.pop(path, None)
            return None
        key = (st.st_mtime_ns, st.st_size)
        ent = self._entries.get(path)
        if ent is not None and ent[0] == key:
            return ent[1]
        self.parses += 1
        value = loader(path)
        self._entries[path] = (key, value)
        return value


def _parse_prom(path: str) -> List[tuple]:
    """Pre-parse a Prometheus textfile into (kind, metric_name, line)
    rows; `# TYPE` dedup across files happens at render time."""
    rows: List[tuple] = []
    try:
        with open(path) as f:
            text = f.read()
    except OSError:
        return rows
    for line in text.splitlines():
        if line.startswith("# TYPE "):
            rows.append(("type", line.split()[2], line))
        elif line.startswith("#"):
            continue
        else:
            rows.append(("metric", None, line))
    return rows


class _TokenBucket:
    """One tenant's admission budget: `rate` tokens/s refill up to
    `burst`. `take()` spends one token or returns how long until one
    exists — that number IS the Retry-After the client is told."""

    def __init__(self, rate: float, burst: float):
        self.rate = float(rate)
        self.burst = float(burst)
        self.tokens = float(burst)
        self.ts = time.monotonic()  # madsim: allow(D001)

    def take(self) -> float:
        now = time.monotonic()  # madsim: allow(D001)
        self.tokens = min(self.burst,
                          self.tokens + (now - self.ts) * self.rate)
        self.ts = now
        if self.tokens >= 1.0:
            self.tokens -= 1.0
            return 0.0
        return (1.0 - self.tokens) / self.rate


class FleetAPI:
    #: Retry-After answered while shedding or depth-capped — depth
    #: recovers at drain speed, not token-refill speed, so the hint is
    #: a flat "come back soon" rather than a bucket computation
    SHED_RETRY_S = 1.0

    def __init__(self, store: JobStore):
        self.store = store
        self._prom_cache = _FileCache()
        self._events_cache = _FileCache()
        self._bench_cache = _FileCache()
        # -- admission control (all knobs default OFF: unset/0 keeps
        # the pre-admission behavior byte-for-byte) -----------------------
        env = os.environ.get
        self.rate_limit = float(env("MADSIM_TPU_FLEET_RATE_LIMIT") or 0)
        self.rate_burst = (float(env("MADSIM_TPU_FLEET_RATE_BURST") or 0)
                           or max(self.rate_limit, 1.0))
        self.max_queue_depth = int(
            env("MADSIM_TPU_FLEET_MAX_QUEUE_DEPTH") or 0)
        self.shed_depth = int(env("MADSIM_TPU_FLEET_SHED_DEPTH") or 0)
        self._admission_lock = threading.Lock()
        self._buckets: Dict[str, _TokenBucket] = {}
        #: tenant -> {admitted, rate_limited, depth_limited, shed}
        self._admission: Dict[str, Dict[str, int]] = {}
        self.shedding = False
        self.sheds_total = 0

    # -- admission -----------------------------------------------------------

    def _queue_depth(self) -> int:
        """Backlog from the queue index, not the docs: admission stays
        O(1) per request even at a 10k-job store."""
        return sum(1 for row in self.store.queue_rows().values()
                   if row.get("state") not in TERMINAL)

    def _update_shed(self, depth: int) -> bool:
        """Enter shed at depth >= $MADSIM_TPU_FLEET_SHED_DEPTH, leave
        as soon as the backlog drains below it. 0/unset never sheds."""
        with self._admission_lock:
            want = bool(self.shed_depth) and depth >= self.shed_depth
            if want and not self.shedding:
                self.sheds_total += 1
            self.shedding = want
            return want

    def _count_admission(self, tenant: str, outcome: str) -> None:
        with self._admission_lock:
            per = self._admission.setdefault(tenant, {})
            per[outcome] = per.get(outcome, 0) + 1

    def _reject(self, tenant: str, reason: str, retry_after_s: float,
                depth: int) -> Tuple[int, str, bytes]:
        self._count_admission(tenant, reason)
        return _json(429, {
            "error": f"admission refused ({reason}); retry after "
                     f"{retry_after_s:g}s",
            "reason": reason,
            "tenant": tenant,
            "queue_depth": depth,
            "retry_after_s": round(retry_after_s, 3),
        })

    def _job_events(self, job_id: str) -> List[dict]:
        """The job's event log via the stat-keyed cache (scrapes and
        queue renders re-parse only what changed)."""
        evs = self._events_cache.get(
            self.store.events_path(job_id),
            lambda p: fleet_events.read_events(p))
        return evs if isinstance(evs, list) else []

    # -- router --------------------------------------------------------------

    def handle(self, method: str, path: str,
               body: Optional[bytes] = None) -> Tuple[int, str, bytes]:
        path, _, query = path.partition("?")
        path = path.rstrip("/") or "/"
        try:
            if path == "/healthz" and method == "GET":
                return self._healthz()
            if path == "/metrics" and method == "GET":
                return 200, "text/plain; version=0.0.4", self._metrics()
            if path in ("/queue", "/jobs") and method == "GET":
                return self._queue()
            if path == "/jobs" and method == "POST":
                return self._submit(body)
            m = _JOB_RE.match(path)
            if m:
                job_id, sub = m.group(1), m.group(2) or ""
                if sub == "/result" and method == "GET":
                    return self._result(job_id)
                if sub == "/events" and method == "GET":
                    return self._events(job_id, query)
                if sub == "/timeline" and method == "GET":
                    return self._timeline(job_id)
                if sub == "/profile" and method == "GET":
                    return self._profile(job_id)
                if not sub and method == "GET":
                    return self._status(job_id, query)
                if not sub and method == "DELETE":
                    return self._cancel(job_id)
            return _err(
                404,
                "routes: GET /queue /jobs/{id} /jobs/{id}/result "
                "/jobs/{id}/events /jobs/{id}/timeline /jobs/{id}/profile "
                "/metrics /healthz; POST /jobs; DELETE /jobs/{id}",
            )
        except KeyError as exc:
            return _err(404, str(exc.args[0]) if exc.args else "not found")
        except ValueError as exc:
            return _err(400, str(exc))
        except CorruptJobFile as exc:
            # a torn/garbled document on disk is an operator problem,
            # never an unhandled 500: name the file and the fix
            return _err(503, str(exc))

    # -- endpoints -----------------------------------------------------------

    def _submit(self, body: Optional[bytes]) -> Tuple[int, str, bytes]:
        try:
            doc = json.loads((body or b"").decode() or "{}")
        except json.JSONDecodeError as exc:
            return _err(400, f"body is not JSON: {exc}")
        if not isinstance(doc, dict):
            return _err(400, "body must be a JSON object")
        tenant = str(doc.get("tenant") or "default")
        spec = doc.get("spec", None)
        if spec is None:
            # bare-spec convenience: {"machine": ...} without the wrapper
            spec = {k: v for k, v in doc.items()
                    if k not in ("priority", "deadline_s", "tenant")}
        # admission, cheapest check first, all reads from the index:
        # shed beats depth beats rate (a shedding farm refuses even
        # tenants with tokens to spend)
        depth = self._queue_depth()
        if self._update_shed(depth):
            return self._reject(tenant, "shed", self.SHED_RETRY_S, depth)
        if self.max_queue_depth and depth >= self.max_queue_depth:
            return self._reject(tenant, "depth_limited",
                                self.SHED_RETRY_S, depth)
        if self.rate_limit:
            with self._admission_lock:
                bucket = self._buckets.get(tenant)
                if bucket is None:
                    bucket = self._buckets[tenant] = _TokenBucket(
                        self.rate_limit, self.rate_burst)
                wait = bucket.take()
            if wait > 0:
                return self._reject(tenant, "rate_limited",
                                    max(wait, 0.001), depth)
        self._count_admission(tenant, "admitted")
        job = self.store.submit(
            spec,
            priority=int(doc.get("priority", 0) or 0),
            deadline_s=doc.get("deadline_s"),
        )
        return _json(201, {"id": job.id, "state": job.state,
                           "subkey": job.subkey})

    def _farm(self, *, degraded: bool) -> dict:
        """The contention plane for `fleet top` and /healthz: per-worker
        claim-conflict / fenced-write counts (the workers mirror them to
        workers/<id>.json), the queue-log lag, and the shed state. The
        O(n) lag scan is skipped while degraded — that's the whole
        point of shedding."""
        farm: dict = {
            "shed": self.shedding,
            "workers": self.store.read_worker_stats(),
        }
        if not degraded:
            farm["queue_log_lag"] = self.store.queue_log_lag()
        return farm

    def _queue(self) -> Tuple[int, str, bytes]:
        if self._update_shed(self._queue_depth()):
            # degraded read: the queue index IS the response — one log
            # read, zero per-job doc/event/momentum I/O
            rows = self.store.queue_rows()
            counts: Dict[str, int] = {}
            for row in rows.values():
                s = row.get("state") or "?"
                counts[s] = counts.get(s, 0) + 1
            return _json(200, {
                "degraded": True,
                "counts": counts,
                "jobs": [
                    {"id": jid, "state": row.get("state"),
                     "worker": row.get("worker")}
                    for jid, row in sorted(rows.items())
                ],
                "farm": self._farm(degraded=True),
            })
        from .scheduler import job_momentum

        jobs = self.store.list()
        summaries = []
        for j in jobs:
            s = _job_summary(j)
            tail = fleet_events.tail_event(self.store.events_path(j.id))
            if tail:
                s["last_event"] = {k: tail.get(k)
                                   for k in ("seq", "ts", "type", "worker")}
            # the scheduler's live-search read, surfaced for `fleet top`
            s["momentum"] = job_momentum(self.store, j)
            summaries.append(s)
        return _json(200, {
            "counts": {s: n for s, n in self.store.counts().items() if n},
            "jobs": summaries,
            "farm": self._farm(degraded=False),
        })

    #: ?wait=S ceiling — a long-poll never parks a server thread
    #: longer than this (clients re-issue; the stdlib server is
    #: threading, so parked watchers don't block other requests)
    WAIT_CAP_S = 30.0
    #: change-detection poll cadence while a ?wait request is parked
    WAIT_TICK_S = 0.2

    def _state_token(self, job_id: str) -> tuple:
        """A cheap change token for (job doc, stats feed): file sizes +
        mtimes. Both artifacts are atomic-rename writes, so any state
        change moves the token."""
        token = []
        for path in (self.store.job_path(job_id),
                     self.store.stats_base(job_id) + ".jsonl"):
            try:
                st = os.stat(path)
                token.append((st.st_mtime_ns, st.st_size))
            except OSError:
                token.append(None)
        return tuple(token)

    def _status(self, job_id: str, query: str) -> Tuple[int, str, bytes]:
        job = self.store.get(job_id)
        feed_n = 20
        m = re.search(r"(?:^|&)feed=(\d+)", query)
        if m:
            feed_n = min(int(m.group(1)), 1000)
        wait_s = 0.0
        m = re.search(r"(?:^|&)wait=([0-9.]+)", query)
        if m:
            try:
                wait_s = min(float(m.group(1)), self.WAIT_CAP_S)
            except ValueError:
                wait_s = 0.0
        changed = None
        if wait_s > 0 and not job.terminal:
            # long-poll: park until the job document or its stats feed
            # changes (atomic-rename artifacts — no torn observation),
            # or the window elapses. Terminal jobs answer immediately:
            # nothing will ever change again.
            start_token = self._state_token(job_id)
            deadline = time.monotonic() + wait_s  # madsim: allow(D001)
            changed = False
            while time.monotonic() < deadline:  # madsim: allow(D001)
                time.sleep(self.WAIT_TICK_S)  # madsim: allow(D001)
                if self._state_token(job_id) != start_token:
                    changed = True
                    break
            job = self.store.get(job_id)  # freshest doc after the park
        doc = job.to_dict()
        doc["feed"] = self.store.read_feed(job_id, last=feed_n)
        if changed is not None:
            doc["wait"] = {"waited": True, "changed": changed}
        return _json(200, doc)

    def _result(self, job_id: str) -> Tuple[int, str, bytes]:
        job = self.store.get(job_id)
        if job.state not in TERMINAL:
            return _err(
                409,
                f"job {job_id} is {job.state}; results exist once the job "
                f"reaches a terminal state ({', '.join(sorted(TERMINAL))})",
            )
        return _json(200, {
            "id": job.id,
            "state": job.state,
            "error": job.error,
            "result": job.result,
        })

    # -- the event log on the wire -------------------------------------------

    def _events(self, job_id: str, query: str) -> Tuple[int, str, bytes]:
        """One-shot JSON view of the event log (`?since=SEQ` filter;
        `?wait=S` parks until new events arrive, same deadline
        machinery as the /jobs/{id} long-poll). The SSE view of the
        same log is `events_stream` (negotiated by Accept header at the
        socket layer)."""
        job = self.store.get(job_id)  # 404/503 before touching the log
        since = _query_int(query, "since", 0)
        wait_s = _query_wait(query, self.WAIT_CAP_S)
        evs = self.store.read_events(job_id, since)
        if not evs and wait_s > 0 and not job.terminal:
            deadline = time.monotonic() + wait_s  # madsim: allow(D001)
            while time.monotonic() < deadline:  # madsim: allow(D001)
                time.sleep(self.WAIT_TICK_S)  # madsim: allow(D001)
                evs = self.store.read_events(job_id, since)
                if evs:
                    break
            job = self.store.get(job_id)
        last = max([since] + [int(e["seq"]) for e in evs])
        return _json(200, {
            "job": job_id,
            "since": since,
            "last_seq": last,
            "state": job.state,
            "terminal": job.terminal,
            "events": evs,
        })

    def events_stream(self, job_id: str, since: int = 0,
                      wait_s: Optional[float] = None) -> Iterator[bytes]:
        """Server-Sent Events over the job's event log: replay
        everything past `since`, then tail the log at WAIT_TICK_S
        cadence — the `?wait=S` deadline machinery reused as the
        tail-poll window, so no server thread parks longer than
        WAIT_CAP_S per request (clients reconnect with
        `since=<last id>`). A terminal state drains the log one last
        time and closes with `event: end`."""
        cap = self.WAIT_CAP_S if wait_s is None else min(
            float(wait_s), self.WAIT_CAP_S)
        deadline = time.monotonic() + max(cap, 0.0)  # madsim: allow(D001)
        last = int(since)
        yield b"retry: 1000\n\n"
        while True:
            try:
                job = self.store.get(job_id)
            except (KeyError, CorruptJobFile) as exc:
                yield _sse_frame({"seq": last, "type": "error",
                                  "error": str(exc)})
                return
            for ev in self.store.read_events(job_id, last):
                last = max(last, int(ev.get("seq", last)))
                yield _sse_frame(ev)
            if job.terminal:
                # one last drain: events appended between the read and
                # the terminal-state observation must not be lost
                for ev in self.store.read_events(job_id, last):
                    last = max(last, int(ev.get("seq", last)))
                    yield _sse_frame(ev)
                yield (b"event: end\ndata: " + json.dumps(
                    {"job": job_id, "state": job.state,
                     "last_seq": last}).encode() + b"\n\n")
                return
            if time.monotonic() >= deadline:  # madsim: allow(D001)
                return  # window over; the client reconnects with since=
            time.sleep(self.WAIT_TICK_S)  # madsim: allow(D001)

    def _timeline(self, job_id: str) -> Tuple[int, str, bytes]:
        """The merged cross-process Perfetto timeline: lifecycle events
        (this process's log) + the worker's span dumps, joined by the
        job id as trace id."""
        job = self.store.get(job_id)
        evs = self.store.read_events(job_id)
        spans = list(fleet_events.iter_jsonl(self.store.spans_path(job_id)))
        return _json(200, fleet_events.timeline_doc(
            job.to_dict(), evs, spans))

    def _profile(self, job_id: str) -> Tuple[int, str, bytes]:
        """The three-clock merge over the store's artifacts: the
        /timeline doc (control-plane lifecycle + worker host spans,
        including the worker's ``madsim.sync`` instants) is the host
        plane; the worker's device-profile dump (written when it ran
        under MADSIM_TPU_XPROF=1) and its failing lane's virtual-time
        trace join it through `xprof.merge_plane` — the same alignment
        `prof --merge` does locally, served from the store. xprof's
        module level is stdlib-only, so this stays in the torch-free
        control plane; with no device/virtual artifacts on disk the
        response degrades to the host plane plus a summary saying so."""
        from ..perf import xprof

        job = self.store.get(job_id)
        evs = self.store.read_events(job_id)
        spans = list(fleet_events.iter_jsonl(self.store.spans_path(job_id)))
        host = fleet_events.timeline_doc(job.to_dict(), evs, spans)
        dev = xprof.load_device_events(self.store.device_trace_path(job_id))
        vdoc = None
        try:
            with open(self.store.vtrace_path(job_id)) as f:
                vdoc = json.load(f)
        except (OSError, json.JSONDecodeError, ValueError):
            vdoc = None
        doc = xprof.merge_plane(host, dev, vdoc, meta={
            "job": job_id, "trace_id": job_id, "source": "fleet",
            "state": job.state,
        })
        return _json(200, doc)

    def _cancel(self, job_id: str) -> Tuple[int, str, bytes]:
        job = self.store.request_cancel(job_id)
        return _json(200, {
            "id": job.id,
            "state": job.state,
            "cancel_requested": job.cancel_requested,
        })

    # -- health --------------------------------------------------------------

    def _healthz(self) -> Tuple[int, str, bytes]:
        """Liveness + store integrity in one probe: a read-only fsck
        scan (per-file verdicts summarized, nothing mutated) plus the
        farm gauges. 200 only while every artifact is readable; a
        corrupt store answers 503 with the count and the fix, so a
        `curl -f` health check trips exactly when `fleet fsck` has
        work to do."""
        from . import fsck

        rep = fsck.scan(self.store)
        shedding = self._update_shed(self._queue_depth())
        store_ok = rep["corrupt"] == 0
        # a shedding farm is alive but degraded: writes are being
        # refused, so the probe answers 503 until the backlog drains
        ok = store_ok and not shedding
        doc = {
            "ok": ok,
            "store": {
                "files_scanned": rep["files_scanned"],
                "corrupt_files": rep["corrupt"],
                "drifted_jobs": rep["drifted"],
                "stale_tmp": rep["stale_tmp"],
                "torn_tails": rep["torn_tails"],
                "stale_claims": rep.get("stale_claims", 0),
            },
            "queue_depth": rep["queue_depth"],
            "stale_leases": rep["stale_leases"],
            "quarantined_jobs": rep["quarantined"],
            "queue_log_lag": rep.get("queue_log_lag", 0),
            "shed": shedding,
            "workers": self.store.read_worker_stats(),
            **({} if store_ok else {"fix": "run `fleet fsck --root "
                                    f"{self.store.root}`"}),
            **({"degraded": "load-shedding writes; queue depth "
                f"{rep['queue_depth']} >= {self.shed_depth}"}
               if shedding else {}),
        }
        return _json(200 if ok else 503, doc)

    # -- metrics -------------------------------------------------------------

    def _metrics(self) -> bytes:
        """Fleet-level gauges plus every job's own StatsEmitter
        Prometheus textfile. Per-job files are label-namespaced by the
        worker (`{job="<id>"}`), so concatenation is a valid exposition
        — `# TYPE` lines are deduped across files."""
        lines = ["# madsim_tpu fleet control plane"]
        jobs = self.store.list()
        counts = self.store.counts()
        lines.append("# TYPE madsim_tpu_fleet_jobs gauge")
        for s in STATES:
            lines.append(f'madsim_tpu_fleet_jobs{{state="{s}"}} {counts.get(s, 0)}')
        # the self-healing counters: requeues (all causes), lease
        # reclaims (the sweep's share of them) and the quarantine gauge
        lines.append("# TYPE madsim_tpu_fleet_requeues_total counter")
        lines.append(
            f"madsim_tpu_fleet_requeues_total "
            f"{sum(j.n_requeues for j in jobs)}"
        )
        lines.append("# TYPE madsim_tpu_fleet_lease_reclaims_total counter")
        lines.append(
            f"madsim_tpu_fleet_lease_reclaims_total "
            f"{sum(j.n_lease_reclaims for j in jobs)}"
        )
        lines.append("# TYPE madsim_tpu_fleet_quarantined_jobs gauge")
        lines.append(
            f"madsim_tpu_fleet_quarantined_jobs "
            f"{counts.get('quarantined', 0)}"
        )
        # the contention plane: claim races lost (per-worker stats
        # docs), zombie writes refused by fencing (per-job docs), the
        # index's honesty, and the admission ledger
        wstats = self.store.read_worker_stats()
        lines.append("# TYPE madsim_tpu_fleet_claim_conflicts_total counter")
        lines.append(
            f"madsim_tpu_fleet_claim_conflicts_total "
            f"{sum(int(w.get('claim_conflicts', 0)) for w in wstats.values())}"
        )
        lines.append("# TYPE madsim_tpu_fleet_fenced_writes_total counter")
        lines.append(
            f"madsim_tpu_fleet_fenced_writes_total "
            f"{sum(j.n_fenced_writes for j in jobs)}"
        )
        lines.append("# TYPE madsim_tpu_fleet_queue_log_lag gauge")
        lines.append(
            f"madsim_tpu_fleet_queue_log_lag {self.store.queue_log_lag()}")
        lines.append("# TYPE madsim_tpu_fleet_shed gauge")
        lines.append(f"madsim_tpu_fleet_shed {int(self.shedding)}")
        lines.append("# TYPE madsim_tpu_fleet_sheds_total counter")
        lines.append(f"madsim_tpu_fleet_sheds_total {self.sheds_total}")
        with self._admission_lock:
            admission = {t: dict(per) for t, per in self._admission.items()}
        if admission:
            lines.append("# TYPE madsim_tpu_fleet_admission_total counter")
            for tenant in sorted(admission):
                for outcome in sorted(admission[tenant]):
                    lines.append(
                        f'madsim_tpu_fleet_admission_total'
                        f'{{tenant="{tenant}",outcome="{outcome}"}} '
                        f'{admission[tenant][outcome]}'
                    )
        self._slo_histograms(lines, jobs)
        self._bench_trajectory(lines)
        seen_types = {"madsim_tpu_fleet_jobs",
                      "madsim_tpu_fleet_requeues_total",
                      "madsim_tpu_fleet_lease_reclaims_total",
                      "madsim_tpu_fleet_quarantined_jobs",
                      "madsim_tpu_fleet_claim_conflicts_total",
                      "madsim_tpu_fleet_fenced_writes_total",
                      "madsim_tpu_fleet_queue_log_lag",
                      "madsim_tpu_fleet_shed",
                      "madsim_tpu_fleet_sheds_total",
                      "madsim_tpu_fleet_admission_total"}
        for job in jobs:
            # parsed-textfile cache keyed (path, mtime, size): a scrape
            # of an unchanged store re-parses nothing, so scrape cost
            # stops being O(jobs) parse work
            rows = self._prom_cache.get(
                self.store.stats_base(job.id) + ".prom", _parse_prom)
            for kind, name, line in rows or ():
                if kind == "type":
                    if name in seen_types:
                        continue
                    seen_types.add(name)
                lines.append(line)
        return ("\n".join(lines) + "\n").encode()

    #: SLO histogram buckets (seconds for the *_seconds metrics, plain
    #: counts for fleet_batches_per_find — same ladder, documented)
    SLO_BUCKETS = (0.1, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0, 120.0,
                   300.0, 600.0)

    #: metric name -> per-job SLO observation key (events.slo_observations)
    SLO_METRICS = (
        ("madsim_tpu_fleet_queue_wait_seconds", "queue_wait_s"),
        ("madsim_tpu_fleet_time_to_first_find_seconds",
         "time_to_first_find_s"),
        ("madsim_tpu_fleet_lane_seconds_per_find", "lane_seconds_per_find"),
        ("madsim_tpu_fleet_batches_per_find", "batches_per_find"),
    )

    def _bench_trajectory(self, lines: List[str]) -> None:
        """The BENCH_HISTORY.jsonl trajectory as gauges: for each
        comparable-fingerprint group (platform + lanes + gate tuple +
        host — `perf/history.comparable`), the NEWEST row's throughput
        and warm compile, labeled by its tag. The scrape answers "what
        is this box's current bench baseline, and which capture set
        it" without shelling out to `bench report`; rows from other
        boxes/configs export as their own series instead of being
        averaged into noise. File resolution matches bench.py
        ($MADSIM_TPU_BENCH_HISTORY, else the repo's checked-in file);
        parsed via the stat-keyed cache — unchanged history, zero
        re-reads. Absent file → no series (a farm box without the repo
        checkout scrapes clean)."""
        from ..perf import history

        path = os.environ.get("MADSIM_TPU_BENCH_HISTORY") or os.path.join(
            os.path.dirname(os.path.dirname(os.path.dirname(
                os.path.abspath(__file__)))),
            history.DEFAULT_BASENAME,
        )
        rows = self._bench_cache.get(path, history.load)
        if not rows:
            return
        # newest row per comparability group, file order == time order
        heads: List[dict] = []
        for row in rows:
            for i, head in enumerate(heads):
                if history.comparable(row.get("fingerprint"),
                                      head.get("fingerprint")):
                    heads[i] = row
                    break
            else:
                heads.append(row)
        series = (
            ("madsim_tpu_bench_seeds_per_sec", "value",
             "newest capture per comparable fingerprint"),
            ("madsim_tpu_bench_compile_s_warm", "compile_s_warm",
             "persistent-cache warm start, same grouping"),
        )
        for name, key, help_text in series:
            rendered = False
            for row in heads:
                val = row.get(key)
                if val is None:
                    continue  # e.g. no cache configured: no warm path
                fp = row.get("fingerprint") or {}
                labels = ",".join(
                    f'{k}="{v}"' for k, v in (
                        ("tag", row.get("tag", "?")),
                        ("platform", fp.get("platform", "?")),
                        ("lanes", fp.get("lanes", "?")),
                        ("host", fp.get("host") or "?"),
                    )
                )
                if not rendered:
                    lines.append(f"# HELP {name} {help_text}")
                    lines.append(f"# TYPE {name} gauge")
                    rendered = True
                lines.append(f"{name}{{{labels}}} {val:g}")

    def _slo_histograms(self, lines: List[str], jobs) -> None:
        """SLO metrics derived from the event log at scrape time —
        pure deltas over each job's events.jsonl (via the stat-keyed
        cache), nothing precomputed or stored. A job contributes to a
        histogram only once the underlying events exist (no finds →
        no find-latency sample)."""
        samples: Dict[str, List[float]] = {k: [] for _n, k in self.SLO_METRICS}
        for job in jobs:
            obs = fleet_events.slo_observations(self._job_events(job.id))
            for _name, key in self.SLO_METRICS:
                if key in obs:
                    samples[key].append(obs[key])
        for name, key in self.SLO_METRICS:
            vals = samples[key]
            lines.append(f"# TYPE {name} histogram")
            acc = 0
            for le in self.SLO_BUCKETS:
                acc = sum(1 for v in vals if v <= le)
                lines.append(f'{name}_bucket{{le="{le:g}"}} {acc}')
            lines.append(f'{name}_bucket{{le="+Inf"}} {len(vals)}')
            lines.append(f"{name}_sum {round(sum(vals), 6):g}")
            lines.append(f"{name}_count {len(vals)}")


def make_handler(api: FleetAPI):
    class Handler(http.server.BaseHTTPRequestHandler):
        def _dispatch(self, method: str) -> None:
            length = int(self.headers.get("Content-Length") or 0)
            body = self.rfile.read(length) if length else None
            status, ctype, payload = api.handle(method, self.path, body)
            self.send_response(status)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(payload)))
            if status == 429:
                # the admission verdict carries the precise wait in its
                # JSON body (retry_after_s); the header is the RFC's
                # integer delta-seconds rendering of the same number
                try:
                    ra = json.loads(payload).get("retry_after_s")
                except (json.JSONDecodeError, ValueError, AttributeError):
                    ra = None
                if ra is not None:
                    self.send_header("Retry-After",
                                     str(max(1, math.ceil(float(ra)))))
            self.end_headers()
            self.wfile.write(payload)

        def _maybe_stream_events(self) -> bool:
            """SSE content negotiation for /jobs/{id}/events: a client
            asking for `text/event-stream` gets the live tail — sent
            frame by frame, flushed per event, no Content-Length (the
            connection close delimits the stream; `fleet watch`
            reconnects with since=<last id>)."""
            path, _, query = self.path.partition("?")
            m = _JOB_RE.match(path.rstrip("/") or "/")
            if not (m and m.group(2) == "/events"
                    and "text/event-stream" in
                    (self.headers.get("Accept") or "")):
                return False
            since = _query_int(query, "since", 0)
            wait_s = _query_wait(query, FleetAPI.WAIT_CAP_S) or None
            self.send_response(200)
            self.send_header("Content-Type", "text/event-stream")
            self.send_header("Cache-Control", "no-cache")
            self.send_header("Connection", "close")
            self.end_headers()
            try:
                for frame in api.events_stream(m.group(1), since, wait_s):
                    self.wfile.write(frame)
                    self.wfile.flush()
            except (BrokenPipeError, ConnectionResetError):
                pass  # watcher went away; nothing to clean up
            return True

        def do_GET(self):  # noqa: N802 (stdlib API name)
            if self._maybe_stream_events():
                return
            self._dispatch("GET")

        def do_POST(self):  # noqa: N802
            self._dispatch("POST")

        def do_DELETE(self):  # noqa: N802
            self._dispatch("DELETE")

        def log_message(self, fmt, *a):  # route access logs to logging
            _LOG.debug(fmt, *a)

    return Handler


def serve(root: str, addr: str, port_file: Optional[str] = None,
          sweep_interval_s: float = 5.0) -> int:
    """`fleet serve` entry: bind (port 0 supported), announce the
    realized port (stdout + optional --port-file), serve until
    SIGTERM/Ctrl-C, close gracefully. A daemon supervisor thread runs
    the lease-reclamation sweep every `sweep_interval_s` (0 disables):
    expired worker leases requeue their jobs with backoff — or
    quarantine at the attempt cap — so the farm heals even while no
    worker is alive to sweep for itself."""
    store = JobStore(root)
    stop = threading.Event()

    def _sweep() -> None:
        while not stop.wait(sweep_interval_s):
            try:
                for act in store.reclaim_expired():
                    print(
                        f"sweep: reclaimed {act['job']} from dead "
                        f"worker {act['worker']} -> {act['outcome']} "
                        f"(attempt {act['attempt']})", flush=True,
                    )
                # pay the O(n) index-healing scan here so the workers'
                # poll path never has to: any job the queue log
                # misrepresents (mirror append lost to a crash) gets a
                # correction row
                fixed = store.sync_queue_log()
                if fixed:
                    print(f"sweep: healed {fixed} stale queue-index "
                          f"row(s)", flush=True)
            except Exception:  # the farm outlives a bad sweep pass
                _LOG.exception("lease-reclamation sweep failed")

    srv, host, port = httpd.bind(addr, make_handler(FleetAPI(store)))
    print(
        f"fleet control plane on {host}:{port} (root {store.root}; "
        f"GET /queue /jobs/{{id}} /jobs/{{id}}/result /jobs/{{id}}/events "
        f"/jobs/{{id}}/timeline /jobs/{{id}}/profile /metrics /healthz, "
        f"POST /jobs, DELETE /jobs/{{id}}; lease sweep every "
        f"{sweep_interval_s:g}s)",
        flush=True,
    )
    sweeper = None
    if sweep_interval_s > 0:
        sweeper = threading.Thread(
            target=_sweep, daemon=True, name="fleet-lease-sweep"
        )
        sweeper.start()
    try:
        return httpd.run_http_server(srv, port_file=port_file)
    finally:
        stop.set()
        if sweeper is not None:
            sweeper.join(timeout=2)
