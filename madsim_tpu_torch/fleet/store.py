"""Durable job store + queue — JSON-on-disk, atomic, fingerprinted.

One job = one file under `<root>/jobs/<id>.json`, written with the
`runtime/checkpoint.py` discipline (tmp + rename) so a kill mid-write
leaves the previous document intact and the control plane
never serves a torn read. The store IS the wire between the API server
and the worker: POST /jobs writes a `queued` document, the worker polls
the directory — no RPC, and both sides survive restarts for free.

Lifecycle state machine::

    queued -> compiling -> running -> plateaued | exhausted | found
                                      found -> shrunk -> filed
    (queued|compiling|running|found) -> cancelled
    (compiling|running|found|shrunk) -> failed
    (queued|compiling|running|found|shrunk) -> queued       (requeue)
    (queued|compiling|running|found|shrunk) -> quarantined  (poison)
    quarantined -> queued                                   (release)

A *requeue* is the supervisor path: an expired worker lease (the worker
died, or its clock jumped past the ttl) or a worker-reported hard
failure sends the job back to `queued` with the lease cleared, the
checkpoint preserved (the next worker resumes at <=1 lost batch) and an
exponential backoff stamped in `requeue_after_ts`. The `attempt`
counter counts CONSECUTIVE deaths — any completed unit resets it — and
at `max_attempts` the job is declared poison and moves to the terminal
`quarantined` state carrying the last exception, the batch index it
died in, and the exact repro command, instead of wedging the farm
forever. `release_quarantined` is the explicit operator edge back.

Every job records the same argument FINGERPRINT the checkpoint
machinery uses (`runtime/checkpoint.fingerprint_from_args` over the
spec), plus a sha256 of the normalized spec: a worker that leases a job
whose spec no longer hashes to its recorded fingerprint refuses it —
exactly like a `--checkpoint` resume refuses a drifted command line —
instead of silently blending two different hunts.

The port's copy of `madsim_tpu/fleet/store.py`: the same documents,
file names, lock names, queue log and fingerprints, byte for byte, so a
JAX worker and the port's worker can lease from one root. Pure host-side
stdlib — no torch import anywhere in this module, so `fleet serve` runs
on a box with no card.
"""

from __future__ import annotations

# madsim: allow-file(D001) — submit/lease/history wall-clock stamps are
# this host-side service's contract (lease expiry, deadlines, audit
# trail); nothing here feeds simulation state. Virtual time lives in
# the engine, and a job's *results* are a pure function of
# (fingerprint, seed schedule), both recorded below.
import contextlib
import dataclasses
import hashlib
import json
import os
import re
import time
from types import SimpleNamespace
from typing import Callable, Dict, List, Optional

from ..runtime.atomicio import (
    append_text,
    atomic_write_json,
    atomic_write_text,
    create_exclusive,
)
from ..runtime.checkpoint import fingerprint_from_args
from . import events as fleet_events

try:  # POSIX file locks guard read-modify-write; no-op elsewhere
    import fcntl
except ImportError:  # pragma: no cover - non-POSIX fallback
    fcntl = None

# -- lifecycle ---------------------------------------------------------------

QUEUED = "queued"
COMPILING = "compiling"
RUNNING = "running"
PLATEAUED = "plateaued"   # coverage plateau stop, no finds
EXHAUSTED = "exhausted"   # seed budget (or deadline) consumed, no finds
FOUND = "found"           # finds harvested, shrink pending
SHRUNK = "shrunk"         # finds minimized, filing pending
FILED = "filed"           # corpus entries + result written
CANCELLED = "cancelled"
FAILED = "failed"
QUARANTINED = "quarantined"  # poison: N consecutive deaths/hard failures

STATES = (QUEUED, COMPILING, RUNNING, PLATEAUED, EXHAUSTED, FOUND,
          SHRUNK, FILED, CANCELLED, FAILED, QUARANTINED)
TERMINAL = frozenset({PLATEAUED, EXHAUSTED, FILED, CANCELLED, FAILED,
                      QUARANTINED})
#: states a worker may hold a lease in (crash recovery re-leases these)
LEASABLE = frozenset({QUEUED, COMPILING, RUNNING, FOUND, SHRUNK})

#: consecutive deaths/hard failures before a job is declared poison
MAX_ATTEMPTS = 3
#: requeue backoff: base * 2^(attempt-1) seconds
REQUEUE_BACKOFF_BASE_S = 2.0

_TRANSITIONS: Dict[str, frozenset] = {
    # queued -> failed: a job can be refused before compiling (unknown
    # machine, fingerprint drift detected at lease time); queued ->
    # quarantined: the 3rd lease death can land before the worker ever
    # reached compiling
    QUEUED: frozenset({COMPILING, CANCELLED, FAILED, QUARANTINED}),
    COMPILING: frozenset({RUNNING, FAILED, CANCELLED, QUEUED, QUARANTINED}),
    RUNNING: frozenset({PLATEAUED, EXHAUSTED, FOUND, FAILED, CANCELLED,
                        QUEUED, QUARANTINED}),
    FOUND: frozenset({SHRUNK, FAILED, CANCELLED, QUEUED, QUARANTINED}),
    SHRUNK: frozenset({FILED, FAILED, QUEUED, QUARANTINED}),
    PLATEAUED: frozenset(),
    EXHAUSTED: frozenset(),
    FILED: frozenset(),
    CANCELLED: frozenset(),
    FAILED: frozenset(),
    # terminal for every automatic path; the one edge out is the
    # explicit operator release (`fleet fsck --release-quarantined`)
    QUARANTINED: frozenset({QUEUED}),
}

# -- job spec ----------------------------------------------------------------

#: whitelisted spec fields -> (type, default). Mirrors the hunt CLI;
#: `batch` defaults to the CI shape (256 lanes) where a warm worker
#: compiles in ~4 s, not the flagship 8192.
SPEC_FIELDS = {
    "machine": (str, None),          # required
    "nodes": (int, 0),
    "seed": (int, 0),
    "seeds": (int, 1024),
    "batch": (int, 256),
    "horizon": (float, 5.0),
    "max_steps": (int, 3000),
    "queue": (int, 96),
    "faults": (int, 2),
    "loss": (float, 0.0),
    "fault_tmax": (int, 0),
    "fault_kinds": (str, "pair,kill"),
    "rng_stream": (int, 2),
    "strict_restart": (bool, False),
    "coverage": (bool, False),
    "provenance": (bool, False),
    "flight_recorder": (bool, False),
    "stop_on_plateau": (int, 0),
    "shrink_limit": (int, 5),
    # coverage-feedback search (search/): the worker evolves
    # the job's seed corpus, biases draws toward thin coverage cells /
    # lineage-implicated kinds, and escalates the vocabulary on
    # plateau; the (seed schedule, bias state) trail rides the job
    # checkpoint so resume/replacement replays are byte-identical
    "guided": (bool, False),
    # span the hunt over the first N devices as one SPMD
    # program (the lane-axis mesh; 0 = unsharded). Part of the
    # warm-compile grouping key: a mesh job and a single-device job
    # compile different programs and must never share a group
    "devices": (int, 0),
}

SEGMENT_STEPS = 384  # the streaming driver's pinned segment shape


def normalize_spec(spec: dict) -> dict:
    """Validate + default a job spec. Raises ValueError (the API maps it
    to 400) on unknown fields, a missing machine, or type mismatches."""
    unknown = sorted(set(spec) - set(SPEC_FIELDS))
    if unknown:
        raise ValueError(
            f"unknown spec fields {unknown}; known: {sorted(SPEC_FIELDS)}"
        )
    out = {}
    for name, (typ, default) in SPEC_FIELDS.items():
        v = spec.get(name, default)
        if v is None:
            raise ValueError(f"spec field {name!r} is required")
        if typ is bool:
            if not isinstance(v, bool):
                raise ValueError(f"spec field {name!r} must be a bool, got {v!r}")
        elif typ is float:
            if isinstance(v, bool) or not isinstance(v, (int, float)):
                raise ValueError(f"spec field {name!r} must be a number, got {v!r}")
            v = float(v)
        elif typ is int:
            if isinstance(v, bool) or not isinstance(v, int):
                raise ValueError(f"spec field {name!r} must be an int, got {v!r}")
        elif typ is str:
            if not isinstance(v, str) or not v:
                raise ValueError(f"spec field {name!r} must be a non-empty string")
        out[name] = v
    if out["seeds"] < 1 or out["batch"] < 1:
        raise ValueError("spec needs seeds >= 1 and batch >= 1")
    if out["stop_on_plateau"] and not out["coverage"]:
        raise ValueError(
            "stop_on_plateau needs coverage: the plateau signal IS the "
            "coverage curve"
        )
    if out["guided"] and not out["coverage"]:
        raise ValueError(
            "guided needs coverage: the bias signal IS the live map"
        )
    if out["devices"] < 0:
        raise ValueError("spec field 'devices' must be >= 0 (0 = unsharded)")
    if out["devices"] and out["batch"] % out["devices"]:
        raise ValueError(
            f"batch ({out['batch']}) must be a multiple of devices "
            f"({out['devices']}): lanes shard evenly over the mesh axis"
        )
    return out


def spec_to_args(spec: dict, **overrides) -> SimpleNamespace:
    """The args namespace `__main__._build_engine` / `_stream_batches`
    expect, built from a job spec. The fleet worker drives the SAME
    chunked streaming driver the `hunt` CLI uses — one code path, one
    fingerprint function, one checkpoint format."""
    ns = SimpleNamespace(
        **spec,
        stream=True,
        no_pipeline=False,
        segments_per_dispatch=8,
        dispatch_depth=4,
        no_donate=False,
        compile_cache=None,
        checkpoint=None,
        stats=None,
        stats_labels=None,
        stop_after_batches=0,
        all_seeds=False,
        limit=spec.get("shrink_limit", 5),
    )
    for k, v in overrides.items():
        setattr(ns, k, v)
    return ns


def job_fingerprint(spec: dict) -> dict:
    """The resume-safety fingerprint: the checkpoint machinery's field
    set computed over the spec, so the job store and the job's
    `--checkpoint` file refuse drift with one voice."""
    return fingerprint_from_args(spec_to_args(spec))


def spec_sha(spec: dict) -> str:
    return hashlib.sha256(
        json.dumps(spec, sort_keys=True).encode()
    ).hexdigest()


def cache_subkey(
    *,
    gates: Optional[dict] = None,
    rng_stream: Optional[int] = None,
    lanes: Optional[int] = None,
    segment_steps: Optional[int] = None,
    devices: Optional[int] = None,
) -> str:
    """The directory-name-safe warm-start key of the JAX package's
    `compile_cache.cache_subkey(import_jax=False, ...)`, copied: the
    fixed `jax-unknown` prefix, the stream version, the gate tuple, the
    lane shape and the mesh size. The fleet groups jobs by it, so it
    must be the same string whichever package renders it; the port
    compiles no graph and keeps it only as the grouping key."""
    parts = ["jax-unknown"]
    if rng_stream is not None:
        parts.append(f"rng{rng_stream}")
    if gates:
        bits = []
        for k in sorted(gates):
            v = gates[k]
            if v is None:
                continue
            short = "".join(w[0] for w in k.split("_")) or k
            bits.append(f"{short}{int(v) if isinstance(v, bool) else v}")
        if bits:
            parts.append(".".join(bits))
    if lanes is not None:
        shape = f"l{lanes}"
        if segment_steps is not None:
            shape += f"x{segment_steps}"
        parts.append(shape)
    if devices is not None:
        parts.append(f"d{devices}")
    return re.sub(r"[^A-Za-z0-9._-]", "_", "-".join(parts))


def job_subkey(spec: dict) -> str:
    """The warm-start subkey this job's engine runs under (`cache_subkey`
    over the gate tuple / stream version / lane shape), computed ONCE at
    submit. The allocator only needs EQUALITY to pack jobs of one engine
    shape back-to-back on the worker's live engine."""
    return cache_subkey(
        gates={
            "flight_recorder": spec["flight_recorder"],
            "coverage": spec["coverage"],
            "provenance": spec["provenance"],
        },
        rng_stream=spec["rng_stream"],
        lanes=spec["batch"],
        segment_steps=SEGMENT_STEPS,
        # mesh topology: a d8 job and an unsharded job run disjoint
        # programs, so the allocator must never pack them back-to-back.
        # .get: docs persisted before the mesh field have none and stay
        # in the unsharded group
        devices=spec.get("devices") or None,
    )


def repro_cmd(spec: dict, *, batch_index: Optional[int] = None) -> str:
    """The exact `hunt` command reproducing this job's stream — or,
    with `batch_index`, the single batch it died in (batch i always
    consumes the same seed range, so one batch is a complete repro).
    Recorded verbatim in quarantine documents: a poisoned job must be
    debuggable from its doc alone, with no farm running.

    Guided jobs cannot be sliced to one batch (their batch seed
    vectors are bias-chosen, not sequential ranges) — the full-run
    command reproduces the identical schedule deterministically, so
    that is the honest repro."""
    start, seeds = spec["seed"], spec["seeds"]
    if spec.get("guided"):
        batch_index = None
    if batch_index is not None:
        start = spec["seed"] + batch_index * spec["batch"]
        seeds = max(1, min(spec["batch"], spec["seeds"] - batch_index * spec["batch"]))
    parts = [
        f"python -m madsim_tpu_torch hunt --stream --machine {spec['machine']}",
        f"--nodes {spec['nodes']}", f"--seed {start}", f"--seeds {seeds}",
        f"--batch {spec['batch']}", f"--horizon {spec['horizon']}",
        f"--max-steps {spec['max_steps']}", f"--queue {spec['queue']}",
        f"--faults {spec['faults']}", f"--loss {spec['loss']}",
        f"--fault-tmax {spec['fault_tmax']}",
        f"--fault-kinds {spec['fault_kinds']}",
        f"--rng-stream {spec['rng_stream']}",
    ]
    if spec.get("devices"):
        parts.append(f"--devices {spec['devices']}")
    for flag, key in (("--strict-restart", "strict_restart"),
                      ("--coverage", "coverage"),
                      ("--provenance", "provenance"),
                      ("--flight-recorder", "flight_recorder"),
                      ("--guided", "guided")):
        if spec.get(key):
            parts.append(flag)
    return " ".join(parts)


def engine_key(spec: dict) -> str:
    """Everything that shapes the COMPILED streaming program (model,
    vocabulary, gates, lane shape) — jobs with equal keys can share one
    live Engine instance in a worker. Seed budget/cursor are excluded:
    they are runtime inputs, not compiled structure."""
    fields = (
        "machine", "nodes", "horizon", "queue", "faults", "loss",
        "fault_tmax", "fault_kinds", "rng_stream", "strict_restart",
        "coverage", "provenance", "flight_recorder", "batch",
    )
    key = {f: spec[f] for f in fields}
    # mesh size shapes the compiled program (explicit shardings are in
    # the program); .get keeps pre-mesh docs readable (unsharded group)
    key["devices"] = spec.get("devices", 0)
    return json.dumps(key, sort_keys=True)


# -- the job document --------------------------------------------------------


class CorruptJobFile(RuntimeError):
    """A job document exists on disk but cannot be read (truncated,
    unparseable, or schema-broken). Raised instead of the raw decode
    error so every reader can distinguish "no such job" (KeyError)
    from "run `fleet fsck`" — the API maps this to 503, `list()` skips
    the file, and fsck quarantines it to `*.corrupt`."""

    def __init__(self, path: str, detail: str):
        super().__init__(f"{path}: {detail} — run `fleet fsck`")
        self.path = path
        self.detail = detail


class FencedWrite(RuntimeError):
    """A store mutation carried a fencing token from a dead lease
    generation: the job was reclaimed (and possibly re-leased) since
    this worker last held it. The write was REJECTED and counted —
    nothing of it was merged. The worker's only correct response is to
    abandon the unit; the current holder owns the job now."""

    def __init__(self, job_id: str, worker: str, gen: int, op: str):
        super().__init__(
            f"job {job_id}: {op} from {worker!r} gen {gen} rejected — "
            f"lease was reclaimed; abandon the unit"
        )
        self.job_id = job_id
        self.worker = worker
        self.gen = gen
        self.op = op


@dataclasses.dataclass
class Job:
    id: str
    spec: dict
    fingerprint: dict
    fingerprint_sha: str
    subkey: str
    state: str = QUEUED
    priority: int = 0
    deadline_ts: Optional[float] = None
    ts_submit: float = 0.0
    history: list = dataclasses.field(default_factory=list)
    lease: Optional[dict] = None
    cancel_requested: bool = False
    progress: dict = dataclasses.field(default_factory=dict)
    result: Optional[dict] = None
    error: Optional[str] = None
    #: consecutive deaths/hard failures since the last completed unit
    #: (a completed unit resets it — deaths are only poison when
    #: consecutive)
    attempt: int = 0
    #: wall timestamp before which the job may not be leased (requeue
    #: backoff); None = leasable now
    requeue_after_ts: Optional[float] = None
    #: post-mortems of every death [{ts, reason, worker, state,
    #: error, batch_index, attempt}] — the quarantine doc quotes the
    #: fatal tail of this list
    deaths: list = dataclasses.field(default_factory=list)
    #: OOM lane-count backoff records [{ts, from_batch, to_batch,
    #: error, worker}]
    degraded: list = dataclasses.field(default_factory=list)
    #: set when state == quarantined: {reason, error, batch_index,
    #: attempts, deaths, repro}
    quarantine: Optional[dict] = None
    n_requeues: int = 0
    n_lease_reclaims: int = 0
    #: monotonic fencing token: bumped every time the lease passes to
    #: a NEW hold (first lease, takeover, or re-lease after a
    #: reclaim). The live lease dict carries the current value as
    #: ``lease["gen"]``; a worker's renewal/progress writes CAS
    #: against it, so a reclaimed ("zombie") hold can never resurrect
    #: its lease or merge state the next holder doesn't expect.
    lease_gen: int = 0
    #: observability-class tally (never feeds job results): store
    #: writes rejected because they carried a dead lease generation.
    #: Claim-race losses are counted worker-side (`workers/<id>.json`)
    #: — the loser's whole point is to back off without taking the
    #: job's lock.
    n_fenced_writes: int = 0

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["version"] = 1
        return d

    @staticmethod
    def from_dict(d: dict) -> "Job":
        d = dict(d)
        d.pop("version", None)
        return Job(**d)

    @property
    def terminal(self) -> bool:
        return self.state in TERMINAL


class JobStore:
    """Directory layout under `root`::

        jobs/<id>.json         the job document (atomic writes)
        jobs/<id>.lock         flock guard for read-modify-write
        jobs/<id>.ckpt.json    the job's hunt checkpoint (worker-owned)
        jobs/<id>.stats.*      the job's StatsEmitter feed (jsonl/prom/json)
        jobs/<id>.events.jsonl the job-lifecycle event log (append-only)
        jobs/<id>.spans.jsonl  worker PerfRecorder span dumps (append-only)
        jobs/<id>.device.trace.json.gz  worker device-profile capture
                               (MADSIM_TPU_XPROF=1 units only)
        jobs/<id>.vtrace.json  failing lane's virtual-time trace (ditto)
        jobs/<id>.claim        O_EXCL claim file (contention arbiter;
                               advisory — the flock stays authoritative)
        corpus.json            filed finds (corpus.CorpusEntry records)
        queue.log              append-only queue index (rebuildable
                               from the job docs; docs stay the truth)
        workers/<id>.json      per-worker observability counters
    """

    def __init__(self, root: str):
        self.root = os.path.abspath(root)
        self.jobs_dir = os.path.join(self.root, "jobs")
        os.makedirs(self.jobs_dir, exist_ok=True)
        # in-memory materialization of queue.log: row per job, refreshed
        # incrementally (stat + read-the-new-bytes) on every poll
        self._qrows: Dict[str, dict] = {}
        self._qlog_pos = 0
        self._qlog_ino: Optional[int] = None

    # -- paths ---------------------------------------------------------------

    def job_path(self, job_id: str) -> str:
        if not re.fullmatch(r"[A-Za-z0-9._-]+", job_id):
            raise KeyError(f"malformed job id {job_id!r}")
        return os.path.join(self.jobs_dir, f"{job_id}.json")

    def ckpt_path(self, job_id: str) -> str:
        return os.path.join(self.jobs_dir, f"{job_id}.ckpt.json")

    def stats_base(self, job_id: str) -> str:
        return os.path.join(self.jobs_dir, f"{job_id}.stats")

    def events_path(self, job_id: str) -> str:
        return os.path.join(self.jobs_dir, f"{job_id}.events.jsonl")

    def spans_path(self, job_id: str) -> str:
        return os.path.join(self.jobs_dir, f"{job_id}.spans.jsonl")

    def device_trace_path(self, job_id: str) -> str:
        """The worker's last device-profile capture (Chrome JSON, gz) —
        written only when the worker runs under MADSIM_TPU_XPROF=1."""
        return os.path.join(self.jobs_dir, f"{job_id}.device.trace.json.gz")

    def vtrace_path(self, job_id: str) -> str:
        """The first failing lane's VIRTUAL-time Perfetto doc (same
        gate as the device trace; times are simulated µs, never wall)."""
        return os.path.join(self.jobs_dir, f"{job_id}.vtrace.json")

    def claim_path(self, job_id: str) -> str:
        return os.path.join(self.jobs_dir, f"{job_id}.claim")

    @property
    def corpus_path(self) -> str:
        return os.path.join(self.root, "corpus.json")

    @property
    def queue_log_path(self) -> str:
        return os.path.join(self.root, "queue.log")

    @property
    def workers_dir(self) -> str:
        return os.path.join(self.root, "workers")

    def worker_stats_path(self, worker_id: str) -> str:
        if not re.fullmatch(r"[A-Za-z0-9._-]+", worker_id):
            raise KeyError(f"malformed worker id {worker_id!r}")
        return os.path.join(self.workers_dir, f"{worker_id}.json")

    def write_worker_stats(self, worker_id: str, doc: dict) -> None:
        """Per-worker observability counters (claim conflicts, fenced
        writes, polls...). Throwaway-on-crash quality: no fsync, and
        nothing in the store depends on them."""
        os.makedirs(self.workers_dir, exist_ok=True)
        atomic_write_json(self.worker_stats_path(worker_id), doc,
                          fsync=False)

    def read_worker_stats(self) -> Dict[str, dict]:
        out: Dict[str, dict] = {}
        try:
            names = sorted(os.listdir(self.workers_dir))
        except FileNotFoundError:
            return out
        for fn in names:
            if not fn.endswith(".json"):
                continue
            with contextlib.suppress(OSError, json.JSONDecodeError,
                                     UnicodeDecodeError):
                with open(os.path.join(self.workers_dir, fn)) as f:
                    out[fn[:-len(".json")]] = json.load(f)
        return out

    # -- locking + atomic IO -------------------------------------------------

    @contextlib.contextmanager
    def _locked(self, name: str):
        path = os.path.join(self.jobs_dir, name + ".lock")
        f = open(path, "a")
        try:
            if fcntl is not None:
                fcntl.flock(f, fcntl.LOCK_EX)
            yield
        finally:
            if fcntl is not None:
                fcntl.flock(f, fcntl.LOCK_UN)
            f.close()

    def _write(self, job: Job) -> None:
        # shared crash-safe discipline (tmp + fsync + rename +
        # dir-fsync): a kill — or a power cut — mid-write leaves the
        # previous document, and the chaos harness injects its torn
        # writes at exactly this point
        atomic_write_json(self.job_path(job.id), job.to_dict())
        # mirror the queue-relevant fields into the append-only index
        # log. Best-effort by design: the doc above is the source of
        # truth, a missed or torn record only makes the index lag, and
        # the sweep/fsck re-sync it. Appends from different jobs' locks
        # interleave whole records (single O_APPEND write).
        with contextlib.suppress(OSError):
            append_text(self.queue_log_path,
                        json.dumps(self._queue_record(job), sort_keys=True,
                                   separators=(",", ":")) + "\n",
                        fsync=False)

    # -- the queue log (rebuildable index; the docs stay the truth) ----------

    @staticmethod
    def _queue_record(job: Job) -> dict:
        """One queue-log row: exactly the fields a lease poll filters
        and ranks on, so a reader answers "what can I claim?" without
        touching any job document."""
        lease = job.lease or {}
        return {
            "job": job.id,
            "state": job.state,
            "subkey": job.subkey,
            "priority": job.priority,
            "deadline_ts": job.deadline_ts,
            "requeue_after_ts": job.requeue_after_ts,
            "worker": lease.get("worker"),
            "lease_expires_ts": lease.get("expires_ts"),
            "gen": job.lease_gen,
            "plateau": bool(job.progress.get("plateau")),
            "ts": round(time.time(), 3),
        }

    def queue_rows(self) -> Dict[str, dict]:
        """The in-memory queue index: job id -> latest queue-log row.
        Refresh is O(new bytes): stat the log, read only what grew
        since the last call, keep at most one unterminated tail line
        unconsumed (it may be mid-append; the next append heals it).
        Unparseable lines are skipped — same torn-tolerance contract as
        the event-log readers. A store without a log yet (pre-index
        farms) gets one built from the docs, so the NEXT poll is
        O(1)."""
        path = self.queue_log_path
        try:
            stt = os.stat(path)
        except FileNotFoundError:
            self.rebuild_queue_log()
            try:
                stt = os.stat(path)
            except FileNotFoundError:  # pragma: no cover - read-only fs
                return dict(self._qrows)
        if stt.st_ino != self._qlog_ino or stt.st_size < self._qlog_pos:
            # replaced (rebuild) or truncated (torn-tail repair): rescan
            self._qrows, self._qlog_pos = {}, 0
            self._qlog_ino = stt.st_ino
        if stt.st_size > self._qlog_pos:
            with open(path, "rb") as f:
                f.seek(self._qlog_pos)
                chunk = f.read()
            cut = chunk.rfind(b"\n")
            if cut >= 0:
                for line in chunk[:cut].split(b"\n"):
                    if not line.strip():
                        continue
                    try:
                        row = json.loads(line)
                        self._qrows[row["job"]] = row
                    except (json.JSONDecodeError, UnicodeDecodeError,
                            KeyError, TypeError):
                        continue  # torn/foreign line: skip, never crash
                self._qlog_pos += cut + 1
        return self._qrows

    def rebuild_queue_log(self) -> int:
        """Write a fresh queue.log from the job documents (one row per
        job, sorted ids) — the fsck repair and the lazy migration path
        for stores that predate the log. Atomic replace, so concurrent
        readers see either the old log or the new one."""
        with self._locked(".store"):
            jobs = self.list()
            lines = [
                json.dumps(self._queue_record(j), sort_keys=True,
                           separators=(",", ":"))
                for j in sorted(jobs, key=lambda j: j.id)
            ]
            text = "\n".join(lines) + ("\n" if lines else "")
            atomic_write_text(self.queue_log_path, text, fsync=False)
        self._qrows, self._qlog_pos, self._qlog_ino = {}, 0, None
        return len(lines)

    @staticmethod
    def _row_stale(row: Optional[dict], job: "Job") -> bool:
        """A row misrepresents its job when the poll-relevant fields —
        state, lease holder, lease generation — disagree with the doc.
        (A row showing a leased job as free sends every poller into a
        claim conflict; state alone would miss that.)"""
        if row is None:
            return True
        lease = job.lease or {}
        return (row.get("state") != job.state
                or row.get("worker") != lease.get("worker")
                or row.get("gen", 0) != job.lease_gen)

    def queue_log_lag(self) -> int:
        """How many jobs the index currently misrepresents: doc state
        or lease differs from (or is missing from) the log's last
        word. O(n) — for sweeps, fsck and /healthz, never the poll
        path."""
        rows = self.queue_rows()
        return sum(1 for job in self.list()
                   if self._row_stale(rows.get(job.id), job))

    def sync_queue_log(self) -> int:
        """Append correction rows for any job the log misrepresents
        (e.g. the doc write landed but the process died before the
        mirror append). Called from the serve sweep and fsck — both
        already pay the O(n) doc scan."""
        rows = self.queue_rows()
        fixed = 0
        for job in self.list():
            if self._row_stale(rows.get(job.id), job):
                with contextlib.suppress(OSError):
                    append_text(self.queue_log_path,
                                json.dumps(self._queue_record(job),
                                           sort_keys=True,
                                           separators=(",", ":")) + "\n",
                                fsync=False)
                fixed += 1
        return fixed

    # -- submit / read -------------------------------------------------------

    def submit(self, spec: dict, *, priority: int = 0,
               deadline_s: Optional[float] = None) -> Job:
        """Validate + enqueue a job. `deadline_s` is relative seconds
        from submit; the store records the ABSOLUTE wall deadline."""
        spec = normalize_spec(spec)
        now = time.time()
        with self._locked(".store"):
            seq = 1 + max(
                (int(m.group(1)) for m in (
                    re.match(r"j(\d+)-", fn)
                    for fn in os.listdir(self.jobs_dir)
                ) if m),
                default=0,
            )
            sha = spec_sha(spec)
            job = Job(
                id=f"j{seq:04d}-{sha[:8]}",
                spec=spec,
                fingerprint=job_fingerprint(spec),
                fingerprint_sha=sha,
                subkey=job_subkey(spec),
                priority=int(priority),
                deadline_ts=(now + float(deadline_s)) if deadline_s else None,
                ts_submit=round(now, 3),
                history=[[round(now, 3), QUEUED]],
            )
            self._write(job)
            self._emit(job.id, [
                {"type": "submitted", "machine": spec["machine"],
                 "seeds": spec["seeds"], "batch": spec["batch"],
                 "priority": job.priority, "subkey": job.subkey},
                {"type": "queued"},
            ])
        return job

    def get(self, job_id: str) -> Job:
        """Read a job document. Raises KeyError when it does not exist
        and CorruptJobFile when it exists but cannot be read — a torn
        or schema-broken file must surface as "run fsck", never as an
        uncaught decode error deep in a worker or API handler."""
        path = self.job_path(job_id)
        try:
            with open(path) as f:
                return Job.from_dict(json.load(f))
        except FileNotFoundError:
            raise KeyError(f"no such job {job_id!r}") from None
        except (json.JSONDecodeError, UnicodeDecodeError) as exc:
            raise CorruptJobFile(path, f"unparseable JSON ({exc})") from None
        except TypeError as exc:
            raise CorruptJobFile(path, f"schema mismatch ({exc})") from None

    def list(self) -> List[Job]:
        out = []
        for fn in sorted(os.listdir(self.jobs_dir)):
            # strict id match: the directory also holds each job's
            # .ckpt.json checkpoint and .stats.json snapshot
            m = re.fullmatch(r"(j\d+-[0-9a-f]{8})\.json", fn)
            if m:
                # a corrupt document never takes the farm down: the
                # sweep/allocator simply do not see it until fsck
                # quarantines or an operator repairs it
                with contextlib.suppress(KeyError, CorruptJobFile):
                    out.append(self.get(m.group(1)))
        return out

    def counts(self) -> Dict[str, int]:
        c = {s: 0 for s in STATES}
        for j in self.list():
            c[j.state] = c.get(j.state, 0) + 1
        return c

    # -- the event log (observability-class; never feeds results) ------------

    def _emit(self, job_id: str, pending: List[dict]) -> None:
        """Append pending event records to the job's lifecycle log.
        Called under the same per-job lock as the mutation that
        produced them, so the log is the authoritative ordered history.
        Emission failure never breaks the store (the chaos harness
        SIGKILLs exactly here on purpose)."""
        if not pending or not fleet_events.enabled():
            return
        path = self.events_path(job_id)
        for ev in pending:
            ev = dict(ev)
            type_ = ev.pop("type")
            with contextlib.suppress(OSError):
                fleet_events.emit_event(path, type_, job=job_id, **ev)

    def emit_job_event(self, job_id: str, type_: str, *,
                       worker: Optional[str] = None, **fields) -> None:
        """Milestone events that do not mutate the job document (find,
        shrink_started/shrink_done): the worker reports them through
        the store so they take the same per-job lock — and therefore
        the same total order — as the lifecycle events."""
        if not fleet_events.enabled():
            return
        with self._locked(job_id):
            with contextlib.suppress(OSError):
                fleet_events.emit_event(self.events_path(job_id), type_,
                                        job=job_id, worker=worker, **fields)

    def read_events(self, job_id: str, since: int = 0) -> List[dict]:
        return fleet_events.read_events(self.events_path(job_id), since)

    # -- guarded mutation ----------------------------------------------------

    def _update(self, job_id: str, fn: Callable[[Job], None],
                pending_events: Optional[List[dict]] = None) -> Job:
        with self._locked(job_id):
            job = self.get(job_id)
            fn(job)
            self._write(job)
            if pending_events:
                self._emit(job_id, pending_events)
        return job

    def _fenced(self, job: Job, worker: Optional[str], gen: Optional[int],
                op: str, ev: List[dict]) -> bool:
        """The fence: a mutation carrying a token (worker, gen) goes
        through only while that exact generation is the live lease.
        Rejections are counted on the document and logged as a `fenced`
        event — observability, never results — and the caller raises
        FencedWrite so the zombie learns it lost the job. No token
        (gen None) means an operator/supervisor mutation: not fenced."""
        if gen is None:
            return False
        lease = job.lease
        if lease and lease["worker"] == worker and lease.get("gen", 0) == gen:
            return False
        job.n_fenced_writes += 1
        ev.append({"type": "fenced", "worker": worker, "gen": gen,
                   "op": op, "holder": lease["worker"] if lease else None,
                   "holder_gen": job.lease_gen})
        return True

    def transition(self, job_id: str, to: str, *, error: Optional[str] = None,
                   result: Optional[dict] = None,
                   progress: Optional[dict] = None,
                   worker: Optional[str] = None,
                   gen: Optional[int] = None) -> Job:
        """Move a job along the lifecycle; illegal edges raise. When
        the caller holds a lease it passes its fencing token (worker,
        gen): a reclaimed generation's transition raises FencedWrite
        and mutates nothing but the rejection counter."""
        if to not in STATES:
            raise ValueError(f"unknown state {to!r}")

        ev: List[dict] = []
        fenced: List[bool] = [False]

        def mut(job: Job) -> None:
            if self._fenced(job, worker, gen, f"transition->{to}", ev):
                fenced[0] = True
                return
            if to not in _TRANSITIONS[job.state]:
                raise ValueError(
                    f"illegal transition {job.state} -> {to} for {job.id}"
                )
            rec = {"type": to, "from": job.state}
            if job.lease:
                rec["worker"] = job.lease["worker"]
            if error is not None:
                rec["error"] = error
            ev.append(rec)
            job.state = to
            job.history.append([round(time.time(), 3), to])
            if error is not None:
                job.error = error
            if result is not None:
                job.result = result
            if progress is not None:
                job.progress = {**job.progress, **progress}
            if to in TERMINAL:
                job.lease = None

        out = self._update(job_id, mut, ev)
        if fenced[0]:
            raise FencedWrite(job_id, worker or "?", gen, f"transition->{to}")
        if to in TERMINAL:
            self._clear_claim(job_id)
        return out

    def request_cancel(self, job_id: str) -> Job:
        """Queued jobs cancel immediately; in-flight jobs get the flag
        and the worker finalizes at the next unit boundary."""

        ev: List[dict] = []

        def mut(job: Job) -> None:
            if job.terminal:
                return
            job.cancel_requested = True
            if job.state == QUEUED:
                ev.append({"type": "cancelled", "from": job.state})
                job.state = CANCELLED
                job.history.append([round(time.time(), 3), CANCELLED])
                job.lease = None
            else:
                ev.append({"type": "cancel_requested"})

        out = self._update(job_id, mut, ev)
        if out.terminal:
            self._clear_claim(job_id)
        return out

    # -- leases --------------------------------------------------------------

    def _read_claim(self, job_id: str) -> Optional[dict]:
        try:
            with open(self.claim_path(job_id)) as f:
                doc = json.loads(f.read())
            return doc if isinstance(doc, dict) else None
        except (OSError, json.JSONDecodeError, UnicodeDecodeError):
            return None

    def _clear_claim(self, job_id: str) -> None:
        with contextlib.suppress(OSError):
            os.unlink(self.claim_path(job_id))

    def try_lease(self, job_id: str, worker: str, ttl_s: float, *,
                  info: Optional[dict] = None) -> Optional[Job]:
        """Claim (or renew/reclaim) a job for `worker`. Returns the job
        when the lease is held, None when another worker's unexpired
        lease blocks it or the job is in requeue backoff. A worker
        always reclaims its OWN lease immediately (restart-after-
        SIGKILL without waiting out the ttl).

        Contention discipline: a `jobs/<id>.claim` file created
        O_EXCL-style arbitrates N workers racing the same pick — the
        kernel picks exactly one winner and every loser returns None
        *without taking the job's lock* (`info["outcome"] ==
        "claim-conflict"`; the caller backs off with seeded jitter). A
        claim whose holder no longer has a live lease on the doc is
        dead weight (crashed claimant or reclaimed generation): the
        contender falls through to the flock, which stays the
        authoritative arbiter, and overwrites it on success. `info`,
        when passed, receives the outcome for the caller's counters."""
        now = time.time()
        claimed: List[Optional[Job]] = [None]
        claim = self.claim_path(job_id)
        won_create = create_exclusive(
            claim,
            json.dumps({"worker": worker, "ts": round(now, 3)},
                       sort_keys=True) + "\n",
            fsync=False,
        )
        if not won_create:
            holder = self._read_claim(job_id)
            if holder and holder.get("worker") not in (None, worker):
                try:
                    cur: Optional[Job] = self.get(job_id)
                except (KeyError, CorruptJobFile):
                    cur = None
                lease = cur.lease if cur else None
                if (lease and lease["worker"] == holder.get("worker")
                        and lease["expires_ts"] > now):
                    # live claim, live lease: a genuine race lost
                    if info is not None:
                        info["outcome"] = "claim-conflict"
                        info["holder"] = lease["worker"]
                    return None
                # stale claim (dead generation / claimant died between
                # claim and lease): arbitrate under the lock below

        def mut(job: Job) -> None:
            if job.state not in LEASABLE:
                return
            if job.requeue_after_ts and job.requeue_after_ts > now:
                return  # still backing off from its last death
            lease = job.lease
            if (lease and lease["worker"] != worker
                    and lease["expires_ts"] > now):
                return
            if not (lease and lease["worker"] == worker):
                # a NEW holder (first lease, takeover, or re-lease
                # after a reclaim cleared it) starts a new lease
                # generation and is an event; a worker re-claiming its
                # own lease is just a renewal and keeps the generation
                job.lease_gen += 1
                ev.append({"type": "leased", "worker": worker,
                           "ttl_s": ttl_s, "attempt": job.attempt,
                           "gen": job.lease_gen})
            job.lease = {
                "worker": worker,
                "expires_ts": round(now + ttl_s, 3),
                "ttl_s": ttl_s,
                "gen": job.lease_gen,
            }
            claimed[0] = job

        ev: List[dict] = []
        try:
            self._update(job_id, mut, ev)
        except (KeyError, CorruptJobFile):
            if won_create:
                self._clear_claim(job_id)
            raise
        got = claimed[0]
        if got is not None:
            # stamp the claim with the winning hold (atomic replace —
            # the O_EXCL race is settled once the lease is on the doc);
            # fsck judges claim staleness by this generation
            atomic_write_text(
                claim,
                json.dumps({"worker": worker, "gen": got.lease_gen,
                            "expires_ts": got.lease["expires_ts"]},
                           sort_keys=True) + "\n",
                fsync=False,
            )
            if info is not None:
                info["outcome"] = "leased"
        else:
            if won_create:
                # we arbitrated the claim but the doc said no (backoff,
                # terminal, foreign lease): leave nothing behind
                self._clear_claim(job_id)
            if info is not None:
                info.setdefault("outcome", "not-leasable")
        return got

    def renew_lease(self, job_id: str, worker: str,
                    gen: Optional[int] = None) -> bool:
        """Heartbeat renewal as a compare-and-swap on the lease
        generation. `reclaim_expired` can fire between a live worker's
        last read and its renewal: worker-identity alone would then
        either no-op silently (lease cleared) or — worse, when the
        same worker re-leased in between — resurrect a hold from a
        dead generation. The CAS renews only while `worker` still
        holds generation `gen` and reports the outcome, so the caller
        learns it lost the job instead of streaming on. `gen=None`
        checks worker identity only (pre-fencing callers)."""
        renewed = [False]

        def mut(job: Job) -> None:
            lease = job.lease
            if not (lease and lease["worker"] == worker):
                return
            if gen is not None and lease.get("gen", 0) != gen:
                return
            lease["expires_ts"] = round(time.time() + lease["ttl_s"], 3)
            renewed[0] = True

        self._update(job_id, mut)
        return renewed[0]

    # -- deaths, requeue, quarantine -----------------------------------------

    def note_progress(self, job_id: str, worker: str, progress: dict,
                      event_fields: Optional[dict] = None,
                      gen: Optional[int] = None) -> Job:
        """A unit completed: merge progress, reset the consecutive-
        failure counter (deaths are only poison when consecutive) and
        renew the lease — one locked write, so the worker's per-unit
        store-write sequence stays deterministic for the chaos
        harness's write counter. `event_fields` carries the worker's
        batch telemetry (seeds/s, elapsed, device count) into the
        `batch_done` event.

        `gen` is the worker's fencing token: a reclaimed generation's
        progress raises FencedWrite and merges NOTHING — a zombie must
        not resurrect the lease, reset the attempt counter, or clobber
        the current holder's progress. Pre-fencing callers (gen None)
        keep the worker-identity-only lease renewal."""
        ev: List[dict] = []
        fenced: List[bool] = [False]

        def mut(job: Job) -> None:
            if self._fenced(job, worker, gen, "note_progress", ev):
                fenced[0] = True
                return
            was_plateau = bool(job.progress.get("plateau"))
            job.progress = {**job.progress, **progress}
            job.attempt = 0
            job.requeue_after_ts = None
            if job.lease and job.lease["worker"] == worker:
                job.lease["expires_ts"] = round(
                    time.time() + job.lease["ttl_s"], 3
                )
            rec = {"type": "batch_done", "worker": worker,
                   "batch": job.progress.get("batches_run"),
                   "coverage_slots": job.progress.get("coverage_slots"),
                   "escalation": job.progress.get("escalation"),
                   "failing": job.progress.get("failing")}
            if job.lease:
                rec["gen"] = job.lease.get("gen", 0)
            rec.update(event_fields or {})
            ev.append(rec)
            if not was_plateau and bool(job.progress.get("plateau")):
                ev.append({"type": "plateau", "worker": worker,
                           "batch": job.progress.get("batches_run")})

        out = self._update(job_id, mut, ev)
        if fenced[0]:
            raise FencedWrite(job_id, worker, gen, "note_progress")
        return out

    def record_death(self, job_id: str, *, reason: str,
                     worker: Optional[str] = None,
                     error: Optional[str] = None,
                     batch_index: Optional[int] = None,
                     max_attempts: int = MAX_ATTEMPTS,
                     backoff_base_s: float = REQUEUE_BACKOFF_BASE_S,
                     lease_reclaim: bool = False,
                     require_expired_lease: bool = False,
                     gen: Optional[int] = None) -> Optional[Job]:
        """One worker death (expired lease) or worker-reported hard
        failure on this job: bump the consecutive-attempt counter and
        either requeue with exponential backoff — checkpoint preserved,
        so the next worker resumes at <=1 lost batch — or, at
        `max_attempts`, quarantine with the full post-mortem (last
        exception, batch index, repro command). Returns the updated job,
        or None when the guarded re-check made this a no-op (e.g. the
        lease was renewed between the sweep's scan and the lock).

        A worker SELF-reporting a failure passes its fencing token:
        a zombie's death report from a dead generation must not clear
        the current holder's lease or burn an attempt on a job someone
        else is running — it is counted and dropped (returns None,
        no raise: the reporter was abandoning the job anyway)."""
        now = time.time()
        done: List[Optional[Job]] = [None]

        def mut(job: Job) -> None:
            if self._fenced(job, worker, gen, "record_death", ev):
                return
            if job.state not in LEASABLE:
                return
            if require_expired_lease and not (
                job.lease and job.lease["expires_ts"] <= now
            ):
                return
            job.attempt += 1
            if lease_reclaim:
                job.n_lease_reclaims += 1
            job.deaths.append({
                "ts": round(now, 3),
                "reason": reason,
                "worker": worker,
                "state": job.state,
                "error": error,
                "batch_index": batch_index,
                "attempt": job.attempt,
            })
            job.lease = None
            if error is not None:
                job.error = error
            if job.attempt >= max_attempts:
                job.quarantine = {
                    "reason": (
                        f"{job.attempt} consecutive failed attempts "
                        f"({reason})"
                    ),
                    "error": error,
                    "batch_index": batch_index,
                    "attempts": job.attempt,
                    "deaths": job.deaths[-max_attempts:],
                    "repro": repro_cmd(job.spec, batch_index=batch_index),
                }
                job.state = QUARANTINED
                job.history.append([round(now, 3), QUARANTINED])
                job.requeue_after_ts = None
                ev.append({"type": "quarantined", "worker": worker,
                           "reason": job.quarantine["reason"],
                           "batch": batch_index})
            else:
                job.n_requeues += 1
                job.requeue_after_ts = round(
                    now + backoff_base_s * (2 ** (job.attempt - 1)), 3
                )
                if job.state != QUEUED:
                    job.state = QUEUED
                    job.history.append([round(now, 3), QUEUED])
                ev.append({"type": "requeued", "cause": reason,
                           "worker": worker, "attempt": job.attempt,
                           "backoff_s": round(
                               backoff_base_s * (2 ** (job.attempt - 1)), 3),
                           "batch": batch_index})
            done[0] = job

        ev: List[dict] = []
        self._update(job_id, mut, ev)
        if done[0] is not None:
            self._clear_claim(job_id)  # the lease is gone either way
        return done[0]

    def reclaim_expired(self, *, max_attempts: int = MAX_ATTEMPTS,
                        backoff_base_s: float = REQUEUE_BACKOFF_BASE_S,
                        via_index: bool = False) -> List[dict]:
        """The supervisor sweep: every non-terminal job whose worker
        lease expired is a worker death — requeue it (or quarantine at
        the attempt cap) via `record_death`. Runs in `fleet serve`'s
        sweep thread, in `fleet fsck --reclaim`, and at the top of every
        worker lease poll, so a farm with ANY live component reclaims.
        Returns one action record per reclaimed job.

        `via_index=True` sweeps from the queue-log index instead of
        re-reading every document — the worker-poll variant, O(1) when
        nothing expired. Safe against a lagging index: `record_death`
        re-validates the expiry under the job's lock, so a stale row
        is a no-op (a MISSING row is healed by the serve sweep's
        `sync_queue_log`, which runs the full-scan variant)."""
        now = time.time()
        actions = []
        if via_index:
            sweep = [
                SimpleNamespace(
                    id=row["job"], state=row.get("state"),
                    lease=(
                        {"worker": row.get("worker"),
                         "expires_ts": row.get("lease_expires_ts")}
                        if row.get("worker") else None
                    ),
                    error=None,
                )
                for row in list(self.queue_rows().values())
            ]
        else:
            sweep = self.list()
        for job in sweep:
            if job.state not in LEASABLE or not job.lease:
                continue
            if (job.lease["expires_ts"] or 0) > now:
                continue
            dead_worker = job.lease["worker"]
            try:
                out = self.record_death(
                    job.id,
                    reason="lease expired",
                    worker=dead_worker,
                    error=job.error,
                    batch_index=self._ckpt_batch(job.id),
                    max_attempts=max_attempts,
                    backoff_base_s=backoff_base_s,
                    lease_reclaim=True,
                    require_expired_lease=True,
                )
            except (KeyError, CorruptJobFile):
                continue  # index row outlived its doc: fsck's problem
            if out is not None:
                actions.append({
                    "job": out.id,
                    "worker": dead_worker,
                    "outcome": out.state,
                    "attempt": out.attempt,
                    "requeue_after_ts": out.requeue_after_ts,
                })
        return actions

    def release_quarantined(self, job_id: str) -> Job:
        """The explicit operator edge out of quarantine: back to
        `queued` with the attempt counter reset. The quarantine
        post-mortem stays on the document (audit trail) until a fresh
        quarantine overwrites it."""

        ev: List[dict] = []

        def mut(job: Job) -> None:
            if job.state != QUARANTINED:
                raise ValueError(
                    f"job {job.id} is {job.state}, not quarantined"
                )
            job.state = QUEUED
            job.history.append([round(time.time(), 3), QUEUED])
            job.attempt = 0
            job.requeue_after_ts = None
            job.n_requeues += 1
            ev.append({"type": "requeued",
                       "cause": "released from quarantine"})

        return self._update(job_id, mut, ev)

    def degrade_lanes(self, job_id: str, *, error: str,
                      worker: Optional[str] = None,
                      gen: Optional[int] = None) -> Job:
        """OOM lane-count backoff: halve the job's `batch` and requeue
        it, instead of burning attempts on a shape that cannot
        allocate. `batch` is a fingerprint field, so the fingerprint /
        spec sha / warm-compile subkey are re-derived and re-recorded
        (a deliberate, audited re-spec — NOT silent drift), and the old
        checkpoint — whose fingerprint no longer matches — is removed:
        the job restarts its seed schedule at the smaller shape.
        Correctness over progress; the degradation is recorded in
        `job.degraded`."""
        new_batch: List[int] = [0]
        ev: List[dict] = []
        fenced: List[bool] = [False]

        def mut(job: Job) -> None:
            if self._fenced(job, worker, gen, "degrade_lanes", ev):
                fenced[0] = True
                return
            if job.terminal:
                return
            nb = max(1, job.spec["batch"] // 2)
            new_batch[0] = nb
            job.degraded.append({
                "ts": round(time.time(), 3),
                "from_batch": job.spec["batch"],
                "to_batch": nb,
                "error": error,
                "worker": worker,
            })
            ev.append({"type": "degraded", "worker": worker,
                       "from_batch": job.spec["batch"], "to_batch": nb})
            job.spec = {**job.spec, "batch": nb}
            job.fingerprint = job_fingerprint(job.spec)
            job.fingerprint_sha = spec_sha(job.spec)
            job.subkey = job_subkey(job.spec)
            job.lease = None
            job.requeue_after_ts = None
            job.n_requeues += 1
            if job.state != QUEUED:
                job.state = QUEUED
                job.history.append([round(time.time(), 3), QUEUED])
            ev.append({"type": "requeued", "cause": "lane degradation",
                       "worker": worker})

        out = self._update(job_id, mut, ev)
        if fenced[0]:
            raise FencedWrite(job_id, worker or "?", gen, "degrade_lanes")
        self._clear_claim(job_id)  # requeued: the hold is over
        with contextlib.suppress(OSError):
            os.remove(self.ckpt_path(job_id))
        return out

    def _ckpt_batch(self, job_id: str) -> Optional[int]:
        """Best-effort batch index from the job's checkpoint (for death
        post-mortems); None when there is no readable checkpoint."""
        try:
            with open(self.ckpt_path(job_id)) as f:
                return int(json.load(f).get("batch", 0))
        except (OSError, ValueError, TypeError):
            return None

    def stale_leases(self) -> int:
        """How many non-terminal jobs hold an expired lease right now
        (the `/healthz` gauge; the next sweep will reclaim them)."""
        now = time.time()
        return sum(
            1 for j in self.list()
            if j.state in LEASABLE and j.lease
            and j.lease["expires_ts"] <= now
        )

    # -- drift refusal -------------------------------------------------------

    def fingerprint_mismatch(self, job: Job) -> Optional[str]:
        """None when the job's spec still hashes to its recorded
        fingerprint; otherwise a message naming EVERY drifted field —
        the same shape the checkpoint refusal prints, surfaced verbatim
        as the job's `failed` reason."""
        want = job_fingerprint(job.spec)
        diffs = [
            f"{f} (recorded {job.fingerprint.get(f)!r}, now {want.get(f)!r})"
            for f in sorted(set(want) | set(job.fingerprint))
            if job.fingerprint.get(f) != want.get(f)
        ]
        if spec_sha(job.spec) != job.fingerprint_sha and not diffs:
            diffs = ["spec hash (non-fingerprint field edited)"]
        if not diffs:
            return None
        return (
            f"job {job.id}: spec drifted since submit — refusing to run; "
            "differing: " + ", ".join(diffs)
        )

    # -- live feed -----------------------------------------------------------

    def read_feed(self, job_id: str, last: int = 20) -> List[dict]:
        """The job's live per-batch coverage/failure feed: the tail of
        its StatsEmitter JSONL, parsed. Missing file = empty feed (the
        job has not started streaming yet)."""
        path = self.stats_base(job_id) + ".jsonl"
        try:
            with open(path) as f:
                lines = f.readlines()
        except OSError:
            return []
        out = []
        for line in lines[-max(0, last):]:
            with contextlib.suppress(json.JSONDecodeError):
                out.append(json.loads(line))
        return out
