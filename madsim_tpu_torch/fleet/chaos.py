"""The fleet-chaos harness — test the farm with its own medicine.

The repo's whole thesis (PAPER.md) is that recovery code is exactly the
code you cannot trust until you have injected every failure
deterministically. The fleet IS recovery code — leases, requeues,
quarantine, fsck — so it gets the same treatment the simulated
protocols get: a seeded schedule of process-level faults, derived from
ONE RNG so a failing seed reproduces forever, with the invariants
checked after every schedule:

* **no accepted job is ever lost** — every submitted job reaches a
  real terminal state with a result, never `failed`/`cancelled`, and a
  healthy job quarantined by genuinely-consecutive deaths is released
  and completes;
* **byte-identical recovery** — each job's final `result.report` is
  byte-identical to an unperturbed oracle farm's run of the same spec
  (the checkpoint resume guarantee, now across worker replacement, torn
  writes and lease-clock jumps);
* **the store heals** — the final fsck leaves zero corrupt files and
  zero stale tmp files;
* (`--real` only) **every filed find still `regress`-replays**.

The fault vocabulary (`derive_schedule`):

``kill_worker``   SIGKILL the worker at its k-th store write (injected
                  at the shared `runtime/atomicio` write point — "at
                  step k" is an instrumented, replayable place, not a
                  wall-clock race)
``torn_write``    the kill lands mid-write: b bytes of the k-th payload
                  reach the tmp file, the rename never runs — the
                  atomicity claim under test is that the final path
                  keeps its previous version
``corrupt_ckpt``  external corruption: truncate a checkpoint's FINAL
                  file at byte b (what a dying disk — not the farm's
                  own fsync'd writes — can produce); the lenient reader
                  must quarantine it and restart the stream
``lease_jump``    jump the lease clock: expire every live lease on
                  disk, then run the reclamation sweep (requeue with
                  backoff / quarantine at the cap)
``server_bounce`` SIGKILL `fleet serve`, issue a client verb INTO the
                  outage (the seeded-jitter retry must carry it), then
                  restart the server on the same port — a bounce-window
                  submit grows the accepted-jobs set the invariants
                  track
``sigterm_worker``  graceful kill: SIGTERM the worker at its k-th
                  store write (same instrumented injection point as
                  ``kill_worker``). The invariant under test is the
                  crash-flush path: the dying worker must leave a
                  non-empty span dump — its open spans materialized
                  as ``partial`` — so the killed unit's
                  `fleet timeline` is never empty
``clean_units``   run k units with no fault (progress resets the
                  consecutive-attempt counter — quarantine only fires
                  on genuinely consecutive deaths)
``kill_event_append``  the kill lands mid-append to a job's
                  `.events.jsonl`: b bytes of the k-th event record
                  reach the REAL file (appends are fsync'd but not
                  atomic, by design), then SIGKILL — the next append's
                  healing newline must confine the torn record to its
                  own line, readers skip it, and the job's lifecycle
                  (and byte-identical report) must be unaffected
``torn_events``   external truncation of a job's `.events.jsonl` at a
                  JSON-structural boundary — fsck must REPORT the torn
                  tail without quarantining the log (it is an append-
                  mode observability stream, not sim state)

The ``claims`` profile races the contention plane itself and
only makes sense with ``--workers N`` > 1 (it still passes at 1 —
the races just never fire):

``claim_race``    SIGKILL one contender at its k-th O_EXCL claim-file
                  create — the other racers must arbitrate around the
                  corpse's stale claim (flock stays authoritative)
``zombie_resume`` SIGSTOP one worker at its k-th CHECKPOINT write (a
                  path written outside every store flock), expire its
                  lease, let a new holder reclaim and finish the job,
                  then SIGCONT the zombie — every resumed write must
                  be REFUSED by its dead fencing generation, counted
                  on the doc, never merged
``lease_jump_one``  jump the lease clock for ONE worker's holdings
                  only (the suspended-VM case): its jobs reclaim while
                  every other lease stays live
``torn_queue_log``  the kill lands mid-append to the shared queue.log:
                  a torn tail reaches the REAL file — index readers
                  must leave it unconsumed, pollers fall back to the
                  docs, and fsck rebuilds the log from them

With ``--workers N`` every worker-running round launches N synthetic
workers CONCURRENTLY against one store (ids ``chaos-w0..``, the armed
chaos plan on a seeded choice of one), and two contention invariants
join the originals: **no (job, batch, generation) is executed by two
workers** (batch_done events are the witness) and **no find is filed
twice** (corpus keys stay unique). The final reports must STILL be
byte-identical to the 1-worker oracle — contention is not allowed to
change a single result byte.

By default workers run the torch-free **synthetic driver** below — the
deterministic stand-in for `_stream_batches` that drives the REAL
checkpoint, stats-emitter and store machinery (the farm paths under
test) without an engine, so one chaos round costs milliseconds and a
32-seed sweep is a lunch break, not a day. `--real` swaps in echo-
machine engines end to end, on the CUDA card (or the CPU with
`device="cpu"`).

Torch-free by contract (the orchestrator and the synthetic driver import
no engine code); `random.Random(seed)` is the repo-sanctioned seeded
constructor.
"""

from __future__ import annotations

# madsim: allow-file(D001) — the orchestrator babysits real processes:
# subprocess timeouts, bounce windows and drain deadlines are host
# wall-clock by nature. Nothing here feeds simulation state; the
# schedule itself is a pure function of the seed.
import contextlib
import json
import os
import random
import shutil
import signal
import subprocess
import sys
import tempfile
import threading
import time
from typing import List, Optional

from . import client as fleet_client
from . import fsck as fsck_mod
from .store import (
    FAILED,
    CANCELLED,
    QUARANTINED,
    TERMINAL,
    JobStore,
)

CHAOS_ENV = "MADSIM_TPU_FLEET_CHAOS"

#: action weights per profile (CI pins one kill-heavy and
#: one torn-heavy seed)
_PROFILES = {
    "kill": (("kill_worker", 5), ("torn_write", 1), ("corrupt_ckpt", 1),
             ("lease_jump", 2), ("server_bounce", 1), ("clean_units", 2),
             ("kill_event_append", 2), ("torn_events", 1)),
    "torn": (("kill_worker", 1), ("torn_write", 5), ("corrupt_ckpt", 2),
             ("lease_jump", 1), ("server_bounce", 1), ("clean_units", 2),
             ("kill_event_append", 1), ("torn_events", 2)),
    "mixed": (("kill_worker", 2), ("torn_write", 2), ("corrupt_ckpt", 1),
              ("lease_jump", 2), ("server_bounce", 1), ("clean_units", 2),
              ("kill_event_append", 1), ("torn_events", 1)),
    # the graceful-kill profile exercises the
    # partial-span crash flush — a NEW profile so the pinned seeds of
    # the profiles above keep their schedules byte-identical
    "spans": (("sigterm_worker", 5), ("kill_worker", 1),
              ("lease_jump", 1), ("clean_units", 2)),
    # the contention profile — claim races, zombie resumes,
    # single-worker lease jumps and torn queue-log tails. A NEW
    # profile (same precedent as "spans") so kill/torn/mixed pinned
    # seeds keep their schedules byte-identical
    "claims": (("claim_race", 4), ("zombie_resume", 2),
               ("lease_jump_one", 2), ("torn_queue_log", 2),
               ("kill_worker", 1), ("clean_units", 2)),
}


# -- the synthetic driver ----------------------------------------------------


def synthetic_driver(worker, job, args) -> None:
    """Deterministic torch-free stand-in for one `_stream_batches` unit.

    Everything the farm touches is REAL — the fingerprinted checkpoint
    (strict load + `check_fingerprint` refusal, atomic save), the
    per-job StatsEmitter feed, the store lifecycle the caller drives —
    only the engine between them is simulated: batch results are a pure
    function of (spec, batch index), which is exactly the determinism
    contract the byte-identical oracle invariant needs.

    Magic machine names (farm test fixtures):

    * ``chaos-poison``  raises every attempt once batch index 1 (the
      second batch) is reached — the canonical poison job
    * ``chaos-oom``     raises an OOM-marked error while ``batch`` > 16
      — exercises the lane-count backoff
    * ``chaos-find``    one deterministic failing seed in batch 0 —
      exercises found -> shrunk -> filed under chaos
    """
    import sys as _sys

    from ..runtime.checkpoint import (
        check_fingerprint,
        fingerprint_from_args,
        load_checkpoint,
        save_checkpoint,
    )
    from ..tracing import StatsEmitter

    spec = job.spec
    ck = load_checkpoint(args.checkpoint)
    if ck is not None:
        err = check_fingerprint(ck, args)
        if err:
            _sys.exit(f"--checkpoint {args.checkpoint}: {err}")
    bi = int(ck["batch"]) if ck else 0
    machine = spec["machine"]
    if machine == "chaos-poison" and bi >= 1:
        raise RuntimeError(
            f"poison: model raised in batch {bi + 1} (synthetic fixture)"
        )
    if machine == "chaos-oom" and spec["batch"] > 16:
        raise RuntimeError(
            "RESOURCE_EXHAUSTED: out of memory allocating synthetic "
            f"buffer at {spec['batch']} lanes (fixture)"
        )
    planned = -(-spec["seeds"] // spec["batch"])
    chunk = min(spec["batch"], spec["seeds"] - bi * spec["batch"])
    completed = (int(ck["completed"]) if ck else 0) + chunk
    cursor = (int(ck["cursor"]) if ck else spec["seed"]) + chunk
    failing = [tuple(x) for x in ck["failing"]] if ck else []
    if machine == "chaos-find" and bi == 0:
        failing.append((spec["seed"] + 3, 7))
    done = completed >= spec["seeds"]
    emitter = StatsEmitter(args.stats, labels=args.stats_labels)
    emitter.emit({
        "kind": "fleet_batch", "machine": machine, "batch": bi + 1,
        "batches": planned, "completed": completed,
        "batch_completed": chunk, "failing": len(failing), "infra": 0,
        "abandoned": 0,
    })
    if done:
        emitter.emit({
            "kind": "fleet_summary", "machine": machine,
            "completed": completed, "failing": len(failing), "infra": 0,
            "abandoned": 0, "batches_run": bi + 1,
            "batches_planned": planned, "plateau": False,
        })
    emitter.close()
    save_checkpoint(args.checkpoint, {
        "fingerprint": fingerprint_from_args(args),
        "batch": bi + 1, "planned": planned, "cursor": cursor,
        "completed": completed, "seeds_consumed": completed,
        "failing": [list(x) for x in failing], "infra": [],
        "abandoned": [], "prov": {}, "cov_b64": None, "detector": None,
        "plateau": False, "done": done,
    })


# -- schedule derivation -----------------------------------------------------


def derive_schedule(seed: int, *, profile: str = "mixed",
                    rounds: Optional[int] = None,
                    jobs: Optional[int] = None,
                    real: bool = False) -> dict:
    """The whole attack, derived up front from one RNG — printed,
    persisted as `schedule.json`, and replayable from the seed alone."""
    if profile not in _PROFILES:
        raise ValueError(f"unknown profile {profile!r}; "
                         f"known: {sorted(_PROFILES)}")
    rng = random.Random(f"fleet-chaos-{seed}")
    n_jobs = jobs or rng.randint(2, 3)
    specs = []
    for i in range(n_jobs):
        if real:
            spec = {"machine": "echo", "seeds": 64, "batch": 32,
                    "faults": 0, "horizon": 1.0, "max_steps": 300}
        else:
            spec = {
                "machine": rng.choice(("chaos-echo", "chaos-find")),
                "seeds": rng.choice((48, 96)),
                "batch": rng.choice((16, 32)),
                "faults": 0,
            }
        specs.append(spec)
    actions, weights = zip(*_PROFILES[profile])
    n_rounds = rounds or rng.randint(5, 8)
    events: List[dict] = []
    for i in range(n_rounds):
        action = rng.choices(actions, weights=weights, k=1)[0]
        ev: dict = {"round": i, "action": action}
        if action == "kill_worker":
            ev["at_write"] = rng.randint(1, 16)
        elif action == "sigterm_worker":
            # counts CHECKPOINT writes only (see run_chaos): those
            # happen strictly mid-unit, where the worker's SIGTERM
            # flush handler is installed and spans are open — a
            # lease-write kill would have nothing to flush by design
            ev["at_write"] = rng.randint(1, 6)
        elif action == "torn_write":
            ev["at_write"] = rng.randint(1, 16)
            ev["at_byte"] = rng.randint(0, 200)
        elif action == "corrupt_ckpt":
            ev["job_index"] = rng.randrange(n_jobs)
            ev["at_byte"] = rng.randint(0, 160)
        elif action == "server_bounce":
            ev["verb"] = rng.choice(("queue", "submit"))
            if ev["verb"] == "submit":
                ev["spec"] = (
                    {"machine": "echo", "seeds": 64, "batch": 32,
                     "faults": 0, "horizon": 1.0, "max_steps": 300}
                    if real else
                    {"machine": "chaos-echo", "seeds": 48, "batch": 16,
                     "faults": 0}
                )
        elif action == "clean_units":
            ev["units"] = rng.randint(1, 3)
        elif action == "kill_event_append":
            # count only .events.jsonl appends; the torn prefix lands
            # in the REAL file (appends are not atomic, by design)
            ev["at_write"] = rng.randint(1, 6)
            ev["at_byte"] = rng.randint(0, 80)
        elif action == "torn_events":
            ev["job_index"] = rng.randrange(n_jobs)
            ev["cut"] = rng.randint(2, 25)
        elif action == "claim_race":
            # the k-th O_EXCL claim create (the .claim match counts
            # nothing else) — k small: claims happen once per lease
            ev["at_claim"] = rng.randint(1, 3)
        elif action == "zombie_resume":
            # counts CHECKPOINT writes only: .ckpt saves happen outside
            # every store flock, so a stopped zombie wedges nobody
            ev["at_write"] = rng.randint(1, 4)
        elif action == "torn_queue_log":
            ev["at_write"] = rng.randint(1, 6)
            ev["at_byte"] = rng.randint(0, 80)
        # lease_jump_one carries no params: the victim worker is
        # whoever holds a live lease when the round fires
        events.append(ev)
    return {"seed": seed, "profile": profile, "real": real,
            "specs": specs, "events": events}


# -- process plumbing --------------------------------------------------------


def _start_server(root: str, port_file: str,
                  addr: str = "127.0.0.1:0") -> subprocess.Popen:
    with contextlib.suppress(OSError):
        os.remove(port_file)
    proc = subprocess.Popen(
        [sys.executable, "-m", "madsim_tpu_torch", "fleet", "serve",
         "--root", root, "--addr", addr, "--port-file", port_file,
         # the harness drives reclamation itself (lease_jump events) so
         # same-seed runs keep a deterministic attempt history; the
         # sweep thread has its own in-process tests
         "--sweep-interval", "0"],
        stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL,
    )
    return proc


def _worker_cmd(root: str, *, worker_id: str, max_units: int,
                real: bool, backoff_base_s: float,
                lease_ttl_s: float, device: str = "cuda") -> tuple:
    cmd = [sys.executable, "-m", "madsim_tpu_torch", "fleet", "worker",
           "--root", root, "--worker-id", worker_id, "--poll", "0.02",
           "--lease-ttl", str(lease_ttl_s),
           "--backoff-base", str(backoff_base_s),
           # always drain-capable: a unit-budgeted round on an already-
           # finished farm must exit, not idle-poll into the timeout
           "--drain"]
    if not real:
        cmd += ["--driver", "synthetic"]
    elif device != "cuda":
        cmd += ["--device", device]
    if max_units:
        cmd += ["--max-units", str(max_units)]
    return tuple(cmd)


def _worker_env(chaos: Optional[dict]) -> dict:
    env = dict(os.environ)
    env.pop(CHAOS_ENV, None)
    if chaos is not None:
        env[CHAOS_ENV] = json.dumps(chaos)
    return env


def _run_worker(root: str, *, chaos: Optional[dict] = None,
                max_units: int = 0, worker_id: str = "chaos-w",
                real: bool = False, backoff_base_s: float = 0.05,
                lease_ttl_s: float = 30.0,
                timeout_s: float = 120.0,
                device: str = "cuda") -> subprocess.CompletedProcess:
    """One worker incarnation. An armed chaos plan makes it SIGKILL
    itself at the scheduled write (rc -9); otherwise it exits 0 after
    draining / its unit budget."""
    return subprocess.run(
        _worker_cmd(root, worker_id=worker_id, max_units=max_units,
                    real=real, device=device, backoff_base_s=backoff_base_s,
                    lease_ttl_s=lease_ttl_s),
        env=_worker_env(chaos), timeout=timeout_s,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )


def _spawn_worker(root: str, *, worker_id: str,
                  chaos: Optional[dict] = None, max_units: int = 0,
                  real: bool = False, backoff_base_s: float = 0.05,
                  lease_ttl_s: float = 30.0,
                  device: str = "cuda") -> subprocess.Popen:
    """Popen variant of `_run_worker` for rounds that run several
    workers at once (or need to signal one mid-flight)."""
    return subprocess.Popen(
        _worker_cmd(root, worker_id=worker_id, max_units=max_units,
                    real=real, device=device, backoff_base_s=backoff_base_s,
                    lease_ttl_s=lease_ttl_s),
        env=_worker_env(chaos),
        stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL,
    )


def _race_workers(root: str, worker_ids, *, plans: Optional[dict] = None,
                  max_units: int = 0, real: bool = False,
                  backoff_base_s: float = 0.05,
                  lease_ttl_s: float = 30.0,
                  timeout_s: float = 120.0,
                  device: str = "cuda") -> dict:
    """Launch every worker in `worker_ids` CONCURRENTLY against one
    store — the genuine N-claimants race.
    `plans` optionally arms a chaos plan on specific worker ids.
    Returns {worker_id: returncode} (a worker that outlives the
    timeout is killed and reported as -9)."""
    procs = {
        wid: _spawn_worker(root, worker_id=wid,
                           chaos=(plans or {}).get(wid),
                           max_units=max_units, real=real, device=device,
                           backoff_base_s=backoff_base_s,
                           lease_ttl_s=lease_ttl_s)
        for wid in worker_ids
    }
    deadline = time.monotonic() + timeout_s
    rcs = {}
    for wid, p in procs.items():
        try:
            p.wait(timeout=max(1.0, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait()
        rcs[wid] = p.returncode
    return rcs


def _wait_stopped(pid: int, timeout_s: float = 30.0) -> bool:
    """Poll /proc until the process is SIGSTOPped (state T) or gone.
    True = it is stopped and safe to operate around; False = it exited
    first (the write budget outlived the unit — nothing to zombify)."""
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        try:
            with open(f"/proc/{pid}/stat") as f:
                state = f.read().rsplit(")", 1)[1].split()[0]
        except (OSError, IndexError):
            return False
        if state in ("T", "t"):
            return True
        if state == "Z":
            return False
        time.sleep(0.02)
    return False


def _expire_leases(root: str, worker: Optional[str] = None) -> int:
    """The lease-clock jump: rewrite live leases as already expired
    (what a suspended worker VM looks like to the farm). With
    `worker`, only THAT worker's holdings jump — the single-victim
    variant the claims profile uses."""
    store = JobStore(root)

    def mut(j) -> None:
        if j.lease is not None and (
                worker is None or j.lease.get("worker") == worker):
            j.lease["expires_ts"] = 0.0

    n = 0
    for job in store.list():
        if job.lease is None:
            continue
        if worker is not None and job.lease.get("worker") != worker:
            continue
        store._update(job.id, mut)
        n += 1
    return n


def _tear_events_tail(path: str, cut: int) -> bool:
    """External truncation of an append-mode event log, mid-record and
    ON a JSON-structural character boundary inside the final record —
    the adversarial cut positions (a prefix like `{"seq": 7, "ts":`) a
    real torn disk write leaves behind. The invariants under test:
    fsck REPORTS the torn tail without quarantining the log, readers
    skip the torn line, and the next append's healing newline keeps
    later records parseable."""
    try:
        with open(path, "rb") as f:
            data = f.read()
    except OSError:
        return False
    body = data.rstrip(b"\n")
    if not body:
        return False
    last_nl = body.rfind(b"\n")
    last = body[last_nl + 1:]
    # structural positions within the last record; never 0 — an empty
    # tail would be a clean file, not a torn one
    marks = [i for i, c in enumerate(last) if c in b'{}[]:,"' and i > 0]
    if not marks:
        return False
    target = max(1, len(last) - cut)
    pos = min(marks, key=lambda i: abs(i - target))
    with open(path, "r+b") as f:
        f.truncate(last_nl + 1 + pos)
    return True


def _partial_span_dumped(root: str) -> bool:
    """True when any job's span dump holds a span tagged ``partial`` —
    the marker `PerfRecorder.open_spans` stamps on spans that were
    still open when a dying worker's SIGTERM flush materialized them."""
    store = JobStore(root)
    for job in store.list():
        try:
            with open(store.spans_path(job.id)) as f:
                lines = f.readlines()
        except OSError:
            continue
        for line in lines:
            try:
                rec = json.loads(line)
            except json.JSONDecodeError:
                continue
            for sp in rec.get("spans") or ():
                if (sp.get("args") or {}).get("partial"):
                    return True
    return False


def _truncate_file(path: str, at_byte: int) -> bool:
    """External-corruption simulation: cut a FINAL file (never what the
    farm's own fsync'd atomic writes produce). Clamped below the
    closing `}\\n` so the result is guaranteed unparseable."""
    try:
        size = os.path.getsize(path)
    except OSError:
        return False
    with open(path, "r+b") as f:
        f.truncate(min(at_byte, max(0, size - 3)))
    return True


def _contention_violations(root: str) -> List[str]:
    """The two multi-worker invariants, read back from the artifacts.

    * **no (job, batch, generation) executed by two unfenced workers**
      — every accepted `batch_done` event names its worker and the
      lease generation that authorized it; two workers landing the
      same (batch, gen) means a zombie write was merged instead of
      fenced. (The same batch under DIFFERENT generations is the
      legitimate requeue-and-retry path.)
    * **no find filed twice** — corpus entry keys
      (machine, nodes, seed, fail_code) stay unique even when racing
      workers both reach the filing path (parsed straight from
      corpus.json; chaos stays torch-free by contract).
    """
    out: List[str] = []
    store = JobStore(root)
    for job in store.list():
        owners: dict = {}
        for ev in store.read_events(job.id):
            if ev.get("type") != "batch_done":
                continue
            key = (ev.get("batch"), ev.get("gen"))
            w = ev.get("worker")
            prev = owners.setdefault(key, w)
            if prev != w:
                out.append(
                    f"job {job.id} batch {key[0]} gen {key[1]} executed "
                    f"by two unfenced workers: {prev} and {w}"
                )
    try:
        with open(store.corpus_path) as f:
            entries = json.load(f).get("entries", [])
    except (OSError, json.JSONDecodeError, AttributeError):
        entries = []
    seen: dict = {}
    for e in entries:
        key = (e.get("machine"), e.get("nodes"), e.get("seed"),
               e.get("fail_code"))
        seen[key] = seen.get(key, 0) + 1
    for key, n in seen.items():
        if n > 1:
            out.append(f"find filed {n} times: corpus key {key}")
    return out


# -- the orchestrator --------------------------------------------------------


def run_chaos(seed: int, *, profile: str = "mixed",
              out_dir: Optional[str] = None, real: bool = False,
              rounds: Optional[int] = None, jobs: Optional[int] = None,
              keep: bool = False, backoff_base_s: float = 0.05,
              recovery_rounds: int = 8, workers: int = 1,
              device: str = "cuda") -> dict:
    """Run one seeded chaos schedule against a scratch farm and check
    every invariant. Returns the result dict ({"ok", "violations",
    ...}); prints the exact reproduction line on failure.

    `workers` > 1 turns every worker-running round into an N-way race
    against one store (the armed chaos plan rides a seeded choice of
    contender), adds the contention invariants, and still demands the
    final reports byte-identical to the 1-worker oracle.

    With `real`, the workers (and the closing `regress`) run on
    `device`: the CUDA card by default, or "cpu"."""
    sched = derive_schedule(seed, profile=profile, rounds=rounds,
                            jobs=jobs, real=real)
    ephemeral = out_dir is None
    workdir = (
        tempfile.mkdtemp(prefix=f"fleet-chaos-{seed}-") if ephemeral
        else os.path.join(out_dir, f"seed{seed}")
    )
    os.makedirs(workdir, exist_ok=True)
    root = os.path.join(workdir, "farm")
    oracle_root = os.path.join(workdir, "oracle")
    port_file = os.path.join(workdir, "serve.port")
    with open(os.path.join(workdir, "schedule.json"), "w") as f:
        json.dump(sched, f, indent=1, sort_keys=True)
    worker_timeout = 600.0 if real else 120.0
    violations: List[str] = []
    job_ids: List[str] = []
    oracle_specs: List[dict] = []

    def _note(msg: str) -> None:
        print(f"chaos[{seed}]: {msg}", flush=True)

    n_workers = max(1, int(workers))
    wids = (["chaos-w"] if n_workers == 1
            else [f"chaos-w{i}" for i in range(n_workers)])
    # which contender carries the armed plan is itself seeded —
    # a failing (seed, workers) pair replays the same victim forever
    race_rng = random.Random(f"fleet-chaos-race {seed} {n_workers}")

    def _worker_round(*, chaos: Optional[dict] = None,
                      max_units: int = 0) -> dict:
        """One worker-running round: a single incarnation at
        --workers 1 (byte-identical to the pre-race harness), a
        genuine N-way race otherwise. Returns {worker_id: rc}."""
        if n_workers == 1:
            p = _run_worker(root, chaos=chaos, max_units=max_units,
                            worker_id=wids[0], real=real, device=device,
                            backoff_base_s=backoff_base_s,
                            timeout_s=worker_timeout)
            return {wids[0]: p.returncode}
        plans = ({race_rng.choice(wids): chaos}
                 if chaos is not None else None)
        return _race_workers(root, wids, plans=plans,
                             max_units=max_units, real=real, device=device,
                             backoff_base_s=backoff_base_s,
                             timeout_s=worker_timeout)

    def _rcs_str(rcs: dict) -> str:
        return ",".join(str(rc) for rc in rcs.values())

    server = _start_server(root, port_file)
    try:
        addr = fleet_client.resolve_addr(None, port_file, wait_s=30.0)
        for spec in sched["specs"]:
            job_ids.append(fleet_client.submit(addr, spec)["id"])
            oracle_specs.append(spec)
        _note(f"submitted {len(job_ids)} jobs; "
              f"{len(sched['events'])} scheduled events")

        for ev in sched["events"]:
            action = ev["action"]
            if action == "kill_worker":
                rcs = _worker_round(
                    chaos={"kill_at_write": ev["at_write"],
                           "match": root})
                _note(f"round {ev['round']}: kill_worker at write "
                      f"{ev['at_write']} -> rc {_rcs_str(rcs)}")
            elif action == "sigterm_worker":
                rcs = _worker_round(
                    chaos={"sigterm_at_write": ev["at_write"],
                           "match": ".ckpt"})
                died = -signal.SIGTERM in rcs.values()
                flushed = _partial_span_dumped(root)
                # the crash-flush invariant: a gracefully killed worker
                # leaves its open spans behind, tagged partial (if the
                # write budget outlived the unit the worker exits
                # clean and there is nothing to assert)
                if died and not flushed:
                    violations.append(
                        f"round {ev['round']}: SIGTERM'd worker left "
                        f"no partial span dump"
                    )
                _note(f"round {ev['round']}: sigterm_worker at write "
                      f"{ev['at_write']} -> rc {_rcs_str(rcs)} "
                      f"(partial spans {'flushed' if flushed else 'absent'})")
            elif action == "torn_write":
                rcs = _worker_round(
                    chaos={"torn_at_write": [ev["at_write"],
                                             ev["at_byte"]],
                           "match": root})
                _note(f"round {ev['round']}: torn_write "
                      f"[{ev['at_write']}, {ev['at_byte']}] -> "
                      f"rc {_rcs_str(rcs)}")
            elif action == "corrupt_ckpt":
                if ev["job_index"] < len(job_ids):
                    jid = job_ids[ev["job_index"]]
                    hit = _truncate_file(
                        JobStore(root).ckpt_path(jid), ev["at_byte"]
                    )
                    _note(f"round {ev['round']}: corrupt_ckpt {jid} "
                          f"at byte {ev['at_byte']} "
                          f"({'hit' if hit else 'no file yet'})")
            elif action == "lease_jump":
                n = _expire_leases(root)
                acts = fsck_mod.fsck(
                    root, fix=True, reclaim=True,
                    backoff_base_s=backoff_base_s,
                ).get("reclaimed", [])
                _note(f"round {ev['round']}: lease_jump expired "
                      f"{n} lease(s), sweep reclaimed {len(acts)}")
            elif action == "server_bounce":
                server.send_signal(signal.SIGKILL)
                server.wait()
                box: dict = {}

                def _call(ev=ev, box=box) -> None:
                    try:
                        if ev["verb"] == "submit":
                            box["out"] = fleet_client.submit(
                                addr, ev["spec"]
                            )
                        else:
                            box["out"] = fleet_client.queue(addr)
                    except Exception as exc:  # surfaced as a violation
                        box["err"] = f"{type(exc).__name__}: {exc}"

                t = threading.Thread(target=_call, daemon=True)
                t.start()
                time.sleep(0.3)  # the call is now inside the outage
                host_port = addr  # same port: the retry must land
                server = _start_server(root, port_file,
                                       addr=host_port)
                t.join(timeout=30)
                if t.is_alive() or "err" in box:
                    violations.append(
                        f"client {ev['verb']} did not survive the "
                        f"server bounce: {box.get('err', 'timed out')}"
                    )
                elif ev["verb"] == "submit":
                    job_ids.append(box["out"]["id"])
                    oracle_specs.append(ev["spec"])
                _note(f"round {ev['round']}: server_bounce + "
                      f"{ev['verb']} -> "
                      f"{box.get('out', {}).get('id', 'ok')}")
            elif action == "clean_units":
                rcs = _worker_round(max_units=ev["units"])
                _note(f"round {ev['round']}: clean_units "
                      f"{ev['units']} -> rc {_rcs_str(rcs)}")
            elif action == "kill_event_append":
                # the SIGKILL lands mid-append to an events.jsonl: the
                # match filter counts ONLY event-log appends, and the
                # torn prefix reaches the real file before the kill
                rcs = _worker_round(
                    chaos={"torn_at_write": [ev["at_write"],
                                             ev["at_byte"]],
                           "match": ".events.jsonl"})
                _note(f"round {ev['round']}: kill_event_append "
                      f"[{ev['at_write']}, {ev['at_byte']}] -> "
                      f"rc {_rcs_str(rcs)}")
            elif action == "claim_race":
                # one contender dies AT its k-th O_EXCL claim create;
                # the survivors must arbitrate around the stale claim
                rcs = _worker_round(
                    chaos={"kill_at_write": ev["at_claim"],
                           "match": ".claim"})
                _note(f"round {ev['round']}: claim_race kill at claim "
                      f"{ev['at_claim']} -> rc {_rcs_str(rcs)}")
            elif action == "torn_queue_log":
                # the kill lands mid-append to the SHARED queue.log:
                # the torn tail reaches the real file, readers must
                # leave it unconsumed, fsck rebuilds from the docs
                rcs = _worker_round(
                    chaos={"torn_at_write": [ev["at_write"],
                                             ev["at_byte"]],
                           "match": "queue.log"})
                _note(f"round {ev['round']}: torn_queue_log "
                      f"[{ev['at_write']}, {ev['at_byte']}] -> "
                      f"rc {_rcs_str(rcs)}")
            elif action == "lease_jump_one":
                # the suspended-VM case, single victim: jump ONE
                # worker's lease clock, leave every other lease live
                holders = sorted({
                    (j.lease or {}).get("worker")
                    for j in JobStore(root).list()
                    if j.lease is not None
                } - {None})
                victim = race_rng.choice(holders) if holders else None
                if victim is None:
                    _note(f"round {ev['round']}: lease_jump_one "
                          f"(no live leases; skipped)")
                else:
                    n = _expire_leases(root, worker=victim)
                    acts = fsck_mod.fsck(
                        root, fix=True, reclaim=True,
                        backoff_base_s=backoff_base_s,
                    ).get("reclaimed", [])
                    _note(f"round {ev['round']}: lease_jump_one "
                          f"{victim} expired {n} lease(s), sweep "
                          f"reclaimed {len(acts)}")
            elif action == "zombie_resume":
                # SIGSTOP a worker at a checkpoint write (outside every
                # store flock), steal its jobs, then SIGCONT it — the
                # zombie's resumed writes must die on the fence
                zombie_id = race_rng.choice(wids)
                rescue_ids = [w for w in wids if w != zombie_id] or [
                    f"{zombie_id}-rescue"]
                z = _spawn_worker(
                    root, worker_id=zombie_id,
                    chaos={"sigstop_at_write": ev["at_write"],
                           "match": ".ckpt"},
                    real=real, device=device, backoff_base_s=backoff_base_s)
                stopped = _wait_stopped(z.pid, timeout_s=worker_timeout)
                if stopped:
                    n = _expire_leases(root, worker=zombie_id)
                    fsck_mod.fsck(root, fix=True, reclaim=True,
                                  backoff_base_s=backoff_base_s)
                    rcs = _race_workers(
                        root, rescue_ids, real=real, device=device,
                        backoff_base_s=backoff_base_s,
                        timeout_s=worker_timeout)
                    os.kill(z.pid, signal.SIGCONT)
                else:
                    n, rcs = 0, {}
                try:
                    z.wait(timeout=worker_timeout)
                except subprocess.TimeoutExpired:
                    z.kill()
                    z.wait()
                what = (f"stopped, {n} lease(s) stolen, rescue rc "
                        f"{_rcs_str(rcs)}" if stopped
                        else "outlived its write budget")
                _note(f"round {ev['round']}: zombie_resume {zombie_id} "
                      f"at ckpt write {ev['at_write']} ({what}); "
                      f"zombie rc {z.returncode}")
            elif action == "torn_events":
                if ev["job_index"] < len(job_ids):
                    jid = job_ids[ev["job_index"]]
                    hit = _tear_events_tail(
                        JobStore(root).events_path(jid), ev["cut"]
                    )
                    _note(f"round {ev['round']}: torn_events {jid} "
                          f"cut {ev['cut']} "
                          f"({'hit' if hit else 'no events yet'})")

        # -- recovery: the farm must converge with no faults armed ----------
        store = JobStore(root)
        for r in range(recovery_rounds):
            fsck_mod.fsck(root, fix=True, reclaim=True,
                          release_quarantined=True,
                          backoff_base_s=backoff_base_s)
            _worker_round()
            jobs_now = {j.id: j for j in store.list()}
            missing = [jid for jid in job_ids if jid not in jobs_now]
            if not missing and all(
                j.state in TERMINAL and j.state != QUARANTINED
                for j in jobs_now.values()
            ):
                break
            time.sleep(0.2)
        else:
            violations.append(
                f"farm did not converge in {recovery_rounds} recovery "
                f"rounds"
            )
    finally:
        with contextlib.suppress(OSError):
            server.send_signal(signal.SIGKILL)
            server.wait()

    # -- final fsck must leave a clean store --------------------------------
    final_rep = fsck_mod.fsck(root, fix=True, reclaim=True)
    with open(os.path.join(workdir, "fsck.json"), "w") as f:
        json.dump(final_rep, f, indent=1, sort_keys=True)
    rescan = fsck_mod.scan(JobStore(root))
    if rescan["corrupt"] or rescan["stale_tmp"]:
        violations.append(
            f"store not clean after fsck: {rescan['corrupt']} corrupt, "
            f"{rescan['stale_tmp']} stale tmp"
        )

    # -- invariants: contention plane (gen-aware witnesses) -----------------
    violations.extend(_contention_violations(root))

    # -- invariant: no accepted job lost ------------------------------------
    store = JobStore(root)
    reports = {}
    for jid in job_ids:
        try:
            job = store.get(jid)
        except KeyError:
            violations.append(f"accepted job {jid} LOST (no document)")
            continue
        if job.state not in TERMINAL:
            violations.append(f"job {jid} not terminal: {job.state}")
        elif job.state in (FAILED, CANCELLED, QUARANTINED):
            violations.append(
                f"job {jid} ended {job.state}: {job.error or job.quarantine}"
            )
        elif not job.result or "report" not in job.result:
            violations.append(f"job {jid} terminal without a report")
        else:
            reports[jid] = job.result["report"]

    # -- invariant: byte-identical to the unperturbed oracle ----------------
    oracle_ids: List[str] = []
    if not violations:
        ostore = JobStore(oracle_root)
        for spec in oracle_specs:
            oracle_ids.append(ostore.submit(spec).id)
        _run_worker(oracle_root, real=real, device=device,
                    backoff_base_s=backoff_base_s,
                    timeout_s=worker_timeout)
        for jid, oid in zip(job_ids, oracle_ids):
            try:
                oracle_report = ostore.get(oid).result["report"]
            except (KeyError, TypeError):
                violations.append(f"oracle job {oid} has no report")
                continue
            got = json.dumps(reports[jid], sort_keys=True)
            want = json.dumps(oracle_report, sort_keys=True)
            if got != want:
                violations.append(
                    f"job {jid} report diverged from oracle {oid}:\n"
                    f"  chaos:  {got}\n  oracle: {want}"
                )

    # -- invariant (--real): filed finds regress-replay ---------------------
    corpus = os.path.join(root, "corpus.json")
    if real and not violations and os.path.exists(corpus):
        p = subprocess.run(
            [sys.executable, "-m", "madsim_tpu_torch", "regress",
             "--corpus", corpus, "--device", device],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            timeout=1200,
        )
        if p.returncode != 0:
            violations.append(
                f"filed finds failed regress replay:\n{p.stdout[-2000:]}"
            )

    result = {
        "ok": not violations,
        "seed": seed,
        "profile": profile,
        "workers": n_workers,
        "violations": violations,
        "jobs": job_ids,
        "workdir": workdir,
        "requeues": sum(j.n_requeues for j in store.list()),
        "lease_reclaims": sum(j.n_lease_reclaims for j in store.list()),
    }
    with open(os.path.join(workdir, "result.json"), "w") as f:
        json.dump(result, f, indent=1, sort_keys=True)
    if violations:
        repro = (
            f"python -m madsim_tpu_torch fleet chaos --seed {seed} "
            f"--profile {profile}"
            + (" --real" if real else "")
            + (f" --device {device}" if real and device != "cuda" else "")
            + (f" --rounds {rounds}" if rounds else "")
            + (f" --jobs {jobs}" if jobs else "")
            + (f" --workers {n_workers}" if n_workers > 1 else "")
        )
        print(
            f"FLEET CHAOS FAILURE (seed {seed}): "
            f"{len(violations)} violation(s)\n"
            + "\n".join(f"  - {v}" for v in violations)
            + f"\nreproduce forever with:\n  {repro}\n"
            f"artifacts: {workdir}",
            flush=True,
        )
    else:
        _note(
            f"ok — {len(job_ids)} jobs survived "
            f"{len(sched['events'])} faults "
            f"({result['requeues']} requeues, "
            f"{result['lease_reclaims']} lease reclaims); reports "
            f"byte-identical to oracle"
        )
        if ephemeral and not keep:
            shutil.rmtree(workdir, ignore_errors=True)
            result["workdir"] = None
    return result
