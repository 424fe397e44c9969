"""The port's hardened hunt farm, held to the cases of
tests/test_fleet_chaos.py: lease reclamation + requeue backoff,
poison-job quarantine, OOM lane backoff, crash-safe atomic writes with
deterministic chaos injection, store fsck (torn-artifact table), the
/healthz + /metrics, client transient retry, and the seeded fleet-chaos
harness end to end.

Tier budget: everything here is torch-free (the farm paths under test
run the synthetic driver; subprocess incarnations never build an
engine) except the one `--real` chaos run, which builds an echo engine
per worker incarnation on the CPU and lives in the `slow` tier. Where
the JAX package's twin races the wall clock (a 0.01 s backoff that can
elapse before the next lease), the store's clock is stepped instead.
"""

import http.server
import json
import os
import signal
import socket
import subprocess
import sys
import threading
import time

import pytest

from madsim_tpu_torch.fleet import fsck as fsck_mod
from madsim_tpu_torch.fleet.api import FleetAPI
from madsim_tpu_torch.fleet.chaos import derive_schedule, run_chaos, synthetic_driver
from madsim_tpu_torch.fleet.store import (
    EXHAUSTED,
    QUARANTINED,
    QUEUED,
    CorruptJobFile,
    JobStore,
)
from madsim_tpu_torch.fleet.worker import FleetWorker
from madsim_tpu_torch.runtime.checkpoint import save_checkpoint
from madsim_tpu_torch.runtime.atomicio import atomic_write_json

ECHO = {"machine": "chaos-echo", "seeds": 96, "batch": 32, "faults": 0}


# -- lease reclamation + requeue ---------------------------------------------


class _Clock:
    """The store's `time` module with its wall clock movable: a test
    steps past a backoff instead of sleeping through it, so a busy
    machine cannot let a backoff elapse between two calls."""

    def __init__(self):
        self.offset = 0.0

    def time(self):
        return time.time() + self.offset

    def __getattr__(self, name):
        return getattr(time, name)


def test_reclaim_requeues_with_backoff_then_quarantines(tmp_path, monkeypatch):
    """An expired lease is a worker death: requeue with exponential
    backoff and the attempt counter bumped; the third consecutive death
    quarantines with the full post-mortem."""
    from madsim_tpu_torch.fleet import store as store_mod

    clock = _Clock()
    monkeypatch.setattr(store_mod, "time", clock)
    st = JobStore(str(tmp_path))
    job = st.submit(dict(ECHO))
    for attempt in (1, 2):
        assert st.try_lease(job.id, f"w{attempt}", ttl_s=-1)
        acts = st.reclaim_expired(backoff_base_s=5.0)
        assert [a["job"] for a in acts] == [job.id]
        j = st.get(job.id)
        assert j.state == QUEUED and j.attempt == attempt
        assert j.lease is None and j.requeue_after_ts is not None
        assert j.n_lease_reclaims == attempt and j.n_requeues == attempt
        # backoff blocks leasing until it passes (5 s, then 10 s)
        assert st.try_lease(job.id, "w9", ttl_s=60) is None
        clock.offset += 5.0 * 2 ** (attempt - 1) + 1.0
    assert st.try_lease(job.id, "w3", ttl_s=-1)
    [act] = st.reclaim_expired(backoff_base_s=5.0)
    assert act["outcome"] == QUARANTINED
    q = st.get(job.id)
    assert q.state == QUARANTINED and q.terminal
    assert q.quarantine["attempts"] == 3
    assert "lease expired" in q.quarantine["reason"]
    assert q.quarantine["repro"].startswith(
        "python -m madsim_tpu_torch hunt --stream --machine chaos-echo"
    )
    assert len(q.quarantine["deaths"]) == 3
    # reclaiming again is a no-op (nothing leasable, nothing expired)
    assert st.reclaim_expired() == []
    # the operator release edge: back to queued, counter reset,
    # post-mortem kept as audit trail
    r = st.release_quarantined(job.id)
    assert r.state == QUEUED and r.attempt == 0
    assert r.quarantine is not None


def test_completed_unit_resets_consecutive_attempts(tmp_path):
    """Deaths are only poison when CONSECUTIVE: progress between deaths
    must reset the counter, or a long healthy job would eventually be
    quarantined by unrelated worker crashes."""
    st = JobStore(str(tmp_path))
    job = st.submit(dict(ECHO))
    for _ in range(2):
        st.record_death(job.id, reason="worker hard failure",
                        backoff_base_s=0.0)
    assert st.get(job.id).attempt == 2
    st.try_lease(job.id, "w1", ttl_s=60)
    st.note_progress(job.id, "w1", {"batches_run": 1})
    j = st.get(job.id)
    assert j.attempt == 0 and j.requeue_after_ts is None
    out = st.record_death(job.id, reason="worker hard failure",
                          backoff_base_s=0.0)
    assert out.state == QUEUED and out.attempt == 1  # NOT quarantined


# -- poison-job quarantine (acceptance) --------------------------------------


def test_poison_job_quarantined_healthy_job_completes(tmp_path, capsys):
    """THE acceptance fixture: a job that raises in batch 2 every
    attempt is quarantined after exactly N=3 attempts with exception +
    batch index + repro recorded, while a concurrently queued healthy
    job runs to completion — the farm never wedges."""
    root = str(tmp_path)
    st = JobStore(root)
    poison = st.submit({"machine": "chaos-poison", "seeds": 96, "batch": 32})
    healthy = st.submit(dict(ECHO))
    w = FleetWorker(root, worker_id="w1", poll_s=0.01,
                    backoff_base_s=0.01, driver=synthetic_driver)
    w.run(drain=True)
    pj, hj = st.get(poison.id), st.get(healthy.id)
    assert pj.state == QUARANTINED
    assert pj.quarantine["attempts"] == 3 and pj.attempt == 3
    assert "batch 2" in pj.quarantine["error"]
    assert pj.quarantine["batch_index"] == 1  # 0-based: died in batch 2
    # the repro line names the exact batch's seed range
    assert pj.quarantine["repro"].startswith(
        "python -m madsim_tpu_torch hunt --stream --machine chaos-poison "
        "--nodes 0 --seed 32 --seeds 32"
    )
    assert [d["reason"] for d in pj.deaths] == ["worker hard failure"] * 3
    assert hj.state == EXHAUSTED
    assert hj.result["report"]["completed"] == 96
    assert "QUARANTINED after 3" in capsys.readouterr().out


def test_oom_job_degrades_lanes_then_completes(tmp_path):
    """OOM-class failures get the lane-count backoff BEFORE poison
    attempts: halve `batch`, re-derive fingerprint/sha/subkey, reset
    the checkpoint, record the degradation — then run to completion at
    the shape that fits."""
    root = str(tmp_path)
    st = JobStore(root)
    job = st.submit({"machine": "chaos-oom", "seeds": 64, "batch": 64})
    sub0 = job.subkey
    w = FleetWorker(root, worker_id="w1", poll_s=0.01,
                    backoff_base_s=0.01, driver=synthetic_driver)
    w.run(drain=True)
    j = st.get(job.id)
    assert j.state == EXHAUSTED
    assert [(d["from_batch"], d["to_batch"]) for d in j.degraded] == [
        (64, 32), (32, 16)
    ]
    assert j.spec["batch"] == 16 and j.subkey != sub0
    # re-derived, not drifted: the recorded fingerprint matches the
    # degraded spec, so the fingerprint refusal stays quiet
    assert st.fingerprint_mismatch(j) is None
    assert j.attempt == 0  # degrades never burned poison attempts
    assert j.result["report"]["completed"] == 64


# -- crash-safe atomic writes + deterministic chaos injection ----------------


def test_chaos_injection_kill_and_torn_write(tmp_path):
    """The atomicity claim under deterministic attack: a SIGKILL at (or
    inside) the k-th write leaves the previous version of the final
    file — the torn bytes only ever reach the tmp file."""
    victim = tmp_path / "doc.json"
    atomic_write_json(str(victim), {"v": "old"})
    script = (
        "from madsim_tpu_torch.runtime.atomicio import atomic_write_json\n"
        f"atomic_write_json({str(tmp_path / 'other.json')!r}, {{'n': 1}})\n"
        f"atomic_write_json({str(victim)!r}, {{'v': 'new'}})\n"
        "print('UNREACHED')\n"
    )
    for plan in ({"kill_at_write": 2}, {"torn_at_write": [2, 6]}):
        env = {**os.environ,
               "MADSIM_TPU_FLEET_CHAOS": json.dumps(
                   {**plan, "match": str(tmp_path)})}
        out = subprocess.run([sys.executable, "-c", script], env=env,
                             capture_output=True, text=True, timeout=60)
        assert out.returncode == -signal.SIGKILL, out.stdout + out.stderr
        assert "UNREACHED" not in out.stdout
        assert json.load(open(victim)) == {"v": "old"}  # survived
        assert json.load(open(tmp_path / "other.json")) == {"n": 1}
    # the torn plan left exactly the scheduled prefix in the tmp file
    tmp_file = str(victim) + ".tmp"
    assert os.path.exists(tmp_file)
    assert len(open(tmp_file).read()) == 6
    # unmatched paths are not counted against the schedule
    env = {**os.environ,
           "MADSIM_TPU_FLEET_CHAOS": json.dumps(
               {"kill_at_write": 1, "match": "/nonexistent-root"})}
    out = subprocess.run([sys.executable, "-c", script], env=env,
                         capture_output=True, text=True, timeout=60)
    assert out.returncode == 0 and "UNREACHED" in out.stdout


def test_shared_atomic_writer_has_no_tmp_leftovers(tmp_path):
    """checkpoint + job store + port file all ride the one atomicio
    discipline: after normal operation no `*.tmp` survives anywhere."""
    from madsim_tpu_torch.fleet import httpd

    st = JobStore(str(tmp_path / "farm"))
    job = st.submit(dict(ECHO))
    st.try_lease(job.id, "w1", ttl_s=60)
    save_checkpoint(st.ckpt_path(job.id), {
        "fingerprint": job.fingerprint, "batch": 1, "planned": 3,
        "cursor": 32, "completed": 32, "seeds_consumed": 32,
        "failing": [], "infra": [], "abandoned": [], "done": False,
    })
    httpd.write_port_file(str(tmp_path / "p.port"), 1234)
    leftovers = [
        os.path.join(d, fn)
        for d, _dirs, fns in os.walk(tmp_path)
        for fn in fns if fn.endswith(".tmp")
    ]
    assert leftovers == []


# -- torn-artifact table: fsck verdicts + reader survival --------------------


def _boundaries(text: str):
    """Every JSON-structural boundary: each position holding a brace,
    bracket, quote, comma or colon (truncating there cuts the document
    mid-structure), plus byte 0."""
    return sorted({0} | {
        i for i, c in enumerate(text) if c in '{}[]:,"'
    })


def test_torn_store_files_fsck_verdicts_and_reader_survival(tmp_path):
    """Table-driven: truncate every store/corpus/checkpoint artifact at
    every JSON-structural boundary; fsck must verdict the file as
    truncated/unparseable and every fleet reader must survive (typed
    error or graceful skip — no uncaught exception anywhere)."""
    root = str(tmp_path / "farm")
    st = JobStore(root)
    api = FleetAPI(st)
    job = st.submit(dict(ECHO))
    ckpt = st.ckpt_path(job.id)
    save_checkpoint(ckpt, {
        "fingerprint": job.fingerprint, "batch": 1, "planned": 3,
        "cursor": 32, "completed": 32, "seeds_consumed": 32,
        "failing": [[5, 7]], "infra": [], "abandoned": [],
        "prov": {}, "cov_b64": None, "detector": None, "plateau": False,
        "done": False,
    })
    stats_json = st.stats_base(job.id) + ".json"
    with open(stats_json, "w") as f:
        f.write(json.dumps({"kind": "fleet_batch", "batch": 1}) + "\n")
    corpus = st.corpus_path
    with open(corpus, "w") as f:
        json.dump({"version": 1, "entries": [{
            "machine": "echo", "nodes": 0, "seed": 5, "fail_code": 7,
            "config": {}, "max_steps": 100,
        }]}, f)
    w = FleetWorker(root, worker_id="w1", driver=synthetic_driver)

    targets = {
        "job": st.job_path(job.id),
        "ckpt": ckpt,
        "stats_json": stats_json,
        "corpus": corpus,
    }
    pristine = {k: open(p).read() for k, p in targets.items()}
    checked = 0
    for kind, path in targets.items():
        for cut in _boundaries(pristine[kind]):
            with open(path, "w") as f:
                f.write(pristine[kind][:cut])
            rep = fsck_mod.scan(st)
            [finding] = [x for x in rep["findings"]
                         if x["path"] == path]
            assert finding["verdict"] in ("truncated", "unparseable"), (
                kind, cut, finding)
            assert rep["corrupt"] >= 1
            # reader survival, per artifact
            if kind == "job":
                assert st.list() == []  # skipped, not raised
                with pytest.raises(CorruptJobFile):
                    st.get(job.id)
                status, _, body = api.handle("GET", f"/jobs/{job.id}")
                assert status == 503
                assert "fsck" in json.loads(body)["error"]
                assert w._lease_next() is None  # farm keeps polling
            elif kind == "ckpt":
                # the fleet's lenient reader quarantines + restarts
                assert w._load_ckpt(job) is None
                assert os.path.exists(path + ".corrupt")
                os.replace(path + ".corrupt", path)  # restore for next cut
            status, _, _ = api.handle("GET", "/healthz")
            assert status == 503  # integrity probe trips
            with open(path, "w") as f:
                f.write(pristine[kind])
            checked += 1
    assert checked > 100  # the table really swept the boundary space
    # pristine store: healthz healthy again
    status, _, body = api.handle("GET", "/healthz")
    assert status == 200 and json.loads(body)["ok"] is True

    # torn JSONL tail: reported (never quarantined), reader skips it
    jsonl = st.stats_base(job.id) + ".jsonl"
    with open(jsonl, "w") as f:
        f.write(json.dumps({"batch": 1}) + "\n" + '{"batch": 2, "trunc')
    rep = fsck_mod.scan(st)
    [finding] = [x for x in rep["findings"] if x["path"] == jsonl]
    assert finding["verdict"] == "torn-tail"
    assert rep["corrupt"] == 0  # a torn tail is expected append damage
    assert [r["batch"] for r in st.read_feed(job.id, 10)] == [1]


def test_fsck_fix_quarantines_sweeps_and_rebuilds(tmp_path):
    root = str(tmp_path)
    st = JobStore(root)
    ok_job = st.submit(dict(ECHO))
    bad_job = st.submit(dict(ECHO))
    # corrupt one job doc, leave a stale atomic-write tmp behind
    with open(st.job_path(bad_job.id), "w") as f:
        f.write('{"id": "j0002-')
    with open(st.job_path(ok_job.id) + ".tmp", "w") as f:
        f.write("interrupted")
    rep = fsck_mod.fsck(root, fix=True)
    verdicts = {x["file"]: x for x in rep["findings"]}
    assert verdicts[f"{bad_job.id}.json"]["action"].startswith("quarantined")
    assert os.path.exists(st.job_path(bad_job.id) + ".corrupt")
    assert not os.path.exists(st.job_path(bad_job.id))
    assert not os.path.exists(st.job_path(ok_job.id) + ".tmp")
    # the queue index is rebuilt from the survivors
    assert rep["counts"] == {QUEUED: 1} and rep["queue_depth"] == 1
    text = fsck_mod.render(rep)
    assert "quarantined" in text and "stale" in text.lower()
    # a drifted job doc is reported but left for the worker's
    # field-naming refusal (the audit trail lives in the state machine)
    doc = json.load(open(st.job_path(ok_job.id)))
    doc["spec"]["seeds"] = 4096
    atomic_write_json(st.job_path(ok_job.id), doc)
    rep2 = fsck_mod.fsck(root, fix=True)
    [drift] = [x for x in rep2["findings"] if x["verdict"] == "drifted"]
    assert drift["action"] == "none" and rep2["corrupt"] == 0
    assert os.path.exists(st.job_path(ok_job.id))


def test_torn_queue_log_and_claim_files_table(tmp_path):
    """The multi-worker artifacts join the torn table: queue.log and a
    live claim file cut at every JSON-structural boundary. Neither cut
    is EVER corruption — the index reader consumes only committed
    lines (docs stay the source of truth; fsck rebuilds the log from
    them), and a torn claim is arbitrated around by the job flock
    (fsck removes it) — so /healthz stays green through the whole
    sweep."""
    root = str(tmp_path / "farm")
    st = JobStore(root)
    api = FleetAPI(st)
    jobs = [st.submit(dict(ECHO)) for _ in range(3)]
    held = st.try_lease(jobs[0].id, "w1", ttl_s=3600)
    assert held is not None

    qlog = st.queue_log_path
    claim = st.claim_path(jobs[0].id)
    pristine = {p: open(p).read() for p in (qlog, claim)}
    # every committed queue row a prefix can expose, keyed by job
    legit = {}
    for line in pristine[qlog].splitlines():
        legit.setdefault(json.loads(line)["job"], []).append(
            json.loads(line))

    checked = 0
    for cut in _boundaries(pristine[qlog]):
        with open(qlog, "w") as f:
            f.write(pristine[qlog][:cut])
        rep = fsck_mod.scan(st)
        [finding] = [x for x in rep["findings"] if x["path"] == qlog]
        assert finding["verdict"] in ("torn-tail", "index-stale"), (
            cut, finding)
        assert rep["corrupt"] == 0
        # reader survival: a FRESH index (new process) materializes
        # only committed rows, each byte-identical to a real append
        rows = JobStore(root).queue_rows()
        for jid, row in rows.items():
            assert row in legit[jid], (cut, jid)
        status, _, _ = api.handle("GET", "/healthz")
        assert status == 200
        checked += 1
    with open(qlog, "w") as f:
        f.write(pristine[qlog])

    for cut in _boundaries(pristine[claim]):
        with open(claim, "w") as f:
            f.write(pristine[claim][:cut])
        rep = fsck_mod.scan(st)
        [finding] = [x for x in rep["findings"] if x["path"] == claim]
        assert finding["verdict"] == "stale-claim", (cut, finding)
        assert rep["corrupt"] == 0
        # reader survival: the torn claim neither crashes a contender
        # nor lets it steal w1's live lease (the flock arbitrates)
        assert st.try_lease(jobs[0].id, "w9", ttl_s=60) is None
        status, _, _ = api.handle("GET", "/healthz")
        assert status == 200
        checked += 1
    assert checked > 100  # the table really swept the boundary space

    # a fixing fsck heals both: log rebuilt from docs, torn claim gone
    with open(qlog, "w") as f:
        f.write(pristine[qlog][:37])
    with open(claim, "w") as f:
        f.write(pristine[claim][:10])
    rep = fsck_mod.fsck(root, fix=True)
    acts = {x["file"]: x["action"] for x in rep["findings"]}
    assert acts["queue.log"].startswith("rebuilt from 3")
    assert acts[f"{jobs[0].id}.claim"] == "removed"
    assert JobStore(root).queue_log_lag() == 0


def test_fsck_cli_exit_codes_and_json(tmp_path):
    from madsim_tpu_torch.__main__ import main

    root = str(tmp_path)
    st = JobStore(root)
    st.submit(dict(ECHO))
    assert main(["fleet", "fsck", "--root", root]) == 0
    with open(os.path.join(st.jobs_dir, "j0009-deadbeef.json"), "w") as f:
        f.write("{torn")
    assert main(["fleet", "fsck", "--root", root, "--dry-run"]) == 1
    assert os.path.exists(os.path.join(st.jobs_dir, "j0009-deadbeef.json"))
    assert main(["fleet", "fsck", "--root", root, "--json"]) == 1
    assert not os.path.exists(os.path.join(st.jobs_dir, "j0009-deadbeef.json"))
    assert main(["fleet", "fsck", "--root", root]) == 0


# -- /healthz + /metrics -----------------------------------------------------


def test_healthz_reports_farm_gauges(tmp_path):
    st = JobStore(str(tmp_path))
    api = FleetAPI(st)
    st.submit(dict(ECHO))
    j2 = st.submit(dict(ECHO))
    st.try_lease(j2.id, "w1", ttl_s=-1)  # already expired
    j3 = st.submit(dict(ECHO))
    for _ in range(3):
        st.record_death(j3.id, reason="worker hard failure",
                        backoff_base_s=0.0)
    status, ctype, body = api.handle("GET", "/healthz")
    doc = json.loads(body)
    assert status == 200 and doc["ok"] is True
    assert doc["queue_depth"] == 2  # j1 + j2 (j3 is quarantined)
    assert doc["stale_leases"] == 1
    assert doc["quarantined_jobs"] == 1
    assert doc["store"]["corrupt_files"] == 0


def test_metrics_gains_self_healing_series(tmp_path):
    st = JobStore(str(tmp_path))
    api = FleetAPI(st)
    job = st.submit(dict(ECHO))
    st.try_lease(job.id, "w1", ttl_s=-1)
    st.reclaim_expired(backoff_base_s=0.0)
    j2 = st.submit(dict(ECHO))
    for _ in range(3):
        st.record_death(j2.id, reason="worker hard failure",
                        backoff_base_s=0.0)
    _, _, body = api.handle("GET", "/metrics")
    text = body.decode()
    assert "madsim_tpu_fleet_requeues_total 3" in text
    assert "madsim_tpu_fleet_lease_reclaims_total 1" in text
    assert "madsim_tpu_fleet_quarantined_jobs 1" in text
    assert 'madsim_tpu_fleet_jobs{state="quarantined"} 1' in text


def test_metrics_exports_bench_history_trajectory(tmp_path, monkeypatch):
    """/metrics exports the bench history trajectory as gauges: the
    NEWEST row per comparable-fingerprint group —
    superseded captures drop out, different shapes stay distinct
    series, and compile_s_warm only appears where a warm path was
    measured. Resolution honors $MADSIM_TPU_BENCH_HISTORY; a missing
    file exports no bench series at all."""
    from madsim_tpu_torch.perf import history

    hp = str(tmp_path / "h.jsonl")
    fp = {
        "host": "boxA", "platform": "cpu", "python": "3", "torch": "2.11",
        "cuda": "12.8", "lanes": 8192, "reps": 5, "segment_steps": 384,
        "gates": {"rng_stream": 3, "clog_packed": True, "pallas_pop": False,
                  "flight_recorder": True, "coverage": True,
                  "provenance": False},
    }
    history.append(hp, history.make_record("r01", 100.0, fp, ts=1.0))
    # the port's bench measures no warm compile (eager PyTorch has no
    # compile cache); a row that carries one still exports it
    history.append(hp, dict(history.make_record("r02", 110.0, fp, ts=2.0),
                            compile_s_warm=3.2))
    history.append(hp, history.make_record(
        "r03", 55.0, dict(fp, lanes=512), ts=3.0))
    monkeypatch.setenv("MADSIM_TPU_BENCH_HISTORY", hp)
    api = FleetAPI(JobStore(str(tmp_path / "farm")))
    _, _, body = api.handle("GET", "/metrics")
    text = body.decode()
    # r01 was superseded by the comparable r02; r03 is its own shape
    assert 'madsim_tpu_bench_seeds_per_sec{tag="r02"' in text
    assert 'lanes="8192",host="boxA"} 110' in text
    assert 'madsim_tpu_bench_seeds_per_sec{tag="r03"' in text
    assert 'tag="r01"' not in text
    # warm compile: only the row that measured one exports the gauge
    warm = [ln for ln in text.splitlines()
            if ln.startswith("madsim_tpu_bench_compile_s_warm{")]
    assert warm == [
        'madsim_tpu_bench_compile_s_warm{tag="r02",platform="cpu",'
        'lanes="8192",host="boxA"} 3.2'
    ]
    # scrape of an unchanged history re-parses nothing
    parses = api._bench_cache.parses
    api.handle("GET", "/metrics")
    assert api._bench_cache.parses == parses
    # missing file: no bench series, scrape still clean
    monkeypatch.setenv("MADSIM_TPU_BENCH_HISTORY", str(tmp_path / "nope"))
    api2 = FleetAPI(JobStore(str(tmp_path / "farm2")))
    status, _, body = api2.handle("GET", "/metrics")
    assert status == 200
    assert "madsim_tpu_bench" not in body.decode()


# -- client transient retry --------------------------------------------------


class _FlakyHandler(http.server.BaseHTTPRequestHandler):
    remaining_503 = 0
    hits = []

    def do_GET(self):  # noqa: N802 (stdlib API name)
        type(self).hits.append(self.path)
        if "missing" in self.path:
            self._reply(404, b'{"error": "no such job"}')
        elif type(self).remaining_503 > 0:
            type(self).remaining_503 -= 1
            self._reply(503, b'{"error": "restarting"}')
        else:
            self._reply(200, b'{"counts": {}, "jobs": []}')

    def _reply(self, status, payload):
        self.send_response(status)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(payload)))
        self.end_headers()
        self.wfile.write(payload)

    def log_message(self, fmt, *a):
        pass


def test_client_retries_transient_http_and_connection_errors(monkeypatch):
    from madsim_tpu_torch.fleet import client

    monkeypatch.setattr(client, "RETRY_BACKOFF_S", 0.01)
    monkeypatch.setattr(client, "RETRY_BACKOFF_MAX_S", 0.02)
    srv = http.server.ThreadingHTTPServer(("127.0.0.1", 0), _FlakyHandler)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    addr = f"127.0.0.1:{srv.server_address[1]}"
    try:
        # 503s are retried until the server recovers
        _FlakyHandler.remaining_503, _FlakyHandler.hits = 2, []
        assert client.queue(addr) == {"counts": {}, "jobs": []}
        assert len(_FlakyHandler.hits) == 3
        # --no-retry escape hatch: first 503 raises
        _FlakyHandler.remaining_503, _FlakyHandler.hits = 2, []
        with pytest.raises(client.FleetClientError) as exc:
            client.queue(addr, retries=0)
        assert exc.value.status == 503 and len(_FlakyHandler.hits) == 1
        # non-transient 4xx NEVER retries
        _FlakyHandler.remaining_503, _FlakyHandler.hits = 0, []
        with pytest.raises(client.FleetClientError) as exc:
            client.status(addr, "missing", feed=0)
        assert exc.value.status == 404
    finally:
        srv.shutdown()
        srv.server_close()
    # connection refused: retried, then the original error surfaces
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        dead = f"127.0.0.1:{s.getsockname()[1]}"
    t0 = time.monotonic()
    with pytest.raises(OSError):
        client.queue(dead, retries=2)
    assert time.monotonic() - t0 < 5  # bounded backoff, no hang


def test_serve_sweep_thread_reclaims_expired_leases(tmp_path):
    """`fleet serve` is a supervisor, not just an API: its sweep thread
    requeues a job whose worker died, with no worker process alive."""
    from madsim_tpu_torch.fleet import httpd

    root = str(tmp_path / "farm")
    st = JobStore(root)
    job = st.submit(dict(ECHO))
    st.try_lease(job.id, "w-dead", ttl_s=-1)
    port_file = str(tmp_path / "p.port")
    proc = subprocess.Popen(
        [sys.executable, "-m", "madsim_tpu_torch", "fleet", "serve",
         "--root", root, "--addr", "127.0.0.1:0",
         "--port-file", port_file, "--sweep-interval", "0.2"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )
    try:
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline:
            j = st.get(job.id)
            if j.n_lease_reclaims:
                break
            assert proc.poll() is None
            time.sleep(0.05)
        j = st.get(job.id)
        assert j.n_lease_reclaims == 1 and j.lease is None
        assert j.state == QUEUED and j.attempt == 1
    finally:
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=30) == 0


# -- the chaos harness -------------------------------------------------------


def test_chaos_schedule_is_a_pure_function_of_the_seed():
    a = derive_schedule(7, profile="kill")
    b = derive_schedule(7, profile="kill")
    assert a == b
    assert a != derive_schedule(8, profile="kill")
    assert derive_schedule(7, profile="torn") != a
    known = {"kill_worker", "torn_write", "corrupt_ckpt", "lease_jump",
             "server_bounce", "clean_units", "kill_event_append",
             "torn_events"}
    for sched in (a, derive_schedule(3, profile="torn"),
                  derive_schedule(5, profile="mixed")):
        assert {ev["action"] for ev in sched["events"]} <= known
        assert all(s["machine"].startswith("chaos-") for s in sched["specs"])
    with pytest.raises(ValueError, match="unknown profile"):
        derive_schedule(0, profile="bogus")
    # overrides pin the shape without changing the derivation
    s = derive_schedule(7, profile="kill", rounds=3, jobs=2)
    assert len(s["events"]) == 3 and len(s["specs"]) == 2


def test_chaos_spans_profile_schedule_derivation():
    """The graceful-kill profile derives purely from
    the seed like every other, with sigterm write budgets scoped to the
    checkpoint-write range — and it is a NEW profile, so the pinned
    seeds of kill/torn/mixed keep their schedules byte-identical."""
    a = derive_schedule(0, profile="spans")
    assert a == derive_schedule(0, profile="spans")
    assert {ev["action"] for ev in a["events"]} <= {
        "sigterm_worker", "kill_worker", "lease_jump", "clean_units"
    }
    assert any(ev["action"] == "sigterm_worker" for ev in a["events"])
    for ev in a["events"]:
        if ev["action"] == "sigterm_worker":
            assert 1 <= ev["at_write"] <= 6
    # the pre-existing profiles never emit the new action
    for profile in ("kill", "torn", "mixed"):
        for seed in range(4):
            sched = derive_schedule(seed, profile=profile)
            assert all(ev["action"] != "sigterm_worker"
                       for ev in sched["events"])


def test_fleet_chaos_sigterm_flushes_partial_spans(tmp_path):
    """The crash-flush invariant under seeded attack: a worker
    SIGTERM'd mid-unit (at its k-th checkpoint write) must leave its
    open spans behind in the store's span dump, tagged partial — the
    killed unit's timeline is never empty. Seed 0's schedule lands a
    real mid-unit SIGTERM (rc -15); run_chaos itself asserts the
    flush, and the farm is kept under --out so the dump is checked
    directly here too. Jax-free (synthetic driver)."""
    res = run_chaos(0, profile="spans", out_dir=str(tmp_path / "out"))
    assert res["ok"], res["violations"]
    out = tmp_path / "out" / "seed0"
    assert json.load(open(out / "schedule.json")) == derive_schedule(
        0, profile="spans")
    st = JobStore(str(out / "farm"))
    partials = [
        dict(sp, job=job.id)
        for job in st.list()
        for line in open(st.spans_path(job.id))
        for sp in json.loads(line).get("spans") or ()
        if (sp.get("args") or {}).get("partial")
    ]
    assert partials, "no partial span survived the SIGTERM rounds"
    # the flush dumped the open stack: the unit span itself is there,
    # with a real duration (ran to the moment of death, not zero)
    assert any(sp["name"] == "fleet_unit" for sp in partials)
    assert all(sp["dur"] > 0 for sp in partials)


def test_fleet_chaos_end_to_end_pinned_seed(tmp_path):
    """One full chaos schedule (the CI smoke runs two more): seeded
    faults against a real farm of subprocesses, then the invariants —
    no accepted job lost, reports byte-identical to the unperturbed
    oracle, store fsck-clean. Jax-free throughout (synthetic driver)."""
    res = run_chaos(0, profile="mixed", out_dir=str(tmp_path / "out"))
    assert res["ok"], res["violations"]
    out = tmp_path / "out" / "seed0"
    sched = json.load(open(out / "schedule.json"))
    assert sched == derive_schedule(0, profile="mixed")
    assert json.load(open(out / "result.json"))["ok"] is True
    assert os.path.exists(out / "fsck.json")
    # the farm directory is kept under --out for post-mortems
    farm_jobs = os.listdir(os.path.join(out, "farm", "jobs"))
    assert any(f.endswith(".json") for f in farm_jobs)


def test_chaos_claims_profile_schedule_derivation():
    """The contention profile derives purely from the seed like every
    other; its schedule never depends on --workers (the worker count
    only picks which contender carries an armed plan, via a separate
    seeded RNG); and it is a NEW profile, so the pinned seeds of the
    pre-existing profiles keep their schedules byte-identical."""
    a = derive_schedule(0, profile="claims")
    assert a == derive_schedule(0, profile="claims")
    assert a != derive_schedule(1, profile="claims")
    new = {"claim_race", "zombie_resume", "lease_jump_one",
           "torn_queue_log"}
    assert {ev["action"] for ev in a["events"]} <= new | {
        "kill_worker", "clean_units"}
    seen = {ev["action"]
            for s in range(16)
            for ev in derive_schedule(s, profile="claims")["events"]}
    assert new <= seen  # every contention action reachable
    for s in range(16):
        for ev in derive_schedule(s, profile="claims")["events"]:
            if ev["action"] == "claim_race":
                assert 1 <= ev["at_claim"] <= 3
            elif ev["action"] == "zombie_resume":
                assert 1 <= ev["at_write"] <= 4
            elif ev["action"] == "torn_queue_log":
                assert 1 <= ev["at_write"] <= 6
                assert 0 <= ev["at_byte"] <= 80
    # the pre-existing profiles never emit the contention actions
    for profile in ("kill", "torn", "mixed", "spans"):
        for seed in range(4):
            sched = derive_schedule(seed, profile=profile)
            assert not new & {ev["action"] for ev in sched["events"]}


def test_fleet_chaos_two_workers_claims_pinned_seed(tmp_path):
    """The contention e2e: TWO workers race one store through the claims
    profile. Seed 3's schedule lands a genuine zombie round — a worker
    SIGSTOPped at a checkpoint write, its leases stolen by the rescue
    worker, then SIGCONT'd so its resumed writes die on the fence — and
    the invariants must still hold: contention witnesses clean (no
    (batch, gen) executed by two workers, no duplicate corpus keys),
    no accepted job lost, reports byte-identical to the 1-WORKER
    oracle. Jax-free (synthetic driver)."""
    res = run_chaos(3, profile="claims", workers=2,
                    out_dir=str(tmp_path / "out"))
    assert res["ok"], res["violations"]
    assert res["workers"] == 2
    out = tmp_path / "out" / "seed3"
    # the schedule is untouched by --workers: same derivation as 1-worker
    assert json.load(open(out / "schedule.json")) == derive_schedule(
        3, profile="claims")
    assert json.load(open(out / "result.json"))["workers"] == 2
    # the race was real: accepted batch work landed from BOTH contenders
    st = JobStore(str(out / "farm"))
    owners = {
        ev.get("worker")
        for job in st.list()
        for ev in st.read_events(job.id)
        if ev.get("type") == "batch_done"
    }
    assert len(owners) >= 2, f"no genuine race: batches only from {owners}"


@pytest.mark.slow
def test_fleet_chaos_real_engine(tmp_path):
    """The same medicine against REAL echo-machine engines: worker
    incarnations pay a torch import + engine build each, so this is slow-tier;
    the byte-identical + no-loss invariants must hold identically, and
    any filed find regress-replays."""
    res = run_chaos(1, profile="kill", rounds=2, jobs=1, real=True,
                    out_dir=str(tmp_path / "out"), device="cpu")
    assert res["ok"], res["violations"]
