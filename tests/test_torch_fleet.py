"""The port's hunt fleet (madsim_tpu_torch/fleet), held to the cases of
tests/test_fleet.py: store lifecycle, lane allocator, control-plane API
handlers, fingerprint-drift refusal, daemon hardening (--port-file +
SIGTERM), and the end-to-end worker durability proof.

Tier budget: everything except the one end-to-end worker test builds
no engine (the store/allocator/API are torch-free by contract — pinned
by a subprocess import check); the worker test runs a small echo engine
on the CPU and lives in the `slow` tier, as its twin does
(tests/test_torch_fleet_interop.py holds the same proof against the JAX
worker in tier-1).
"""

import json
import os
import signal
import subprocess
import sys
import time
from types import SimpleNamespace

import pytest

from madsim_tpu_torch.fleet import httpd
from madsim_tpu_torch.fleet.allocator import LaneAllocator
from madsim_tpu_torch.fleet.api import FleetAPI
from madsim_tpu_torch.fleet.store import (
    CANCELLED,
    COMPILING,
    EXHAUSTED,
    FAILED,
    FILED,
    FOUND,
    QUEUED,
    RUNNING,
    SHRUNK,
    Job,
    JobStore,
    job_fingerprint,
    normalize_spec,
    spec_to_args,
)

ECHO_SPEC = {"machine": "echo", "seeds": 96, "batch": 32, "faults": 0,
             "horizon": 1.0, "max_steps": 300}


# -- spec --------------------------------------------------------------------


def test_spec_normalize_defaults_and_validation():
    spec = normalize_spec({"machine": "raft"})
    assert spec["seeds"] == 1024 and spec["batch"] == 256
    assert spec["fault_kinds"] == "pair,kill" and not spec["coverage"]
    with pytest.raises(ValueError, match="unknown spec fields"):
        normalize_spec({"machine": "raft", "bogus": 1})
    with pytest.raises(ValueError, match="machine"):
        normalize_spec({})
    with pytest.raises(ValueError, match="must be an int"):
        normalize_spec({"machine": "raft", "seeds": "many"})
    with pytest.raises(ValueError, match="must be a bool"):
        normalize_spec({"machine": "raft", "coverage": 1})
    with pytest.raises(ValueError, match="plateau"):
        normalize_spec({"machine": "raft", "stop_on_plateau": 3})


def test_spec_fingerprint_matches_hunt_checkpoint_fingerprint():
    """The job fingerprint and a hunt --checkpoint fingerprint computed
    from an equivalent CLI argument set must be the same dict — one
    refusal discipline, not two drifting ones."""
    from madsim_tpu_torch.runtime.checkpoint import fingerprint_from_args

    spec = normalize_spec(dict(ECHO_SPEC))
    cli_args = SimpleNamespace(
        machine="echo", nodes=0, seed=0, seeds=96, batch=32, max_steps=300,
        horizon=1.0, loss=0.0, faults=0, fault_tmax=0,
        fault_kinds="pair,kill", rng_stream=2, strict_restart=False,
        coverage=False, stop_on_plateau=0, guided=False,
    )
    assert job_fingerprint(spec) == fingerprint_from_args(cli_args)
    # and the namespace the worker hands to the streaming driver carries
    # the exact same fingerprint
    assert fingerprint_from_args(spec_to_args(spec)) == job_fingerprint(spec)


# -- store lifecycle ---------------------------------------------------------


def test_store_lifecycle_roundtrip(tmp_path):
    st = JobStore(str(tmp_path / "fleet"))
    job = st.submit(dict(ECHO_SPEC))
    assert job.state == QUEUED and job.id.startswith("j0001-")
    assert st.get(job.id).fingerprint == job_fingerprint(job.spec)
    for state in (COMPILING, RUNNING, FOUND, SHRUNK, FILED):
        st.transition(job.id, state)
        assert st.get(job.id).state == state  # persisted, not in-memory
    done = st.get(job.id)
    assert [s for _ts, s in done.history] == [
        QUEUED, COMPILING, RUNNING, FOUND, SHRUNK, FILED
    ]
    assert done.terminal and done.lease is None
    with pytest.raises(ValueError, match="illegal transition"):
        st.transition(job.id, RUNNING)
    # second submit gets a fresh id even with an identical spec
    job2 = st.submit(dict(ECHO_SPEC))
    assert job2.id.startswith("j0002-")
    assert job2.subkey == job.subkey
    assert st.counts()[FILED] == 1 and st.counts()[QUEUED] == 1


def test_store_cancel_semantics(tmp_path):
    st = JobStore(str(tmp_path))
    q = st.submit(dict(ECHO_SPEC))
    assert st.request_cancel(q.id).state == CANCELLED  # queued dies now
    r = st.submit(dict(ECHO_SPEC))
    st.transition(r.id, COMPILING)
    st.transition(r.id, RUNNING)
    out = st.request_cancel(r.id)
    assert out.state == RUNNING and out.cancel_requested  # worker finalizes
    # cancelling a terminal job is a no-op
    done = st.request_cancel(q.id)
    assert done.state == CANCELLED


def test_store_lease_block_expiry_and_own_reclaim(tmp_path):
    st = JobStore(str(tmp_path))
    job = st.submit(dict(ECHO_SPEC))
    assert st.try_lease(job.id, "w1", ttl_s=60) is not None
    assert st.try_lease(job.id, "w2", ttl_s=60) is None  # blocked
    assert st.try_lease(job.id, "w1", ttl_s=60) is not None  # own renew
    # simulate w1 dying: hand it an already-expired lease
    assert st.try_lease(job.id, "w1", ttl_s=-1) is not None
    assert st.try_lease(job.id, "w2", ttl_s=60) is not None  # reclaim
    st.transition(job.id, CANCELLED)
    assert st.try_lease(job.id, "w2", ttl_s=60) is None  # terminal


def test_store_fingerprint_drift_refused(tmp_path):
    st = JobStore(str(tmp_path))
    job = st.submit(dict(ECHO_SPEC))
    assert st.fingerprint_mismatch(job) is None
    # tamper the on-disk definition the way a bad edit would
    doc = json.load(open(st.job_path(job.id)))
    doc["spec"]["seeds"] = 4096
    doc["spec"]["machine"] = "raft"
    json.dump(doc, open(st.job_path(job.id), "w"))
    msg = st.fingerprint_mismatch(st.get(job.id))
    # names EVERY drifted field, not just the first
    assert "seeds" in msg and "machine" in msg and "refusing" in msg
    # the worker surfaces it verbatim as the failed reason (no engine,
    # no card — refusal happens before any build)
    from madsim_tpu_torch.fleet.worker import FleetWorker

    w = FleetWorker(str(tmp_path), worker_id="w1")
    w._run_unit(st.get(job.id))
    failed = st.get(job.id)
    assert failed.state == FAILED and "seeds" in failed.error


def test_checkpoint_mismatch_message_lists_all_fields(tmp_path):
    """The hunt-checkpoint refusal names WHICH fields differ
    (model, kinds, gates, lanes ...) instead of the bare first hit."""
    from madsim_tpu_torch.runtime import checkpoint as ck

    base = dict(machine="echo", nodes=0, seed=0, seeds=96, batch=32,
                max_steps=300, horizon=1.0, loss=0.0, faults=0,
                fault_tmax=0, fault_kinds="pair,kill", rng_stream=2,
                strict_restart=False, coverage=False, stop_on_plateau=0)
    saved = {"fingerprint": ck.fingerprint_from_args(SimpleNamespace(**base))}
    drifted = SimpleNamespace(**{
        **base, "machine": "raft", "fault_kinds": "torn", "seeds": 128,
    })
    msg = ck.check_fingerprint(saved, drifted)
    assert "machine" in msg and "fault_kinds" in msg and "seeds" in msg
    assert "'echo'" in msg and "'raft'" in msg  # both sides printed
    assert ck.check_fingerprint(saved, SimpleNamespace(**base)) is None


# -- allocator ---------------------------------------------------------------


def _mk_job(i, subkey, priority=0, deadline_ts=None):
    return Job(
        id=f"j{i:04d}-{'0' * 8}", spec={}, fingerprint={},
        fingerprint_sha="", subkey=subkey, priority=priority,
        deadline_ts=deadline_ts,
    )


def test_allocator_packs_by_subkey_with_round_robin():
    a, b = _mk_job(1, "s1"), _mk_job(2, "s1")
    c = _mk_job(3, "s2")
    al = LaneAllocator()
    # same-subkey jobs run back-to-back (round-robin within the group);
    # the other compile family waits for the group to drain
    assert [al.pick([a, b, c]).id for _ in range(4)] == [
        a.id, b.id, a.id, b.id
    ]
    assert al.pick([b, c]).id == b.id      # still sticky on s1
    assert al.pick([c]).id == c.id         # s1 drained: switch
    assert al.current_subkey == "s2"
    assert al.pick([]) is None


def test_allocator_priority_pays_the_compile_switch():
    a, b = _mk_job(1, "s1"), _mk_job(2, "s1")
    al = LaneAllocator()
    assert al.pick([a, b]).id == a.id      # s1 in flight
    hot = _mk_job(3, "s2", priority=5)
    assert al.pick([a, b, hot]).id == hot.id  # strictly higher priority
    assert al.current_subkey == "s2"
    # back to s1 once drained — round-robin resumes where it left off
    # (a was served last, so b is next)
    assert al.pick([a, b]).id == b.id
    assert al.current_subkey == "s1"


def test_allocator_deadline_orders_within_priority():
    soon = _mk_job(2, "s2", deadline_ts=100.0)
    late = _mk_job(1, "s1", deadline_ts=1e12)
    al = LaneAllocator()
    assert al.pick([late, soon]).id == soon.id


def test_mesh_jobs_never_share_a_warm_compile_group():
    """Mesh topology is part of the warm-compile grouping key (all
    torch-free): a d8 job and an unsharded job compile disjoint programs,
    so the allocator must treat them as different compile families —
    and a pre-mesh spec (no `devices` field at all, docs persisted
    before the rebuild) lands in the unsharded group."""
    from madsim_tpu_torch.fleet.store import job_subkey, repro_cmd

    base = normalize_spec({"machine": "raft", "batch": 256})
    meshed = normalize_spec({"machine": "raft", "batch": 256, "devices": 8})
    legacy = dict(base)
    del legacy["devices"]

    k_base, k_mesh = job_subkey(base), job_subkey(meshed)
    assert k_base != k_mesh and "d8" in k_mesh
    assert job_subkey(legacy) == k_base  # pre-mesh docs: unsharded group
    assert k_base.startswith("jax-unknown")  # the JAX package's fixed prefix

    # the allocator keys purely on subkey equality, so the two families
    # round-robin within themselves and never interleave
    a, b = _mk_job(1, k_base), _mk_job(2, k_mesh)
    al = LaneAllocator()
    assert al.pick([a, b]).id == a.id
    assert al.pick([a, b]).id == a.id  # sticky until the group drains

    # quarantine repro lines carry the topology; divisibility is
    # refused at submit, not at the worker
    assert "--devices 8" in repro_cmd(meshed)
    assert "--devices" not in repro_cmd(base)
    with pytest.raises(ValueError, match="multiple of devices"):
        normalize_spec({"machine": "raft", "batch": 100, "devices": 8})


# -- coverage-feedback scheduler ---------------------------------------------


def test_spec_guided_needs_coverage():
    with pytest.raises(ValueError, match="guided needs coverage"):
        normalize_spec({"machine": "raft", "guided": True})
    spec = normalize_spec({"machine": "raft", "guided": True,
                           "coverage": True})
    assert spec["guided"] is True
    # guided is a fingerprint field: flipping it refuses a resume
    other = dict(spec)
    other["guided"] = False
    assert job_fingerprint(spec) != job_fingerprint(other)


def test_scheduler_momentum_reads_feed_and_progress(tmp_path):
    from madsim_tpu_torch.fleet.scheduler import job_momentum, momentum_for

    st = JobStore(str(tmp_path))
    hot = st.submit(dict(ECHO_SPEC))
    cold = st.submit(dict(ECHO_SPEC))
    fresh = st.submit(dict(ECHO_SPEC))

    def feed(job_id, new_slots_list):
        with open(st.stats_base(job_id) + ".jsonl", "w") as f:
            for i, n in enumerate(new_slots_list):
                f.write(json.dumps({
                    "kind": "fleet_batch", "batch": i,
                    "coverage": {"slots_hit": 100 + i, "new_slots": n},
                }) + "\n")

    feed(hot.id, [40, 3, 2])
    # only the last RECENT_BATCHES rows count: an old burst ages out
    feed(cold.id, [40, 0, 0, 0, 0, 0])
    m_hot = job_momentum(st, st.get(hot.id))
    m_cold = job_momentum(st, st.get(cold.id))
    m_fresh = job_momentum(st, st.get(fresh.id))
    assert m_hot["active"] and m_hot["new_slots_recent"] == 45
    assert not m_cold["active"] and m_cold["new_slots_recent"] == 0
    assert m_fresh["active"] and m_fresh["batches_seen"] == 0  # bootstrap
    # a plateaued job is never active, whatever its feed says
    st.note_progress(hot.id, "w0", {"plateau": True})
    assert not job_momentum(st, st.get(hot.id))["active"]
    # jobs that emit no coverage at all keep their lanes (no signal is
    # not a verdict)
    blind = st.submit(dict(ECHO_SPEC))
    with open(st.stats_base(blind.id) + ".jsonl", "w") as f:
        f.write(json.dumps({"kind": "fleet_batch", "batch": 0}) + "\n")
    assert job_momentum(st, st.get(blind.id))["active"]
    m = momentum_for(st, st.list())
    assert set(m) == {hot.id, cold.id, fresh.id, blind.id}


def test_allocator_momentum_reallocates_within_ring():
    a, b, c = _mk_job(1, "s1"), _mk_job(2, "s1"), _mk_job(3, "s1")
    al = LaneAllocator()
    mom = {
        a.id: {"active": True}, b.id: {"active": False},
        c.id: {"active": True},
    }
    # the active front (a, c) round-robins; the stalled job waits
    picks = [al.pick([a, b, c], momentum=mom).id for _ in range(4)]
    assert picks == [a.id, c.id, a.id, c.id]
    # the stalled job gets its lanes back the moment the actives drain
    assert al.pick([b], momentum=mom).id == b.id
    # an all-stalled ring still runs (budget completion over starvation)
    mom_all = {j.id: {"active": False} for j in (a, b, c)}
    assert al.pick([a, b, c], momentum=mom_all) is not None
    # jobs missing from the momentum map default to active
    assert al.pick([a, b], momentum={}).id in (a.id, b.id)


def test_api_status_wait_longpoll(tmp_path):
    """?wait=S holds the GET until the job's artifacts change (or the
    window ends) — the streaming-results item in its minimal honest
    form. Terminal jobs answer immediately."""
    import threading

    st = JobStore(str(tmp_path))
    api = FleetAPI(st)
    api.WAIT_TICK_S = 0.05
    job = st.submit(dict(ECHO_SPEC))

    # no change: returns after the window with changed=False
    t0 = time.monotonic()
    status, _, body = api.handle("GET", f"/jobs/{job.id}?feed=2&wait=0.2")
    doc = json.loads(body)
    assert status == 200
    assert doc["wait"] == {"waited": True, "changed": False}
    assert time.monotonic() - t0 >= 0.2

    # a stats-feed append mid-wait releases the poll promptly
    def touch():
        with open(st.stats_base(job.id) + ".jsonl", "a") as f:
            f.write(json.dumps({"kind": "fleet_batch", "batch": 0}) + "\n")

    timer = threading.Timer(0.15, touch)
    timer.start()
    t0 = time.monotonic()
    status, _, body = api.handle("GET", f"/jobs/{job.id}?wait=10")
    timer.join()
    doc = json.loads(body)
    assert doc["wait"] == {"waited": True, "changed": True}
    assert time.monotonic() - t0 < 5  # released by the change, not the cap
    assert [r["batch"] for r in doc["feed"]] == [0]

    # terminal jobs never park: nothing will change again
    st.transition(job.id, COMPILING)
    st.transition(job.id, RUNNING)
    st.transition(job.id, EXHAUSTED, result={"report": {}, "finds": []})
    t0 = time.monotonic()
    status, _, body = api.handle("GET", f"/jobs/{job.id}?wait=5")
    assert time.monotonic() - t0 < 1
    assert "wait" not in json.loads(body)


def test_queue_summaries_surface_search_state(tmp_path):
    st = JobStore(str(tmp_path))
    api = FleetAPI(st)
    spec = dict(ECHO_SPEC)
    spec.update(coverage=True, guided=True)
    job = st.submit(spec)
    st.note_progress(job.id, "w0", {
        "plateau": False, "coverage_slots": 321, "escalation": 2,
    })
    _, _, body = api.handle("GET", "/queue")
    summary = [j for j in json.loads(body)["jobs"] if j["id"] == job.id][0]
    assert summary["guided"] is True
    assert summary["coverage_slots"] == 321
    assert summary["escalation"] == 2
    assert summary["plateau"] is False


# -- control-plane API -------------------------------------------------------


def test_api_handlers_roundtrip(tmp_path):
    st = JobStore(str(tmp_path))
    api = FleetAPI(st)
    # submit (wrapped and bare-spec bodies)
    status, _, body = api.handle(
        "POST", "/jobs",
        json.dumps({"spec": dict(ECHO_SPEC), "priority": 2}).encode(),
    )
    assert status == 201
    job_id = json.loads(body)["id"]
    status, _, _ = api.handle("POST", "/jobs",
                              json.dumps({"machine": "raft"}).encode())
    assert status == 201
    # validation -> 400 with the store's message
    status, _, body = api.handle(
        "POST", "/jobs", json.dumps({"spec": {"machine": "raft", "x": 1}}).encode()
    )
    assert status == 400 and "unknown spec fields" in json.loads(body)["error"]
    status, _, _ = api.handle("POST", "/jobs", b"not json")
    assert status == 400
    # queue
    status, _, body = api.handle("GET", "/queue")
    doc = json.loads(body)
    assert status == 200 and doc["counts"]["queued"] == 2
    assert {j["id"] for j in doc["jobs"]} >= {job_id}
    assert [j for j in doc["jobs"] if j["id"] == job_id][0]["priority"] == 2
    # status + live feed from the job's StatsEmitter JSONL
    rows = [{"kind": "fleet_batch", "batch": i} for i in range(5)]
    with open(st.stats_base(job_id) + ".jsonl", "w") as f:
        f.writelines(json.dumps(r) + "\n" for r in rows)
    status, _, body = api.handle("GET", f"/jobs/{job_id}?feed=2")
    doc = json.loads(body)
    assert status == 200 and doc["state"] == QUEUED
    assert [r["batch"] for r in doc["feed"]] == [3, 4]
    # result gated on terminal states
    status, _, _ = api.handle("GET", f"/jobs/{job_id}/result")
    assert status == 409
    st.transition(st.get(job_id).id, COMPILING)
    st.transition(job_id, RUNNING)
    st.transition(job_id, EXHAUSTED,
                  result={"report": {"completed": 96}, "finds": []})
    status, _, body = api.handle("GET", f"/jobs/{job_id}/result")
    doc = json.loads(body)
    assert status == 200 and doc["result"]["report"]["completed"] == 96
    # cancel + 404s
    status, _, _ = api.handle("DELETE", f"/jobs/{job_id}")
    assert status == 200
    assert api.handle("GET", "/jobs/nope")[0] == 404
    assert api.handle("GET", "/bogus")[0] == 404
    assert api.handle("GET", "/healthz")[0] == 200


def test_api_metrics_aggregates_labeled_job_feeds(tmp_path):
    st = JobStore(str(tmp_path))
    api = FleetAPI(st)
    ids = []
    for _ in range(2):
        _, _, body = api.handle(
            "POST", "/jobs", json.dumps({"spec": dict(ECHO_SPEC)}).encode()
        )
        ids.append(json.loads(body)["id"])
    # per-job StatsEmitter textfiles, label-namespaced like the worker
    # writes them
    for jid in ids:
        with open(st.stats_base(jid) + ".prom", "w") as f:
            f.write("# emitted by madsim_tpu StatsEmitter (seq 9)\n"
                    "# TYPE madsim_tpu_completed gauge\n"
                    f'madsim_tpu_completed{{job="{jid}"}} 32\n')
    _, ctype, body = api.handle("GET", "/metrics")
    text = body.decode()
    assert "version=0.0.4" in ctype
    assert 'madsim_tpu_fleet_jobs{state="queued"} 2' in text
    for jid in ids:
        assert f'madsim_tpu_completed{{job="{jid}"}} 32' in text
    # a valid exposition declares each metric's TYPE exactly once
    assert text.count("# TYPE madsim_tpu_completed gauge") == 1


def test_control_plane_is_torch_free():
    """The acceptance contract: `fleet serve` (store + api + client +
    httpd) imports neither torch nor anything of JAX, so it runs on a
    box with no card. Subprocess so this process's own imports can't
    mask a regression."""
    code = (
        "import sys; "
        "import madsim_tpu_torch.fleet.api, madsim_tpu_torch.fleet.client, "
        "madsim_tpu_torch.fleet.store, madsim_tpu_torch.fleet.httpd, "
        "madsim_tpu_torch.fleet.events; "
        "from madsim_tpu_torch.fleet.store import JobStore; "
        "import tempfile; "
        "s = JobStore(tempfile.mkdtemp()); "
        "s.submit({'machine': 'raft'}); "
        "bad = [m for m in sys.modules if m.split('.')[0] in ('torch', 'jax', 'madsim_tpu')]; "
        "sys.exit(1 if bad else 0)"
    )
    out = subprocess.run([sys.executable, "-c", code],
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


# -- worker finalization (no compiles: shrink + audit stubbed) ---------------


def test_worker_files_finds_with_job_provenance(tmp_path, monkeypatch):
    """found -> shrunk -> filed: corpus entries carry filed-by-job
    metadata + the minimal repro line + why attribution, and the result
    doc mirrors them. shrink/audit are stubbed so no replay runs."""
    import importlib

    from madsim_tpu_torch.fleet.worker import FleetWorker

    st = JobStore(str(tmp_path))
    job = st.submit({**ECHO_SPEC, "provenance": True})
    st.transition(job.id, COMPILING)
    st.transition(job.id, RUNNING)
    # a finished checkpoint with two failing seeds sharing one code and
    # a provenance word for seed 5
    from madsim_tpu_torch.runtime.checkpoint import save_checkpoint

    save_checkpoint(st.ckpt_path(job.id), {
        "fingerprint": job.fingerprint, "batch": 3, "planned": 3,
        "cursor": 96, "completed": 96, "seeds_consumed": 96,
        "failing": [[5, 7], [9, 7]], "infra": [], "abandoned": [],
        "prov": {"5": 3}, "cov_b64": None, "detector": None,
        "plateau": False, "done": True,
    })

    shrink_mod = importlib.import_module("madsim_tpu_torch.engine.shrink")
    audit_mod = importlib.import_module("madsim_tpu_torch.engine.audit")

    def fake_shrink(eng, seed, max_steps=10_000, prov_word=None):
        assert seed == 5 and prov_word == 3  # dedup kept one per code
        return SimpleNamespace(
            shrunk=eng.config, steps=57, fail_code=7,
            summary=lambda: f"seed {seed} shrunk (stub)",
        )

    monkeypatch.setattr(shrink_mod, "shrink", fake_shrink)
    monkeypatch.setattr(
        audit_mod, "record_entry",
        lambda entry, build_machine, every=64, device=None: (entry, None),
    )
    prov_mod = importlib.import_module("madsim_tpu_torch.engine.provenance")
    monkeypatch.setattr(
        prov_mod, "implicated",
        lambda eng, seed, word: SimpleNamespace(
            word=word, kinds=("kill",), faults=[], aliased=False
        ),
    )

    w = FleetWorker(str(tmp_path), worker_id="w9", device="cpu")
    w._finalize(st.get(job.id))

    done = st.get(job.id)
    assert done.state == FILED
    assert done.result["report"]["completed"] == 96
    assert done.result["report"]["failing"] == [[5, 7], [9, 7]]
    [find] = done.result["finds"]
    assert find["seed"] == 5 and find["corpus_status"] == "added"
    assert find["repro"].startswith("python -m madsim_tpu_torch replay --machine echo")
    assert find["why"]["kinds"] == ["kill"]
    entries = json.load(open(st.corpus_path))["entries"]
    assert entries[0]["meta"]["filed_by"]["job"] == job.id
    assert entries[0]["meta"]["why_kinds"] == ["kill"]
    assert entries[0]["meta"]["repro"] == find["repro"]


# -- daemon hardening (--port-file + SIGTERM) --------------------------------


def test_port_file_roundtrip(tmp_path):
    path = str(tmp_path / "p.port")
    httpd.write_port_file(path, 12345)
    assert httpd.read_port_file(path) == 12345
    assert not os.path.exists(path + ".tmp")  # rename, not rewrite


@pytest.mark.parametrize("argv", [
    ("serve", "--service", "stats"),
    ("fleet", "serve"),
])
def test_daemons_write_port_file_and_exit_on_sigterm(tmp_path, argv):
    """Both HTTP daemons support --addr host:0 + --port-file
    discovery and close gracefully on SIGTERM (exit 0), not only on
    KeyboardInterrupt."""
    port_file = str(tmp_path / "daemon.port")
    extra = (
        ["--stats", str(tmp_path / "stats")] if argv[0] == "serve"
        else ["--root", str(tmp_path / "fleet")]
    )
    proc = subprocess.Popen(
        [sys.executable, "-m", "madsim_tpu_torch", *argv,
         "--addr", "127.0.0.1:0", "--port-file", port_file, *extra],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )
    try:
        deadline = time.monotonic() + 30
        while not os.path.exists(port_file):
            assert proc.poll() is None, proc.stdout.read()
            assert time.monotonic() < deadline, "port file never appeared"
            time.sleep(0.05)
        port = httpd.read_port_file(port_file)
        import urllib.request

        with urllib.request.urlopen(
            f"http://127.0.0.1:{port}/healthz", timeout=10
        ) as resp:
            body = resp.read()
            # stats service: bare "ok"; fleet serve: the store-
            # integrity JSON — healthy either way
            assert body == b"ok\n" or json.loads(body)["ok"] is True
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=30) == 0  # graceful, not -15
    finally:
        if proc.poll() is None:
            proc.kill()


# -- end-to-end worker (slow tier: one echo-engine compile) ------------------


@pytest.mark.slow
def test_worker_crash_resume_identical_and_warm_reuse(tmp_path, capsys):
    """The durability + multi-tenancy proof at test scale: two tenants
    with one compile family; the worker is interrupted after one unit
    and a successor (same lease identity, fresh engine cache) drains
    the farm. The interrupted job's final report must be byte-identical
    to an uninterrupted run's, the second tenant must reuse the live
    engine (zero compiles), and the per-job stats feeds stay isolated."""
    from madsim_tpu_torch.fleet.worker import FleetWorker

    root = str(tmp_path / "farm")
    st = JobStore(root)
    a = st.submit(dict(ECHO_SPEC))
    b = st.submit(dict(ECHO_SPEC))
    FleetWorker(root, worker_id="w1", device="cpu").run(max_units=1)
    assert st.get(a.id).progress["batches_run"] == 1  # ckpt after batch 1

    FleetWorker(root, worker_id="w1", device="cpu").run(drain=True)  # reclaims own lease
    out = capsys.readouterr().out
    assert "resumed at batch 2/3" in out
    ja, jb = st.get(a.id), st.get(b.id)
    assert ja.state == EXHAUSTED and jb.state == EXHAUSTED
    assert ja.result["report"]["completed"] == 96
    # tenant B never built an engine of its own
    assert jb.progress["engine"] == "cached"
    # isolated per-job feeds: each JSONL names only its own batches
    feed_a = st.read_feed(a.id, 100)
    feed_b = st.read_feed(b.id, 100)
    assert feed_a and feed_b
    assert all(r["kind"].startswith("fleet_") for r in feed_a + feed_b)
    assert ja.result["report"] == jb.result["report"]  # same spec, same seeds

    # uninterrupted twin farm -> byte-identical report
    root2 = str(tmp_path / "farm2")
    st2 = JobStore(root2)
    c = st2.submit(dict(ECHO_SPEC))
    FleetWorker(root2, worker_id="w2", device="cpu").run(drain=True)
    assert st2.get(c.id).result["report"] == ja.result["report"]
