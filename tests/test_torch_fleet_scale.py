"""Many workers, one queue (the port's fleet under contention), held to
the cases of tests/test_fleet_scale.py: lease generations + CAS renewal,
fencing tokens, the O_EXCL claim protocol, the log-structured queue
index, admission control, and the multi-worker chaos invariants.

Everything here builds no engine — the control plane is torch-free by
contract (pinned in test_torch_fleet.py) and the few subprocess tests
run synthetic drivers only.
"""

import json
import os
import subprocess
import sys
import tempfile
import time

import pytest

from madsim_tpu_torch.fleet import fsck as fsck_mod
from madsim_tpu_torch.fleet.store import (
    COMPILING,
    FAILED,
    QUEUED,
    RUNNING,
    FencedWrite,
    JobStore,
)
from madsim_tpu_torch.fleet.worker import FleetWorker
from madsim_tpu_torch.runtime.atomicio import create_exclusive

ECHO_SPEC = {"machine": "echo", "seeds": 96, "batch": 32, "faults": 0,
             "horizon": 1.0, "max_steps": 300}


def _expire(st, job_id):
    """Hand the current holder an already-expired lease (the chaos
    harness's lease-jump, at store scale)."""

    def mut(job):
        if job.lease:
            job.lease["expires_ts"] = 0.0

    st._update(job_id, mut)


# -- lease generations + CAS renewal (the 1-worker fencing corner) -----------


def test_renew_lease_cas_rejects_reclaimed_generation(tmp_path):
    """Regression for the lease-reclaim/heartbeat race: the reclaim
    sweep fires between a live worker's last read and its renewal
    write. Worker-identity renewal either no-ops silently (worker keeps
    streaming on a job it lost) or — when the same worker re-leased in
    between — resurrects a hold from a dead generation. The CAS refuses
    both and says so."""
    st = JobStore(str(tmp_path))
    job = st.submit(dict(ECHO_SPEC))

    held = st.try_lease(job.id, "w1", ttl_s=60)
    gen1 = held.lease["gen"]
    assert gen1 == 1 and held.lease_gen == 1
    # renewing the live generation succeeds (and reports it)
    assert st.renew_lease(job.id, "w1", gen=gen1) is True
    # a worker re-claiming its OWN live lease keeps the generation
    assert st.try_lease(job.id, "w1", ttl_s=60).lease["gen"] == gen1

    # the lease expires and the sweep reclaims it mid-heartbeat
    _expire(st, job.id)
    acts = st.reclaim_expired(backoff_base_s=0.0)
    assert [a["outcome"] for a in acts] == [QUEUED]
    assert st.get(job.id).lease is None

    # w1's in-flight heartbeat carries the dead generation: refused,
    # and nothing is resurrected
    assert st.renew_lease(job.id, "w1", gen=gen1) is False
    assert st.get(job.id).lease is None

    # takeover starts a new generation; the zombie still can't renew
    j2 = st.try_lease(job.id, "w2", ttl_s=60)
    assert j2.lease["gen"] == gen1 + 1
    expires2 = j2.lease["expires_ts"]
    assert st.renew_lease(job.id, "w1", gen=gen1) is False
    after = st.get(job.id)
    assert after.lease["worker"] == "w2"
    assert after.lease["expires_ts"] == expires2  # untouched

    # the same-worker corner worker-identity checks cannot catch: w2's
    # lease is reclaimed and w2 itself re-leases (gen 3); a heartbeat
    # captured before the reclaim (gen 2) must still fail the CAS
    _expire(st, job.id)
    st.reclaim_expired(backoff_base_s=0.0)
    j3 = st.try_lease(job.id, "w2", ttl_s=60)
    assert j3.lease["gen"] == gen1 + 2
    assert st.renew_lease(job.id, "w2", gen=gen1 + 1) is False
    assert st.renew_lease(job.id, "w2", gen=j3.lease["gen"]) is True

    # gen=None keeps the legacy worker-identity semantics
    assert st.renew_lease(job.id, "w2") is True
    assert st.renew_lease(job.id, "w1") is False


def test_lease_generation_survives_the_doc_roundtrip(tmp_path):
    """The generation is part of the persisted document (a restarted
    worker or a second process sees the same fencing state), and old
    pre-generation docs load with gen 0."""
    st = JobStore(str(tmp_path))
    job = st.submit(dict(ECHO_SPEC))
    st.try_lease(job.id, "w1", ttl_s=60)
    doc = json.load(open(st.job_path(job.id)))
    assert doc["lease_gen"] == 1 and doc["lease"]["gen"] == 1

    # a pre-fencing document: no lease_gen field, no lease["gen"]
    doc.pop("lease_gen")
    doc["lease"] = {"worker": "w0", "expires_ts": 1e12, "ttl_s": 60}
    json.dump(doc, open(st.job_path(job.id), "w"))
    old = st.get(job.id)
    assert old.lease_gen == 0
    # worker-identity renewal still works against the legacy lease
    assert st.renew_lease(job.id, "w0", gen=0) is True
    assert st.renew_lease(job.id, "w0", gen=1) is False

# -- fencing tokens: the store refuses zombie writes --------------------------


def test_fencing_refuses_every_zombie_mutation(tmp_path):
    """After a reclaim + takeover, every mutation carrying the dead
    generation is refused: transition / note_progress / degrade_lanes
    raise FencedWrite, record_death returns None silently (the reporter
    was abandoning the job anyway). Each refusal is tallied on the doc
    and lands on the event stream — observability only, never results."""
    st = JobStore(str(tmp_path))
    job = st.submit(dict(ECHO_SPEC))
    st.try_lease(job.id, "w1", ttl_s=60)
    _expire(st, job.id)
    st.reclaim_expired(backoff_base_s=0.0)
    j2 = st.try_lease(job.id, "w2", ttl_s=60)
    assert j2.lease["gen"] == 2
    before = open(st.job_path(job.id)).read()

    with pytest.raises(FencedWrite) as exc:
        st.transition(job.id, COMPILING, worker="w1", gen=1)
    assert "reclaimed" in str(exc.value) and job.id in str(exc.value)
    with pytest.raises(FencedWrite):
        st.note_progress(job.id, "w1", {"batches_run": 9}, gen=1)
    with pytest.raises(FencedWrite):
        st.degrade_lanes(job.id, error="zombie OOM", worker="w1", gen=1)
    assert st.record_death(job.id, reason="zombie death", worker="w1",
                           gen=1) is None

    after = st.get(job.id)
    # the only doc change is the refusal tally; the new holder's state,
    # lease and progress are untouched
    assert after.n_fenced_writes == 4
    assert after.state == QUEUED and after.lease["worker"] == "w2"
    assert after.lease["gen"] == 2
    assert after.progress == json.loads(before)["progress"]
    fenced = [e for e in st.read_events(job.id) if e["type"] == "fenced"]
    assert len(fenced) == 4
    assert {e["worker"] for e in fenced} == {"w1"}
    assert {e["gen"] for e in fenced} == {1}
    assert {e["holder"] for e in fenced} == {"w2"}
    ops = {e["op"] for e in fenced}
    assert f"transition->{COMPILING}" in ops

    # the live generation still works end to end
    st.transition(job.id, COMPILING, worker="w2", gen=2)
    st.transition(job.id, RUNNING, worker="w2", gen=2)
    assert st.get(job.id).state == RUNNING

    # legacy writers (gen=None) keep the unfenced semantics
    st.note_progress(job.id, "w2", {"batches_run": 1})
    assert st.get(job.id).n_fenced_writes == 4


# -- the O_EXCL claim protocol ------------------------------------------------


def test_claim_protocol_stamps_conflicts_and_clears(tmp_path):
    st = JobStore(str(tmp_path))
    job = st.submit(dict(ECHO_SPEC))

    info = {}
    held = st.try_lease(job.id, "w1", ttl_s=60, info=info)
    assert info["outcome"] == "leased"
    claim = json.load(open(st.claim_path(job.id)))
    assert claim["worker"] == "w1" and claim["gen"] == held.lease["gen"]
    assert claim["expires_ts"] == held.lease["expires_ts"]

    # the loser's fast path: no lock taken, outcome + holder reported
    info2 = {}
    assert st.try_lease(job.id, "w2", ttl_s=60, info=info2) is None
    assert info2 == {"outcome": "claim-conflict", "holder": "w1"}

    # terminal transition clears the claim file
    st.transition(job.id, COMPILING, worker="w1", gen=1)
    st.transition(job.id, RUNNING, worker="w1", gen=1)
    st.transition(job.id, FAILED, error="boom", worker="w1", gen=1)
    assert not os.path.exists(st.claim_path(job.id))

    # a stale claim from a dead generation never blocks a fresh lease:
    # the flock arbitrates and the winner restamps the claim
    job2 = st.submit(dict(ECHO_SPEC))
    assert create_exclusive(
        st.claim_path(job2.id),
        json.dumps({"worker": "w-dead", "gen": 7}) + "\n", fsync=False)
    info3 = {}
    got = st.try_lease(job2.id, "w1", ttl_s=60, info=info3)
    assert got is not None and info3["outcome"] == "leased"
    assert json.load(open(st.claim_path(job2.id)))["worker"] == "w1"

    # a torn claim stamp (crash mid-claim) is arbitrated around too
    job3 = st.submit(dict(ECHO_SPEC))
    with open(st.claim_path(job3.id), "w") as f:
        f.write('{"worker": "w-to')
    assert st.try_lease(job3.id, "w2", ttl_s=60) is not None


# -- the log-structured queue index -------------------------------------------


def test_queue_index_is_incremental_and_torn_tolerant(tmp_path):
    st = JobStore(str(tmp_path))
    jobs = [st.submit(dict(ECHO_SPEC)) for _ in range(3)]
    rows = st.queue_rows()
    assert sorted(rows) == sorted(j.id for j in jobs)
    assert {r["state"] for r in rows.values()} == {QUEUED}

    # mutations surface incrementally (no rescan, no doc reads)
    st.try_lease(jobs[0].id, "w1", ttl_s=60)
    rows = st.queue_rows()
    assert rows[jobs[0].id]["worker"] == "w1"
    assert rows[jobs[0].id]["gen"] == 1

    # a torn mid-append tail is NOT consumed: the reader stops at the
    # last newline and picks the record up once the append completes
    row = json.dumps({"job": jobs[1].id, "state": "exhausted",
                      "subkey": jobs[1].subkey, "priority": 0,
                      "deadline_ts": None, "requeue_after_ts": None,
                      "worker": None, "lease_expires_ts": None,
                      "gen": 0, "plateau": False, "ts": 1.0},
                     sort_keys=True, separators=(",", ":")) + "\n"
    with open(st.queue_log_path, "a") as f:
        f.write(row[:20])
    assert st.queue_rows()[jobs[1].id]["state"] == QUEUED  # unchanged
    with open(st.queue_log_path, "a") as f:
        f.write(row[20:])
    assert st.queue_rows()[jobs[1].id]["state"] == "exhausted"

    # ...which now misrepresents the doc: lag detected, corrections
    # appended, index converges back to the docs (the source of truth)
    assert st.queue_log_lag() == 1
    assert st.sync_queue_log() == 1
    assert st.queue_log_lag() == 0
    assert st.queue_rows()[jobs[1].id]["state"] == QUEUED

    # a vanished log is rebuilt lazily from the docs
    os.unlink(st.queue_log_path)
    rows = st.queue_rows()
    assert sorted(rows) == sorted(j.id for j in jobs)
    assert st.queue_log_lag() == 0


# -- O(1) polling at scale (acceptance) ---------------------------------------


def _fabricate_store(n_jobs):
    """A store with one leasable job and n_jobs-1 terminal ones,
    fabricated directly (submit() per job would dominate the bench)."""
    root = tempfile.mkdtemp(prefix="fleet-scale-")
    st = JobStore(root)
    live = st.submit(dict(ECHO_SPEC))
    template = json.load(open(st.job_path(live.id)))
    for i in range(n_jobs - 1):
        doc = dict(template, id=f"jt{i:05d}-deadbeef", state="exhausted",
                   result={"report": {}, "finds": []})
        json.dump(doc, open(st.job_path(doc["id"]), "w"))
    st.rebuild_queue_log()
    return root


def _fs_ops_for_one_poll(worker):
    """Count every filesystem touch (open/os.open/listdir/scandir/stat)
    one `_lease_next` poll makes."""
    import builtins

    real = {"open": builtins.open, "os_open": os.open,
            "listdir": os.listdir, "scandir": os.scandir, "stat": os.stat}
    count = [0]

    def wrap(fn):
        def inner(*a, **k):
            count[0] += 1
            return fn(*a, **k)
        return inner

    builtins.open = wrap(real["open"])
    os.open = wrap(real["os_open"])
    os.listdir = wrap(real["listdir"])
    os.scandir = wrap(real["scandir"])
    os.stat = wrap(real["stat"])
    try:
        worker._lease_next()
    finally:
        builtins.open = real["open"]
        os.open = real["os_open"]
        os.listdir = real["listdir"]
        os.scandir = real["scandir"]
        os.stat = real["stat"]
    return count[0]


def test_poll_filesystem_ops_do_not_scale_with_store_size():
    """THE contention-fix pin: one lease poll costs a CONSTANT number
    of filesystem operations — the queue index answers "what is
    leasable" from memory plus the log's new bytes, and only the
    surviving candidates get their documents opened. A directory scan
    (or per-job doc read) would make this grow with the store."""
    ops = {}
    lat = {}
    for n in (100, 1000, 10_000):
        root = _fabricate_store(n)
        w = FleetWorker(root, worker_id="bench", poll_s=0.01)
        w._lease_next()  # warm-up: the first poll reads the whole log
        ops[n] = _fs_ops_for_one_poll(w)
        best = float("inf")
        for _ in range(5):
            # this process's CPU time, not the wall clock: the test
            # workers beside it cannot stretch a poll
            t0 = time.process_time()
            w._lease_next()
            best = min(best, time.process_time() - t0)
        lat[n] = best
    assert ops[100] == ops[1000] == ops[10_000], ops
    # the latency micro-bench: flat 100 -> 10k (generous bound — the
    # in-memory index scan is O(n) CPU but never O(n) filesystem)
    assert lat[10_000] < lat[100] * 5 + 0.005, lat


# -- concurrent appenders never interleave ------------------------------------


_APPENDER = """
import json, sys
sys.path.insert(0, {repo!r})
from madsim_tpu_torch.runtime.atomicio import append_text
tag, path, n = sys.argv[1], sys.argv[2], int(sys.argv[3])
for i in range(n):
    rec = {{"w": tag, "i": i, "pad": "x" * (37 * (i % 5))}}
    append_text(path, json.dumps(rec, sort_keys=True) + "\\n", fsync=False)
print("done", tag)
"""


def test_two_processes_share_one_log_without_interleaving(tmp_path):
    """Two processes hammer one append-only log; the committed file
    must hold every record intact — whole-record interleaving only,
    never bytes of one record inside another (the single-os.write
    O_APPEND discipline). This is what lets N workers share queue.log
    and the event logs without a lock."""
    log = str(tmp_path / "shared.log")
    script = _APPENDER.format(
        repo=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    n = 200
    procs = [
        subprocess.Popen([sys.executable, "-c", script, tag, log, str(n)],
                         stdout=subprocess.PIPE, stderr=subprocess.PIPE)
        for tag in ("a", "b")
    ]
    for p in procs:
        out, err = p.communicate(timeout=120)
        assert p.returncode == 0, err.decode()
    seen = {"a": [], "b": []}
    with open(log) as f:
        for line in f:
            rec = json.loads(line)  # every committed line parses whole
            assert rec["pad"] == "x" * (37 * (rec["i"] % 5))
            seen[rec["w"]].append(rec["i"])
    # nothing lost, nothing duplicated, per-writer order preserved
    assert seen["a"] == list(range(n))
    assert seen["b"] == list(range(n))


# -- the worker under contention ----------------------------------------------


def test_worker_abandons_fenced_unit_without_stomping_new_holder(tmp_path,
                                                                 capsys):
    """The zombie-resume scenario at worker scale: w1 leases a unit,
    stalls, loses the lease to the reclaim sweep, w2 takes over — then
    w1 resumes. Its first store write carries the dead generation, the
    store refuses it, and the worker abandons the unit (counted in its
    stats doc) instead of failing the job or stomping w2's lease."""
    from madsim_tpu_torch.fleet.chaos import synthetic_driver

    root = str(tmp_path)
    st = JobStore(root)
    job = st.submit(dict(ECHO_SPEC))
    w1 = FleetWorker(root, worker_id="w1", poll_s=0.01,
                     driver=synthetic_driver)
    held = w1._lease_next()
    assert held is not None and w1._unit_gen == 1

    # the stall: lease expires, the sweep reclaims, w2 takes over
    _expire(st, job.id)
    st.reclaim_expired(backoff_base_s=0.0)
    assert st.try_lease(job.id, "w2", ttl_s=60).lease["gen"] == 2

    w1._run_unit(held)  # the zombie resumes

    j = st.get(job.id)
    assert j.lease["worker"] == "w2" and j.lease["gen"] == 2
    assert j.state == QUEUED  # w2's unit has not run yet; not FAILED
    assert j.n_fenced_writes >= 1
    assert w1.fenced_writes == 1
    stats = st.read_worker_stats()
    assert stats["w1"]["fenced_writes"] == 1
    assert "rejected" in capsys.readouterr().out


def test_worker_counts_claim_conflicts_and_backs_off(tmp_path, capsys,
                                                     monkeypatch):
    """The true contention window: w1 leases AFTER w2's poll validated
    the job as free but BEFORE w2's claim. w2 loses the O_EXCL race to
    the live holder: it reports the conflict in its stats doc, prints
    the loss, and returns None after a seeded-jitter backoff (which
    de-synchronizes N losers)."""
    root = str(tmp_path)
    st = JobStore(root)
    job = st.submit(dict(ECHO_SPEC))
    w2 = FleetWorker(root, worker_id="w2", poll_s=0.01, reclaim=False)

    real_pick = w2.alloc.pick

    def racing_pick(cands, momentum=None):
        picked = real_pick(cands, momentum=momentum)
        if picked is not None:
            # w1 wins the race in the instant between w2's candidate
            # validation and w2's claim attempt
            st.try_lease(picked.id, "w1", ttl_s=60)
        return picked

    monkeypatch.setattr(w2.alloc, "pick", racing_pick)
    t0 = time.perf_counter()
    assert w2._lease_next() is None
    elapsed = time.perf_counter() - t0
    assert w2.claim_conflicts == 1
    assert st.read_worker_stats()["w2"]["claim_conflicts"] == 1
    out = capsys.readouterr().out
    assert "lost claim race" in out and "w1" in out
    assert elapsed >= 0.004  # the seeded-jitter backoff actually slept
    # the holder is untouched
    assert st.get(job.id).lease["worker"] == "w1"


# -- fsck: stale claims + queue-log repair ------------------------------------


def test_fsck_removes_stale_claims_and_rebuilds_the_queue_log(tmp_path):
    root = str(tmp_path)
    st = JobStore(root)
    job = st.submit(dict(ECHO_SPEC))
    live = st.submit(dict(ECHO_SPEC))
    st.try_lease(live.id, "w1", ttl_s=60)

    # a claim from a dead generation (no matching live lease)
    create_exclusive(st.claim_path(job.id),
                     json.dumps({"worker": "w-dead", "gen": 3}) + "\n",
                     fsync=False)
    # a lagging index: out-of-band truncation eats the lease row
    with open(st.queue_log_path, "r+") as f:
        f.truncate(0)

    rep = fsck_mod.fsck(root, fix=True)
    by_file = {x["file"]: x for x in rep["findings"]}
    assert by_file[f"{job.id}.claim"]["verdict"] == "stale-claim"
    assert by_file[f"{job.id}.claim"]["action"] == "removed"
    assert not os.path.exists(st.claim_path(job.id))
    assert by_file["queue.log"]["verdict"] == "index-stale"
    assert by_file["queue.log"]["action"].startswith("rebuilt from 2")
    # the LIVE claim survives (w1's lease is current)
    assert os.path.exists(st.claim_path(live.id))
    assert rep["corrupt"] == 0  # none of this is corruption

    # post-repair: the rebuilt log agrees with the docs
    st2 = JobStore(root)
    assert st2.queue_log_lag() == 0
    assert st2.queue_rows()[live.id]["worker"] == "w1"


# -- admission control and graceful degradation -------------------------------

SYN_SPEC = {"machine": "chaos-echo", "seeds": 96, "batch": 32, "faults": 0,
            "horizon": 1.0, "max_steps": 300}

_ADMISSION_ENVS = (
    "MADSIM_TPU_FLEET_RATE_LIMIT",
    "MADSIM_TPU_FLEET_RATE_BURST",
    "MADSIM_TPU_FLEET_MAX_QUEUE_DEPTH",
    "MADSIM_TPU_FLEET_SHED_DEPTH",
)


def _admission_api(tmp_path, monkeypatch, **env):
    """A FleetAPI over a fresh store with ONLY the given admission
    knobs set (the envs are read once at construction)."""
    from madsim_tpu_torch.fleet.api import FleetAPI

    for k in _ADMISSION_ENVS:
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, str(v))
    st = JobStore(str(tmp_path / "farm"))
    return st, FleetAPI(st)


def _drain(root):
    from madsim_tpu_torch.fleet.chaos import synthetic_driver

    FleetWorker(root, worker_id="wDrain", poll_s=0.01,
                driver=synthetic_driver).run(drain=True)


def test_burst_past_rate_limit_429s_then_farm_drains(tmp_path, monkeypatch):
    """The overload acceptance criterion: a synthetic burst past the
    rate limit yields 429 + a retry hint, ZERO accepted-job loss, and
    the farm drains to completion once the burst stops. Tenants spend
    separate buckets; /metrics keeps the admission ledger."""
    st, api = _admission_api(tmp_path, monkeypatch,
                             MADSIM_TPU_FLEET_RATE_LIMIT="0.5",
                             MADSIM_TPU_FLEET_RATE_BURST="2")
    accepted, refused = [], []
    for _ in range(6):  # burst: 2 tokens in the bucket, slow refill
        status, _, body = api.handle(
            "POST", "/jobs", json.dumps(SYN_SPEC).encode())
        (accepted if status == 201 else refused).append(
            (status, json.loads(body)))
    assert [s for s, _ in accepted] == [201, 201]
    assert [s for s, _ in refused] == [429] * 4
    for _, doc in refused:
        assert doc["reason"] == "rate_limited"
        assert doc["tenant"] == "default"
        assert doc["retry_after_s"] > 0
        assert "retry after" in doc["error"]
    # another tenant spends its OWN bucket — not starved by the burst
    status, _, body = api.handle("POST", "/jobs", json.dumps(
        {"spec": dict(SYN_SPEC), "tenant": "teamB"}).encode())
    assert status == 201
    accepted.append((status, json.loads(body)))

    # zero accepted-job loss: every 201 is a durable job doc, and the
    # farm drains them all once the burst stops
    ids = [doc["id"] for _, doc in accepted]
    assert sorted(ids) == sorted(j.id for j in st.list())
    _drain(str(tmp_path / "farm"))
    for jid in ids:
        assert st.get(jid).terminal

    _, _, mb = api.handle("GET", "/metrics")
    text = mb.decode()
    assert ('madsim_tpu_fleet_admission_total'
            '{tenant="default",outcome="admitted"} 2') in text
    assert ('madsim_tpu_fleet_admission_total'
            '{tenant="default",outcome="rate_limited"} 4') in text
    assert ('madsim_tpu_fleet_admission_total'
            '{tenant="teamB",outcome="admitted"} 1') in text
    assert "madsim_tpu_fleet_claim_conflicts_total 0" in text
    assert "madsim_tpu_fleet_fenced_writes_total 0" in text


def test_depth_cap_and_load_shed_degrade_reads_and_healthz(tmp_path,
                                                           monkeypatch):
    """Queue-depth admission + the shed ladder: the cap 429s new work,
    the shed threshold flips the whole plane into degraded mode —
    index-served reads, 503 health, a shed gauge — and everything
    recovers the moment the backlog drains."""
    st, api = _admission_api(tmp_path, monkeypatch,
                             MADSIM_TPU_FLEET_MAX_QUEUE_DEPTH="3",
                             MADSIM_TPU_FLEET_SHED_DEPTH="5")
    for _ in range(3):
        status, _, _ = api.handle(
            "POST", "/jobs", json.dumps(SYN_SPEC).encode())
        assert status == 201
    status, _, body = api.handle(
        "POST", "/jobs", json.dumps(SYN_SPEC).encode())
    assert status == 429 and json.loads(body)["reason"] == "depth_limited"

    # backlog grows past the shed threshold out-of-band (direct store
    # submits model jobs accepted before the operator tightened knobs)
    st.submit(dict(SYN_SPEC))
    st.submit(dict(SYN_SPEC))
    status, _, body = api.handle(
        "POST", "/jobs", json.dumps(SYN_SPEC).encode())
    doc = json.loads(body)
    assert status == 429 and doc["reason"] == "shed"
    assert doc["retry_after_s"] > 0

    # /healthz: alive but degraded -> 503, shed named, workers/lag keys
    status, _, body = api.handle("GET", "/healthz")
    hz = json.loads(body)
    assert status == 503 and hz["ok"] is False and hz["shed"] is True
    assert "load-shedding" in hz["degraded"]
    assert hz["store"]["corrupt_files"] == 0  # NOT a corruption 503
    assert "workers" in hz and "queue_log_lag" in hz

    # /jobs reads serve from the index while shedding: degraded rows,
    # no momentum/event I/O, farm block says shed
    status, _, body = api.handle("GET", "/jobs")
    q = json.loads(body)
    assert status == 200 and q["degraded"] is True
    assert q["counts"]["queued"] == 5 and len(q["jobs"]) == 5
    assert all(set(j) == {"id", "state", "worker"} for j in q["jobs"])
    assert q["farm"]["shed"] is True

    _, _, mb = api.handle("GET", "/metrics")
    assert "madsim_tpu_fleet_shed 1" in mb.decode()
    assert "madsim_tpu_fleet_sheds_total 1" in mb.decode()

    # the backlog drains -> admission reopens, health goes green
    _drain(str(tmp_path / "farm"))
    status, _, body = api.handle("GET", "/healthz")
    assert status == 200 and json.loads(body)["shed"] is False
    status, _, body = api.handle(
        "POST", "/jobs", json.dumps(SYN_SPEC).encode())
    assert status == 201
    status, _, body = api.handle("GET", "/jobs")
    q = json.loads(body)
    assert "degraded" not in q and "momentum" in q["jobs"][0]
    assert q["farm"] == {"shed": False, "workers": q["farm"]["workers"],
                         "queue_log_lag": 0}
    _, _, mb = api.handle("GET", "/metrics")
    assert "madsim_tpu_fleet_shed 0" in mb.decode()


def test_retry_after_rides_the_wire_and_the_client_honors_it(tmp_path,
                                                             monkeypatch):
    """End-to-end over a real socket: the 429 carries an RFC
    Retry-After header (integer rendering of the body's precise
    retry_after_s), FleetClientError exposes it, and the retrying
    client waits it out and lands the submit."""
    import threading
    import urllib.error
    import urllib.request

    from madsim_tpu_torch.fleet import client, httpd
    from madsim_tpu_torch.fleet.api import FleetAPI, make_handler

    monkeypatch.setenv("MADSIM_TPU_FLEET_RATE_LIMIT", "5")
    monkeypatch.setenv("MADSIM_TPU_FLEET_RATE_BURST", "1")
    root = str(tmp_path / "farm")
    srv, _host, port = httpd.bind(
        "127.0.0.1:0", make_handler(FleetAPI(JobStore(root))))
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    addr = f"127.0.0.1:{port}"
    try:
        assert client.submit(addr, dict(SYN_SPEC))["id"]  # spends the token

        # raw refusal: header + body agree on the price
        req = urllib.request.Request(
            f"http://{addr}/jobs", data=json.dumps(SYN_SPEC).encode(),
            method="POST", headers={"Content-Type": "application/json"})
        try:
            urllib.request.urlopen(req, timeout=10)
            raise AssertionError("expected 429")
        except urllib.error.HTTPError as exc:
            assert exc.code == 429
            assert int(exc.headers["Retry-After"]) >= 1
            assert json.loads(exc.read())["retry_after_s"] > 0

        # the typed error carries the precise wait for --no-retry users
        with pytest.raises(client.FleetClientError) as ei:
            client.request(addr, "POST", "/jobs",
                           {"spec": dict(SYN_SPEC)}, retries=0)
        assert ei.value.status == 429 and ei.value.retry_after > 0

        # the retrying client waits the named price, then lands it
        t0 = time.monotonic()
        out = client.submit(addr, dict(SYN_SPEC))
        assert out["id"]
        assert time.monotonic() - t0 >= 0.05  # waited, not hammered
    finally:
        srv.shutdown()
        srv.server_close()
