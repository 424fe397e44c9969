"""The port's fleet against the JAX package's on one store root: the same
submits give the same bytes (job documents, fingerprints, subkeys, the
queue log and the event logs, timestamps masked), each package's store,
allocator, fsck and worker read a root the other wrote, and the same
small echo job gives byte-identical results on a JAX worker and on the
port's worker on the CPU, across a crash and resume too, and so does a
lane-sharded job over 2 CPU ranks. Then an out-of-memory error from
torch on the lane backoff, and the per-job Prometheus labels in the JAX
package's bytes.

Tolerance: byte equality after masking wall-clock timestamps, the store
roots' paths and the program name in repro lines.
"""

import ast
import json
import os
import pathlib
import re

import pytest
import torch

from madsim_tpu.fleet import fsck as jax_fsck
from madsim_tpu.fleet.allocator import LaneAllocator as JaxAllocator
from madsim_tpu.fleet.chaos import synthetic_driver as jax_synthetic
from madsim_tpu.fleet.store import JobStore as JaxStore
from madsim_tpu.fleet.worker import FleetWorker as JaxWorker
from madsim_tpu_torch.fleet import fsck
from madsim_tpu_torch.fleet.allocator import LaneAllocator
from madsim_tpu_torch.fleet.chaos import synthetic_driver
from madsim_tpu_torch.fleet.store import EXHAUSTED, FAILED, FILED, JobStore
from madsim_tpu_torch.fleet.worker import FleetWorker

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parents[1]

ECHO_SPEC = {"machine": "echo", "seeds": 96, "batch": 32, "faults": 0,
             "horizon": 1.0, "max_steps": 300}

# one of each shape the store keys on: gates, stream, strict restarts,
# guided search, a mesh size, a priority and a deadline
SUBMITS = [
    (dict(ECHO_SPEC), {}),
    ({"machine": "raft", "nodes": 3, "seeds": 96, "batch": 32, "horizon": 1.0, "max_steps": 600,
      "queue": 64, "faults": 2, "fault_tmax": 600_000, "coverage": True, "provenance": True,
      "guided": True, "stop_on_plateau": 1}, {"priority": 2}),
    ({"machine": "demo-volatilecommit-raft", "strict_restart": True, "rng_stream": 3, "queue": 32,
      "seeds": 16384, "batch": 8192, "flight_recorder": True, "coverage": True, "shrink_limit": 1},
     {"deadline_s": 3600.0}),
    ({"machine": "kv", "seeds": 64, "batch": 64, "devices": 2}, {}),
    (dict(ECHO_SPEC), {"priority": -1}),
]

# wall-clock stamps: ten integer digits, a fraction
_TS = re.compile(r"\b1\d{9}(\.\d+)?\b")


def _masked_text(text: str, *roots: str) -> str:
    for root in roots:
        text = text.replace(root, "<root>")
    return _TS.sub("<ts>", text.replace("madsim_tpu_torch", "madsim_tpu"))


def _tree(root: str) -> dict:
    """relative path -> text of every file a store root holds (locks and
    claim files are empty markers)."""
    out = {}
    for dirpath, _dirs, files in os.walk(root):
        for fn in files:
            path = os.path.join(dirpath, fn)
            with open(path) as f:
                out[os.path.relpath(path, root)] = f.read()
    return out


def _submit_all(store):
    return [store.submit(dict(spec), **kw) for spec, kw in SUBMITS]


def test_submit_sequence_matches_jax_store(tmp_path):
    jax_root, port_root = str(tmp_path / "jax"), str(tmp_path / "port")
    want, got = _submit_all(JaxStore(jax_root)), _submit_all(JobStore(port_root))
    for w, g in zip(want, got):
        assert (g.id, g.fingerprint, g.fingerprint_sha, g.subkey) == (w.id, w.fingerprint, w.fingerprint_sha,
                                                                      w.subkey)
    assert got[3].subkey.endswith("-d2") and got[0].subkey.startswith("jax-unknown-rng2")
    jt, pt = _tree(jax_root), _tree(port_root)
    assert sorted(pt) == sorted(jt)
    # job documents, queue log, event logs: the same bytes but the stamps
    for rel in jt:
        assert _masked_text(pt[rel]) == _masked_text(jt[rel]), rel
    assert any(rel.endswith(".events.jsonl") for rel in jt) and "queue.log" in jt


def test_each_package_reads_the_other_root(tmp_path):
    """A root written by either package is read by the other's store,
    allocator and fsck with the same answers, and drained by the other's
    worker (the synthetic driver: no engine) to the same results."""
    for writer, reader, reader_alloc, reader_fsck in (
        (JaxStore, JobStore, LaneAllocator, fsck),
        (JobStore, JaxStore, JaxAllocator, jax_fsck),
    ):
        root = str(tmp_path / writer.__module__.split(".")[0])
        _submit_all(writer(root))
        mine, theirs = reader(root), writer(root)
        assert [j.to_dict() for j in mine.list()] == [j.to_dict() for j in theirs.list()]
        assert mine.queue_rows() == theirs.queue_rows() and mine.queue_log_lag() == 0
        jobs = mine.list()
        assert reader_alloc().pick(jobs).id == JaxAllocator().pick(theirs.list()).id
        report = reader_fsck.scan(mine)
        assert report["corrupt"] == 0 and report["stale_tmp"] == 0
        assert _masked_text(json.dumps(report, sort_keys=True)) == _masked_text(
            json.dumps(jax_fsck.scan(JaxStore(root)), sort_keys=True))

    # workers: each drains the other's submits (chaos-echo and a find)
    results = {}
    for name, store_cls, worker in (
        ("jax-port", JaxStore, lambda r: FleetWorker(r, worker_id="w", poll_s=0.01, driver=synthetic_driver)),
        ("port-jax", JobStore, lambda r: JaxWorker(r, worker_id="w", poll_s=0.01, driver=jax_synthetic)),
    ):
        root = str(tmp_path / name)
        st = store_cls(root)
        ids = [st.submit({"machine": m, "seeds": 48, "batch": 16}).id for m in ("chaos-echo", "chaos-find")]
        worker(root).run(drain=True)
        results[name] = [_masked_text(json.dumps(st.get(i).result, sort_keys=True), root) for i in ids]
    assert results["jax-port"] == results["port-jax"]
    assert '"stop_reason": "exhausted"' in results["jax-port"][0] and '"code": 7' in results["jax-port"][1]


def test_echo_job_matches_jax_worker_across_crash_and_resume(tmp_path, capsys):
    """tests/test_fleet.py:613-650 on the port's CPU worker, held to a
    JAX worker's uninterrupted run: two tenants of one engine shape, the
    worker stopped after one unit and a successor (same lease identity,
    fresh engine cache) draining the farm. The interrupted job's report
    is the JAX worker's byte for byte, the second tenant runs on the
    live engine ("cached"), and the per-job feeds stay apart."""
    root = str(tmp_path / "farm")
    st = JobStore(root)
    a, b = st.submit(dict(ECHO_SPEC)), st.submit(dict(ECHO_SPEC))
    FleetWorker(root, worker_id="w1", device="cpu").run(max_units=1)
    assert st.get(a.id).progress["batches_run"] == 1
    FleetWorker(root, worker_id="w1", device="cpu").run(drain=True)
    out = capsys.readouterr().out
    assert "resumed at batch 2/3" in out
    ja, jb = st.get(a.id), st.get(b.id)
    assert ja.state == EXHAUSTED and jb.state == EXHAUSTED
    assert jb.progress["engine"] == "cached"
    feed_a, feed_b = st.read_feed(a.id, 100), st.read_feed(b.id, 100)
    assert feed_a and feed_b and all(r["kind"].startswith("fleet_") for r in feed_a + feed_b)

    jax_root = str(tmp_path / "jax")
    jst = JaxStore(jax_root)
    c = jst.submit(dict(ECHO_SPEC))
    JaxWorker(jax_root, worker_id="w2", poll_s=0.01).run(drain=True)
    want = jst.get(c.id)
    assert json.dumps(ja.result, sort_keys=True) == json.dumps(want.result, sort_keys=True)
    assert json.dumps(jb.result, sort_keys=True) == json.dumps(want.result, sort_keys=True)
    # the checkpoints the two workers left are the same bytes too
    with open(st.ckpt_path(a.id)) as f, open(jst.ckpt_path(c.id)) as g:
        assert f.read() == g.read()


def test_mesh_job_runs_on_the_port_worker(tmp_path, capsys):
    """A lane-sharded job (spec `devices` 2, submitted through the JAX
    package) runs on the port's CPU worker, each unit over 2 ranks, to
    the result of the same job unsharded and of a JAX worker's run of
    it (on its 2-device mesh)."""
    results = {}
    for name, store, worker, devices in (("port-mesh", JaxStore, FleetWorker, 2), ("port", JobStore, FleetWorker, 0),
                                         ("jax-mesh", JaxStore, JaxWorker, 2)):
        root = str(tmp_path / name)
        job = store(root).submit({**ECHO_SPEC, "seeds": 64, "devices": devices})
        kw = {"device": "cpu"} if worker is FleetWorker else {}
        worker(root, worker_id="w1", poll_s=0.01, **kw).run(drain=True)
        done = JobStore(root).get(job.id)
        assert done.state == EXHAUSTED and done.attempt == 0 and not done.deaths, (name, done.error)
        results[name] = json.dumps(done.result, sort_keys=True)
        if devices:
            units = [e for e in JobStore(root).read_events(job.id) if e.get("type") == "batch_done"]
            assert units and all(e.get("device_count") == 2 for e in units), name
    assert results["port-mesh"] == results["port"] == results["jax-mesh"]
    assert "FAILED" not in capsys.readouterr().out


def test_torch_out_of_memory_takes_the_lane_backoff(tmp_path):
    """torch raises `torch.OutOfMemoryError` ("CUDA out of memory. Tried
    to allocate ..."): the worker halves the lanes (re-deriving the
    subkey and resetting the checkpoint) instead of burning a poison
    attempt, and the job completes at the smaller shape."""
    calls = []

    def oom_driver(worker, job, args):
        calls.append(job.spec["batch"])
        if job.spec["batch"] > 16:
            raise torch.OutOfMemoryError(
                "CUDA out of memory. Tried to allocate 2.00 GiB. GPU 0 has a total capacity of 79.19 GiB")
        synthetic_driver(worker, job, args)

    root = str(tmp_path)
    st = JobStore(root)
    job = st.submit({"machine": "chaos-echo", "seeds": 64, "batch": 32})
    FleetWorker(root, worker_id="w1", poll_s=0.01, backoff_base_s=0.0, driver=oom_driver).run(drain=True)
    done = st.get(job.id)
    assert done.state == EXHAUSTED and done.attempt == 0 and not done.deaths
    assert done.spec["batch"] == 16 and calls[0] == 32
    [deg] = done.degraded
    assert (deg["from_batch"], deg["to_batch"]) == (32, 16) and "OutOfMemoryError" in deg["error"]
    assert done.subkey != job.subkey and done.result["report"]["completed"] == 64


def test_stats_emitter_labels_match_jax(tmp_path):
    """The per-job gauges of the fleet /metrics: `StatsEmitter(base,
    labels={"job": ...})` writes the JAX package's .prom, .jsonl and
    .json bytes but the wall-clock stamp."""
    from madsim_tpu.tracing import StatsEmitter as JaxEmitter
    from madsim_tpu_torch.tracing import StatsEmitter

    rows = [
        {"kind": "fleet_batch", "batch": 1, "completed": 32, "coverage": {"slots_hit": 91, "new_slots": 7},
         "plateau": False, "machine": "raft"},
        {"kind": "fleet_summary", "completed": 96, "failing": 3, "seeds_per_sec": 812.5},
    ]
    labels = {"job": 'j0001-abc"\\', "tenant": "teamA"}
    files = {}
    for name, cls in (("jax", JaxEmitter), ("port", StatsEmitter)):
        base = str(tmp_path / name)
        em = cls(base, labels=labels)
        for row in rows:
            em.emit(row)
        em.close()
        files[name] = {ext: open(base + ext).read() for ext in (".prom", ".jsonl", ".json")}
    assert 'madsim_tpu_completed{job="j0001-abc\\"\\\\",tenant="teamA"} 96' in files["port"][".prom"]
    for ext in (".prom", ".jsonl", ".json"):
        assert _masked_text(files["port"][ext]) == _masked_text(files["jax"][ext]), ext
    # the stamp is the one difference
    assert files["port"][".prom"] != files["jax"][".prom"] and "<ts>" in _masked_text(files["port"][".prom"])


def _banned_strings(tree):
    """`importlib.import_module("madsim_tpu...")`, `__import__("jax")` and
    `[..., "-m", "madsim_tpu", ...]` spelled in a module's syntax tree."""
    banned = {"jax", "jaxlib", "flax", "madsim_tpu"}
    hits = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Call):
            fn = node.func
            name = fn.attr if isinstance(fn, ast.Attribute) else getattr(fn, "id", "")
            if name in ("import_module", "__import__") and node.args and isinstance(node.args[0], ast.Constant):
                if str(node.args[0].value).split(".")[0] in banned:
                    hits.append(node.args[0].value)
        if isinstance(node, (ast.List, ast.Tuple)):
            vals = [e.value if isinstance(e, ast.Constant) else None for e in node.elts]
            for x, y in zip(vals, vals[1:]):
                if x == "-m" and isinstance(y, str) and y.split(".")[0] in banned:
                    hits.append(f"-m {y}")
        if isinstance(node, ast.Constant) and isinstance(node.value, str):
            for m in re.finditer(r"python3? -m (madsim_tpu|jax)\b(?!_torch)( \w+)?", node.value):
                # the one permitted mention: the refusal naming the JAX
                # package's `serve` for the host services
                if m.group(2) != " serve":
                    hits.append(m.group(0))
    return hits


def test_port_names_only_itself():
    """Nothing in the port or chip_smoke.py reaches the JAX package: no
    import statement (tests/test_torch_engine.py holds those), no
    importlib string, no `-m madsim_tpu` subprocess and no `python -m
    madsim_tpu` repro line."""
    files = sorted((REPO / "madsim_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert any(p.name == "worker.py" for p in files)
    for path in files:
        assert not _banned_strings(ast.parse(path.read_text())), path
    # and the check bites on the reference's own worker and chaos harness
    for name in ("worker.py", "chaos.py"):
        assert _banned_strings(ast.parse((REPO / "madsim_tpu" / "fleet" / name).read_text())), name


@pytest.mark.parametrize("machine", ["chaos-echo", "chaos-find"])
def test_synthetic_farm_files_match_jax(tmp_path, machine):
    """The synthetic driver (the chaos harness's engine stand-in) leaves
    the JAX package's checkpoint, stats feed and result bytes."""
    out = {}
    for name, store_cls, worker_cls, driver in (("jax", JaxStore, JaxWorker, jax_synthetic),
                                                ("port", JobStore, FleetWorker, synthetic_driver)):
        root = str(tmp_path / name)
        st = store_cls(root)
        job = st.submit({"machine": machine, "seeds": 48, "batch": 16})
        worker_cls(root, worker_id="w", poll_s=0.01, driver=driver).run(drain=True)
        tree = _tree(root)
        out[name] = {rel: _masked_text(text, root) for rel, text in tree.items()
                     if rel.endswith((".ckpt.json", ".stats.jsonl", ".stats.prom"))}
        out[name]["result"] = _masked_text(json.dumps(st.get(job.id).result, sort_keys=True), root)
        assert st.get(job.id).state in (EXHAUSTED, FILED)
    assert out["port"] == out["jax"] and len(out["port"]) == 4
