"""Jobs that move between the JAX package's fleet worker and the port's
worker on the CPU. A job started by one package's worker and finished by
the other's gives the uninterrupted oracle's result, for an unguided
hunt with finds and for a guided one (the job of
tests/test_search.py:465-510), in both directions.

Tolerance: byte equality of the result documents (the store root in
the corpus path masked) and of the checkpoints.
"""

import json
import os
import time

import torch

from madsim_tpu.fleet.store import JobStore as JaxStore
from madsim_tpu.fleet.worker import FleetWorker as JaxWorker
from madsim_tpu_torch.fleet.store import EXHAUSTED, FILED, JobStore
from madsim_tpu_torch.fleet.worker import FleetWorker

torch.set_num_threads(1)

# the volatile-commit hunt at CPU size, shrink off: 24 of 64 seeds fail
# 102, with coverage and provenance words in the checkpoint
UNGUIDED = {"machine": "demo-volatilecommit-raft", "strict_restart": True, "seeds": 64, "batch": 32,
            "horizon": 1.0, "max_steps": 600, "queue": 64, "faults": 2, "fault_tmax": 600_000,
            "coverage": True, "provenance": True, "shrink_limit": 0}
# tests/test_search.py:470-475
GUIDED = {"machine": "raft", "nodes": 3, "seeds": 96, "batch": 32, "horizon": 1.0, "max_steps": 600,
          "queue": 64, "faults": 2, "fault_tmax": 600_000, "fault_kinds": "pair,kill",
          "coverage": True, "provenance": True, "guided": True}


def _worker(package, root, worker_id, **kw):
    if package == "jax":
        return JaxWorker(root, worker_id=worker_id, poll_s=0.01, **kw)
    return FleetWorker(root, worker_id=worker_id, poll_s=0.01, device="cpu", **kw)


def _handover(tmp_path, spec, first, units):
    """`first`'s worker runs `units` units and dies with its lease held;
    the other package's worker reclaims the job once the lease expires
    and finishes it. Returns the job document."""
    root = str(tmp_path / f"farm-{first}")
    store = (JaxStore if first == "jax" else JobStore)(root)
    job = store.submit(dict(spec))
    _worker(first, root, "wA", lease_ttl_s=2.0).run(max_units=units)
    assert store.get(job.id).progress["batches_run"] == units
    time.sleep(2.2)  # wA's lease expires
    second = "port" if first == "jax" else "jax"
    _worker(second, root, "wB", backoff_base_s=0.0).run(drain=True)
    done = store.get(job.id)
    assert done.n_lease_reclaims >= 1 and done.history[-1][1] in (EXHAUSTED, FILED)
    assert {e["worker"] for e in store.read_events(job.id) if e.get("type") == "batch_done"} == {"wA", "wB"}
    return done, store.ckpt_path(job.id)


def _oracle(tmp_path, spec):
    root = str(tmp_path / "oracle")
    store = JaxStore(root)
    job = store.submit(dict(spec))
    _worker("jax", root, "wO").run(drain=True)
    return store.get(job.id), store.ckpt_path(job.id)


def _result(job):
    """The result document with its store root masked (the corpus path
    names the farm's directory)."""
    return json.dumps({**job.result, "corpus": os.path.basename(job.result.get("corpus") or "")}, sort_keys=True)


def _same(done, oracle):
    (got, got_ck), (want, want_ck) = done, oracle
    assert _result(got) == _result(want)
    with open(got_ck) as f, open(want_ck) as g:
        assert f.read() == g.read()


def test_unguided_hunt_moves_between_packages(tmp_path):
    oracle = _oracle(tmp_path, UNGUIDED)
    report = oracle[0].result["report"]
    assert len(report["failing"]) == 24 and {c for _s, c in report["failing"]} == {102}
    assert report["coverage_slots"] > 0
    _same(_handover(tmp_path, UNGUIDED, "jax", 1), oracle)
    _same(_handover(tmp_path, UNGUIDED, "port", 1), oracle)


def test_guided_hunt_moves_between_packages(tmp_path):
    oracle = _oracle(tmp_path, GUIDED)
    assert oracle[0].result["report"]["guided"]["trail"], "guided trail must ride the result"
    _same(_handover(tmp_path, GUIDED, "jax", 2), oracle)
    _same(_handover(tmp_path, GUIDED, "port", 1), oracle)
