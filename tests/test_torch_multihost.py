"""Multi-process seed batches on the port: the three cases of
tests/test_multihost.py (a global batch, a global stream, a service
machine with faults), each a job of two processes joined from the
MADSIM_TPU_* env (coordinator host:port, process count, process id)
over gloo on the CPU. Both processes print the same result, and it is
the JAX package's single-process run of the same seeds: the
`run_batch_global` summary against the JAX `run_batch`, the whole
`run_stream_global` dict against the JAX `run_stream`. Then `explore
--multihost` on the command line: process 0 alone prints the summary.
"""

import json
import os
import re
import socket
import subprocess
import sys
import textwrap

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

WORKER = textwrap.dedent(
    """
    import json, os, sys
    sys.path.insert(0, {repo!r})
    import torch
    torch.set_num_threads(1)
    from madsim_tpu_torch.parallel import multihost
    multihost.initialize(device="cpu")  # MADSIM_TPU_* env vars
    from madsim_tpu_torch.engine import Engine, EngineConfig, FaultPlan
    from madsim_tpu_torch.models.echo import EchoMachine

    section = os.environ["MADSIM_TPU_TEST_SECTION"]
    echo = dict(horizon_us=3_000_000, queue_capacity=16, faults=FaultPlan(n_faults=0))
    if section == "batch":
        eng = Engine(EchoMachine(rounds=4), EngineConfig(**echo), device="cpu")
        out = multihost.run_batch_global(eng, 32, seed_start=10, max_steps=400)
    elif section == "stream":
        eng = Engine(EchoMachine(rounds=4), EngineConfig(**echo), device="cpu")
        out = multihost.run_stream_global(
            eng, 64, batch=16, segment_steps=64, seed_start=100, max_steps=400,
            segments_per_dispatch=4, dispatch_depth=2,
        )
    elif section == "mvcc":
        from madsim_tpu_torch.models.etcd_mvcc import EtcdMvccMachine
        eng = Engine(
            EtcdMvccMachine(4, target_ops=3),
            EngineConfig(horizon_us=4_000_000, queue_capacity=48,
                         faults=FaultPlan(n_faults=1, t_max_us=1_000_000)),
            device="cpu",
        )
        out = multihost.run_batch_global(eng, 16, seed_start=0, max_steps=1500)
    else:
        raise SystemExit(f"unknown section {{section!r}}")
    print("RESULT " + json.dumps(out, sort_keys=True), flush=True)
    torch.distributed.destroy_process_group()
    """
).format(repo=REPO)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run_workers(section: str):
    """Spawn the 2-process job for `section`; return each process's
    parsed result. Asserts both exit 0."""
    port = _free_port()
    procs = []
    for pid in range(2):
        env = dict(os.environ, MADSIM_TPU_COORDINATOR=f"127.0.0.1:{port}", MADSIM_TPU_NUM_PROCS="2",
                   MADSIM_TPU_PROC_ID=str(pid), MADSIM_TPU_TEST_SECTION=section)
        procs.append(subprocess.Popen([sys.executable, "-c", WORKER], env=env, stdout=subprocess.PIPE,
                                      stderr=subprocess.PIPE, text=True))
    outputs = [p.communicate(timeout=240) for p in procs]
    results = []
    for p, (out, err) in zip(procs, outputs):
        assert p.returncode == 0, f"worker failed:\n{out}\n{err}"
        line = [ln for ln in out.splitlines() if ln.startswith("RESULT ")]
        assert line, f"no RESULT line:\n{out}\n{err}"
        results.append(json.loads(line[0][len("RESULT "):]))
    return results


def _jax_batch(machine, config, n, seed_start, max_steps):
    """The JAX package's single-process run of the same seeds, as the
    summary `run_batch_global` gives."""
    from madsim_tpu.engine import Engine

    res = Engine(machine, config).make_runner(max_steps)(np.arange(seed_start, seed_start + n, dtype=np.uint32))
    failed = np.asarray(res.failed)
    failing = [[int(s), int(c)] for s, c in zip(np.asarray(res.seeds)[failed], np.asarray(res.fail_code)[failed])]
    return {"completed": int(np.asarray(res.done).sum()), "failed": len(failing), "failing": failing,
            "truncated": False, "processes": 2, "global_devices": 2}


def _echo():
    from madsim_tpu.engine import EngineConfig, FaultPlan
    from madsim_tpu.models.echo import EchoMachine

    return EchoMachine(rounds=4), EngineConfig(horizon_us=3_000_000, queue_capacity=16, faults=FaultPlan(n_faults=0))


def test_two_process_global_batch():
    results = _run_workers("batch")
    assert results[0] == results[1] == _jax_batch(*_echo(), 32, 10, 400)
    assert results[0]["completed"] == 32 and results[0]["failed"] == 0


def test_two_process_streaming():
    from madsim_tpu.engine import Engine

    results = _run_workers("stream")
    want = Engine(*_echo()).run_stream(64, batch=16, segment_steps=64, seed_start=100, max_steps=400,
                                       segments_per_dispatch=4, dispatch_depth=2)
    assert results[0] == results[1] == json.loads(json.dumps(want))
    st = results[0]["stats"]
    assert results[0]["completed"] >= 64 and not results[0]["failing"]
    assert 0 < st["host_syncs"] <= st["device_segments"] + 2


def test_two_process_service_machine():
    from madsim_tpu.engine import EngineConfig, FaultPlan
    from madsim_tpu.models.etcd_mvcc import EtcdMvccMachine

    results = _run_workers("mvcc")
    cfg = EngineConfig(horizon_us=4_000_000, queue_capacity=48, faults=FaultPlan(n_faults=1, t_max_us=1_000_000))
    assert results[0] == results[1] == _jax_batch(EtcdMvccMachine(4, target_ops=3), cfg, 16, 0, 1500)
    assert results[0]["completed"] == 16


@pytest.mark.parametrize("bad", ["n_seeds", "batch"])
def test_global_shapes_refuse_a_batch_that_does_not_split(bad):
    """The reference's messages for a seed count or a stream batch that
    does not split over the job's devices."""
    import torch

    from madsim_tpu_torch.parallel import Mesh, multihost

    mesh = Mesh(group=None, rank=0, world=4, device=torch.device("cpu"), backend="gloo")
    with pytest.raises(ValueError, match="multiple of the global device count"):
        if bad == "n_seeds":
            multihost.global_seeds(30, mesh=mesh)
        else:
            multihost.run_stream_global(None, 64, batch=30, mesh=mesh)
    assert multihost.global_seeds(32, seed_start=7, mesh=Mesh(None, 2, 4, torch.device("cpu"), "gloo")).tolist() \
        == list(range(23, 31))


def _multihost(tmp_path, argv, nprocs=2):
    """Each process's (rc, stdout, stderr) of `argv` run as a job of
    `nprocs` processes joined from the MADSIM_TPU_* env (a file
    rendezvous in `tmp_path`)."""
    procs = []
    for pid in range(nprocs):
        env = dict(os.environ, PYTHONPATH=REPO, MADSIM_TPU_COORDINATOR=f"file://{tmp_path / 'rendezvous'}",
                   MADSIM_TPU_NUM_PROCS=str(nprocs), MADSIM_TPU_PROC_ID=str(pid))
        procs.append(subprocess.Popen([sys.executable, "-m", "madsim_tpu_torch", *argv], env=env,
                                      stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=REPO))
    outs = [p.communicate(timeout=300) for p in procs]
    return [(p.returncode, out, err) for p, (out, err) in zip(procs, outs)]


def test_explore_multihost_prints_from_process_0_only(tmp_path):
    """Process 0 prints the summary, with the unsharded explore's counts
    and the JAX package's failing seeds and codes; process 1 prints
    nothing, and both exit 1 (failures found)."""
    from madsim_tpu.__main__ import main as jax_main
    from madsim_tpu_torch.__main__ import main

    from torch_port_util import cli_text, run_cli

    argv = ["explore", "--machine", "demo-doublegrant-etcd", "--seeds", "30", "--horizon", "8.0", "--queue", "96",
            "--faults", "3", "--loss", "0.05", "--rng-stream", "3", "--max-steps", "200"]
    (rc0, out0, err0), (rc1, out1, err1) = _multihost(tmp_path, [*argv, "--multihost", "--device", "cpu"])
    assert rc0 == rc1 == 1 and out1 == "", err0[-2000:] + err1[-2000:]
    head, pairs = out0.splitlines()
    # 30 seeds pad to a multiple of the 2 ranks: 30
    _rc, want = run_cli(jax_main, argv)
    _rc, got = run_cli(main, [*argv, "--device", "cpu"])
    assert cli_text(got) == want
    explored, codes, seeds = want.splitlines()[:3]
    assert re.sub(r" over 2 processes / 2 devices", "", head) == explored
    # the first 20 (seed, code) pairs: the JAX package's first 20 seeds
    failing = eval(pairs[len("failing seeds: "):])
    n = int(head.split(", ")[-1].split()[0])
    assert len(failing) == min(n, 20)
    assert f"failing seeds: {[s for s, _c in failing]}{' ...' if n > 20 else ''}" == seeds
    assert set(eval(codes[len("failure codes: "):])) >= {c for _s, c in failing}


def test_initialize_needs_the_job(monkeypatch):
    """Without a coordinator, a process count and a process id (passed
    or from the MADSIM_TPU_* env) there is no job to join."""
    import torch.distributed as dist

    from madsim_tpu_torch.parallel import multihost

    for var in ("MADSIM_TPU_COORDINATOR", "MADSIM_TPU_NUM_PROCS", "MADSIM_TPU_PROC_ID"):
        monkeypatch.delenv(var, raising=False)
    assert not dist.is_initialized()
    with pytest.raises(ValueError, match="MADSIM_TPU_COORDINATOR, MADSIM_TPU_NUM_PROCS and MADSIM_TPU_PROC_ID"):
        multihost.initialize(num_processes=1, process_id=0, device="cpu")
    assert not dist.is_initialized()


def test_a_cpu_job_meshes_on_the_cpu_beside_a_card(monkeypatch, tmp_path):
    """`initialize(device="cpu")` on a machine with a card runs the job
    over gloo on the CPU, and the job's mesh says so."""
    import torch
    import torch.distributed as dist

    from madsim_tpu_torch.parallel import multihost

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(multihost, "_devices", None)
    multihost.initialize(f"file://{tmp_path / 'rendezvous'}", 1, 0, device="cpu")
    try:
        mesh = multihost.global_mesh()
        assert mesh.device == torch.device("cpu") and mesh.backend == "gloo" and mesh.size == 1
    finally:
        dist.destroy_process_group()
