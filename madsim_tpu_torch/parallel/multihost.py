"""Multi-process seed-batch scale-out over torch.distributed.

The port of `madsim_tpu/parallel/multihost.py`: every process joins one
job, the seed-lane axis shards over the job's ranks (one rank per
process, one process per device), and the engine's meshed stream runs
on every rank, each over its own lanes, with the registered collectives
(`parallel/__init__.py`) the only cross-process traffic.

Smoke-tested without a cluster by running N processes on one machine
over gloo on the CPU (tests/test_torch_multihost.py), and by two
processes sharing one card.

Env-driven setup (the reference's contract):
  MADSIM_TPU_COORDINATOR  host:port of process 0 (or a torch init URL,
                          `tcp://...` or `file://...`)
  MADSIM_TPU_NUM_PROCS    total process count
  MADSIM_TPU_PROC_ID      this process's id
The backend is NCCL when the job runs on cards and this machine has a
card for every process, else gloo (processes that share a card, or run
on the CPU). A collective that waits longer than `TIMEOUT` for the
other ranks fails the job.
"""

from __future__ import annotations

import os
from datetime import timedelta
from typing import Optional

import torch

from . import all_sum, gather_masked, make_mesh

_ENV_COORD = "MADSIM_TPU_COORDINATOR"
_ENV_NPROCS = "MADSIM_TPU_NUM_PROCS"
_ENV_PID = "MADSIM_TPU_PROC_ID"

#: how long a collective waits for the other ranks before the job fails:
#: long enough for a rank that builds the CUDA kernels at its first call
TIMEOUT = timedelta(minutes=30)

# each rank's device, as `initialize` chose it (None before it ran)
_devices: Optional[list] = None


def default_backend(world: int, cpu: bool) -> str:
    """NCCL when every rank can have a card of its own on this machine;
    gloo when ranks share a card or run on the CPU (NCCL refuses two
    ranks on one card)."""
    if not cpu and torch.cuda.is_available() and torch.cuda.device_count() >= world:
        return "nccl"
    return "gloo"


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    device: Optional[str] = None,
) -> None:
    """Join (or start) the distributed job. Idempotent. Arguments fall
    back to the MADSIM_TPU_* env vars. With `device="cpu"` the ranks run
    on the CPU over gloo; otherwise rank r takes card `r %
    device_count` when the machine has a card, else the CPU."""
    global _devices
    import torch.distributed as dist

    if dist.is_initialized():
        return
    coordinator_address = coordinator_address or os.environ.get(_ENV_COORD)
    if num_processes is None and os.environ.get(_ENV_NPROCS):
        num_processes = int(os.environ[_ENV_NPROCS])
    if process_id is None and os.environ.get(_ENV_PID):
        process_id = int(os.environ[_ENV_PID])
    if coordinator_address is None or num_processes is None or process_id is None:
        raise ValueError(f"multihost.initialize needs the job's coordinator address, process count and process "
                         f"id: pass them, or set {_ENV_COORD}, {_ENV_NPROCS} and {_ENV_PID}")
    init_method = coordinator_address if "://" in coordinator_address else f"tcp://{coordinator_address}"
    cpu = device == "cpu" or not torch.cuda.is_available()
    backend = default_backend(num_processes, cpu)
    if cpu:
        devices = ["cpu"] * num_processes
    else:
        devices = [f"cuda:{r % torch.cuda.device_count()}" for r in range(num_processes)]
        torch.cuda.set_device(torch.device(devices[process_id]))
    dist.init_process_group(backend, init_method=init_method, world_size=num_processes, rank=process_id,
                            timeout=TIMEOUT)
    _devices = devices


def process_index() -> int:
    import torch.distributed as dist

    return dist.get_rank() if dist.is_initialized() else 0


def global_mesh():
    """The 1-D "batch" (lane-axis) mesh over every rank of the job, each
    rank on the device `initialize` gave it."""
    return make_mesh(_devices)


def global_seeds(n_seeds: int, seed_start: int = 0, mesh=None) -> torch.Tensor:
    """This rank's slice of the uint32 seeds [seed_start, seed_start+n),
    as int64 values (the port's seed tensors)."""
    mesh = mesh if mesh is not None else global_mesh()
    axis = mesh.size
    if n_seeds % axis != 0:
        raise ValueError(f"n_seeds ({n_seeds}) must be a multiple of the global device count ({axis})")
    per = n_seeds // axis
    first = seed_start + mesh.rank * per
    return torch.arange(first, first + per, dtype=torch.int64) & 0xFFFFFFFF


def run_stream_global(
    engine,
    n_seeds: int,
    batch: int = 1024,
    segment_steps: int = 256,
    seed_start: int = 0,
    max_steps: int = 10_000,
    mesh=None,
    **stream_kwargs,
) -> dict:
    """Seed streaming sharded over the whole job: every process runs the
    same meshed executor over its lanes (the `run_stream` knobs pass
    through), and the host loops stay in lockstep because every decision
    reads global leaves. Returns run_stream's dict, the same on every
    process."""
    mesh = mesh if mesh is not None else global_mesh()
    axis = mesh.size
    if batch % axis != 0:
        raise ValueError(f"batch ({batch}) must be a multiple of the global device count ({axis})")
    return engine.run_stream(
        n_seeds,
        batch=batch,
        segment_steps=segment_steps,
        seed_start=seed_start,
        max_steps=max_steps,
        mesh=mesh,
        **stream_kwargs,
    )


def run_batch_global(
    engine,
    n_seeds: int,
    seed_start: int = 0,
    max_steps: int = 10_000,
    fail_capacity: int = 1024,
    mesh=None,
) -> dict:
    """Run a globally sharded seed batch on every process and return the
    same summary on each: the completion and failure counts and up to
    `fail_capacity` failing (seed, code) pairs in seed order. The
    completion count is a sum over ranks, the failing lanes a gather of
    the failing lanes only (`multihost-*` collectives)."""
    from ..ops import u32

    mesh = mesh if mesh is not None else global_mesh()
    seeds = global_seeds(n_seeds, seed_start, mesh)
    res = engine.run_batch(seeds, max_steps=max_steps, mesh=mesh)
    # madsim: collective(multihost-completed-sum, reduce=sum)
    completed = all_sum(mesh, res.done.sum(dtype=torch.int64), "multihost-completed-sum")
    pairs = torch.stack([u32.from_i32(res.seeds), res.fail_code.to(torch.int64)], dim=1)
    found, n_fail = gather_masked(mesh, res.failed, pairs, ranks="multihost-fail-ranks", name="multihost-fail-ring")
    n_fail = int(n_fail)
    listed = min(n_fail, fail_capacity)
    return {
        "completed": int(completed),
        "failed": n_fail,
        "failing": [(int(s), int(c)) for s, c in found[:listed].tolist()],
        "truncated": n_fail > fail_capacity,
        "processes": mesh.size,
        "global_devices": mesh.size,
    }
