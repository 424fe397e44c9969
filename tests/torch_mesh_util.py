"""Rank processes for the port's mesh tests, and the fixture they share.

`start_ranks` launches `world` processes (this file run as a script)
that join one gloo job on the CPU through a file in the test's
tmp_path, so that parallel test workers cannot collide. Each process
makes the subgroups of every round (all processes make every group, in
one order, as torch.distributed requires), then, round by round, runs
each case on the mesh of the group it belongs to and pickles the
result: a stream case's `run_stream` dict, a runner case's
`make_runner(mesh)` BatchResult as numpy. The rank processes import
the port only, never JAX.

`meshed_runs` runs the fixture of tests/test_mesh.py:27-53 (a 3-node
Raft with buffered coverage, the flight recorder and provenance on) on
one such job, every cell of `CELLS` and the runner case, and, while it
runs, the JAX package's unsharded and meshed references of the same
calls."""

from __future__ import annotations

import os
import pickle
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: the mesh sizes of tests/test_mesh.py, in two rounds over 8 processes:
#: 1, 2 and 4 ranks side by side, then all 8
ROUNDS = [[(0,), (1, 2), (3, 4, 5, 6)], [tuple(range(8))]]
COUNTS = (1, 2, 4, 8)

CONFIG = dict(horizon_us=2_000_000, queue_capacity=64, coverage=True, flight_recorder=True, provenance=True)
FAULTS = dict(n_faults=1, t_max_us=1_000_000)
STREAM_KW = dict(batch=16, segment_steps=48, seed_start=100, max_steps=400, segments_per_dispatch=4,
                 dispatch_depth=2)
EXECUTORS = {"pipelined": True, "segment": False}
#: the stream cells: both executors on both RNG streams
CELLS = {f"{ex}_v{rng}": (rng, ex) for rng in (3, 2) for ex in EXECUTORS}
# the fixture's seeds 100..163 that finish first (77-80 events) and last
# (167-284 events), in that order: at every rank count the first rank's
# lanes all freeze before the last rank's
RUNNER_SEEDS = [163, 114, 115, 112, 119, 128, 154, 160, 109, 144, 126, 135, 111, 106, 118, 145]
RUNNER_STEPS = 400


def engines(rng_stream):
    """(JAX engine, port engine on the CPU) of the tests/test_mesh.py fixture."""
    from madsim_tpu.engine import Engine as JaxEngine
    from madsim_tpu.engine import EngineConfig as JaxConfig
    from madsim_tpu.engine import FaultPlan as JaxFaultPlan
    from madsim_tpu.models.raft import RaftMachine as JaxRaft
    from madsim_tpu_torch.engine import Engine, EngineConfig, FaultPlan
    from madsim_tpu_torch.models.raft import RaftMachine

    return (
        JaxEngine(JaxRaft(num_nodes=3, log_capacity=4),
                  JaxConfig(faults=JaxFaultPlan(**FAULTS), rng_stream=rng_stream, **CONFIG)),
        Engine(RaftMachine(num_nodes=3, log_capacity=4),
               EngineConfig(faults=FaultPlan(**FAULTS), rng_stream=rng_stream, **CONFIG), device="cpu"),
    )


def meshed_runs(tmp):
    """Start the port's rank job on the fixture's stream (every cell of
    CELLS) and on its `make_runner` of RUNNER_SEEDS (the counter-based
    stream); run the JAX package's references of the same calls while
    it runs. Returns (JAX results keyed by (case, k), k = 0 unsharded;
    port results keyed by (case, k), one per rank)."""
    import jax
    import numpy as np

    from madsim_tpu.parallel import make_mesh
    from torch_port_util import jax_to_numpy

    pairs = {rng: engines(rng) for rng in (3, 2)}
    cases = {cell: (pairs[rng][1].machine, pairs[rng][1].config, "stream",
                    dict(n_seeds=32, pipelined=EXECUTORS[ex], **STREAM_KW))
             for cell, (rng, ex) in CELLS.items()}
    port = pairs[3][1]
    cases["runner"] = (port.machine, port.config, "runner", dict(seeds=RUNNER_SEEDS, max_steps=RUNNER_STEPS))
    ranks = start_ranks(tmp, cases)
    want = {}
    devs = jax.devices()
    for k in (0,) + COUNTS:
        mesh = make_mesh(devs[:k]) if k else None
        for cell, (rng, ex) in CELLS.items():
            want[cell, k] = pairs[rng][0].run_stream(32, mesh=mesh, pipelined=EXECUTORS[ex], **STREAM_KW)
        seeds = np.asarray(RUNNER_SEEDS, dtype=np.uint32)
        want["runner", k] = jax_to_numpy(pairs[3][0].make_runner(RUNNER_STEPS, mesh=mesh)(seeds))
    return want, ranks.results()


def assert_stream_equal(want, got, cell):
    """Every rank's dict at every count equals the JAX package's
    unsharded and meshed runs of the stream, its coverage map too."""
    import numpy as np

    golden = dict(want[cell, 0])
    gmap = golden.pop("coverage_map")
    for k in COUNTS:
        ref = dict(want[cell, k])
        assert np.array_equal(ref.pop("coverage_map"), gmap) and ref == golden, f"JAX mesh of {k} diverged"
        per_rank = got[cell, k]
        assert len(per_rank) == k
        for r, out in enumerate(per_rank):
            out = dict(out)
            assert np.array_equal(out.pop("coverage_map"), gmap), f"coverage map diverged at {k} ranks (rank {r})"
            assert out == golden, f"stream results diverged at {k} ranks (rank {r})"
    assert golden["completed"] >= 32 and golden["stats"]["device_segments"] > 1


class Ranks:
    """A running job of rank processes; `results()` waits for it."""

    def __init__(self, tmp, procs):
        self.tmp, self.procs = tmp, procs

    def results(self, timeout: float = 600):
        """{(case, k): [result of rank 0, rank 1, ...]} for every case
        and group size; asserts that every process exited 0."""
        outs = [p.communicate(timeout=timeout) for p in self.procs]
        for p, (_out, err) in zip(self.procs, outs):
            assert p.returncode == 0, f"rank process failed:\n{err[-4000:]}"
        got = {}
        for name in sorted(os.listdir(self.tmp)):
            if name.startswith("out.") and name.endswith(".pkl"):
                _, case, k, r, _ = name.split(".")
                got.setdefault((case, int(k)), {})[int(r)] = pickle.load(open(os.path.join(self.tmp, name), "rb"))
        return {key: [v[r] for r in sorted(v)] for key, v in got.items()}


def start_ranks(tmp, cases, rounds=ROUNDS) -> Ranks:
    """Start the job: `cases` maps a name to (machine, config, kind,
    kwargs), kind "stream" (`run_stream(**kwargs, mesh=...)`) or
    "runner" (`make_runner(max_steps)(seeds)`)."""
    tmp = str(tmp)
    world = max(r for rnd in rounds for grp in rnd for r in grp) + 1
    with open(os.path.join(tmp, "cases.pkl"), "wb") as f:
        pickle.dump((cases, rounds), f)
    env = dict(os.environ, PYTHONPATH=REPO)
    procs = [
        subprocess.Popen([sys.executable, os.path.abspath(__file__), tmp, str(r), str(world)],
                         env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(world)
    ]
    return Ranks(tmp, procs)


def _main(tmp: str, rank: int, world: int) -> None:
    import torch
    import torch.distributed as dist

    from madsim_tpu_torch.engine import Engine
    from madsim_tpu_torch.interop import tree_to_numpy
    from madsim_tpu_torch.parallel import make_mesh

    torch.set_num_threads(1)
    # eight processes of one job: below the test workers beside them, so
    # their timing-sensitive tests keep the CPU
    os.nice(10)
    cases, rounds = pickle.load(open(os.path.join(tmp, "cases.pkl"), "rb"))
    dist.init_process_group("gloo", init_method=f"file://{os.path.join(tmp, 'rendezvous')}", rank=rank,
                            world_size=world)
    groups = [[(grp, dist.new_group(list(grp)) if len(grp) < world else None) for grp in rnd] for rnd in rounds]
    engines = {}
    for rnd in groups:
        for grp, group in rnd:
            if rank not in grp:
                continue
            mesh = make_mesh(group=group)
            for name, (machine, config, kind, kwargs) in cases.items():
                eng = engines.setdefault(name, Engine(machine, config, device="cpu"))
                if kind == "stream":
                    out = eng.run_stream(mesh=mesh, **kwargs)
                else:
                    out = tree_to_numpy(eng.make_runner(kwargs["max_steps"], mesh=mesh)(kwargs["seeds"]))
                with open(os.path.join(tmp, f"out.{name}.{len(grp)}.{mesh.rank}.pkl"), "wb") as f:
                    pickle.dump(out, f)
    dist.destroy_process_group()


if __name__ == "__main__":
    sys.path.insert(0, REPO)
    _main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]))
