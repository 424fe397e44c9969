"""Shared helpers of the tests that hold the PyTorch port
(`madsim_tpu_torch`) against the JAX package: the flagship config built
for both, and leaf-for-leaf comparison of their state trees."""

from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import re
import types

import numpy as np
import torch

import madsim_tpu.ops.step_rng  # noqa: F401  (pins the partitionable Threefry lowering)
from madsim_tpu.engine import Engine as JaxEngine
from madsim_tpu.engine import EngineConfig as JaxConfig
from madsim_tpu.engine import FaultPlan as JaxFaultPlan
from madsim_tpu_torch.engine import Engine, EngineConfig, FaultPlan
from madsim_tpu_torch.interop import tree_to_numpy

# The port's tests run small tensors that gain nothing from intra-op
# threads; one thread keeps each test worker from crowding the others.
torch.set_num_threads(1)

# The flagship hunt (bench.py): MadRaft-5, 32 queue slots, 5 s horizon,
# two pair-clog / kill faults, v3 stream, recorder and coverage on.
FLAGSHIP = dict(
    horizon_us=5_000_000, queue_capacity=32, rng_stream=3, clog_packed=True,
    flight_recorder=True, coverage=True, provenance=False,
)
FLAGSHIP_FAULTS = dict(n_faults=2, t_max_us=3_000_000, dur_min_us=200_000, dur_max_us=800_000)


def engines(jax_machine, torch_machine, **overrides):
    """(JAX engine, port engine on the CPU) for the flagship config."""
    kw = {**FLAGSHIP, **overrides}
    faults = kw.pop("faults", FLAGSHIP_FAULTS)
    return (
        JaxEngine(jax_machine, JaxConfig(faults=JaxFaultPlan(**faults), **kw)),
        Engine(torch_machine, EngineConfig(faults=FaultPlan(**faults), **kw), device="cpu"),
    )


def jax_to_numpy(tree):
    """A JAX-side tree (flax dataclasses, dicts, arrays) -> nested dicts
    of numpy arrays, the shape `madsim_tpu_torch.interop.tree_to_numpy`
    gives for the port."""
    if dataclasses.is_dataclass(tree):
        return {f.name: jax_to_numpy(getattr(tree, f.name)) for f in dataclasses.fields(tree)}
    if isinstance(tree, dict):
        return {k: jax_to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(jax_to_numpy(v) for v in tree)
    return np.asarray(tree)


def tree_diff(a, b, path=""):
    """Paths where two numpy trees differ in keys, dtype, shape or value."""
    if isinstance(a, tuple) or isinstance(b, tuple):
        if not (isinstance(a, tuple) and isinstance(b, tuple)) or len(a) != len(b):
            return [f"{path}: tuple vs non-tuple or lengths differ"]
        return [d for i, (x, y) in enumerate(zip(a, b)) for d in tree_diff(x, y, f"{path}[{i}]")]
    if isinstance(a, dict) or isinstance(b, dict):
        if not (isinstance(a, dict) and isinstance(b, dict)) or set(a) != set(b):
            return [f"{path}: keys {sorted(a) if isinstance(a, dict) else a!r} vs "
                    f"{sorted(b) if isinstance(b, dict) else b!r}"]
        return [d for k in a for d in tree_diff(a[k], b[k], f"{path}.{k}")]
    a, b = np.asarray(a), np.asarray(b)
    if a.dtype != b.dtype or a.shape != b.shape or not np.array_equal(a, b):
        return [f"{path}: {a.dtype}{a.shape} vs {b.dtype}{b.shape}"]
    return []


def same(want, got, what=""):
    """Assert a JAX-side tree equals a port tree leaf for leaf."""
    diff = tree_diff(jax_to_numpy(want), tree_to_numpy(got))
    assert not diff, (what, diff[:5])


def jax_snapshots(jax_eng, seeds, snap_steps):
    """(node state, now_us) of a JAX batch run at each of `snap_steps`."""
    import jax
    import jax.numpy as jnp

    step = jax.jit(jax_eng.step_batch)
    state = jax.jit(jax_eng.init_batch)(jnp.asarray(seeds, dtype=jnp.uint32))
    snaps = []
    for k in range(max(snap_steps) + 1):
        if k in snap_steps:
            snaps.append((jax.tree.map(np.asarray, state.nodes), np.asarray(state.now_us)))
        state = step(state)
    return snaps


def torch_nodes(state_type, np_nodes):
    """A JAX node state of numpy leaves as the port's `state_type`."""
    return state_type(**{
        f.name: torch.from_numpy(np.asarray(getattr(np_nodes, f.name)).copy())
        for f in dataclasses.fields(state_type)
    })


def check_handlers(jax_m, port_m, snapshots, inputs, reps=3):
    """The port's `on_timer` and `on_message` against the reference's,
    vmapped, on every snapshot: `inputs(seed, np_nodes, now)` gives
    (node, timer_id, now, rand [L, H] uint32, src, payload) numpy arrays."""
    import jax

    on_timer = jax.jit(jax.vmap(jax_m.on_timer))
    on_message = jax.jit(jax.vmap(jax_m.on_message))
    t = torch.from_numpy
    for k, (np_nodes, now) in enumerate(snapshots):
        for rep in range(reps):
            node, tid, t_now, rand, src, payload = inputs(10 * k + rep, np_nodes, now)
            t_nodes, t_rand = torch_nodes(port_m.state_type, np_nodes), t(rand.astype(np.int64))
            same(on_timer(np_nodes, node, tid, t_now, rand),
                 port_m.on_timer(t_nodes, t(node), t(tid), t(t_now), t_rand), ("on_timer", k, rep))
            same(on_message(np_nodes, node, src, payload, t_now, rand),
                 port_m.on_message(t_nodes, t(node), t(src), t(payload), t(t_now), t_rand), ("on_message", k, rep))


def check_hooks(jax_m, port_m, states, now, seed=0):
    """`invariant`, `is_done`, `summary` and `restart_node_if` of the port
    against the reference's, vmapped, on each node state of `states`."""
    import jax

    invariant = jax.jit(jax.vmap(jax_m.invariant))
    is_done = jax.jit(jax.vmap(jax_m.is_done))
    summary = jax.jit(jax.vmap(jax_m.summary))
    restart = jax.jit(jax.vmap(jax_m.restart_node_if))
    g = np.random.default_rng(seed)
    t_now = torch.from_numpy(now.copy())
    for k, s in enumerate(states):
        t_nodes = torch_nodes(port_m.state_type, s)
        same(invariant(s, now), port_m.invariant(t_nodes, t_now), ("invariant", k))
        same(is_done(s, now), port_m.is_done(t_nodes, t_now), ("is_done", k))
        same(summary(s), port_m.summary(t_nodes), ("summary", k))
        lanes = len(now)
        node = g.integers(0, port_m.NUM_NODES, lanes).astype(np.int32)
        cond = g.random(lanes) < 0.5
        keys = g.integers(0, 2**32, (lanes, 2), dtype=np.uint32)
        same(restart(s, node, cond, keys),
             port_m.restart_node_if(t_nodes, torch.from_numpy(node), torch.from_numpy(cond),
                                    torch.from_numpy(keys.astype(np.int64))), ("restart", k))


def check_projection(jax_m, port_m, states, now):
    """The port's `coverage_projection` against the reference's, vmapped,
    on each node state of `states`."""
    import jax

    proj = jax.jit(jax.vmap(jax_m.coverage_projection))
    t_now = torch.from_numpy(now.copy())
    for k, s in enumerate(states):
        got = port_m.coverage_projection(torch_nodes(port_m.state_type, s), t_now)
        assert np.array_equal(got.numpy(), np.asarray(proj(s, now))), k


# -- the command line ---------------------------------------------------------

_WALL = re.compile(r" in \d+\.\ds \(\d+ seeds/s\)")


def cli_text(out: str) -> str:
    """A command line's stdout with its wall-clock figures masked and the
    program name as the JAX package's, so the two packages' outputs
    compare as text."""
    return _WALL.sub(" in <wall>", out.replace("madsim_tpu_torch", "madsim_tpu"))


def run_cli(main, argv):
    """(exit code, stdout) of one command line run in this process."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = main(list(argv))
    return rc, out.getvalue()


def run_pair(jax_argv, port_argv=None, port_extra=("--device", "cpu")):
    """Run the JAX package's command line on `jax_argv` and the port's on
    `port_argv` (the same by default) plus `port_extra` (the CPU):
    ((rc, text), (rc, text)), the texts as `cli_text` gives them."""
    from madsim_tpu.__main__ import main as jax_main
    from madsim_tpu_torch.__main__ import main as port_main

    want = run_cli(jax_main, jax_argv)
    got = run_cli(port_main, list(jax_argv if port_argv is None else port_argv) + list(port_extra))
    return (want[0], cli_text(want[1])), (got[0], cli_text(got[1]))


# -- guided search --------------------------------------------------------------


def guided_args(**over):
    """The arguments of the guided hunt of tests/test_search.py:247-256
    (a 3-node Raft, 96 seeds in batches of 32, 600 steps), overridden by
    `over`."""
    d = dict(machine="raft", nodes=3, seed=0, seeds=96, batch=32,
             max_steps=600, horizon=1.0, loss=0.0, faults=2,
             fault_tmax=600_000, fault_kinds="pair,kill", rng_stream=2,
             strict_restart=False, coverage=True, provenance=True,
             stop_on_plateau=0, stats=None, stream=True, guided=True,
             checkpoint=None, stop_after_batches=0)
    d.update(over)
    return types.SimpleNamespace(**d)


def trail_key(agg):
    """Everything the reproducibility contract pins, JSON-canonical."""
    return json.dumps({
        "completed": agg["completed"],
        "failing": sorted(map(list, agg["failing"])),
        "abandoned": sorted(agg["abandoned"]),
        "provenance": {str(k): v for k, v in agg["provenance"].items()},
        "guided": agg["guided"],
        "slots": agg["stats"].get("coverage", {}).get("slots_hit"),
    }, sort_keys=True)


def guided_engines():
    """(JAX engine, port engine on the CPU) of tests/test_search.py:233-244:
    a 3-node Raft with coverage and provenance on, the 4-bit band layout."""
    from madsim_tpu.models.raft import RaftMachine as JaxRaft
    from madsim_tpu_torch.models.raft import RaftMachine

    cfg = dict(horizon_us=1_000_000, queue_capacity=64, coverage=True, provenance=True, cov_slots_log2=10,
               cov_band_bits_min=4)
    faults = dict(n_faults=2, t_max_us=600_000)
    return (
        JaxEngine(JaxRaft(num_nodes=3, log_capacity=8), JaxConfig(faults=JaxFaultPlan(**faults), **cfg)),
        Engine(RaftMachine(num_nodes=3, log_capacity=8), EngineConfig(faults=FaultPlan(**faults), **cfg),
               device="cpu"),
    )


# -- the cross-engine differential ---------------------------------------------


def differential_engines(jax_machine, machine, faults, horizon_us=5_000_000, **cfg):
    """(JAX engine, port engine on the CPU) of the differential's config
    (tests/test_differential.py:21-28: queue 96, the v2 stream)."""
    return (
        JaxEngine(jax_machine, JaxConfig(horizon_us=horizon_us, queue_capacity=96, faults=JaxFaultPlan(**faults),
                                         **cfg)),
        Engine(machine, EngineConfig(horizon_us=horizon_us, queue_capacity=96, faults=FaultPlan(**faults), **cfg),
               device="cpu"),
    )


def raft_differential(engines, seeds, **kw):
    """The port's `differential_raft` report on `seeds`, with the JAX
    package's host Raft as `host_run`, held equal to the report of the
    JAX package's `differential_raft`."""
    from madsim_tpu.differential import differential_raft as jax_differential_raft
    from madsim_tpu.differential import run_host_raft
    from madsim_tpu_torch.differential import differential_raft

    jax_eng, eng = engines
    got = differential_raft(eng, seeds, run_host_raft, **kw)
    assert got == jax_differential_raft(jax_eng, seeds, **kw)
    return got


def raft_differential_own_host(engines, seeds, host_node_cls=None, jax_host_node_cls=None, **kw):
    """The port's `differential_raft` report on `seeds` with its own host
    Raft (the default `host_run`, examples/raft_host_torch.py on the
    port's runtime), held equal to the report of the JAX package's
    `differential_raft`; `host_node_cls` and `jax_host_node_cls` are the
    two packages' host node classes (None: each example's `RaftNode`)."""
    from madsim_tpu.differential import differential_raft as jax_differential_raft
    from madsim_tpu_torch.differential import differential_raft

    jax_eng, eng = engines
    got = differential_raft(eng, seeds, host_node_cls=host_node_cls, **kw)
    assert got == jax_differential_raft(jax_eng, seeds, host_node_cls=jax_host_node_cls, **kw)
    return got


def corpus_without_env(path):
    """A corpus file's entries with the `meta` fields that name the
    package and its framework (the port's torch and CUDA, the reference's
    JAX) taken out; everything else as written."""
    doc = json.load(open(path))
    for entry in doc["entries"]:
        for key in ("madsim_tpu", "madsim_tpu_torch", "jax", "jaxlib", "torch", "cuda"):
            entry.get("meta", {}).pop(key, None)
    return doc


# -- the perf tooling ----------------------------------------------------------

_PERF_MASKS = (
    # the host timeline epilogue: its span count stays, the share of the
    # wall it covers, the wall and the file's path are times and paths
    (re.compile(r"(host timeline: \d+ spans, )\d+% of [0-9.]+s wall attributed -> \S+"),
     r"\1<pct> of <wall> wall attributed -> <path>"),
    (re.compile(r"(host timeline: \d+ spans) -> \S+"), r"\1 -> <path>"),
    (re.compile(r"host verdict: .*"), "host verdict: <verdict>"),
    # each profiler's capture: how many events it holds, and where
    (re.compile(r"device profile: \d+ events \(.*\)"), "device profile: <n> events (<path>)"),
    (re.compile(r"merged plane: \d+ events \(([a-z+]+)\), \d+% of [0-9.]+s wall attributed across \d+ sync "
                r"points -> \S+"),
     r"merged plane: <n> events (\1), <pct> of <wall> wall attributed across <n> sync points -> <path>"),
    # bench-ab's summary: rates and deltas
    (re.compile(r"median paired delta .*"), "median paired delta <timed>"),
)

# keys of the prof_merge and bench-ab JSON lines that are times, rates
# or properties of a profiler's capture
_TIMED_KEYS = {"attribution", "host_wall_us", "clock_offset_us", "sync_points", "rates_a", "rates_b",
               "deltas_pct", "median_a", "median_b", "median_delta_pct", "ci95_pct", "sign_p"}


def perf_text(out: str) -> str:
    """`cli_text` of a perf command's stdout with its timings, the
    profiler's event and sync-point counts and the artifacts' paths
    masked; JSON lines keep every other key."""
    lines = []
    for line in cli_text(out).splitlines():
        if line.startswith("{"):
            doc = json.loads(line)
            line = json.dumps({k: ("<timed>" if k in _TIMED_KEYS else v) for k, v in doc.items()})
        for pat, rep in _PERF_MASKS:
            line = pat.sub(rep, line)
        lines.append(line)
    return "\n".join(lines)


def virtual_track(path):
    """The virtual-time events of a merged plane, their pids numbered
    from 0 in order of first appearance."""
    doc = json.load(open(path))
    pids = [e["pid"] for e in doc["traceEvents"]
            if e.get("ph") == "M" and "VIRTUAL" in (e.get("args") or {}).get("name", "")]
    events = [e for e in doc["traceEvents"] if e.get("pid") in pids]
    return [dict(e, pid=pids.index(e["pid"])) for e in events]
