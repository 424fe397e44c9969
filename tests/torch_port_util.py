"""Shared helpers of the tests that hold the PyTorch port
(`madsim_tpu_torch`) against the JAX package: the flagship config built
for both, and leaf-for-leaf comparison of their state trees."""

from __future__ import annotations

import dataclasses

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
