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
