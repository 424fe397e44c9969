"""Carry lane state between the JAX package and the port.

`lane_state_from_numpy` takes the JAX package's `LaneState` (or any
tree of dataclasses and dicts) whose leaves are numpy arrays `[L, ...]`
and builds the port's `LaneState` on a device; `tree_to_numpy` goes
back. With them a test starts both engines from one state and compares
them step by step. Nothing here imports the JAX package: its objects
are read by attribute name.

The dtype rule, fixed here: JAX uint32 leaves are held on the device as
int32 bit patterns (`ndarray.view(np.int32)`); every other leaf keeps
its dtype. `UINT32_LEAVES` names the uint32 leaves, so the round trip
is lossless.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .engine.core import LaneState, resolve_device

UINT32_LEAVES = frozenset({
    "rng_key", "d0", "d1", "ck_d0", "ck_d1", "node_prov", "eq_prov", "fail_prov", "seeds",
})


def _to_tensor(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(np.array(a, copy=True, order="C")).to(device)


def _convert(value, device):
    if isinstance(value, dict):
        return {k: _convert(v, device) for k, v in value.items()}
    return _to_tensor(value, device)


def lane_state_from_numpy(tree, machine, device=None) -> LaneState:
    """The JAX `LaneState` (numpy leaves, `nodes` a dataclass such as
    `RaftState`) -> the port's `LaneState` on `device`, which means the
    CUDA card unless the caller asks for the CPU, as `Engine` does."""
    device = resolve_device(device)
    fields = {}
    for f in dataclasses.fields(LaneState):
        value = getattr(tree, f.name)
        if f.name == "nodes":
            value = machine.state_type(**{
                nf.name: _to_tensor(getattr(value, nf.name), device)
                for nf in dataclasses.fields(machine.state_type)
            })
        else:
            value = _convert(value, device)
        fields[f.name] = value
    return LaneState(**fields)


def tree_to_numpy(tree, name: str = ""):
    """A port tree (dataclasses, dicts, tuples, tensors) -> nested dicts
    (and tuples) of numpy arrays, with the uint32 leaves restored."""
    if dataclasses.is_dataclass(tree):
        return {f.name: tree_to_numpy(getattr(tree, f.name), f.name) for f in dataclasses.fields(tree)}
    if isinstance(tree, dict):
        return {k: tree_to_numpy(v, k) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(tree_to_numpy(v, name) for v in tree)
    a = tree.detach().cpu().numpy()
    return a.view(np.uint32) if name in UINT32_LEAVES and a.dtype == np.int32 else a


lane_state_to_numpy = tree_to_numpy
