"""Small shared utilities over the port's lane-batched state trees.

A state tree is a dataclass or dict whose leaves are tensors with a
leading lane dimension `[L, ...]`.
"""

from __future__ import annotations

import dataclasses

import torch


def tree_map(fn, tree, *rest):
    """Apply `fn` leaf-wise over congruent trees of dataclasses, dicts,
    tuples and tensors."""
    if dataclasses.is_dataclass(tree):
        return dataclasses.replace(
            tree,
            **{
                f.name: tree_map(fn, getattr(tree, f.name), *(getattr(r, f.name) for r in rest))
                for f in dataclasses.fields(tree)
            },
        )
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(tree_map(fn, *leaves) for leaves in zip(tree, *rest))
    return fn(tree, *rest)


def bcast(pred: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """Broadcast a lane vector [L] over the trailing dims of `like`."""
    return pred.reshape(pred.shape + (1,) * (like.dim() - pred.dim()))


def where(pred, on_true, on_false):
    """`torch.where` with a lane-vector predicate broadcast over trailing dims."""
    return torch.where(bcast(pred, on_true), on_true, on_false)


def tree_where(pred, on_true, on_false):
    """Lane-wise select over two congruent trees; `pred` is [L] bool."""
    return tree_map(lambda a, b: where(pred, a, b), on_true, on_false)


def norm_index(i: torch.Tensor, n: int) -> torch.Tensor:
    """jax's gather index semantics: a negative index counts from the
    end, then the index is clamped into [0, n). So a junk index on a
    path whose result is discarded can never raise."""
    return torch.where(i < 0, i + n, i).clamp(0, n - 1).to(torch.int64)


def gather_at(arr: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """`arr[l, i[l], ...]` for an index already in range (`norm_index`)."""
    at = i.reshape((-1, 1) + (1,) * (arr.dim() - 2)).expand((-1, 1) + arr.shape[2:])
    return arr.gather(1, at).squeeze(1)


def take(arr: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """Per-lane gather with jax's index semantics (`norm_index`):
    `arr[l, i[l], ...]` for arr [L, N, ...] and i [L], or, for a row
    arr [L, N] and indices i [L, K], `arr[l, i[l, k]]` as [L, K]."""
    at = norm_index(i, arr.shape[1])
    if i.dim() == 2:
        return arr.gather(1, at)
    return gather_at(arr, at)


def set2d(arr: torch.Tensor, i, j, value) -> torch.Tensor:
    """Per-lane `arr[l, i, j] = value` for arr [L, N0, N1] as an outer
    mask select (no scatter)."""
    n0, n1 = arr.shape[1:]
    r0 = torch.arange(n0, device=arr.device)
    r1 = torch.arange(n1, device=arr.device)
    mask = (r0[None, :, None] == i.reshape(-1, 1, 1)) & (r1[None, None, :] == j.reshape(-1, 1, 1))
    if isinstance(value, torch.Tensor) and value.dim() > 0:
        value = value.reshape(-1, 1, 1)
    return torch.where(mask, value, arr)
