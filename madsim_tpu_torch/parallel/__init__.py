"""Seed-batch parallelism over torch.distributed ranks.

The port of `madsim_tpu/parallel/__init__.py`. The scaling axis of a
deterministic-simulation hunt is seeds: lanes are independent, so the
lane axis shards over a 1-D "batch" axis of ranks. The reference runs
one jitted SPMD program over a device mesh from one process; the port
runs one process per device, joined by `torch.distributed`, because
eager PyTorch is paced by the host's kernel launches and every card
needs a dispatching thread of its own.

Rank r of a world of size W holds the global lanes [r * L/W, (r+1) *
L/W): the "lane" leaves of `CARRY_AXES` are that slice, the "global"
leaves (scalars, result rings, the OR-folded coverage map) are whole
and equal on every rank. Every cross-lane operation of the stream
executor is one of the collectives below, named after the reference's
registry entry and run inside `perf/xprof.collective_scope` under that
name. Each is integer arithmetic, exact in any reduction order, and a
gathered sequence is in rank-major lane order, which is the unsharded
lane order; so a meshed run is byte-identical to the unsharded one at
any rank count.

Only two collectives are used: `all_gather` (the list form) and
`all_reduce` with SUM or MAX. NCCL has no bitwise-or reduction, so an OR
is an all-gather of the ranks' words followed by a local OR. The
backend is NCCL when every rank has a card of its own, gloo when ranks
share a card or run on the CPU (`multihost.initialize`). A failed
collective raises: nothing is staged through the host by this module
and no rank is replaced by a CPU rank.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Sequence

import torch

from ..perf import xprof as _xprof

#: the 1-D lane-sharding axis, named as the reference names it;
#: `SEED_AXIS` is the reference's older alias
LANE_AXIS = "batch"
SEED_AXIS = LANE_AXIS

# The placement contract, copied from the reference's declared table
# (`analysis/srules.py` CARRY_AXES): every leaf of the streaming structs
# is "lane" (lane-leading [L, ...], sharded) or "global" (replicated). A
# new leaf without a row is refused by `carry_shardings`.
CARRY_AXES = {
    "StreamCarry": {
        "state": "lane",
        "seeds": "lane",
        "done": "lane",
        "next_seed": "global",
        "completed": "global",
        "segments": "global",
        "fail_seeds": "global",
        "fail_codes": "global",
        "fail_provs": "global",
        "fail_count": "global",
        "ab_seeds": "global",
        "ab_count": "global",
        "counters": "global",
        "fr_metrics": "global",
        "cov_map": "global",
    },
    "LaneState": {
        **{
            f: "lane"
            for f in (
                "now_us", "next_seq", "step", "rng_key", "done", "failed",
                "fail_code", "horizon_hit", "msg_count", "storm_loss",
                "delay_spike", "eq_time", "eq_seq", "eq_kind", "eq_node",
                "eq_src", "eq_payload", "eq_valid", "clogged", "killed",
                "paused_until", "skew_q10", "node_prov", "eq_prov",
                "fail_prov", "nodes", "ring", "fr", "cov",
            )
        },
        # the buffered-coverage sub-leaves of `cov` shard with the lanes
        # like the map they flush into
        "cov.map": "lane",
        "cov.buf": "lane",
        "cov.buf_n": "lane",
    },
    "BatchResult": {
        f: "lane"
        for f in (
            "seeds", "done", "failed", "fail_code", "fail_prov", "now_us",
            "steps", "msg_count", "summary", "ring", "fr", "cov",
        )
    },
}


@dataclasses.dataclass(frozen=True)
class Mesh:
    """One rank's view of the 1-D "batch" axis: its process group, its
    rank and the world size in that group, its own device and the
    group's backend. `host_group` carries the host's own agreements (a
    gloo group beside an NCCL one; the group itself otherwise)."""

    group: Any
    rank: int
    world: int
    device: torch.device
    backend: str
    host_group: Any = None

    @property
    def size(self) -> int:
        return self.world

    @property
    def shape(self) -> dict:
        return {LANE_AXIS: self.world}


def make_mesh(devices: Optional[Sequence] = None, group=None) -> Mesh:
    """The mesh of this rank over `group` (default: every rank of the
    initialized job). `devices`, one per rank of the group, names each
    rank's device; by default a rank takes card `rank % device_count`
    when the machine has a card, else the CPU (`multihost.global_mesh`
    passes the devices `multihost.initialize` chose). The caller must have
    joined the job (`multihost.initialize`, or
    `torch.distributed.init_process_group`)."""
    import torch.distributed as dist

    if not dist.is_available() or not dist.is_initialized():
        raise ValueError(
            "make_mesh needs an initialized torch.distributed job: call "
            "parallel.multihost.initialize() (or init_process_group) first"
        )
    group = group if group is not None else dist.group.WORLD
    rank, world = dist.get_rank(group), dist.get_world_size(group)
    if devices is not None:
        devices = list(devices)
        if len(devices) != world:
            raise ValueError(f"make_mesh: {len(devices)} devices for a group of {world} ranks")
        device = torch.device(devices[rank])
    elif torch.cuda.is_available():
        device = torch.device("cuda", dist.get_rank() % torch.cuda.device_count())
    else:
        device = torch.device("cpu")
    backend = str(dist.get_backend(group))
    host_group = group
    if backend == "nccl" and world > 1:
        host_group = dist.new_group(dist.get_process_group_ranks(group), backend="gloo",
                                    use_local_synchronization=True)
    return Mesh(group=group, rank=rank, world=world, device=device, backend=backend, host_group=host_group)


def shard_seeds(seeds, mesh: Mesh):
    """This rank's contiguous slice of a seed batch. Validates the mesh
    and the batch shape up front with the reference's messages, so every
    sharding entry point refuses a batch that does not split evenly."""
    if LANE_AXIS not in mesh.shape:
        raise ValueError(
            f'mesh has no "{LANE_AXIS}" axis (axes: {tuple(mesh.shape)}); '
            f"build it with parallel.make_mesh(...)"
        )
    axis = mesh.shape[LANE_AXIS]
    n = len(seeds)
    if n % axis != 0:
        raise ValueError(
            f"seed batch ({n}) must be a multiple of the mesh's "
            f'"{LANE_AXIS}" axis size ({axis})'
        )
    per = n // axis
    return seeds[mesh.rank * per : (mesh.rank + 1) * per]


def _path_tree(fn, tree, path=()):
    """`fn(path, leaf)` over a tree of dataclasses, dicts and sequences,
    rebuilt as nested dicts (sequences as lists); a path entry is a
    field or key name, or None for a sequence index."""
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return {f.name: _path_tree(fn, getattr(tree, f.name), path + (f.name,)) for f in dataclasses.fields(tree)}
    if isinstance(tree, dict):
        return {k: _path_tree(fn, v, path + (str(k),)) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return [_path_tree(fn, v, path + (None,)) for v in tree]
    return fn(path, tree)


def carry_shardings(mesh: Mesh, carry_tree):
    """Each leaf's axis, "lane" or "global", for a StreamCarry (or any
    tree with its field names), as nested dicts of the carry's shape,
    answered from `CARRY_AXES`. Raises KeyError on a field with no row:
    new carry state must be declared lane-leading or global before it
    can be meshed."""
    carry_table = CARRY_AXES["StreamCarry"]
    state_table = CARRY_AXES["LaneState"]

    def place(path, _leaf):
        top = path[0] if path else None
        if top == "state":
            field = path[1] if len(path) > 1 else None
            axis, table = state_table.get(field), f"LaneState.{field}"
        else:
            axis, table = carry_table.get(top), f"StreamCarry.{top}"
        if axis is None:
            raise KeyError(
                f"{table} has no CARRY_AXES row — declare the new leaf "
                f"lane-leading or global before meshing it"
            )
        return axis

    return _path_tree(place, carry_tree)


def pad_to_multiple(n: int, k: int) -> int:
    return ((n + k - 1) // k) * k


# -- the collectives ----------------------------------------------------------


def _gather(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    """Every rank's `t`, stacked rank-major: [world, *t.shape]. Bools
    ride as uint8."""
    import torch.distributed as dist

    if t.numel() == 0:
        # a gate-off leaf ([L, 0]): the same empty shape on every rank
        return t.new_empty((mesh.world,) + tuple(t.shape))
    src = (t.to(torch.uint8) if t.dtype == torch.bool else t).reshape((-1,) if t.dim() == 0 else t.shape)
    parts = [torch.empty_like(src) for _ in range(mesh.world)]
    dist.all_gather(parts, src.contiguous(), group=mesh.group)
    out = torch.stack(parts).reshape((mesh.world,) + tuple(t.shape))
    return out.to(torch.bool) if t.dtype == torch.bool else out


def _reduce(mesh: Mesh, t: torch.Tensor, op) -> torch.Tensor:
    import torch.distributed as dist

    out = t.clone()
    dist.all_reduce(out, op=op, group=mesh.group)
    return out


def any_host(mesh: Mesh, flag: bool, name: str = "parked-any") -> bool:
    """True on every rank where any rank's host flag is: a one-element MAX
    all-reduce of a CPU tensor over the host group (the port's own
    agreement of the pipelined executor's early stop, no registry
    entry)."""
    import torch.distributed as dist

    with _xprof.collective_scope(name):
        t = torch.tensor([int(flag)], dtype=torch.int32)
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=mesh.host_group)
        return bool(t[0])


def all_sum(mesh: Mesh, t: torch.Tensor, name: str) -> torch.Tensor:
    """The sum over ranks of an integer tensor (`refill-count`,
    `harvest-completed`, `fr-fold`, `multihost-completed-sum`)."""
    import torch.distributed as dist

    with _xprof.collective_scope(name):
        return _reduce(mesh, t, dist.ReduceOp.SUM)


def all_max(mesh: Mesh, t: torch.Tensor, name: str) -> torch.Tensor:
    """The maximum over ranks of an integer tensor (`fr-hwm`)."""
    import torch.distributed as dist

    with _xprof.collective_scope(name):
        return _reduce(mesh, t, dist.ReduceOp.MAX)


def any_rank(mesh: Mesh, flag: torch.Tensor, name: str = "segment-done-any") -> torch.Tensor:
    """A scalar bool tensor, True where any rank's is: a one-element MAX
    all-reduce, queued without a host read."""
    import torch.distributed as dist

    with _xprof.collective_scope(name):
        return _reduce(mesh, flag.to(torch.int32).reshape(1), dist.ReduceOp.MAX)[0] != 0


def exclusive_count(mesh: Mesh, n: torch.Tensor, scan: str, total: str):
    """(offset, total) of a per-rank count: the sum of the counts of the
    ranks before this one (the cross-rank exclusive scan `scan`) and of
    all ranks (`total`), from one gather of the [world] counts."""
    with _xprof.collective_scope(scan):
        counts = _gather(mesh, n.to(torch.int64).reshape(()))
        offset = counts[: mesh.rank].sum()
    with _xprof.collective_scope(total):
        return offset, counts.sum()


def or_words(mesh: Mesh, words: torch.Tensor, fold, name: str = "cov-map-or") -> torch.Tensor:
    """The bitwise OR over ranks of an int32 word vector [W]: an
    all-gather of the ranks' words and a local `fold` of the [world, W]
    stack (NCCL has no OR reduction; the result is exact either way)."""
    with _xprof.collective_scope(name):
        return fold(_gather(mesh, words))


def compact(mask: torch.Tensor, values: torch.Tensor):
    """The masked rows of `values` [L, K] moved to the front in lane
    order: (block [L, K], entries past the count 0; count). The ordered
    append of the failure and abandoned rings, on one rank's lanes or on
    an unsharded batch. Fixed shapes: no host read."""
    lanes = mask.shape[0]
    with _xprof.scope("ring_append"):
        csum = torch.cumsum(mask.to(torch.int64), dim=0)  # madsim: collective(ring-append-ranks, reduce=scan)
        n = csum[-1] if lanes else torch.zeros((), dtype=torch.int64, device=mask.device)
        want = torch.arange(1, lanes + 1, device=mask.device, dtype=torch.int64)
        src = torch.searchsorted(csum, want, side="left").clamp(0, max(lanes - 1, 0))
        # madsim: collective(ring-append-gather, reduce=gather)
        return torch.where((want <= n)[:, None], values[src], 0), n


def gather_masked(mesh: Mesh, mask: torch.Tensor, values: torch.Tensor, ranks: str = "ring-append-ranks",
                  name: str = "ring-append-gather"):
    """The masked lanes of every rank, compacted in global lane order:
    (values [world * L_local, K], count). Each rank compacts its own
    masked lanes (values [L_local, K], `compact`); the counts (`ranks`,
    the exclusive scan) and the blocks (`name`) are gathered, and entry
    k of the result is the k-th masked lane of the whole batch
    (rank-major), entries past `count` 0. Fixed shapes: no host read."""
    lanes = mask.shape[0]
    block, n = compact(mask, values)
    with _xprof.collective_scope(ranks):
        counts = _gather(mesh, n)  # [world]
        incl = torch.cumsum(counts, dim=0)
        total = incl[-1]
    with _xprof.collective_scope(name):
        blocks = _gather(mesh, block)  # [world, L_local, K]
        k = torch.arange(mesh.world * lanes, device=mask.device, dtype=torch.int64)
        r = torch.searchsorted(incl, k, right=True).clamp(0, mesh.world - 1)
        idx = (k - (incl[r] - counts[r])).clamp(0, max(lanes - 1, 0))
        flat = blocks[r, idx]
        return torch.where((k < total)[:, None], flat, 0), total


def gather_lanes(mesh: Mesh, tree, name: str):
    """Every lane-leading leaf of `tree` gathered over the ranks and
    concatenated in rank order: the whole logical batch on every rank."""
    from ..utils import tree_map

    with _xprof.collective_scope(name):
        return tree_map(lambda t: _gather(mesh, t).reshape((-1,) + tuple(t.shape[1:])), tree)


def seed_counter(mesh: Mesh, last_seed: torch.Tensor) -> torch.Tensor:
    """The global last seed of the initial batch (`seed-counter-init`):
    the last rank's last lane, gathered once a stream."""
    with _xprof.collective_scope("seed-counter-init"):
        return _gather(mesh, last_seed.reshape(()))[-1]
