"""The protocol state-machine contract, lane-batched.

The port's counterpart of `madsim_tpu/engine/machine.py`. A `Machine` is
a pure transition system over fixed-shape tensors. Where the reference
vmaps a per-lane handler, the port calls each handler once for the whole
batch:

  * node state: a dataclass whose every leaf is `[L, N, ...]`;
  * handlers receive the node state and `[L]` tensors (node index,
    timer id or source, time) plus `[L, P]` payloads and `[L, H]` random
    words (int64 uint32 values), and return (new node state, Outbox);
  * every write is a masked `torch.where` (`set_at`, `update_node`), so a
    lane whose condition is false writes back its old value.

Timer id 0 (`BOOT`) is reserved: the engine delivers it to every node at
t=0 and after every restart.

Storage faults (`FaultPlan.allow_torn`): `durable_spec()` says which
leaves survive a restart and `torn_spec()` what a torn restart may do to
each durable leaf. `torn_restart_if` walks the state's leaves in the
order `state_leaf_names` gives, which is the JAX package's flatten
order (a dataclass's field order), and salts each leaf's damage word
with its position there.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Tuple

import torch

from ..ops import u32
from ..utils import gather_at, norm_index, take, tree_where

BOOT = 0  # reserved timer id

# Storage-atomicity classes of a durable leaf under a torn restart
# (`Machine.torn_spec`); volatile leaves ignore their class and wipe.
TORN_ATOMIC = 1  # the write is atomic and fsynced: the row survives
TORN_LOSE = 2  # all-or-nothing lost write: the row may revert whole
TORN_PREFIX = 3  # torn multi-element write: the row keeps a seeded prefix
#                  of its trailing axis (rows of one value degrade to LOSE)
TORN_CLASSES = (TORN_ATOMIC, TORN_LOSE, TORN_PREFIX)

# the damage hash: murmur3's fmix over (seed ^ golden * (leaf + 1))
_TORN_GOLDEN = 0x9E3779B9
_TORN_M1 = 0x85EBCA6B
_TORN_M2 = 0xC2B2AE35


def torn_hash(seed, leaf_idx: int) -> torch.Tensor:
    """The uint32 damage word (int64) of durable leaf `leaf_idx` under
    the torn seed words `seed` [L] (int32 bit patterns or uint32 values);
    every multiply wraps at 32 bits."""
    h = u32.from_i32(seed) ^ ((_TORN_GOLDEN * (leaf_idx + 1)) & u32.MASK)
    h = u32.mul(h ^ (h >> 16), _TORN_M1)
    h = u32.mul(h ^ (h >> 13), _TORN_M2)
    return h ^ (h >> 16)


def state_leaf_names(state) -> list:
    """The leaves of a node-state dataclass in the JAX package's flatten
    order (field-declaration order): a leaf's index here salts its torn
    damage."""
    return [f.name for f in dataclasses.fields(state)]


@dataclasses.dataclass
class Outbox:
    """Fixed-capacity per-step outputs of a handler, for every lane."""

    msg_dst: torch.Tensor  # int32[L, M] destination node (-1 = invalid)
    msg_payload: torch.Tensor  # int32[L, M, P]
    msg_valid: torch.Tensor  # bool[L, M]
    timer_delay_us: torch.Tensor  # int32[L, T]
    timer_id: torch.Tensor  # int32[L, T]
    timer_valid: torch.Tensor  # bool[L, T]


def empty_outbox(lanes: int, max_msgs: int, max_timers: int, payload_width: int, device) -> Outbox:
    kw = {"dtype": torch.int32, "device": device}
    return Outbox(
        msg_dst=torch.full((lanes, max_msgs), -1, **kw),
        msg_payload=torch.zeros((lanes, max_msgs, payload_width), **kw),
        msg_valid=torch.zeros((lanes, max_msgs), dtype=torch.bool, device=device),
        timer_delay_us=torch.zeros((lanes, max_timers), **kw),
        timer_id=torch.zeros((lanes, max_timers), **kw),
        timer_valid=torch.zeros((lanes, max_timers), dtype=torch.bool, device=device),
    )


def _col(v):
    """A per-lane int value as an int32 column [L, 1] (python ints pass)."""
    return v.to(torch.int32)[:, None] if isinstance(v, torch.Tensor) else v


def _slot(n: int, slot: int, cond: torch.Tensor) -> torch.Tensor:
    return (torch.arange(n, device=cond.device) == slot)[None, :] & cond[:, None]


def _always(outbox: Outbox) -> torch.Tensor:
    return torch.ones(outbox.msg_dst.shape[0], dtype=torch.bool, device=outbox.msg_dst.device)


def send(outbox: Outbox, slot: int, dst, payload) -> Outbox:
    """Set message slot `slot` of every lane."""
    return send_if(outbox, slot, _always(outbox), dst, payload)


def send_if(outbox: Outbox, slot: int, cond, dst, payload) -> Outbox:
    """Where `cond` [L], set message slot `slot` to (dst [L], payload [L, P])."""
    m = _slot(outbox.msg_dst.shape[1], slot, cond)
    return dataclasses.replace(
        outbox,
        msg_dst=torch.where(m, _col(dst), outbox.msg_dst),
        msg_payload=torch.where(
            m[:, :, None], payload[:, None, :].to(torch.int32), outbox.msg_payload
        ),
        msg_valid=outbox.msg_valid | m,
    )


def send_all_if(outbox: Outbox, cond, dst, payload) -> Outbox:
    """Where `cond` [L], set every message slot: slot s to (dst[:, s],
    payload[:, s]) (dst [L, M]; payload [L, M, P], or [L, P] for one
    payload to all). The same writes as `send_if` on each slot."""
    m = cond[:, None].expand_as(outbox.msg_valid)
    if payload.dim() == 2:
        payload = payload[:, None, :]
    return dataclasses.replace(
        outbox,
        msg_dst=torch.where(m, dst.to(torch.int32), outbox.msg_dst),
        msg_payload=torch.where(m[:, :, None], payload.to(torch.int32), outbox.msg_payload),
        msg_valid=outbox.msg_valid | m,
    )


def set_timer(outbox: Outbox, slot: int, delay_us, timer_id) -> Outbox:
    """Arm timer slot `slot` of every lane."""
    return set_timer_if(outbox, slot, _always(outbox), delay_us, timer_id)


def set_timer_if(outbox: Outbox, slot: int, cond, delay_us, timer_id) -> Outbox:
    """Where `cond` [L], arm timer slot `slot` with (delay_us, timer_id)."""
    m = _slot(outbox.timer_id.shape[1], slot, cond)
    return dataclasses.replace(
        outbox,
        timer_delay_us=torch.where(m, _col(delay_us), outbox.timer_delay_us),
        timer_id=torch.where(m, _col(timer_id), outbox.timer_id),
        timer_valid=outbox.timer_valid | m,
    )


def set_at(arr: torch.Tensor, i, value, cond=None) -> torch.Tensor:
    """Per-lane `arr[l, i[l]] = value[l]` for arr [L, N, ...] as a masked
    select; `cond` [L] gates the whole write. `value` is a scalar or a
    per-lane [L, ...] row."""
    mask = torch.arange(arr.shape[1], device=arr.device)[None, :] == i[:, None]
    if cond is not None:
        mask = mask & cond[:, None]
    mask = mask.reshape(mask.shape + (1,) * (arr.dim() - 2))
    if isinstance(value, torch.Tensor):
        value = value.to(arr.dtype)
        if value.dim() > 0:
            value = value.unsqueeze(1)
    return torch.where(mask, value, arr)


def update_node(nodes: Any, i, **updates) -> Any:
    """Write per-field per-lane updates into node i[l] of a state dataclass."""
    return dataclasses.replace(
        nodes, **{k: set_at(getattr(nodes, k), i, v) for k, v in updates.items()}
    )


def node_row(nodes: Any, i) -> dict:
    """Each lane's node i[l] of a state dataclass: {field: [L, ...]}
    (jax's gather index semantics, `utils.norm_index`). Handlers that
    only ever touch the handling node's row read it once with this,
    compute on the row, and write it back once with `write_row`."""
    leaves = {f.name: getattr(nodes, f.name) for f in dataclasses.fields(nodes)}
    at = norm_index(i, next(iter(leaves.values())).shape[1])
    return {k: gather_at(v, at) for k, v in leaves.items()}


def write_row(nodes: Any, i, row: dict) -> Any:
    """Write the fields of `row` into node i[l] of each lane (a masked
    select, so an out-of-range index writes nothing, as `set_at`)."""
    first = getattr(nodes, next(iter(row)))
    mask = torch.arange(first.shape[1], device=first.device)[None, :] == i[:, None]
    out = {}
    for k, v in row.items():
        arr = getattr(nodes, k)
        m = mask.reshape(mask.shape + (1,) * (arr.dim() - 2))
        out[k] = torch.where(m, v.to(arr.dtype).unsqueeze(1), arr)
    return dataclasses.replace(nodes, **out)


def make_payload(width: int, *vals) -> torch.Tensor:
    """Pack int tensors broadcasting to one shape S ([L], or [L, M] for
    one payload per message slot) and python ints into an int32
    [*S, width] payload, zero-padded."""
    tensors = [v for v in vals if isinstance(v, torch.Tensor)]
    shape = torch.broadcast_shapes(*(t.shape for t in tensors))
    cols = [
        v.to(torch.int32).expand(shape) if isinstance(v, torch.Tensor)
        else torch.full(shape, v, dtype=torch.int32, device=tensors[0].device)
        for v in vals
    ]
    cols += [torch.zeros_like(cols[0])] * (width - len(cols))
    return torch.stack(cols, dim=-1)


class Machine:
    """Base class: subclass and override the handlers.

    Class attributes to set:
      NUM_NODES, PAYLOAD_WIDTH, MAX_MSGS, MAX_TIMERS
    and `state_type`, the node-state dataclass (`interop.py` builds it).
    """

    NUM_NODES: int = 1
    PAYLOAD_WIDTH: int = 4
    MAX_MSGS: int = 4
    MAX_TIMERS: int = 2
    state_type: Any = None

    def empty_outbox(self, lanes: int, device) -> Outbox:
        return empty_outbox(lanes, self.MAX_MSGS, self.MAX_TIMERS, self.PAYLOAD_WIDTH, device)

    # -- required overrides --------------------------------------------------

    def init(self, rng_key: torch.Tensor) -> Any:
        """Initial node state for every lane (rng_key [L, 2]; every leaf
        [L, NUM_NODES, ...])."""
        raise NotImplementedError

    def _wipe_node_if(self, nodes: Any, i, cond, rng_key) -> Any:
        """Copy row i[l] from a fresh init() where cond[l]."""
        fresh = self.init(rng_key)
        return type(nodes)(**{
            f.name: set_at(getattr(nodes, f.name), i, take(getattr(fresh, f.name), i), cond)
            for f in dataclasses.fields(nodes)
        })

    def init_node(self, nodes: Any, i, rng_key) -> Any:
        """Reset node i to its initial state (legacy restart hook)."""
        return self._wipe_node_if(nodes, i, torch.ones_like(i, dtype=torch.bool), rng_key)

    def restart_if(self, nodes: Any, i, cond, rng_key) -> Any:
        """Conditionally reset node i (the engine's restart-fault hook).
        The default honors a subclass's `init_node` override."""
        fresh = self.init_node(nodes, i, rng_key)
        return tree_where(cond, fresh, nodes)

    def durable_spec(self) -> Any:
        """Optional durable-state contract for crash-with-amnesia faults
        (`FaultPlan.strict_restart`): a `state_type` instance whose every
        field is a python bool, True for a leaf that survives a restart
        (stable storage), False for one a restarted node must lose. The
        strict restart wipes the volatile leaves from a fresh `init()`,
        bypassing the model's own restart hook. Default None: no
        contract, and the engine refuses `strict_restart`."""
        return None

    def amnesia_restart_if(self, nodes: Any, i, cond, rng_key) -> Any:
        """Crash-with-amnesia restart: where cond[l], every leaf
        `durable_spec()` marks volatile takes row i[l] of a fresh
        `init(rng_key)`; durable leaves are kept as they are."""
        spec = self.durable_spec()
        if spec is None:
            raise ValueError(
                f"{type(self).__name__} declares no durable_spec(); "
                f"strict_restart (crash-with-amnesia) needs the durable-"
                f"state contract to know which leaves to wipe"
            )
        fresh = self.init(rng_key)
        return dataclasses.replace(nodes, **{
            f.name: set_at(getattr(nodes, f.name), i, take(getattr(fresh, f.name), i), cond)
            for f in dataclasses.fields(spec) if not getattr(spec, f.name)
        })

    def torn_spec(self) -> Any:
        """Optional storage-atomicity contract for torn restarts
        (`FaultPlan.allow_torn`): a `state_type` instance congruent to
        `durable_spec()` whose every field is TORN_ATOMIC, TORN_LOSE or
        TORN_PREFIX. Default None: every durable write is atomic, so a
        torn restart is the amnesia wipe."""
        return None

    def torn_restart_if(self, nodes: Any, i, cond, rng_key, torn_seed) -> Any:
        """Torn restart of node i[l] where cond[l]: volatile leaves wipe
        as `amnesia_restart_if` does; a durable TORN_LOSE leaf (or any
        non-atomic leaf of one value a node) reverts to its fresh row
        when bit 0 of its damage word is set; a TORN_PREFIX leaf keeps
        its first `(h >> 1) % (size + 1)` entries along the trailing axis
        and takes the fresh values past them. `torn_seed` [L] is the
        fault's damage mask xor the step's torn word; the damage word is
        `torn_hash(torn_seed, leaf position)`."""
        spec = self.durable_spec()
        if spec is None:
            raise ValueError(
                f"{type(self).__name__} declares no durable_spec(); "
                f"allow_torn (torn/lost-write storage faults) needs the "
                f"durable-state contract to know which leaves exist"
            )
        tspec = self.torn_spec()
        fresh = self.init(rng_key)
        out = {}
        for li, name in enumerate(state_leaf_names(spec)):
            cur, f = getattr(nodes, name), getattr(fresh, name)
            cls = TORN_ATOMIC if tspec is None else getattr(tspec, name)
            if not getattr(spec, name):
                out[name] = set_at(cur, i, take(f, i), cond)  # amnesia wipe
                continue
            if cls == TORN_ATOMIC:
                continue
            h = torn_hash(torn_seed, li)
            if cls == TORN_LOSE or cur.dim() < 3:
                out[name] = set_at(cur, i, take(f, i), cond & ((h & 1) == 1))
            elif cls == TORN_PREFIX:
                size = cur.shape[-1]
                cut = (h >> 1) % (size + 1)
                torn_tail = torch.arange(size, device=cur.device)[None, :] >= cut[:, None]  # [L, size]
                row = (torch.arange(cur.shape[1], device=cur.device)[None, :] == i[:, None]) & cond[:, None]
                mid = (1,) * (cur.dim() - 3)
                mask = row.reshape(row.shape + mid + (1,)) & torn_tail.reshape((-1, 1) + mid + (size,))
                out[name] = torch.where(mask, f, cur)
            else:
                raise ValueError(
                    f"{type(self).__name__}.torn_spec() leaf {li} has unknown atomicity "
                    f"class {cls!r} (expected TORN_ATOMIC/TORN_LOSE/TORN_PREFIX)"
                )
        return dataclasses.replace(nodes, **out)

    def restart_node_if(self, nodes: Any, i, cond, rng_key, strict: bool = False) -> Any:
        """Engine-facing restart dispatch; do NOT override. With `strict`
        (`FaultPlan.strict_restart`) the amnesia wipe runs instead of the
        model's restart hook; otherwise the hook is picked by MRO
        position as the reference does."""
        if strict:
            return self.amnesia_restart_if(nodes, i, cond, rng_key)
        mro = type(self).__mro__

        def hook_owner(name):
            return next(c for c in mro if name in c.__dict__)

        init_owner = hook_owner("init_node")
        rif_owner = hook_owner("restart_if")
        if init_owner is not Machine and mro.index(init_owner) < mro.index(rif_owner):
            return Machine.restart_if(self, nodes, i, cond, rng_key)
        return self.restart_if(nodes, i, cond, rng_key)

    def on_timer(self, nodes: Any, node, timer_id, now_us, rand_u32) -> Tuple[Any, Outbox]:
        raise NotImplementedError

    def on_message(self, nodes: Any, node, src, payload, now_us, rand_u32) -> Tuple[Any, Outbox]:
        raise NotImplementedError

    # -- optional overrides --------------------------------------------------

    def invariant(self, nodes: Any, now_us) -> Tuple[torch.Tensor, torch.Tensor]:
        """(ok [L] bool, code [L] int32); False freezes the lane as FAILED."""
        lanes = now_us.shape[0]
        return (torch.ones(lanes, dtype=torch.bool, device=now_us.device),
                torch.zeros(lanes, dtype=torch.int32, device=now_us.device))

    def is_done(self, nodes: Any, now_us) -> torch.Tensor:
        return torch.zeros(now_us.shape[0], dtype=torch.bool, device=now_us.device)

    def summary(self, nodes: Any) -> Any:
        """Small per-lane result tree gathered back to the host."""
        first = getattr(nodes, dataclasses.fields(nodes)[0].name)
        return torch.zeros(first.shape[0], dtype=torch.int32, device=first.device)

    def coverage_projection(self, nodes: Any, now_us) -> torch.Tensor:
        """Abstract-state word [L] for the coverage map (low 3 bits: the
        model's coarsest phase). Default 0."""
        return torch.zeros(now_us.shape[0], dtype=torch.int64, device=now_us.device)

