"""KV-store consistency machine (the etcd-class workload) as a
lane-batched Machine.

The port of `madsim_tpu/models/kv.py`. Node 0 is a versioned KV server
whose store survives restart faults (etcd's disk); nodes 1..N-1 are
clients that PUT with at-least-once retries and then GET, alternating.

Checked invariant (STALE_READ, 110): per-client read monotonicity. A client
holding an acknowledged write at version v never observes a GET below
v. It holds for a durable single-copy store under partitions and
kill/restart, and breaks as soon as the store loses acknowledged state
(the tests' `DurabilityBugKv`, which wipes the server on restart).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from ..engine.machine import Machine, Outbox, make_payload, send_if, set_at, set_timer_if
from ..ops import u32
from ..utils import take

SERVER = 0

# message types
M_PUT, M_PUT_OK, M_GET, M_GET_OK = 1, 2, 3, 4

# timers
T_BOOT, T_TICK, T_RETRY = 0, 1, 2

STALE_READ = 110

TICK_US = 40_000
RETRY_US = 120_000


@dataclasses.dataclass
class KvState:
    # server (durable across restart)
    version: torch.Tensor  # int32[L, N] (only SERVER's entry is meaningful)
    value: torch.Tensor  # int32[L, N]
    # clients (volatile)
    acked_version: torch.Tensor  # int32[L, N] highest version acked to this client
    next_val: torch.Tensor  # int32[L, N]
    pending_kind: torch.Tensor  # int32[L, N] 0 = none, M_PUT or M_GET
    pending_val: torch.Tensor  # int32[L, N]
    reqid: torch.Tensor  # int32[L, N]
    stale: torch.Tensor  # bool[L, N] violation observed


class KvMachine(Machine):
    PAYLOAD_WIDTH = 5
    MAX_MSGS = 1
    MAX_TIMERS = 2
    state_type = KvState

    def __init__(self, num_nodes: int = 4):
        self.NUM_NODES = num_nodes

    def init(self, rng_key) -> KvState:
        z = torch.zeros((rng_key.shape[0], self.NUM_NODES), dtype=torch.int32, device=rng_key.device)
        return KvState(version=z, value=z, acked_version=z, next_val=z, pending_kind=z, pending_val=z, reqid=z,
                       stale=torch.zeros_like(z, dtype=torch.bool))

    def init_node(self, nodes: KvState, i, rng_key) -> KvState:
        """Restart: the server's store is durable; a client's state resets."""
        return self.restart_if(nodes, i, torch.ones_like(i, dtype=torch.bool), rng_key)

    def durable_spec(self) -> KvState:
        """The store (version / value) is durable, a client's request state
        volatile; the ghost violation flag survives (spec state, not node
        memory)."""
        return KvState(version=True, value=True, acked_version=False, next_val=False, pending_kind=False,
                       pending_val=False, reqid=False, stale=True)

    def restart_if(self, nodes: KvState, i, cond, rng_key) -> KvState:
        mask = (torch.arange(self.NUM_NODES, device=i.device)[None, :] == i[:, None]) & \
            (cond & (i != SERVER))[:, None]
        return dataclasses.replace(nodes, **{
            k: torch.where(mask, 0, getattr(nodes, k))
            for k in ("acked_version", "next_val", "pending_kind", "pending_val", "reqid")
        })

    # -- timers ---------------------------------------------------------------

    def on_timer(self, nodes: KvState, node, timer_id, now_us, rand_u32) -> Tuple[KvState, Outbox]:
        outbox = self.empty_outbox(node.shape[0], node.device)
        is_client = node != SERVER
        is_boot = timer_id == T_BOOT

        # boot: clients start their op loop
        outbox = set_timer_if(outbox, 0, is_boot & is_client, TICK_US, T_TICK)

        pending_kind, next_val, reqid = take(nodes.pending_kind, node), take(nodes.next_val, node), \
            take(nodes.reqid, node)
        idle = pending_kind == 0
        # tick: start the next op, PUT or GET by next_val's parity
        is_tick = (timer_id == T_TICK) & is_client
        do_put = is_tick & idle & (next_val % 2 == 0)
        do_get = is_tick & idle & (next_val % 2 == 1)
        start = do_put | do_get
        row = {
            "pending_kind": torch.where(do_put, M_PUT, torch.where(do_get, M_GET, pending_kind)),
            "pending_val": torch.where(do_put, node * 100_000 + next_val, take(nodes.pending_val, node)),
            "reqid": torch.where(start, reqid + 1, reqid),
            "next_val": torch.where(start, next_val + 1, next_val),
        }
        nodes = dataclasses.replace(nodes, **{k: set_at(getattr(nodes, k), node, v) for k, v in row.items()})
        # the request; the retry timer covers loss, partitions and a down server
        put = make_payload(self.PAYLOAD_WIDTH, M_PUT, node, row["reqid"], row["pending_val"])
        get = make_payload(self.PAYLOAD_WIDTH, M_GET, node, row["reqid"])
        outbox = send_if(outbox, 0, do_put, SERVER, put)
        outbox = send_if(outbox, 0, do_get, SERVER, get)
        outbox = set_timer_if(outbox, 0, is_tick, TICK_US, T_TICK)
        outbox = set_timer_if(outbox, 1, start, RETRY_US, T_RETRY)

        # retry: resend the pending op (at-least-once)
        is_retry = (timer_id == T_RETRY) & is_client & ~idle
        outbox = send_if(outbox, 0, is_retry & (row["pending_kind"] == M_PUT), SERVER, put)
        outbox = send_if(outbox, 0, is_retry & (row["pending_kind"] == M_GET), SERVER, get)
        outbox = set_timer_if(outbox, 1, is_retry, RETRY_US, T_RETRY)
        return nodes, outbox

    # -- messages -------------------------------------------------------------

    def on_message(self, nodes: KvState, node, src, payload, now_us, rand_u32) -> Tuple[KvState, Outbox]:
        outbox = self.empty_outbox(node.shape[0], node.device)
        mtype = payload[:, 0]
        row0 = (torch.arange(self.NUM_NODES, device=node.device) == SERVER)[None, :]

        # server side
        is_server = node == SERVER
        is_put = is_server & (mtype == M_PUT)
        client, reqid, val = payload[:, 1], payload[:, 2], payload[:, 3]
        version = torch.where(is_put, nodes.version[:, SERVER] + 1, nodes.version[:, SERVER])
        value = torch.where(is_put, val, nodes.value[:, SERVER])
        nodes = dataclasses.replace(nodes, version=torch.where(row0, version[:, None], nodes.version),
                                    value=torch.where(row0, value[:, None], nodes.value))
        outbox = send_if(outbox, 0, is_put, client, make_payload(self.PAYLOAD_WIDTH, M_PUT_OK, 0, reqid, version))
        is_get = is_server & (mtype == M_GET)
        get_ok = make_payload(self.PAYLOAD_WIDTH, M_GET_OK, 0, reqid, version, value)
        outbox = send_if(outbox, 0, is_get, client, get_ok)

        # client side: accept replies matching the current reqid
        is_client = node != SERVER
        r_reqid, r_version = payload[:, 2], payload[:, 3]
        pending_kind, acked = take(nodes.pending_kind, node), take(nodes.acked_version, node)
        current = r_reqid == take(nodes.reqid, node)
        got_put_ok = is_client & (mtype == M_PUT_OK) & current & (pending_kind == M_PUT)
        got_get_ok = is_client & (mtype == M_GET_OK) & current & (pending_kind == M_GET)
        got = got_put_ok | got_get_ok
        row = {
            "acked_version": torch.where(got, torch.maximum(acked, r_version), acked),
            "pending_kind": torch.where(got, 0, pending_kind),
            "stale": take(nodes.stale, node) | (got_get_ok & (r_version < acked)),
        }
        return dataclasses.replace(nodes, **{k: set_at(getattr(nodes, k), node, v) for k, v in row.items()}), outbox

    # -- invariants / results ---------------------------------------------------

    def invariant(self, nodes: KvState, now_us):
        ok = ~nodes.stale.any(dim=1)
        return ok, torch.where(ok, 0, STALE_READ).to(torch.int32)

    def summary(self, nodes: KvState):
        return {"server_version": nodes.version[:, SERVER],
                "total_acked": nodes.acked_version.sum(dim=1, dtype=torch.int32)}

    def coverage_projection(self, nodes: KvState, now_us):
        """Server version bucket (phase) x worst client staleness lag x
        in-flight requests."""
        ver = nodes.version[:, SERVER]
        lag = (ver - nodes.acked_version[:, 1:].amin(dim=1)).clamp(0, 7)
        pending = (nodes.pending_kind[:, 1:] != 0).sum(dim=1, dtype=torch.int32).clamp(0, 3)
        word = ver.clamp(0, 7) | (lag << 3) | (pending << 6) | (nodes.stale.any(dim=1).to(torch.int32) << 8)
        return u32.from_i32(word)
