"""Leased-KV / leader-election machine (the etcd client scenarios) as a
lane-batched Machine.

The port of `madsim_tpu/models/etcd.py`. Node 0 is the etcd-like server
(a durable revision counter, per-client leases, one election); nodes
1..N-1 are clients that grant a lease, campaign for leadership, keep
their lease alive while leading and write revisioned values. The server
expires a lease TTL after the last keepalive receipt; a client stops
believing in its leadership TTL after the last acked keepalive send, so
an honest run keeps

    believes_leader(c)  ==>  server.owner == c and server.gen == c.gen

at every instant (LEASE_SAFETY, 120, otherwise).

Every handler runs on the whole batch at once. The server's fields live
on row 0 and are written there; a client's on its own row. Timer ids are
epoch-encoded (`tid = base + 4 * epoch[node]`).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from ..engine.machine import Machine, Outbox, make_payload, send_if, set_at, set_timer_if
from ..utils import take

SERVER = 0

# message types (payload[0])
M_GRANT = 1  # client -> server: grant/refresh my lease   [m, c, send_us]
M_GRANT_OK = 2  # server -> client                          [m, c, send_us]
M_CAMPAIGN = 3  # client -> server: try to become leader    [m, c, send_us]
M_WON = 4  # server -> client: you own generation g       [m, c, send_us, g]
M_LOST = 5  # server -> client: someone else leads
M_NO_LEASE = 6  # server -> client: grant a lease first
M_KA = 7  # client -> server: keepalive                 [m, c, send_us]
M_KA_OK = 8  # server -> client: lease extended            [m, c, send_us]
M_KA_ERR = 9  # server -> client: lease expired, stand down
M_PUT = 10  # leader -> server: revisioned write          [m, c, send_us, g]
M_PUT_OK = 11  # server -> client                           [m, c, send_us, rev]

# timer bases (tid = base + 4*epoch; engine-raw 0 == BOOT)
T_BOOT = 0
T_TICK = 1

LEASE_SAFETY = 120

TTL_US = 300_000
TICK_US = 100_000


@dataclasses.dataclass
class EtcdState:
    # server-owned (row 0; durable across a server restart)
    srv_rev: torch.Tensor  # int32[L, N] MVCC revision
    srv_gen: torch.Tensor  # int32[L, N] election generation
    srv_owner: torch.Tensor  # int32[L, N] current leader client, -1
    srv_lease_expiry: torch.Tensor  # int32[L, N] per-client lease expiry us (0 = none)
    # client-owned (volatile: reset on that client's restart)
    cl_has_lease: torch.Tensor  # bool[L, N] grant acked
    cl_deadline: torch.Tensor  # int32[L, N] local lease deadline (send-based)
    cl_leader: torch.Tensor  # bool[L, N] believes it leads...
    cl_gen: torch.Tensor  # int32[L, N] ...this generation
    cl_writes: torch.Tensor  # int32[L, N] acked writes
    cl_max_rev: torch.Tensor  # int32[L, N] highest revision observed
    # bookkeeping
    epoch: torch.Tensor  # int32[L, N] timer epoch (persistent)
    violated: torch.Tensor  # bool[L, N] server-detected safety breach


class EtcdMachine(Machine):
    """Honest leased-KV server and campaigning clients."""

    PAYLOAD_WIDTH = 5
    MAX_MSGS = 2  # a leader's tick sends a keepalive and a write
    MAX_TIMERS = 1
    state_type = EtcdState

    # the bug variants' knobs
    CHECK_OWNER_ON_CAMPAIGN = True  # False: the double-grant bug
    REVIVE_EXPIRED_LEASES = False  # True: lease resurrection (server side)
    EXTEND_DEADLINE_ON_WON = False  # True: the client lease-discipline bug

    def __init__(self, num_nodes: int = 4, target_gens: int = 3, target_writes: int = 10):
        self.NUM_NODES = num_nodes
        self.target_gens = target_gens
        self.target_writes = target_writes

    def init(self, rng_key) -> EtcdState:
        lanes, n, dev = rng_key.shape[0], self.NUM_NODES, rng_key.device
        z = torch.zeros((lanes, n), dtype=torch.int32, device=dev)
        f = torch.zeros((lanes, n), dtype=torch.bool, device=dev)
        return EtcdState(srv_rev=z, srv_gen=z, srv_owner=z - 1, srv_lease_expiry=z, cl_has_lease=f, cl_deadline=z,
                         cl_leader=f, cl_gen=z, cl_writes=z, cl_max_rev=z, epoch=z, violated=f)

    def init_node(self, nodes: EtcdState, i, rng_key) -> EtcdState:
        """The server's store survives a restart; a client loses its
        session state; epochs always survive."""
        return self.restart_if(nodes, i, torch.ones_like(i, dtype=torch.bool), rng_key)

    def durable_spec(self) -> EtcdState:
        """The server store is durable, client session state volatile;
        epochs and the ghost violation flag survive."""
        return EtcdState(
            srv_rev=True, srv_gen=True, srv_owner=True, srv_lease_expiry=True, cl_has_lease=False,
            cl_deadline=False, cl_leader=False, cl_gen=False, cl_writes=False, cl_max_rev=False, epoch=True,
            violated=True,
        )

    def restart_if(self, nodes: EtcdState, i, cond, rng_key) -> EtcdState:
        row = (torch.arange(self.NUM_NODES, device=i.device)[None, :] == i[:, None]) & (cond & (i != SERVER))[:, None]
        reset = {k: torch.where(row, 0, getattr(nodes, k)) for k in ("cl_deadline", "cl_gen", "cl_writes",
                                                                      "cl_max_rev")}
        return dataclasses.replace(
            nodes, cl_has_lease=nodes.cl_has_lease & ~row, cl_leader=nodes.cl_leader & ~row, **reset)

    # -- helpers --------------------------------------------------------------

    @staticmethod
    def _tid(epoch, base):
        return base + 4 * epoch

    def _srv(self, nodes: EtcdState, **updates) -> EtcdState:
        """Write per-lane values [L] into row 0 of the named fields."""
        row0 = (torch.arange(self.NUM_NODES, device=nodes.epoch.device) == SERVER)[None, :]
        return dataclasses.replace(nodes, **{k: torch.where(row0, v[:, None], getattr(nodes, k))
                                             for k, v in updates.items()})

    def _lazy_expire(self, nodes: EtcdState, cond, now_us) -> EtcdState:
        """Depose the current leader if its lease lapsed (the server's
        tick done lazily on server events)."""
        owner = nodes.srv_owner[:, SERVER]
        lapsed = cond & (owner >= 0) & (take(nodes.srv_lease_expiry, torch.clamp(owner, min=0)) <= now_us)
        # the key's deletion is a new revision (MVCC: deletes are writes)
        return self._srv(nodes, srv_owner=torch.where(lapsed, -1, owner),
                         srv_rev=nodes.srv_rev[:, SERVER] + lapsed.to(torch.int32))

    # -- timers ---------------------------------------------------------------

    def on_timer(self, nodes: EtcdState, node, timer_id, now_us, rand_u32) -> Tuple[EtcdState, Outbox]:
        outbox = self.empty_outbox(node.shape[0], node.device)
        is_boot = timer_id == T_BOOT
        t_epoch = torch.div(timer_id, 4, rounding_mode="floor")
        epoch = take(nodes.epoch, node)
        live = is_boot | (t_epoch == epoch)
        is_client = node != SERVER

        # BOOT: bump the epoch; clients arm their tick chain
        epoch = torch.where(is_boot & live, epoch + 1, epoch)
        is_tick = live & ~is_boot & (timer_id - 4 * t_epoch == T_TICK) & is_client
        # a jittered tick keeps client phases decorrelated across a lane
        jitter = (rand_u32[:, 0] % (TICK_US // 2)).to(torch.int32)
        outbox = set_timer_if(outbox, 0, (is_boot | is_tick) & is_client, TICK_US + jitter,
                              self._tid(epoch, T_TICK))

        # the local lease discipline: stop believing past the deadline
        still_believes = take(nodes.cl_leader, node) & (now_us < take(nodes.cl_deadline, node))
        has_lease = take(nodes.cl_has_lease, node)
        nodes = dataclasses.replace(nodes, epoch=set_at(nodes.epoch, node, epoch),
                                    cl_leader=set_at(nodes.cl_leader, node, still_believes))

        # one request a tick: no lease -> GRANT; a lease, not leader ->
        # CAMPAIGN; leader -> KA (and a revisioned PUT in slot 1)
        want_ka = is_tick & still_believes
        pay = lambda m, *rest: make_payload(self.PAYLOAD_WIDTH, m, node, now_us, *rest)  # noqa: E731
        outbox = send_if(outbox, 0, is_tick & ~has_lease, SERVER, pay(M_GRANT))
        outbox = send_if(outbox, 0, is_tick & has_lease & ~still_believes, SERVER, pay(M_CAMPAIGN))
        outbox = send_if(outbox, 0, want_ka, SERVER, pay(M_KA))
        outbox = send_if(outbox, 1, want_ka, SERVER, pay(M_PUT, take(nodes.cl_gen, node)))
        return nodes, outbox

    # -- messages -------------------------------------------------------------

    def on_message(self, nodes: EtcdState, node, src, payload, now_us, rand_u32) -> Tuple[EtcdState, Outbox]:
        outbox = self.empty_outbox(node.shape[0], node.device)
        mtype, client, send_us = payload[:, 0], payload[:, 1], payload[:, 2]
        pay = lambda *vals: make_payload(self.PAYLOAD_WIDTH, *vals)  # noqa: E731

        # ---------------- server ----------------
        srv = node == SERVER
        nodes = self._lazy_expire(nodes, srv, now_us)
        c = torch.clamp(client, 0, self.NUM_NODES - 1)
        lease_live = take(nodes.srv_lease_expiry, c) > now_us

        # GRANT: (re)issue the client's lease, receipt-based expiry
        is_grant = srv & (mtype == M_GRANT)
        nodes = dataclasses.replace(nodes, srv_lease_expiry=set_at(nodes.srv_lease_expiry, c, now_us + TTL_US,
                                                                   is_grant))
        outbox = send_if(outbox, 0, is_grant, c, pay(M_GRANT_OK, c, send_us))

        # CAMPAIGN: win iff no live owner (honest) and the caller's lease lives
        is_camp = srv & (mtype == M_CAMPAIGN)
        owner = nodes.srv_owner[:, SERVER]
        already_owner = owner == c
        seat_free = owner < 0 if self.CHECK_OWNER_ON_CAMPAIGN else torch.ones_like(is_camp)
        win_new = is_camp & lease_live & seat_free & ~already_owner
        # stealing a seat whose owner holds a live lease is the breach itself
        stolen = win_new & (owner >= 0)
        gen = nodes.srv_gen[:, SERVER] + win_new.to(torch.int32)
        nodes = self._srv(nodes, srv_gen=gen, srv_owner=torch.where(win_new, c, owner),
                          srv_rev=nodes.srv_rev[:, SERVER] + win_new.to(torch.int32),  # the key's creation
                          violated=nodes.violated[:, SERVER] | stolen)
        won = is_camp & lease_live & (already_owner | win_new)
        outbox = send_if(outbox, 0, won, c, pay(M_WON, c, send_us, gen))
        outbox = send_if(outbox, 0, is_camp & lease_live & ~won, c, pay(M_LOST, c, send_us))
        outbox = send_if(outbox, 0, is_camp & ~lease_live, c, pay(M_NO_LEASE, c, send_us))

        # KEEPALIVE: extend live leases; expired ones answer KA_ERR
        is_ka = srv & (mtype == M_KA)
        may_extend = lease_live | self.REVIVE_EXPIRED_LEASES
        nodes = dataclasses.replace(nodes, srv_lease_expiry=set_at(nodes.srv_lease_expiry, c, now_us + TTL_US,
                                                                   is_ka & may_extend))
        outbox = send_if(outbox, 0, is_ka & may_extend, c, pay(M_KA_OK, c, send_us))
        outbox = send_if(outbox, 0, is_ka & ~may_extend, c, pay(M_KA_ERR, c, send_us))

        # PUT: a revisioned write, from the current leader at the current generation only
        accept = (srv & (mtype == M_PUT) & (nodes.srv_owner[:, SERVER] == c)
                  & (payload[:, 3] == nodes.srv_gen[:, SERVER]))
        put_rev = nodes.srv_rev[:, SERVER] + accept.to(torch.int32)
        nodes = self._srv(nodes, srv_rev=put_rev)
        outbox = send_if(outbox, 0, accept, c, pay(M_PUT_OK, c, send_us, put_rev))

        # ---------------- client ----------------
        cl = node != SERVER
        # the lease discipline first (see on_timer)
        believes = take(nodes.cl_leader, node) & (now_us < take(nodes.cl_deadline, node))
        got_grant = cl & (mtype == M_GRANT_OK)
        got_won = cl & (mtype == M_WON)
        got_ka_ok = cl & (mtype == M_KA_OK)
        got_ka_err = cl & (mtype == M_KA_ERR)
        got_no_lease = cl & (mtype == M_NO_LEASE)
        got_put_ok = cl & (mtype == M_PUT_OK)
        # the send-based local deadline: only lease operations extend it
        # (EXTEND_DEADLINE_ON_WON is the bug that also extends it on M_WON)
        extend = got_grant | got_ka_ok
        if self.EXTEND_DEADLINE_ON_WON:
            extend = extend | got_won
        deadline = take(nodes.cl_deadline, node)
        has_lease = take(nodes.cl_has_lease, node)
        max_rev = take(nodes.cl_max_rev, node)
        row = {
            "cl_has_lease": torch.where(got_grant, True, torch.where(got_ka_err | got_no_lease, False, has_lease)),
            "cl_deadline": torch.where(extend, torch.maximum(deadline, send_us + TTL_US), deadline),
            "cl_leader": torch.where(got_won, True, torch.where(got_ka_err, False, believes)),
            "cl_gen": torch.where(got_won, payload[:, 3], take(nodes.cl_gen, node)),
            "cl_writes": take(nodes.cl_writes, node) + got_put_ok.to(torch.int32),
            "cl_max_rev": torch.where(got_put_ok, torch.maximum(max_rev, payload[:, 3]), max_rev),
        }
        return dataclasses.replace(nodes, **{k: set_at(getattr(nodes, k), node, v) for k, v in row.items()}), outbox

    # -- invariants / termination ---------------------------------------------

    def invariant(self, nodes: EtcdState, now_us):
        """Lease safety: every believed leadership is the server's
        current one, and the server never saw a double grant."""
        idx = torch.arange(self.NUM_NODES, device=now_us.device)
        believes = nodes.cl_leader & (now_us[:, None] < nodes.cl_deadline) & (idx != SERVER)
        owner_ok = (believes & (nodes.srv_owner[:, :1] == idx)
                    & (nodes.srv_gen[:, :1] == nodes.cl_gen))
        bad = (believes & ~owner_ok).any(dim=1) | nodes.violated[:, SERVER]
        return ~bad, torch.where(bad, LEASE_SAFETY, 0).to(torch.int32)

    def is_done(self, nodes: EtcdState, now_us):
        return (nodes.srv_gen[:, SERVER] >= self.target_gens) & (nodes.cl_writes.sum(dim=1) >= self.target_writes)

    def summary(self, nodes: EtcdState):
        return {
            "generations": nodes.srv_gen[:, SERVER],
            "revision": nodes.srv_rev[:, SERVER],
            "writes_acked": nodes.cl_writes.sum(dim=1, dtype=torch.int32),
        }

    def coverage_projection(self, nodes: EtcdState, now_us):
        """Election generation bucket (phase) x seat taken x believed
        leaders x leases held x write progress."""
        gen_b = nodes.srv_gen[:, SERVER].clamp(0, 7)
        owner_set = (nodes.srv_owner[:, SERVER] >= 0).to(torch.int32)
        believers = nodes.cl_leader.sum(dim=1, dtype=torch.int32).clamp(0, 3)
        leases = nodes.cl_has_lease.sum(dim=1, dtype=torch.int32).clamp(0, 3)
        writes_b = nodes.cl_writes.amax(dim=1).clamp(0, 7)
        word = gen_b | (owner_set << 3) | (believers << 4) | (leases << 6) | (writes_b << 8)
        return word.to(torch.int64) & 0xFFFFFFFF
