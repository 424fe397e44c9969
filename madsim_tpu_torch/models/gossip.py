"""Quorum-committed epidemic broadcast at gossip scale, as a lane-batched
Machine.

The port of `madsim_tpu/models/gossip.py`. R rumors, rumor r originated
by node r % N at a staggered inject time; every node runs an
anti-entropy tick (push one random held rumor to one random peer). The
first receipt of a rumor stores it, acks the origin and forwards it to
FANOUT random peers with a hop budget; a duplicate receipt acks again.
The origin commits a rumor once distinct ackers reach a majority.

Every handler runs on the whole batch at once: `[L, N, ...]` node
tensors and `[L]` node indices; the per-lane rank and modulus of the
anti-entropy pick are batched over `[L, R]`.

Invariant: COMMIT_BELOW_QUORUM (160), a committed rumor held by fewer
than a quorum of nodes. The rumor store is durable, so the holder count
only grows and the check is exact at the commit event.

Bug variant: `DUP_ACK_COUNT`, the origin counts every ack instead of
one per acker, and so commits below quorum.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from ..engine.machine import Machine, Outbox, make_payload, send_if, set_at, set_timer_if
from ..ops import u32
from ..utils import take

M_RUMOR = 1
M_ACK = 2

COMMIT_BELOW_QUORUM = 160

GOSSIP_US = 50_000  # anti-entropy tick
INJECT_US = 150_000  # stagger between rumor injections
HOP_BUDGET = 4  # forward TTL on first receipt
FANOUT_MIX = 0x9E3779B9  # the inject fan-out's per-slot salt of one random word


@dataclasses.dataclass
class GossipState:
    holds: torch.Tensor  # bool[L, N, R] durable rumor store
    committed: torch.Tensor  # bool[L, N, R] the origin's commit flag (row = origin)
    ack_cnt: torch.Tensor  # int32[L, N, R] the origin's ack tally
    acked_by: torch.Tensor  # bool[L, N, R, N] the origin's distinct-acker table
    epoch: torch.Tensor  # int32[L, N] timer epoch


class GossipMachine(Machine):
    """N-node quorum broadcast (N = 33 by default, past one 30-bit mask word)."""

    PAYLOAD_WIDTH = 4
    MAX_MSGS = 4  # FANOUT forwards + 1 ack
    MAX_TIMERS = 1
    FANOUT = 3
    state_type = GossipState

    DUP_ACK_COUNT = False

    def __init__(self, num_nodes: int = 33, rumors: int = 6):
        self.NUM_NODES = num_nodes
        self.R = rumors
        self.QUORUM = num_nodes // 2 + 1

    def init(self, rng_key) -> GossipState:
        lanes, n, r = rng_key.shape[0], self.NUM_NODES, self.R
        dev = rng_key.device
        return GossipState(
            holds=torch.zeros((lanes, n, r), dtype=torch.bool, device=dev),
            committed=torch.zeros((lanes, n, r), dtype=torch.bool, device=dev),
            ack_cnt=torch.zeros((lanes, n, r), dtype=torch.int32, device=dev),
            acked_by=torch.zeros((lanes, n, r, n), dtype=torch.bool, device=dev),
            epoch=torch.zeros((lanes, n), dtype=torch.int32, device=dev),
        )

    def restart_if(self, nodes: GossipState, i, cond, rng_key) -> GossipState:
        """Everything is durable (the quorum check needs the holder count
        monotone): a restart only re-fires BOOT."""
        return nodes

    def _origin(self, r):
        return torch.remainder(r, self.NUM_NODES)

    def _cells(self, node, rumor):
        """bool[L, N, R]: the (node, rumor) cell of each lane."""
        n_ix = torch.arange(self.NUM_NODES, device=node.device)
        r_ix = torch.arange(self.R, device=node.device)
        return (n_ix == node[:, None])[:, :, None] & (r_ix == rumor[:, None])[:, None, :]

    # -- timers -------------------------------------------------------------------

    def on_timer(self, nodes: GossipState, node, timer_id, now_us, rand_u32) -> Tuple[GossipState, Outbox]:
        outbox = self.empty_outbox(node.shape[0], node.device)
        n = self.NUM_NODES
        is_boot = timer_id == 0
        t_epoch = torch.div(timer_id - 1, 2, rounding_mode="floor")
        epoch = take(nodes.epoch, node)
        live = is_boot | (t_epoch == epoch)
        epoch = torch.where(is_boot & live, epoch + 1, epoch)
        nodes = dataclasses.replace(nodes, epoch=set_at(nodes.epoch, node, epoch))
        tid = 1 + 2 * epoch

        # inject: the earliest owned, due, not yet held rumor (the origin
        # stores it and fans out; its own copy counts toward the quorum)
        rumors = torch.arange(self.R, dtype=torch.int32, device=node.device)
        held = take(nodes.holds, node)  # [L, R]
        owned = self._origin(rumors) == node[:, None]
        due = now_us[:, None] >= rumors * INJECT_US
        pending = owned & due & ~held
        inject = live & pending.any(dim=1)
        rumor_inj = pending.to(torch.uint8).argmax(dim=1).to(torch.int32)

        # anti-entropy: push one random held rumor to one random peer
        n_held = held.sum(dim=1, dtype=torch.int32)
        pick_rank = (rand_u32[:, 0] % n_held.clamp(min=1)).to(torch.int32)
        ranks = torch.cumsum(held.to(torch.int32), dim=1) - 1
        rumor_push = (held & (ranks == pick_rank[:, None])).to(torch.uint8).argmax(dim=1).to(torch.int32)
        push = live & ~inject & (n_held > 0)
        peer = torch.remainder(node + 1 + (rand_u32[:, 1] % (n - 1)).to(torch.int32), n)

        rumor_out = torch.where(inject, rumor_inj, rumor_push)
        hop = torch.where(inject, HOP_BUDGET, 1)
        inj_row = self._cells(node, rumor_inj) & inject[:, None, None]
        # the origin's own copy is the tally's first member, in the acker
        # table so a self-ack cannot count twice
        inj_cell = inj_row[:, :, :, None] & (torch.arange(n, device=node.device) == node[:, None])[:, None, None, :]
        nodes = dataclasses.replace(
            nodes,
            holds=nodes.holds | inj_row,
            ack_cnt=torch.where(inj_row, 1, nodes.ack_cnt),
            acked_by=nodes.acked_by | inj_cell,
        )
        # an inject fans out to FANOUT peers; a plain tick pushes to one
        rumor_msg = make_payload(self.PAYLOAD_WIDTH, M_RUMOR, rumor_out, hop)
        for s in range(self.FANOUT):
            mix = (rand_u32[:, 2] + ((s * FANOUT_MIX) & u32.MASK)) & u32.MASK
            dst = torch.remainder(node + 1 + (mix % (n - 1)).to(torch.int32), n)
            want = inject if s > 0 else (inject | push)
            outbox = send_if(outbox, s, want, torch.where(inject, dst, peer), rumor_msg)
        jitter = (rand_u32[:, 3] % (GOSSIP_US // 4)).to(torch.int32)
        outbox = set_timer_if(outbox, 0, live, GOSSIP_US + jitter, tid)
        return nodes, outbox

    # -- messages -------------------------------------------------------------------

    def on_message(self, nodes: GossipState, node, src, payload, now_us, rand_u32) -> Tuple[GossipState, Outbox]:
        outbox = self.empty_outbox(node.shape[0], node.device)
        mtype, hop = payload[:, 0], payload[:, 2]
        n = self.NUM_NODES
        rumor = payload[:, 1].clamp(0, self.R - 1)
        cell = self._cells(node, rumor)

        # rumor receipt: store on first sight, always ack the origin
        is_rumor = mtype == M_RUMOR
        first = is_rumor & ~take(take(nodes.holds, node), rumor)
        nodes = dataclasses.replace(nodes, holds=nodes.holds | (cell & is_rumor[:, None, None]))
        origin = self._origin(rumor)
        outbox = send_if(outbox, 3, is_rumor, origin, make_payload(self.PAYLOAD_WIDTH, M_ACK, rumor, 0))
        # forward on first receipt while the hop budget lasts
        fwd = first & (hop > 0)
        forward = make_payload(self.PAYLOAD_WIDTH, M_RUMOR, rumor, hop - 1)
        for s in range(self.FANOUT):
            dst = torch.remainder(node + 1 + (rand_u32[:, s] % (n - 1)).to(torch.int32), n)
            outbox = send_if(outbox, s, fwd, dst, forward)

        # ack receipt at the origin: one per acker (unless DUP_ACK_COUNT),
        # tally, commit at the quorum
        is_ack = (mtype == M_ACK) & (origin == node)
        known = take(take(take(nodes.acked_by, node), rumor), src.clamp(0, n - 1))
        count_it = is_ack & (~known | self.DUP_ACK_COUNT)
        acker = cell[:, :, :, None] & (torch.arange(n, device=node.device) == src[:, None])[:, None, None, :]
        new_cnt = take(take(nodes.ack_cnt, node), rumor) + 1
        commit_now = count_it & (new_cnt >= self.QUORUM)
        nodes = dataclasses.replace(
            nodes,
            acked_by=nodes.acked_by | (acker & is_ack[:, None, None, None]),
            ack_cnt=torch.where(cell & count_it[:, None, None], new_cnt[:, None, None], nodes.ack_cnt),
            committed=nodes.committed | (cell & commit_now[:, None, None]),
        )
        return nodes, outbox

    # -- invariants / results --------------------------------------------------

    def _committed(self, nodes: GossipState):
        """bool[L, R]: each rumor's commit flag, on its origin's row."""
        r = torch.arange(self.R, device=nodes.holds.device)
        return nodes.committed[:, self._origin(r), r]

    def invariant(self, nodes: GossipState, now_us):
        holders = nodes.holds.sum(dim=1, dtype=torch.int32)  # [L, R]
        below = (self._committed(nodes) & (holders < self.QUORUM)).any(dim=1)
        return ~below, torch.where(below, COMMIT_BELOW_QUORUM, 0).to(torch.int32)

    def is_done(self, nodes: GossipState, now_us):
        return self._committed(nodes).all(dim=1) & nodes.holds.flatten(1).all(dim=1)

    def summary(self, nodes: GossipState):
        r = torch.arange(self.R, device=nodes.holds.device)
        return {
            "committed": self._committed(nodes).sum(dim=1, dtype=torch.int32),
            "coverage": nodes.holds.flatten(1).sum(dim=1, dtype=torch.int32),
            "acks": nodes.ack_cnt[:, self._origin(r), r].sum(dim=1, dtype=torch.int32),
        }


class DupAckGossip(GossipMachine):
    DUP_ACK_COUNT = True  # the quorum tally counts duplicate acks
