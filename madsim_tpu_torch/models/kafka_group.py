"""Kafka consumer-group machine as a lane-batched Machine.

The port of `madsim_tpu/models/kafka_group.py`. Node 0 is the broker and
group coordinator; nodes 1..C are the group's members. The topic has P
partitions of `log_len` records each (a record is (partition, offset)).
Members heartbeat the coordinator (an unknown member's heartbeat is a
join); a membership change bumps the generation and recomputes a range
assignment; a member adopting a new generation resumes each owned
partition from its committed offset; members fetch round-robin and
commit after each record, tagged with their generation; the coordinator
fences commits to the current generation's owner; a session timer
expires silent members.

Every handler runs on the whole batch at once. The coordinator's fields
(generation, member table, assignment, committed offsets, the ghost
consumed bitmap) live on row 0.

Invariants: COMMIT_REGRESS (131), an accepted commit moved an offset
backwards; LOST_RECORD (130), an offset below a committed one was never
consumed. `NoFencingGroupMachine` (`demo-nofencing-group`) accepts
commits from any generation, so partitioned zombies regress offsets.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from ..engine.machine import Machine, Outbox, make_payload, send_if, set_at, set_timer_if
from ..utils import take

COORD = 0

# messages
M_HB, M_HB_RESP, M_FETCH, M_FETCH_RESP, M_COMMIT = 1, 2, 3, 4, 5

# timers
T_BOOT, T_SESSION, T_HB, T_POLL = 0, 1, 2, 3

LOST_RECORD = 130
COMMIT_REGRESS = 131

HB_US = 40_000
POLL_US = 17_000
SESSION_US = 150_000
SESSION_CHECK_US = 50_000


@dataclasses.dataclass
class GroupState:
    # coordinator (row COORD); gen doubles as each member's adopted gen
    gen: torch.Tensor  # int32[L, N]
    joined: torch.Tensor  # bool[L, N] the coordinator's member table
    last_hb: torch.Tensor  # int32[L, N] the coordinator's last-heartbeat time (us)
    assign_member: torch.Tensor  # int32[L, N, P] owning node per partition (-1 none)
    committed: torch.Tensor  # int32[L, N, P] durable committed offsets (row COORD)
    commit_gen: torch.Tensor  # int32[L, N, P] generation of the last accepted commit
    bad_regress: torch.Tensor  # bool[L, N] spec flag (row COORD)
    # members
    my_assign: torch.Tensor  # bool[L, N, P]
    position: torch.Tensor  # int32[L, N, P] next offset to consume
    poll_rr: torch.Tensor  # int32[L, N] round-robin partition cursor
    # ghost (spec-only): which (partition, offset) was ever consumed
    consumed: torch.Tensor  # bool[L, N, P, LOG] (row COORD)


class KafkaGroupMachine(Machine):
    """One coordinator / broker and num_nodes - 1 group members."""

    MAX_MSGS = 1
    MAX_TIMERS = 2
    state_type = GroupState

    def __init__(self, num_nodes: int = 4, partitions: int = 2, log_len: int = 12):
        self.NUM_NODES = num_nodes
        self.P = partitions
        self.L = log_len
        self.PAYLOAD_WIDTH = max(5, 3 + partitions)

    def init(self, rng_key) -> GroupState:
        lanes, n, p, dev = rng_key.shape[0], self.NUM_NODES, self.P, rng_key.device
        i32 = {"dtype": torch.int32, "device": dev}
        zp = torch.zeros((lanes, n, p), **i32)
        return GroupState(
            gen=torch.zeros((lanes, n), **i32), joined=torch.zeros((lanes, n), dtype=torch.bool, device=dev),
            last_hb=torch.zeros((lanes, n), **i32), assign_member=zp - 1, committed=zp, commit_gen=zp,
            bad_regress=torch.zeros((lanes, n), dtype=torch.bool, device=dev),
            my_assign=torch.zeros((lanes, n, p), dtype=torch.bool, device=dev), position=zp,
            poll_rr=torch.zeros((lanes, n), **i32),
            consumed=torch.zeros((lanes, n, p, self.L), dtype=torch.bool, device=dev),
        )

    def restart_if(self, nodes: GroupState, i, cond, rng_key) -> GroupState:
        """A coordinator restart wipes the member table (every member
        must rejoin); generation, committed offsets and the ghost
        survive. A member restart loses its session state."""
        ids = torch.arange(self.NUM_NODES, device=i.device)[None, :]
        member_row = (ids == i[:, None]) & cond[:, None] & (ids != COORD)
        any_coord = (cond & (i == COORD))[:, None]
        return dataclasses.replace(
            nodes,
            joined=nodes.joined & ~any_coord,
            last_hb=torch.where(any_coord, 0, nodes.last_hb),
            gen=torch.where(member_row, 0, nodes.gen),
            my_assign=nodes.my_assign & ~member_row[:, :, None],
            position=torch.where(member_row[:, :, None], 0, nodes.position),
            poll_rr=torch.where(member_row, 0, nodes.poll_rr),
        )

    # -- coordinator helpers --------------------------------------------------

    def _rebalance_if(self, nodes: GroupState, cond) -> GroupState:
        """Where cond [L]: bump the generation and recompute the range
        assignment over the joined members."""
        p = self.P
        joined = nodes.joined
        k = joined.sum(dim=1, dtype=torch.int32)
        ranks = torch.cumsum(joined.to(torch.int32), dim=1) - 1  # rank among the joined
        targets = torch.arange(p, device=joined.device, dtype=torch.int32)[None, :] % torch.clamp(k, min=1)[:, None]
        match = joined[:, None, :] & (ranks[:, None, :] == targets[:, :, None])  # [L, P, N]
        assignment = torch.where(k[:, None] > 0, match.to(torch.uint8).argmax(dim=2).to(torch.int32), -1)
        row0 = (torch.arange(self.NUM_NODES, device=joined.device) == COORD)[None, :]
        return dataclasses.replace(
            nodes,
            gen=torch.where(row0 & cond[:, None], nodes.gen[:, :1] + 1, nodes.gen),
            assign_member=torch.where((row0 & cond[:, None])[:, :, None], assignment[:, None, :],
                                      nodes.assign_member),
        )

    def _commit_accepts(self, nodes: GroupState, src, c_gen, c_part) -> torch.Tensor:
        """The fencing predicate: the line NoFencingGroupMachine removes."""
        return (c_gen == nodes.gen[:, COORD]) & take(nodes.joined, src) & (
            take(nodes.assign_member[:, COORD], c_part) == src)

    # -- timers ---------------------------------------------------------------

    def on_timer(self, nodes: GroupState, node, timer_id, now_us, rand_u32) -> Tuple[GroupState, Outbox]:
        outbox = self.empty_outbox(node.shape[0], node.device)
        is_coord = node == COORD
        is_member = ~is_coord
        is_boot = timer_id == T_BOOT
        outbox = set_timer_if(outbox, 0, is_boot & is_coord, SESSION_CHECK_US, T_SESSION)
        outbox = set_timer_if(outbox, 0, is_boot & is_member, HB_US, T_HB)
        outbox = set_timer_if(outbox, 1, is_boot & is_member, POLL_US, T_POLL)

        # coordinator: expire silent members, rebalance if any left
        tick = (timer_id == T_SESSION) & is_coord
        expired = nodes.joined & (nodes.last_hb + SESSION_US < now_us[:, None])
        any_expired = tick & expired.any(dim=1)
        nodes = dataclasses.replace(nodes, joined=nodes.joined & ~(expired & any_expired[:, None]))
        nodes = self._rebalance_if(nodes, any_expired)
        outbox = set_timer_if(outbox, 0, tick, SESSION_CHECK_US, T_SESSION)

        # member: heartbeat (doubles as a join)
        hb = (timer_id == T_HB) & is_member
        outbox = send_if(outbox, 0, hb, COORD, make_payload(self.PAYLOAD_WIDTH, torch.full_like(node, M_HB)))
        outbox = set_timer_if(outbox, 0, hb, HB_US, T_HB)

        # member: fetch the next owned partition (round-robin cursor)
        poll = (timer_id == T_POLL) & is_member
        rr = take(nodes.poll_rr, node)
        owned = take(nodes.my_assign, node)  # [L, P]
        order = (rr[:, None] + torch.arange(self.P, device=node.device, dtype=torch.int32)) % self.P
        owned_rot = owned.gather(1, order.to(torch.int64))
        pick = order.gather(1, owned_rot.to(torch.uint8).argmax(dim=1, keepdim=True).to(torch.int64))[:, 0]
        position = take(take(nodes.position, node), pick)
        want = poll & owned.any(dim=1) & (position < self.L)
        outbox = send_if(outbox, 0, want, COORD, make_payload(self.PAYLOAD_WIDTH, M_FETCH, pick, position))
        nodes = dataclasses.replace(nodes, poll_rr=set_at(nodes.poll_rr, node, torch.where(poll, (pick + 1) % self.P,
                                                                                            rr)))
        outbox = set_timer_if(outbox, 0, poll, POLL_US, T_POLL)
        return nodes, outbox

    # -- messages -------------------------------------------------------------

    def on_message(self, nodes: GroupState, node, src, payload, now_us, rand_u32) -> Tuple[GroupState, Outbox]:
        outbox = self.empty_outbox(node.shape[0], node.device)
        mtype = payload[:, 0]
        is_coord = node == COORD
        pay = lambda *vals: make_payload(self.PAYLOAD_WIDTH, *vals)  # noqa: E731
        parts = torch.arange(self.P, device=node.device, dtype=torch.int32)
        row0 = (torch.arange(self.NUM_NODES, device=node.device) == COORD)[None, :]

        # coordinator: heartbeat / join
        hb = is_coord & (mtype == M_HB)
        new_member = hb & ~take(nodes.joined, src)
        nodes = dataclasses.replace(nodes, joined=set_at(nodes.joined, src, True, hb),
                                    last_hb=set_at(nodes.last_hb, src, now_us, hb))
        nodes = self._rebalance_if(nodes, new_member)
        mask_bits = ((nodes.assign_member[:, COORD] == src[:, None]).to(torch.int32) << parts).sum(dim=1)
        committed0 = nodes.committed[:, COORD]
        outbox = send_if(outbox, 0, hb, src, pay(M_HB_RESP, nodes.gen[:, COORD], mask_bits,
                                                 *committed0.unbind(1)))

        # coordinator: fetch -> the record's identity, if it exists
        fetch = is_coord & (mtype == M_FETCH)
        f_part, f_off = payload[:, 1], payload[:, 2]
        have = (f_off >= 0) & (f_off < self.L)
        outbox = send_if(outbox, 0, fetch & have, src, pay(M_FETCH_RESP, f_part, f_off))

        # coordinator: a fenced commit. In one generation the owner's
        # commits are cumulative (a lower offset is a reordered datagram,
        # absorbed by max); a commit from another generation overwrites,
        # which is where an unfenced zombie regresses the partition
        commit = is_coord & (mtype == M_COMMIT)
        c_gen, c_part, c_off = payload[:, 1], payload[:, 2], payload[:, 3]
        accept = commit & self._commit_accepts(nodes, src, c_gen, c_part)
        part = torch.clamp(c_part, 0, self.P - 1)
        cur = take(committed0, part)
        apply = accept & ((c_gen != take(nodes.commit_gen[:, COORD], part)) | (c_off > cur))
        regress = apply & (c_off < cur)
        at_part = (row0[:, :, None] & (parts == part[:, None])[:, None, :]) & apply[:, None, None]
        nodes = dataclasses.replace(
            nodes,
            committed=torch.where(at_part, c_off[:, None, None], nodes.committed),
            commit_gen=torch.where(at_part, c_gen[:, None, None], nodes.commit_gen),
            bad_regress=nodes.bad_regress | (row0 & (commit & regress)[:, None]),
        )

        # member: heartbeat response -> adopt the new generation and resume
        is_member = ~is_coord
        r_gen, r_mask = payload[:, 1], payload[:, 2]
        adopt = is_member & (mtype == M_HB_RESP) & (r_gen != take(nodes.gen, node))
        new_assign = ((r_mask[:, None] >> parts) & 1) != 0
        resume = payload[:, 3 : 3 + self.P]
        nodes = dataclasses.replace(
            nodes,
            gen=set_at(nodes.gen, node, r_gen, adopt),
            my_assign=set_at(nodes.my_assign, node, new_assign, adopt),
            position=set_at(nodes.position, node, resume, adopt),
        )

        # member: a fetched record -> consume (ghost) and auto-commit
        fr = is_member & (mtype == M_FETCH_RESP)
        g_part, g_off = payload[:, 1], payload[:, 2]
        g_part_c = torch.clamp(g_part, 0, self.P - 1)
        my_pos = take(nodes.position, node)  # [L, P]
        took = fr & take(take(nodes.my_assign, node), g_part_c) & (g_off == take(my_pos, g_part_c))
        # the ghost consumed bitmap lives on the coordinator's row
        off_mask = torch.arange(self.L, device=node.device) == torch.clamp(g_off, 0, self.L - 1)[:, None]
        part_mask = parts == g_part_c[:, None]
        ghost = (took[:, None, None, None] & row0[:, :, None, None] & part_mask[:, None, :, None]
                 & off_mask[:, None, None, :])
        nodes = dataclasses.replace(
            nodes,
            consumed=nodes.consumed | ghost,
            position=set_at(nodes.position, node, set_at(my_pos, g_part_c, g_off + 1, took)),
        )
        outbox = send_if(outbox, 0, took, COORD, pay(M_COMMIT, take(nodes.gen, node), g_part_c, g_off + 1))
        return nodes, outbox

    # -- invariants / results --------------------------------------------------

    def invariant(self, nodes: GroupState, now_us):
        committed = nodes.committed[:, COORD]  # [L, P]
        in_range = ((committed >= 0) & (committed <= self.L)).all(dim=1)
        below = torch.arange(self.L, device=committed.device) < committed[:, :, None]  # [L, P, LOG]
        all_consumed = (nodes.consumed[:, COORD] | ~below).flatten(1).all(dim=1)
        lost = ~(in_range & all_consumed)
        regress = nodes.bad_regress[:, COORD]
        code = torch.where(regress, COMMIT_REGRESS, torch.where(lost, LOST_RECORD, 0))
        return ~(lost | regress), code.to(torch.int32)

    def is_done(self, nodes: GroupState, now_us):
        return (nodes.committed[:, COORD] >= self.L).all(dim=1)

    def summary(self, nodes: GroupState):
        return {
            "committed": nodes.committed[:, COORD],
            "generation": nodes.gen[:, COORD],
            "members": nodes.joined.sum(dim=1, dtype=torch.int32),
        }


class NoFencingGroupMachine(KafkaGroupMachine):
    """Bug variant: the coordinator accepts commits from any generation,
    so a partitioned member's stale commit regresses a committed offset
    (COMMIT_REGRESS)."""

    def _commit_accepts(self, nodes: GroupState, src, c_gen, c_part) -> torch.Tensor:
        return torch.ones_like(src, dtype=torch.bool)
