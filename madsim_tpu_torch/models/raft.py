"""Raft leader election + log replication as a lane-batched Machine.

The port of `madsim_tpu/models/raft.py` (the MadRaft-class flagship):
single-entry AppendEntries, randomized election timeouts, heartbeats,
client appends as a leader-side timer; term/votedFor/log survive
restarts, volatile state resets. Every handler runs on the whole batch
at once: `[L, N, ...]` node tensors, `[L]` node indices, and masked
selects where the reference vmaps a per-lane function. The reference's
`lax.switch` over message types becomes all four branches computed and
selected per lane by type. Each handler touches only the handling
node's row, so it reads that row once and writes it back once.

On-device invariants (checked after every event):
  * ElectionSafety (code 101): at most one leader per term
  * LogMatching on committed prefixes (code 102)

Timer ids are epoch-encoded (`tid = base + 4*epoch[node]`).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from ..engine.machine import (
    Machine, Outbox, make_payload, node_row, send_all_if, send_if, set_at, set_timer_if, write_row,
)
from ..ops.u32 import popcount
from ..utils import take, tree_where

# roles
FOLLOWER, CANDIDATE, LEADER = 0, 1, 2

# message types (payload[0])
M_RV, M_VOTE, M_AE, M_AER = 1, 2, 3, 4

# timer bases (payload[0] = base + 4*epoch; base 0 = engine BOOT)
T_BOOT, T_ELECTION, T_HEARTBEAT, T_CLIENT = 0, 1, 2, 3

# invariant failure codes
ELECTION_SAFETY = 101
LOG_MATCHING = 102

ELECTION_MIN_US = 150_000
ELECTION_MAX_US = 300_000
HEARTBEAT_US = 50_000
CLIENT_APPEND_US = 30_000


@dataclasses.dataclass
class RaftState:
    # persistent (survives restart: stable storage)
    term: torch.Tensor  # int32[L, N]
    voted_for: torch.Tensor  # int32[L, N], -1 = none
    log_term: torch.Tensor  # int32[L, N, CAP+1]; slot 0 is the 0-sentinel
    log_len: torch.Tensor  # int32[L, N]
    epoch: torch.Tensor  # int32[L, N] timer epoch (persistent, bumped at BOOT)
    # volatile
    role: torch.Tensor  # int32[L, N]
    votes: torch.Tensor  # int32[L, N]
    elec_deadline: torch.Tensor  # int32[L, N] us
    commit: torch.Tensor  # int32[L, N]
    next_idx: torch.Tensor  # int32[L, N, N]
    match_idx: torch.Tensor  # int32[L, N, N]


class RaftMachine(Machine):
    PAYLOAD_WIDTH = 6
    MAX_TIMERS = 2
    state_type = RaftState

    # The four seeded-bug flags of the reference model (see its
    # docstrings): follower commit capped at its whole log length
    # (Raft §5.3 overcommit), commit quorum one short, commitIndex
    # persisted instead of the log, and a per-message vote counter
    # instead of a voter bitmask.
    COMMIT_TO_LOG_LEN = False
    QUORUM_OFF_BY_ONE = False
    PERSIST_COMMIT_NOT_LOG = False
    DUP_VOTE_COUNT = False

    def __init__(self, num_nodes: int = 5, log_capacity: int = 8):
        if num_nodes > 31:
            raise ValueError(
                "RaftMachine tracks granting voters as an int32 bitmask "
                "(dup-safe tally, Raft §5.2); num_nodes must be <= 31"
            )
        self.NUM_NODES = num_nodes
        self.MAX_MSGS = num_nodes - 1
        self.log_capacity = log_capacity
        self.majority = num_nodes // 2 + 1

    # -- state ---------------------------------------------------------------

    def init(self, rng_key) -> RaftState:
        lanes, n, cap = rng_key.shape[0], self.NUM_NODES, self.log_capacity
        kw = {"dtype": torch.int32, "device": rng_key.device}
        z = torch.zeros((lanes, n), **kw)
        return RaftState(
            term=z,
            voted_for=torch.full((lanes, n), -1, **kw),
            log_term=torch.zeros((lanes, n, cap + 1), **kw),
            log_len=z,
            epoch=z,
            role=z,
            votes=z,
            elec_deadline=z,
            commit=z,
            next_idx=torch.ones((lanes, n, n), **kw),
            match_idx=torch.zeros((lanes, n, n), **kw),
        )

    def init_node(self, nodes: RaftState, i, rng_key) -> RaftState:
        """Restart: persistent state survives, volatile resets."""
        return self.restart_if(nodes, i, torch.ones_like(i, dtype=torch.bool), rng_key)

    def durable_spec(self) -> RaftState:
        """Crash-with-amnesia contract: term, votedFor and the log are
        stable storage, the timer epoch survives, the rest is volatile;
        under it the strict wipe equals `restart_if`. The
        PERSIST_COMMIT_NOT_LOG bug swaps the log and commitIndex."""
        log_durable = not self.PERSIST_COMMIT_NOT_LOG
        return RaftState(
            term=True, voted_for=True, log_term=log_durable, log_len=log_durable, epoch=True,
            role=False, votes=False, elec_deadline=False, commit=bool(self.PERSIST_COMMIT_NOT_LOG),
            next_idx=False, match_idx=False,
        )

    def restart_if(self, nodes: RaftState, i, cond, rng_key) -> RaftState:
        """Masked restart: cond folds into the row mask."""
        row = (torch.arange(self.NUM_NODES, device=i.device)[None, :] == i[:, None]) & cond[:, None]
        return dataclasses.replace(
            nodes,
            role=torch.where(row, FOLLOWER, nodes.role),
            votes=torch.where(row, 0, nodes.votes),
            elec_deadline=torch.where(row, 0, nodes.elec_deadline),
            commit=torch.where(row, 0, nodes.commit),
            next_idx=torch.where(row[:, :, None], 1, nodes.next_idx),
            match_idx=torch.where(row[:, :, None], 0, nodes.match_idx),
        )

    # -- helpers -------------------------------------------------------------

    def _peers(self, node):
        """[L, NUM_NODES-1]: the other node ids of each lane's node."""
        n = self.NUM_NODES
        offs = torch.arange(1, n, device=node.device, dtype=torch.int32)
        return (node.to(torch.int32)[:, None] + offs) % n

    def _rand_timeout(self, rand_word):
        span = ELECTION_MAX_US - ELECTION_MIN_US
        return ELECTION_MIN_US + (rand_word % span).to(torch.int32)

    def _pay(self, *vals):
        return make_payload(self.PAYLOAD_WIDTH, *vals)

    @staticmethod
    def _tid(r, base):
        return base + 4 * r["epoch"]

    def _vote_init(self, node):
        one = torch.ones_like(node, dtype=torch.int32)
        if self.DUP_VOTE_COUNT:
            return one
        return torch.bitwise_left_shift(one, node.to(torch.int32))

    def _vote_add(self, votes, src, counts):
        if self.DUP_VOTE_COUNT:
            return votes + counts.to(torch.int32)
        bit = torch.bitwise_left_shift(torch.ones_like(votes), src.to(torch.int32))
        return torch.where(counts, votes | bit, votes)

    def _vote_count(self, votes):
        if self.DUP_VOTE_COUNT:
            return votes
        return popcount(votes)

    # Every handler reads and writes only the handling node's row, so it
    # reads that row once (`node_row`: [L] scalars, the [L, CAP+1] log
    # row and the [L, N] next/match rows), computes on it as the
    # reference computes on `nodes.x[node]`, and writes it back once.

    # -- timers --------------------------------------------------------------

    def on_timer(self, nodes: RaftState, node, timer_id, now_us, rand_u32) -> Tuple[RaftState, Outbox]:
        r = node_row(nodes, node)
        outbox = self.empty_outbox(node.shape[0], node.device)
        base = timer_id % 4
        t_epoch = torch.div(timer_id, 4, rounding_mode="floor")
        # BOOT (engine-raw id 0) always valid; others require current epoch
        is_boot = timer_id == T_BOOT
        live = is_boot | (t_epoch == r["epoch"])
        boot = is_boot & live

        # ---- BOOT: bump epoch, arm election + client timers ----
        r["epoch"] = torch.where(boot, r["epoch"] + 1, r["epoch"])
        timeout = self._rand_timeout(rand_u32[:, 0])
        r["elec_deadline"] = torch.where(boot, now_us + timeout, r["elec_deadline"])
        outbox = set_timer_if(outbox, 0, boot, timeout, self._tid(r, T_ELECTION))
        outbox = set_timer_if(outbox, 1, boot, CLIENT_APPEND_US, self._tid(r, T_CLIENT))

        # ---- ELECTION ----
        is_elec = live & (base == T_ELECTION) & ~is_boot
        not_yet = now_us < r["elec_deadline"]
        # re-arm at the postponed deadline (heartbeats push it forward)
        rearm_delay = torch.clamp(r["elec_deadline"] - now_us, min=1)
        outbox = set_timer_if(outbox, 0, is_elec & not_yet, rearm_delay, self._tid(r, T_ELECTION))
        start = is_elec & ~not_yet & (r["role"] != LEADER)
        timeout2 = self._rand_timeout(rand_u32[:, 1])
        r["term"] = torch.where(start, r["term"] + 1, r["term"])
        r["role"] = torch.where(start, CANDIDATE, r["role"])
        r["voted_for"] = torch.where(start, node.to(torch.int32), r["voted_for"])
        r["votes"] = torch.where(start, self._vote_init(node), r["votes"])
        r["elec_deadline"] = torch.where(start, now_us + timeout2, r["elec_deadline"])
        outbox = set_timer_if(outbox, 0, is_elec & ~not_yet, timeout2, self._tid(r, T_ELECTION))
        last_term = take(r["log_term"], r["log_len"])
        rv = self._pay(M_RV, r["term"], node, r["log_len"], last_term)
        peers = self._peers(node)
        outbox = send_all_if(outbox, start, peers, rv)

        # ---- HEARTBEAT (leader replicates) ----
        is_hb = live & (base == T_HEARTBEAT) & ~is_boot
        is_leader = r["role"] == LEADER
        do_hb = is_hb & is_leader
        outbox = set_timer_if(outbox, 1, do_hb, HEARTBEAT_US, self._tid(r, T_HEARTBEAT))
        # one AppendEntries per peer slot, all slots at once ([L, M])
        ni = take(r["next_idx"], peers)
        prev_idx = ni - 1
        prev_term = take(r["log_term"], prev_idx)
        has_entry = ni <= r["log_len"][:, None]
        entry_term = torch.where(has_entry, take(r["log_term"], torch.clamp(ni, max=self.log_capacity)), 0)
        ae = self._pay(M_AE, r["term"][:, None], prev_idx, prev_term, entry_term, r["commit"][:, None])
        outbox = send_all_if(outbox, do_hb, peers, ae)

        # ---- CLIENT (leader appends an entry) ----
        is_client = live & (base == T_CLIENT) & ~is_boot
        outbox = set_timer_if(outbox, 1, is_client & ~do_hb, CLIENT_APPEND_US, self._tid(r, T_CLIENT))
        can_append = is_client & is_leader & (r["log_len"] < self.log_capacity)
        new_len = r["log_len"] + 1
        r["log_term"] = torch.where(
            can_append[:, None],
            set_at(r["log_term"], torch.clamp(new_len, max=self.log_capacity), r["term"]),
            r["log_term"],
        )
        r["log_len"] = torch.where(can_append, new_len, r["log_len"])
        r["match_idx"] = torch.where(can_append[:, None], set_at(r["match_idx"], node, new_len), r["match_idx"])
        return write_row(nodes, node, r), outbox

    # -- messages ------------------------------------------------------------

    @staticmethod
    def _step_down(r, t):
        """Adopt a newer term: follower, no vote."""
        newer = t > r["term"]
        r["term"] = torch.where(newer, t, r["term"])
        r["role"] = torch.where(newer, FOLLOWER, r["role"])
        r["voted_for"] = torch.where(newer, -1, r["voted_for"])

    def _rv_branch(self, r, node, src, payload, now_us, rand_u32):
        outbox = self.empty_outbox(node.shape[0], node.device)
        t, cand, last_idx, last_term = payload[:, 1], payload[:, 2], payload[:, 3], payload[:, 4]
        self._step_down(r, t)
        my_last = r["log_len"]
        my_last_term = take(r["log_term"], my_last)
        log_ok = (last_term > my_last_term) | ((last_term == my_last_term) & (last_idx >= my_last))
        can_vote = (r["voted_for"] == -1) | (r["voted_for"] == cand)
        grant = (t == r["term"]) & can_vote & log_ok
        r["voted_for"] = torch.where(grant, cand, r["voted_for"])
        r["elec_deadline"] = torch.where(
            grant, now_us + self._rand_timeout(rand_u32[:, 0]), r["elec_deadline"]
        )
        vote = self._pay(M_VOTE, r["term"], grant.to(torch.int32))
        return r, send_if(outbox, 0, torch.ones_like(grant), src, vote)

    def _vote_branch(self, r, node, src, payload, now_us, rand_u32):
        outbox = self.empty_outbox(node.shape[0], node.device)
        t, granted = payload[:, 1], payload[:, 2]
        self._step_down(r, t)
        counts = (t == r["term"]) & (r["role"] == CANDIDATE) & (granted == 1)
        new_votes = self._vote_add(r["votes"], src, counts)
        win = counts & (self._vote_count(new_votes) >= self.majority) & (r["role"] == CANDIDATE)
        r["votes"] = new_votes
        r["role"] = torch.where(win, LEADER, r["role"])
        # leader volatile state
        n = self.NUM_NODES
        r["next_idx"] = torch.where(win[:, None], (r["log_len"] + 1)[:, None].expand(-1, n), r["next_idx"])
        own = set_at(torch.zeros_like(r["match_idx"]), node, r["log_len"])
        r["match_idx"] = torch.where(win[:, None], own, r["match_idx"])
        # announce leadership immediately with heartbeats + arm timer
        peers = self._peers(node)
        prev_term = take(r["log_term"], r["log_len"])
        ae = self._pay(M_AE, r["term"], r["log_len"], prev_term, 0, r["commit"])
        outbox = send_all_if(outbox, win, peers, ae)
        outbox = set_timer_if(outbox, 0, win, HEARTBEAT_US, self._tid(r, T_HEARTBEAT))
        return r, outbox

    def _ae_branch(self, r, node, src, payload, now_us, rand_u32):
        outbox = self.empty_outbox(node.shape[0], node.device)
        t, prev_idx, prev_term, entry_term, leader_commit = (payload[:, k] for k in range(1, 6))
        stale = t < r["term"]
        newer = t > r["term"]
        r["term"] = torch.where(newer, t, r["term"])
        r["role"] = torch.where(~stale, FOLLOWER, r["role"])
        r["voted_for"] = torch.where(newer, -1, r["voted_for"])
        r["elec_deadline"] = torch.where(
            ~stale, now_us + self._rand_timeout(rand_u32[:, 0]), r["elec_deadline"]
        )
        log_len = r["log_len"]
        log_ok = (prev_idx <= log_len) & (take(r["log_term"], prev_idx) == prev_term)
        ok = ~stale & log_ok
        has_entry = entry_term > 0
        slot = torch.clamp(prev_idx + 1, max=self.log_capacity)
        existing_matches = (log_len >= prev_idx + 1) & (take(r["log_term"], slot) == entry_term)
        append = ok & has_entry
        new_len = torch.where(
            append,
            torch.where(existing_matches, torch.maximum(log_len, prev_idx + 1), prev_idx + 1),
            log_len,
        )
        # Raft §5.3: commit caps at the last entry this AE verified
        last_new = prev_idx + has_entry.to(torch.int32)
        commit_cap = new_len if self.COMMIT_TO_LOG_LEN else torch.minimum(last_new, new_len)
        r["log_term"] = torch.where(append[:, None], set_at(r["log_term"], slot, entry_term), r["log_term"])
        r["log_len"] = new_len
        r["commit"] = torch.where(
            ok, torch.maximum(r["commit"], torch.minimum(leader_commit, commit_cap)), r["commit"]
        )
        match = torch.where(has_entry, prev_idx + 1, prev_idx)
        aer = self._pay(M_AER, r["term"], ok.to(torch.int32), match)
        return r, send_if(outbox, 0, torch.ones_like(ok), src, aer)

    def _aer_branch(self, r, node, src, payload, now_us, rand_u32):
        outbox = self.empty_outbox(node.shape[0], node.device)
        t, success, midx = payload[:, 1], payload[:, 2], payload[:, 3]
        self._step_down(r, t)
        is_lead = (r["role"] == LEADER) & (t == r["term"])
        good = is_lead & (success == 1)
        new_match = torch.maximum(take(r["match_idx"], src), midx)
        back = torch.clamp(take(r["next_idx"], src) - 1, min=1)
        r["match_idx"] = torch.where(good[:, None], set_at(r["match_idx"], src, new_match), r["match_idx"])
        r["next_idx"] = torch.where(
            good[:, None],
            set_at(r["next_idx"], src, new_match + 1),
            torch.where((is_lead & (success == 0))[:, None], set_at(r["next_idx"], src, back), r["next_idx"]),
        )
        # advance commit: highest idx replicated on a majority with an
        # entry from the current term (Raft §5.4.2)
        idxs = torch.arange(self.log_capacity + 1, device=node.device, dtype=torch.int32)
        cnt = (r["match_idx"][:, None, :] >= idxs[None, :, None]).sum(dim=2)  # [L, CAP+1]
        quorum = self.majority - 1 if self.QUORUM_OFF_BY_ONE else self.majority
        committable = (
            (cnt >= quorum) & (r["log_term"] == r["term"][:, None]) & (idxs >= 1)
            & (idxs[None, :] <= r["log_len"][:, None])
        )
        best = torch.where(committable, idxs, 0).amax(dim=1)
        r["commit"] = torch.where(good, torch.maximum(r["commit"], best), r["commit"])
        return r, outbox

    def on_message(self, nodes: RaftState, node, src, payload, now_us, rand_u32) -> Tuple[RaftState, Outbox]:
        row = node_row(nodes, node)
        branch = torch.clamp(payload[:, 0] - 1, 0, 3)
        rv, vote, ae, aer = (
            f(dict(row), node, src, payload, now_us, rand_u32)
            for f in (self._rv_branch, self._vote_branch, self._ae_branch, self._aer_branch)
        )
        r, outbox = tree_where(branch == 0, rv, tree_where(branch == 1, vote, tree_where(branch == 2, ae, aer)))
        return write_row(nodes, node, r), outbox

    # -- invariants / results ------------------------------------------------

    def invariant(self, nodes: RaftState, now_us):
        n = self.NUM_NODES
        is_lead = nodes.role == LEADER
        same_term = nodes.term[:, :, None] == nodes.term[:, None, :]
        off_diag = ~torch.eye(n, dtype=torch.bool, device=is_lead.device)
        both_lead = is_lead[:, :, None] & is_lead[:, None, :] & off_diag
        elec_viol = (both_lead & same_term).flatten(1).any(dim=1)

        # committed prefixes agree per POSITION: among the nodes whose
        # commit reaches k, the min and max log term at k must be equal
        idxs = torch.arange(self.log_capacity + 1, device=is_lead.device, dtype=torch.int32)
        committed = (idxs >= 1) & (idxs[None, None, :] <= nodes.commit[:, :, None])
        big = 2**31 - 1
        t_min = torch.where(committed, nodes.log_term, big).amin(dim=1)
        t_max = torch.where(committed, nodes.log_term, -big).amax(dim=1)
        log_viol = (t_max > t_min).any(dim=1)

        ok = ~(elec_viol | log_viol)
        code = torch.where(elec_viol, ELECTION_SAFETY, torch.where(log_viol, LOG_MATCHING, 0))
        return ok, code.to(torch.int32)

    def is_done(self, nodes: RaftState, now_us):
        # all nodes committed a full log => nothing left to explore
        return (nodes.commit >= self.log_capacity).all(dim=1)

    def summary(self, nodes: RaftState):
        return {
            "max_term": nodes.term.amax(dim=1),
            "max_commit": nodes.commit.amax(dim=1),
            "min_commit": nodes.commit.amin(dim=1),
            "num_leaders": (nodes.role == LEADER).sum(dim=1, dtype=torch.int32),
        }

    def coverage_projection(self, nodes: RaftState, now_us):
        """Term bucket (phase, low 3 bits) x leader count x committed-log
        divergence x cross-node term delta x candidate count."""
        term_max = nodes.term.amax(dim=1)
        term_b = term_max.clamp(0, 7)
        leaders = (nodes.role == LEADER).sum(dim=1).clamp(0, 3)
        commit_div = (nodes.commit.amax(dim=1) - nodes.commit.amin(dim=1)).clamp(0, 7)
        term_delta = (term_max - nodes.term.amin(dim=1)).clamp(0, 3)
        candidates = (nodes.role == CANDIDATE).sum(dim=1).clamp(0, 3)
        word = (
            term_b.to(torch.int64)
            | (leaders << 3)
            | (commit_div.to(torch.int64) << 5)
            | (term_delta.to(torch.int64) << 8)
            | (candidates << 10)
        )
        return word & 0xFFFFFFFF
