"""Raft with snapshots and log compaction as a lane-batched Machine: the
workload the torn/lost-write fault kind mines.

The port of `madsim_tpu/models/raft_compact.py`. It extends the flagship
Raft (`models/raft.py`, whose constants it shares) with compaction:
every node periodically snapshots its committed prefix and trims its log
ring behind it, and a leader whose follower has fallen behind the trim
point sends InstallSnapshot (`M_IS`) instead of AppendEntries (Raft §7).
The ring is windowed: stored slot `s` of a node holds the term of
absolute index `base + s`, slot 0 being the boundary term at `base`;
`snap_idx` / `snap_term` describe the snapshot of `[1, snap_idx]`.
Honest compaction writes the snapshot and the trim in one event, so
`snap_idx == base` always: the storage invariant torn writes attack.

Every handler runs on the whole batch at once and touches only the
handling node's row, which it reads once (`node_row`) and writes back
once (`write_row`). The message types are computed side by side and
selected per lane, where the reference switches.

On-device invariants (checked after every event):
  * ElectionSafety (code 101): at most one leader per term
  * LogMatching on committed prefixes (code 102), compaction-aware:
    (a) wherever two nodes both store and have both committed an
        absolute position, their terms agree;
    (b) a committed watermark past `snap_idx` with `base > snap_idx`
        stands on positions neither stored nor covered by the snapshot.

`TornSnapshotRaftCompact` (`demo-tornsnapshot-raft`): the snapshot file
is not fsynced, so its `torn_spec` marks `snap_idx` / `snap_term`
TORN_LOSE while the trimmed ring stays atomic; a torn restart then
leaves a trimmed log with no snapshot, and the node's first re-commit
trips check (b).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from ..engine.machine import (
    TORN_ATOMIC, TORN_LOSE, Machine, Outbox, node_row, send_all_if, send_if, set_at, set_timer_if, write_row,
)
from ..ops.u32 import popcount
from ..utils import take, tree_where
from .raft import (
    CANDIDATE, CLIENT_APPEND_US, ELECTION_SAFETY, FOLLOWER, HEARTBEAT_US, LEADER, LOG_MATCHING, M_AE, M_AER, M_RV,
    M_VOTE, T_BOOT, T_CLIENT, T_ELECTION, T_HEARTBEAT, RaftMachine,
)

# InstallSnapshot (Raft §7): payload (M_IS, term, snap_idx, snap_term)
M_IS = 5


@dataclasses.dataclass
class RaftCompactState:
    # persistent (stable storage)
    term: torch.Tensor  # int32[L, N]
    voted_for: torch.Tensor  # int32[L, N], -1 = none
    log_term: torch.Tensor  # int32[L, N, CAP+1]; slot s = term at abs index base+s
    log_len: torch.Tensor  # int32[L, N] stored entries past base
    base: torch.Tensor  # int32[L, N] trim boundary: entries <= base are compacted
    snap_idx: torch.Tensor  # int32[L, N] the snapshot covers [1, snap_idx]
    snap_term: torch.Tensor  # int32[L, N] term at snap_idx
    epoch: torch.Tensor  # int32[L, N] timer epoch (persistent, bumped at BOOT)
    # volatile
    role: torch.Tensor  # int32[L, N]
    votes: torch.Tensor  # int32[L, N] granted-voter bitmask
    elec_deadline: torch.Tensor  # int32[L, N] us
    commit: torch.Tensor  # int32[L, N] absolute watermark
    next_idx: torch.Tensor  # int32[L, N, N] absolute
    match_idx: torch.Tensor  # int32[L, N, N] absolute


class RaftCompactMachine(Machine):
    PAYLOAD_WIDTH = 6
    MAX_TIMERS = 2
    state_type = RaftCompactState

    def __init__(self, num_nodes: int = 5, log_capacity: int = 8, compact_lag: int = 3, target_commit: int = 0):
        if num_nodes > 31:
            raise ValueError(
                "RaftCompactMachine tracks granting voters as an int32 bitmask "
                "(dup-safe tally, Raft §5.2); num_nodes must be <= 31"
            )
        if not 1 <= compact_lag <= log_capacity:
            raise ValueError("compact_lag must be in [1, log_capacity]")
        self.NUM_NODES = num_nodes
        self.MAX_MSGS = num_nodes - 1
        self.log_capacity = log_capacity
        self.compact_lag = compact_lag  # snapshot once commit - base reaches this
        self.target_commit = target_commit or 2 * log_capacity
        self.majority = num_nodes // 2 + 1

    # -- state ---------------------------------------------------------------

    def init(self, rng_key) -> RaftCompactState:
        lanes, n, cap = rng_key.shape[0], self.NUM_NODES, self.log_capacity
        kw = {"dtype": torch.int32, "device": rng_key.device}
        z = torch.zeros((lanes, n), **kw)
        return RaftCompactState(
            term=z, voted_for=torch.full((lanes, n), -1, **kw), log_term=torch.zeros((lanes, n, cap + 1), **kw),
            log_len=z, base=z, snap_idx=z, snap_term=z, epoch=z, role=z, votes=z, elec_deadline=z, commit=z,
            next_idx=torch.ones((lanes, n, n), **kw), match_idx=torch.zeros((lanes, n, n), **kw),
        )

    def durable_spec(self) -> RaftCompactState:
        """term, votedFor, the log window, the trim boundary and the
        snapshot metadata are stable storage and the timer epoch
        survives; the rest is volatile. The amnesia wipe under this
        contract equals `restart_if`."""
        return RaftCompactState(
            term=True, voted_for=True, log_term=True, log_len=True, base=True, snap_idx=True, snap_term=True,
            epoch=True, role=False, votes=False, elec_deadline=False, commit=False, next_idx=False,
            match_idx=False,
        )

    def restart_if(self, nodes: RaftCompactState, i, cond, rng_key) -> RaftCompactState:
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

    def init_node(self, nodes: RaftCompactState, i, rng_key) -> RaftCompactState:
        return self.restart_if(nodes, i, torch.ones_like(i, dtype=torch.bool), rng_key)

    # -- helpers -------------------------------------------------------------

    # the flagship's: peers, election timeout, payload, epoch-coded timer id
    _peers = RaftMachine._peers
    _rand_timeout = RaftMachine._rand_timeout
    _pay = RaftMachine._pay
    _tid = staticmethod(RaftMachine._tid)

    def _term_at(self, r, abs_idx):
        """Stored term at an absolute index ([L] or [L, K]), clipped into
        the node's window; callers gate on validity themselves."""
        base = r["base"] if abs_idx.dim() == 1 else r["base"][:, None]
        return take(r["log_term"], torch.clamp(abs_idx - base, 0, self.log_capacity))

    def _shift_log(self, row, shift):
        """Each lane's ring row [L, CAP+1] moved down by shift [L]; slots
        past the end read 0."""
        cap = self.log_capacity
        srel = torch.arange(cap + 1, device=row.device, dtype=torch.int32)
        at = srel[None, :] + shift[:, None]
        return torch.where(at <= cap, row.gather(1, at.clamp(0, cap).to(torch.int64)), 0)

    # -- timers --------------------------------------------------------------

    def on_timer(self, nodes: RaftCompactState, node, timer_id, now_us, rand_u32) -> Tuple[RaftCompactState, Outbox]:
        r = node_row(nodes, node)
        outbox = self.empty_outbox(node.shape[0], node.device)
        cap = self.log_capacity
        tbase = timer_id % 4
        t_epoch = torch.div(timer_id, 4, rounding_mode="floor")
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
        is_elec = live & (tbase == T_ELECTION) & ~is_boot
        not_yet = now_us < r["elec_deadline"]
        rearm_delay = torch.clamp(r["elec_deadline"] - now_us, min=1)
        outbox = set_timer_if(outbox, 0, is_elec & not_yet, rearm_delay, self._tid(r, T_ELECTION))
        start = is_elec & ~not_yet & (r["role"] != LEADER)
        timeout2 = self._rand_timeout(rand_u32[:, 1])
        r["term"] = torch.where(start, r["term"] + 1, r["term"])
        r["role"] = torch.where(start, CANDIDATE, r["role"])
        r["voted_for"] = torch.where(start, node.to(torch.int32), r["voted_for"])
        one = torch.ones_like(r["votes"])
        r["votes"] = torch.where(start, torch.bitwise_left_shift(one, node.to(torch.int32)), r["votes"])
        r["elec_deadline"] = torch.where(start, now_us + timeout2, r["elec_deadline"])
        outbox = set_timer_if(outbox, 0, is_elec & ~not_yet, timeout2, self._tid(r, T_ELECTION))
        last_idx = r["base"] + r["log_len"]  # absolute
        last_term = take(r["log_term"], r["log_len"])
        peers = self._peers(node)
        outbox = send_all_if(outbox, start, peers, self._pay(M_RV, r["term"], node, last_idx, last_term))

        # ---- HEARTBEAT (leader replicates; a snapshot to a peer behind
        #      the trim point) ----
        is_hb = live & (tbase == T_HEARTBEAT) & ~is_boot
        is_leader = r["role"] == LEADER
        do_hb = is_hb & is_leader
        outbox = set_timer_if(outbox, 1, do_hb, HEARTBEAT_US, self._tid(r, T_HEARTBEAT))
        ni = take(r["next_idx"], peers)  # [L, M] absolute
        need_snap = ni <= r["base"][:, None]
        prev_idx = ni - 1
        has_entry = ni <= (r["base"] + r["log_len"])[:, None]
        entry_term = torch.where(has_entry, self._term_at(r, ni), 0)
        ae = self._pay(M_AE, r["term"][:, None], prev_idx, self._term_at(r, prev_idx), entry_term,
                       r["commit"][:, None])
        inst = self._pay(M_IS, r["term"], r["snap_idx"], r["snap_term"])[:, None, :]
        outbox = send_all_if(outbox, do_hb, peers, torch.where(need_snap[:, :, None], inst, ae))

        # ---- CLIENT tick: compact own log, then (leader) append ----
        is_client = live & (tbase == T_CLIENT) & ~is_boot
        outbox = set_timer_if(outbox, 1, is_client & ~do_hb, CLIENT_APPEND_US, self._tid(r, T_CLIENT))
        # compaction: once the committed prefix outgrows compact_lag,
        # snapshot at the commit point and trim the ring behind it, the
        # snapshot and the trim in this one event
        lag = r["commit"] - r["base"]
        do_compact = is_client & (lag >= self.compact_lag)
        shift = torch.where(do_compact, torch.clamp(torch.minimum(lag, r["log_len"]), 0, cap), 0)
        row = r["log_term"]
        boundary_term = take(row, torch.clamp(shift, 0, cap))
        r["log_term"] = torch.where(do_compact[:, None], self._shift_log(row, shift), row)
        r["log_len"] = torch.where(do_compact, r["log_len"] - shift, r["log_len"])
        r["snap_idx"] = torch.where(do_compact, r["base"] + shift, r["snap_idx"])
        r["snap_term"] = torch.where(do_compact, boundary_term, r["snap_term"])
        r["base"] = torch.where(do_compact, r["base"] + shift, r["base"])

        # leader client append (post-compaction state)
        can_append = is_client & is_leader & (r["log_len"] < cap)
        new_len = r["log_len"] + 1
        r["log_len"] = torch.where(can_append, new_len, r["log_len"])
        r["log_term"] = torch.where(
            can_append[:, None], set_at(r["log_term"], torch.clamp(new_len, 0, cap), r["term"]), r["log_term"])
        r["match_idx"] = torch.where(can_append[:, None], set_at(r["match_idx"], node, r["base"] + new_len),
                                     r["match_idx"])
        return write_row(nodes, node, r), outbox

    # -- messages ------------------------------------------------------------

    @staticmethod
    def _step_down(r, t, also_follow: bool):
        """Adopt a newer term; with `also_follow`, equal-term leader
        contact demotes too."""
        newer = t > r["term"]
        follow = newer | (t == r["term"]) if also_follow else newer
        r["term"] = torch.where(newer, t, r["term"])
        r["role"] = torch.where(follow, FOLLOWER, r["role"])
        r["voted_for"] = torch.where(newer, -1, r["voted_for"])

    def _rv_branch(self, r, node, src, payload, now_us, rand_u32):
        outbox = self.empty_outbox(node.shape[0], node.device)
        t, cand, last_idx, last_term = payload[:, 1], payload[:, 2], payload[:, 3], payload[:, 4]
        self._step_down(r, t, False)
        my_last = r["base"] + r["log_len"]
        my_last_term = take(r["log_term"], r["log_len"])
        log_ok = (last_term > my_last_term) | ((last_term == my_last_term) & (last_idx >= my_last))
        can_vote = (r["voted_for"] == -1) | (r["voted_for"] == cand)
        grant = (t == r["term"]) & can_vote & log_ok
        r["voted_for"] = torch.where(grant, cand, r["voted_for"])
        r["elec_deadline"] = torch.where(grant, now_us + self._rand_timeout(rand_u32[:, 0]), r["elec_deadline"])
        vote = self._pay(M_VOTE, r["term"], grant.to(torch.int32))
        return r, send_if(outbox, 0, torch.ones_like(grant), src, vote)

    def _vote_branch(self, r, node, src, payload, now_us, rand_u32):
        outbox = self.empty_outbox(node.shape[0], node.device)
        t, granted = payload[:, 1], payload[:, 2]
        self._step_down(r, t, False)
        counts = (t == r["term"]) & (r["role"] == CANDIDATE) & (granted == 1)
        bit = torch.bitwise_left_shift(torch.ones_like(r["votes"]), src.to(torch.int32))
        new_votes = torch.where(counts, r["votes"] | bit, r["votes"])
        win = counts & (popcount(new_votes) >= self.majority) & (r["role"] == CANDIDATE)
        n = self.NUM_NODES
        my_last = r["base"] + r["log_len"]
        r["votes"] = new_votes
        r["role"] = torch.where(win, LEADER, r["role"])
        r["next_idx"] = torch.where(win[:, None], (my_last + 1)[:, None].expand(-1, n), r["next_idx"])
        own = set_at(torch.zeros_like(r["match_idx"]), node, my_last)
        r["match_idx"] = torch.where(win[:, None], own, r["match_idx"])
        prev_term = take(r["log_term"], r["log_len"])
        ae = self._pay(M_AE, r["term"], my_last, prev_term, 0, r["commit"])
        outbox = send_all_if(outbox, win, self._peers(node), ae)
        outbox = set_timer_if(outbox, 0, win, HEARTBEAT_US, self._tid(r, T_HEARTBEAT))
        return r, outbox

    def _ae_branch(self, r, node, src, payload, now_us, rand_u32):
        outbox = self.empty_outbox(node.shape[0], node.device)
        cap = self.log_capacity
        t, prev_idx, prev_term, entry_term, leader_commit = (payload[:, k] for k in range(1, 6))
        stale = t < r["term"]
        self._step_down(r, t, True)
        r["elec_deadline"] = torch.where(~stale, now_us + self._rand_timeout(rand_u32[:, 0]), r["elec_deadline"])
        base = r["base"]
        stored_last = base + r["log_len"]
        prev_rel = prev_idx - base
        within = (prev_rel >= 0) & (prev_idx <= stored_last)
        match_here = within & (take(r["log_term"], torch.clamp(prev_rel, 0, cap)) == prev_term)
        # prev below the trim point: the snapshot attests the committed
        # prefix, so it matches (no entry to store)
        ok = ~stale & (match_here | (prev_idx < base))
        has_entry = entry_term > 0
        slot_rel = prev_rel + 1
        can_store = (slot_rel >= 1) & (slot_rel <= cap)
        slot = torch.clamp(slot_rel, 0, cap)
        existing_matches = (stored_last >= prev_idx + 1) & can_store & (take(r["log_term"], slot) == entry_term)
        append = ok & has_entry & can_store
        new_last = torch.where(
            append, torch.where(existing_matches, torch.maximum(stored_last, prev_idx + 1), prev_idx + 1), stored_last)
        # Raft §5.3: commit caps at the last index this AE verified
        commit_cap = torch.minimum(prev_idx + append.to(torch.int32), new_last)
        r["log_term"] = torch.where(append[:, None], set_at(r["log_term"], slot, entry_term), r["log_term"])
        r["log_len"] = new_last - base
        r["commit"] = torch.where(ok, torch.maximum(r["commit"], torch.minimum(leader_commit, commit_cap)),
                                  r["commit"])
        midx = torch.where(append, prev_idx + 1, torch.where(prev_idx < base, base, prev_idx))
        aer = self._pay(M_AER, r["term"], ok.to(torch.int32), midx)
        return r, send_if(outbox, 0, torch.ones_like(ok), src, aer)

    def _aer_branch(self, r, node, src, payload, now_us, rand_u32):
        outbox = self.empty_outbox(node.shape[0], node.device)
        cap = self.log_capacity
        t, success, midx = payload[:, 1], payload[:, 2], payload[:, 3]
        self._step_down(r, t, False)
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
        # advance commit: the highest stored index replicated on a
        # majority with a current-term entry (Raft §5.4.2)
        srel = torch.arange(cap + 1, device=node.device, dtype=torch.int32)
        abs_idx = r["base"][:, None] + srel[None, :]  # [L, CAP+1]
        cnt = (r["match_idx"][:, None, :] >= abs_idx[:, :, None]).sum(dim=2)
        committable = ((cnt >= self.majority) & (r["log_term"] == r["term"][:, None]) & (srel >= 1)
                       & (srel[None, :] <= r["log_len"][:, None]))
        best = torch.where(committable, abs_idx, 0).amax(dim=1)
        r["commit"] = torch.where(good, torch.maximum(r["commit"], best), r["commit"])
        return r, outbox

    def _is_branch(self, r, node, src, payload, now_us, rand_u32):
        outbox = self.empty_outbox(node.shape[0], node.device)
        cap = self.log_capacity
        t, s_idx, s_term = payload[:, 1], payload[:, 2], payload[:, 3]
        stale = t < r["term"]
        self._step_down(r, t, True)
        r["elec_deadline"] = torch.where(~stale, now_us + self._rand_timeout(rand_u32[:, 0]), r["elec_deadline"])
        base = r["base"]
        apply = ~stale & (s_idx > r["commit"])
        rel = s_idx - base
        have_boundary = ((rel >= 0) & (s_idx <= base + r["log_len"])
                         & (take(r["log_term"], torch.clamp(rel, 0, cap)) == s_term))
        retain = apply & have_boundary  # keep the suffix past s_idx
        shift = torch.where(retain, torch.clamp(rel, 0, cap), 0)
        row = r["log_term"]
        srel = torch.arange(cap + 1, device=node.device, dtype=torch.int32)
        discard_row = torch.where(srel[None, :] == 0, s_term[:, None], 0)
        r["log_term"] = torch.where(apply[:, None], torch.where(retain[:, None], self._shift_log(row, shift),
                                                                discard_row), row)
        r["log_len"] = torch.where(apply, torch.where(retain, base + r["log_len"] - s_idx, 0), r["log_len"])
        r["base"] = torch.where(apply, s_idx, base)
        r["snap_idx"] = torch.where(apply, s_idx, r["snap_idx"])
        r["snap_term"] = torch.where(apply, s_term, r["snap_term"])
        r["commit"] = torch.where(apply, torch.maximum(r["commit"], s_idx), r["commit"])
        aer = self._pay(M_AER, r["term"], (~stale).to(torch.int32), s_idx)
        return r, send_if(outbox, 0, torch.ones_like(stale), src, aer)

    def on_message(self, nodes: RaftCompactState, node, src, payload, now_us,
                   rand_u32) -> Tuple[RaftCompactState, Outbox]:
        row = node_row(nodes, node)
        branch = torch.clamp(payload[:, 0] - 1, 0, 4)
        outs = [f(dict(row), node, src, payload, now_us, rand_u32)
                for f in (self._rv_branch, self._vote_branch, self._ae_branch, self._aer_branch, self._is_branch)]
        r, outbox = outs[4]
        for k in (3, 2, 1, 0):
            r, outbox = tree_where(branch == k, outs[k], (r, outbox))
        return write_row(nodes, node, r), outbox

    # -- invariants / results ------------------------------------------------

    def invariant(self, nodes: RaftCompactState, now_us):
        n, cap = self.NUM_NODES, self.log_capacity
        is_lead = nodes.role == LEADER
        same_term = nodes.term[:, :, None] == nodes.term[:, None, :]
        off_diag = ~torch.eye(n, dtype=torch.bool, device=is_lead.device)
        elec_viol = (is_lead[:, :, None] & is_lead[:, None, :] & off_diag & same_term).flatten(1).any(dim=1)

        # (a) committed stored windows agree pairwise: node i's slot s is
        # absolute position base_i + s; find it in j's frame and compare
        # where both store and both committed it
        s = torch.arange(cap + 1, device=is_lead.device, dtype=torch.int32)
        abs_i = nodes.base[:, :, None] + s  # [L, N, S]
        known_i = (s <= nodes.log_len[:, :, None]) & (abs_i >= 1)
        committed_i = known_i & (abs_i <= nodes.commit[:, :, None])
        rel_j = abs_i[:, :, None, :] - nodes.base[:, None, :, None]  # [L, N, N, S]
        known_j = (rel_j >= 0) & (rel_j <= nodes.log_len[:, None, :, None])
        committed_j = known_j & (abs_i[:, :, None, :] <= nodes.commit[:, None, :, None])
        tj = nodes.log_term[:, None, :, :].expand(-1, n, -1, -1).gather(3, rel_j.clamp(0, cap).to(torch.int64))
        ti = nodes.log_term[:, :, None, :]
        log_viol = (committed_i[:, :, None, :] & committed_j & (ti != tj)).flatten(1).any(dim=1)

        # (b) a committed watermark must stand on attested storage
        cover_viol = ((nodes.base > nodes.snap_idx) & (nodes.commit > nodes.snap_idx)).any(dim=1)

        ok = ~(elec_viol | log_viol | cover_viol)
        code = torch.where(elec_viol, ELECTION_SAFETY, torch.where(log_viol | cover_viol, LOG_MATCHING, 0))
        return ok, code.to(torch.int32)

    def is_done(self, nodes: RaftCompactState, now_us):
        return (nodes.commit >= self.target_commit).all(dim=1)

    def summary(self, nodes: RaftCompactState):
        return {
            "max_term": nodes.term.amax(dim=1),
            "max_commit": nodes.commit.amax(dim=1),
            "min_commit": nodes.commit.amin(dim=1),
            "num_leaders": (nodes.role == LEADER).sum(dim=1, dtype=torch.int32),
            "max_base": nodes.base.amax(dim=1),
        }

    def coverage_projection(self, nodes: RaftCompactState, now_us):
        """Raft's cluster-shape axes (term bucket, leaders, commit
        divergence) plus the compaction axes: how far the trim
        boundaries diverge and how many snapshot generations in."""
        term_b = nodes.term.amax(dim=1).clamp(0, 7)
        leaders = (nodes.role == LEADER).sum(dim=1, dtype=torch.int32).clamp(0, 3)
        commit_div = (nodes.commit.amax(dim=1) - nodes.commit.amin(dim=1)).clamp(0, 7)
        base_div = (nodes.base.amax(dim=1) - nodes.base.amin(dim=1)).clamp(0, 7)
        snap_gen = torch.div(nodes.base.amax(dim=1), self.compact_lag, rounding_mode="floor").clamp(0, 3)
        word = term_b | (leaders << 3) | (commit_div << 5) | (base_div << 8) | (snap_gen << 11)
        return word.to(torch.int64) & 0xFFFFFFFF


class TornSnapshotRaftCompact(RaftCompactMachine):
    """Seeded storage bug (`demo-tornsnapshot-raft`): the snapshot file
    write is never fsynced, so a torn restart can keep the trimmed ring
    (atomic) while losing the snapshot behind it; the node's first
    re-commit then fails LOG_MATCHING (102)."""

    def torn_spec(self) -> RaftCompactState:
        a = TORN_ATOMIC
        return RaftCompactState(
            term=a, voted_for=a, log_term=a, log_len=a, base=a, snap_idx=TORN_LOSE, snap_term=TORN_LOSE, epoch=a,
            role=a, votes=a, elec_deadline=a, commit=a, next_idx=a, match_idx=a,
        )
