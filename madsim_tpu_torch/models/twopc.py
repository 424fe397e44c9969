"""Two-phase commit machine (transaction atomicity) as a lane-batched
Machine.

The port of `madsim_tpu/models/twopc.py`. Node 0 is the coordinator;
nodes 1..N-1 are participants. The coordinator drives MAX_TXN
transactions one after another: PREPARE to all, collect the votes (any
NO aborts early), log the decision durably, deliver COMMIT / ABORT until
every participant acks, advance. A participant votes NO with
probability 1/8 (from the event's random word), logs its vote durably,
and records ABORT the moment it votes NO (presumed abort). The logs
survive restart faults; vote and ack collection are volatile and rebuilt
by retry ticks.

Checked invariant (ATOMICITY, 120): no transaction has participants
that recorded different outcomes. It breaks for the "eager" coordinator
that presumes missing votes are YES (the tests' `EagerCommitTwoPc`,
which overrides `_all_votes_in`).

The logs are written by (node, txn) cell as masked selects, never as
scatters.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from ..engine.machine import Machine, Outbox, make_payload, send_if, set_timer_if
from ..ops import u32
from ..utils import take

COORD = 0

# message types
M_PREP, M_VOTE, M_DEC, M_ACK = 1, 2, 3, 4

# outcomes / decisions
COMMIT, ABORT = 1, 2

# votes
V_YES, V_NO = 1, 2

# timers
T_BOOT, T_TICK = 0, 1

ATOMICITY = 120

TICK_US = 30_000


@dataclasses.dataclass
class TwoPcState:
    # durable everywhere (write-ahead logs)
    cur_txn: torch.Tensor  # int32[L, N] the coordinator's txn counter (row COORD)
    decision: torch.Tensor  # int32[L, N, MAX_TXN] the coordinator's decision log (row COORD)
    voted: torch.Tensor  # int32[L, N, MAX_TXN] participant vote log (0 / V_YES / V_NO)
    outcome: torch.Tensor  # int32[L, N, MAX_TXN] participant outcome log (0 / COMMIT / ABORT)
    # volatile (rebuilt by retries after a restart)
    votes_recv: torch.Tensor  # int32[L, N] bitmask of participants whose vote arrived
    votes_yes: torch.Tensor  # int32[L, N] bitmask of YES votes among those
    acks: torch.Tensor  # int32[L, N] bitmask of participants that acked the decision


def _bit(j) -> torch.Tensor:
    """`1 << j` for int32 node indices j [L], 0 where the shift is out of
    [0, 32) (XLA's shift semantics)."""
    ok = (j >= 0) & (j < 32)
    return torch.where(ok, torch.bitwise_left_shift(torch.ones_like(j), j.clamp(0, 31)), 0).to(torch.int32)


class TwoPcMachine(Machine):
    PAYLOAD_WIDTH = 4
    MAX_TIMERS = 1
    state_type = TwoPcState

    def __init__(self, num_nodes: int = 4, max_txn: int = 6):
        self.NUM_NODES = num_nodes
        self.MAX_TXN = max_txn
        self.MAX_MSGS = num_nodes - 1  # one static slot per peer
        # participant bitmask: bits 1..N-1
        self._full_mask = ((1 << num_nodes) - 1) & ~1

    def init(self, rng_key) -> TwoPcState:
        lanes, n, t, dev = rng_key.shape[0], self.NUM_NODES, self.MAX_TXN, rng_key.device
        z1 = torch.zeros((lanes, n), dtype=torch.int32, device=dev)
        z2 = torch.zeros((lanes, n, t), dtype=torch.int32, device=dev)
        return TwoPcState(cur_txn=z1, decision=z2, voted=z2, outcome=z2, votes_recv=z1, votes_yes=z1, acks=z1)

    def init_node(self, nodes: TwoPcState, i, rng_key) -> TwoPcState:
        """The legacy restart hook: the same durable-log split as
        `restart_if`."""
        return self.restart_if(nodes, i, torch.ones_like(i, dtype=torch.bool), rng_key)

    def durable_spec(self) -> TwoPcState:
        """Every log (decision, vote, outcome and the txn counter) is
        durable; vote and ack collection are volatile."""
        return TwoPcState(cur_txn=True, decision=True, voted=True, outcome=True, votes_recv=False,
                          votes_yes=False, acks=False)

    def restart_if(self, nodes: TwoPcState, i, cond, rng_key) -> TwoPcState:
        """The logs are durable; only the in-flight collection resets."""
        mask = (torch.arange(self.NUM_NODES, device=i.device)[None, :] == i[:, None]) & cond[:, None]
        return dataclasses.replace(nodes, **{k: torch.where(mask, 0, getattr(nodes, k))
                                             for k in ("votes_recv", "votes_yes", "acks")})

    # -- the decision policy (the tests break it on purpose) ------------------

    def _all_votes_in(self, votes_recv) -> torch.Tensor:
        return votes_recv == self._full_mask

    # -- helpers --------------------------------------------------------------

    def _cell(self, arr, node, t):
        """arr[l, node[l], t[l]] (jax's gather index semantics)."""
        return take(take(arr, node), t)

    def _set_cell(self, arr, node, t, value, cond):
        """arr[l, node[l], t[l]] = value[l] where cond[l], as a masked select."""
        n_idx = torch.arange(arr.shape[1], device=arr.device)
        t_idx = torch.arange(arr.shape[2], device=arr.device)
        m = (n_idx[None, :, None] == node.reshape(-1, 1, 1)) & (t_idx[None, None, :] == t.reshape(-1, 1, 1)) \
            & cond.reshape(-1, 1, 1)
        if isinstance(value, torch.Tensor):
            value = value.to(arr.dtype).reshape(-1, 1, 1)
        return torch.where(m, value, arr)

    def _pay(self, *vals):
        return make_payload(self.PAYLOAD_WIDTH, *vals)

    # -- timers ---------------------------------------------------------------

    def on_timer(self, nodes: TwoPcState, node, timer_id, now_us, rand_u32) -> Tuple[TwoPcState, Outbox]:
        outbox = self.empty_outbox(node.shape[0], node.device)
        is_coord = node == COORD
        coord = torch.zeros_like(node)

        # boot / restart: only the coordinator drives; participants react
        outbox = set_timer_if(outbox, 0, (timer_id == T_BOOT) & is_coord, TICK_US, T_TICK)

        is_tick = (timer_id == T_TICK) & is_coord
        cur = nodes.cur_txn[:, COORD]
        t = torch.clamp(cur, max=self.MAX_TXN - 1)
        active = cur < self.MAX_TXN
        dec = self._cell(nodes.decision, coord, t)
        phase_vote = is_tick & active & (dec == 0)
        phase_dec = is_tick & active & (dec != 0)

        prep = self._pay(M_PREP, t)
        decmsg = self._pay(M_DEC, t, dec)
        for p in range(1, self.NUM_NODES):
            bit = 1 << p
            outbox = send_if(outbox, p - 1, phase_vote & ((nodes.votes_recv[:, COORD] & bit) == 0), p, prep)
            outbox = send_if(outbox, p - 1, phase_dec & ((nodes.acks[:, COORD] & bit) == 0), p, decmsg)

        outbox = set_timer_if(outbox, 0, is_tick & active, TICK_US, T_TICK)
        return nodes, outbox

    # -- messages -------------------------------------------------------------

    def on_message(self, nodes: TwoPcState, node, src, payload, now_us, rand_u32) -> Tuple[TwoPcState, Outbox]:
        outbox = self.empty_outbox(node.shape[0], node.device)
        mtype, mt = payload[:, 0], payload[:, 1]
        coord = torch.zeros_like(node)

        # ---- participant side ----
        is_part = node != COORD

        # PREPARE: vote once (durably), re-reply idempotently to duplicates
        is_prep = is_part & (mtype == M_PREP)
        prior = self._cell(nodes.voted, node, mt)
        fresh_vote = torch.where(rand_u32[:, 0] % 8 == 0, V_NO, V_YES).to(torch.int32)
        vote = torch.where(prior == 0, fresh_vote, prior)
        # unilateral abort: a NO voter knows the txn cannot commit
        no_outcome = self._cell(nodes.outcome, node, mt) == 0
        nodes = dataclasses.replace(
            nodes,
            voted=self._set_cell(nodes.voted, node, mt, vote, is_prep),
            outcome=self._set_cell(nodes.outcome, node, mt, ABORT, is_prep & (vote == V_NO) & no_outcome),
        )
        outbox = send_if(outbox, 0, is_prep, COORD, self._pay(M_VOTE, mt, vote))

        # DECISION: record once (the first write wins), always ack
        is_dec = is_part & (mtype == M_DEC)
        no_outcome = self._cell(nodes.outcome, node, mt) == 0
        nodes = dataclasses.replace(nodes, outcome=self._set_cell(nodes.outcome, node, mt, payload[:, 2],
                                                                  is_dec & no_outcome))
        outbox = send_if(outbox, 0, is_dec, COORD, self._pay(M_ACK, mt))

        # ---- coordinator side ----
        is_coord = node == COORD
        cur = nodes.cur_txn[:, COORD]
        t = torch.clamp(cur, max=self.MAX_TXN - 1)
        current = (mt == cur) & (cur < self.MAX_TXN)
        bit = _bit(src)
        row = (torch.arange(self.NUM_NODES, device=node.device) == COORD)[None, :]

        # VOTE: collect; all in, or any NO, decides, logs and delivers now
        undecided = self._cell(nodes.decision, coord, t) == 0
        is_vote = is_coord & (mtype == M_VOTE) & current & undecided
        votes_recv = torch.where(is_vote, nodes.votes_recv[:, COORD] | bit, nodes.votes_recv[:, COORD])
        yes_bit = torch.where(payload[:, 2] == V_YES, bit, 0)
        votes_yes = torch.where(is_vote, nodes.votes_yes[:, COORD] | yes_bit, nodes.votes_yes[:, COORD])
        any_no = (votes_recv & ~votes_yes & self._full_mask) != 0
        decide = is_vote & (self._all_votes_in(votes_recv) | any_no)
        d = torch.where(any_no, ABORT, COMMIT).to(torch.int32)
        at_vote = row & is_vote[:, None]
        nodes = dataclasses.replace(
            nodes,
            votes_recv=torch.where(at_vote, votes_recv[:, None], nodes.votes_recv),
            votes_yes=torch.where(at_vote, votes_yes[:, None], nodes.votes_yes),
            decision=self._set_cell(nodes.decision, coord, t, d, decide),
        )

        # ACK: collect; all acked advances to the next transaction
        decided = self._cell(nodes.decision, coord, t) != 0
        is_ack = is_coord & (mtype == M_ACK) & current & decided
        acks = torch.where(is_ack, nodes.acks[:, COORD] | bit, nodes.acks[:, COORD])
        advance = is_ack & (acks == self._full_mask)
        at_ack, at_advance = row & (is_ack & ~advance)[:, None], row & advance[:, None]
        nodes = dataclasses.replace(
            nodes,
            acks=torch.where(at_ack, acks[:, None], torch.where(at_advance, 0, nodes.acks)),
            cur_txn=torch.where(at_advance, (cur + 1)[:, None], nodes.cur_txn),
            votes_recv=torch.where(at_advance, 0, nodes.votes_recv),
            votes_yes=torch.where(at_advance, 0, nodes.votes_yes),
        )

        # fast path: on decide, deliver the decision without waiting a
        # tick; on advance, prepare the next txn at once (disjoint cases)
        dec_now = self._pay(M_DEC, t, self._cell(nodes.decision, coord, t))
        prep_next = self._pay(M_PREP, torch.clamp(cur + 1, max=self.MAX_TXN - 1))
        next_active = advance & (cur + 1 < self.MAX_TXN)
        for p in range(1, self.NUM_NODES):
            deliver = decide & ((nodes.acks[:, COORD] & (1 << p)) == 0)
            outbox = send_if(outbox, p - 1, deliver, p, dec_now)
            outbox = send_if(outbox, p - 1, next_active, p, prep_next)
        return nodes, outbox

    # -- invariants / results -------------------------------------------------

    def invariant(self, nodes: TwoPcState, now_us):
        part = nodes.outcome[:, 1:, :]  # participants only
        mixed = ((part == COMMIT).any(dim=1) & (part == ABORT).any(dim=1)).any(dim=1)
        return ~mixed, torch.where(mixed, ATOMICITY, 0).to(torch.int32)

    def is_done(self, nodes: TwoPcState, now_us):
        return nodes.cur_txn[:, COORD] >= self.MAX_TXN

    def summary(self, nodes: TwoPcState):
        part = nodes.outcome[:, 1:, :]
        return {
            "txns": nodes.cur_txn[:, COORD],
            "committed": (part == COMMIT).all(dim=1).sum(dim=1, dtype=torch.int32),
            "aborted": (part == ABORT).all(dim=1).sum(dim=1, dtype=torch.int32),
        }

    def coverage_projection(self, nodes: TwoPcState, now_us):
        """Txn index (phase) x votes collected for the in-flight txn x
        abort and commit pressure: the 2PC decision tree's axes."""
        phase = nodes.cur_txn[:, COORD].clamp(0, 7)
        votes_in = u32.popcount(nodes.votes_recv[:, COORD]).clamp(0, 7)
        part = nodes.outcome[:, 1:, :]
        aborted = (part == ABORT).any(dim=1).sum(dim=1, dtype=torch.int32).clamp(0, 3)
        committed = (part == COMMIT).any(dim=1).sum(dim=1, dtype=torch.int32).clamp(0, 7)
        return u32.from_i32(phase | (votes_in << 3) | (aborted << 6) | (committed << 8))
