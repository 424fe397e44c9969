"""Multi-decree Paxos (a replicated log of synod instances) as a
lane-batched Machine.

The port of `madsim_tpu/models/multipaxos.py`. Every node is an acceptor
with durable per-slot (promised, accepted) state; nodes 0 and 1 are
proposers that drive a fixed log of `log_slots` decrees, one synod per
slot, racing each other under the fault schedule. A proposer that gets a
slot chosen broadcasts LEARN and moves to its next unlearned slot after
a short T_NEXT timer.

Every handler runs on the whole batch at once: `[L, N, ...]` node
tensors and `[L]` node indices. A handler reads and writes the handling
node's row (`node_row` / `write_row`), computing on it as the reference
computes on `nodes.x[node]`; the ghost chosen registers live on row 0
and are written as whole tensors. The message types are not switched:
each type's updates are masked by its own condition, in the reference's
order, so the lanes of every type go through one straight-line pass.

Invariants:
  * AGREEMENT_MULTI (150): at most one value chosen per slot, checked
    against the ghost per-slot chosen registers of row 0.
  * LEARN_DIVERGED (151): a node learned a value for a slot other than
    the slot's chosen value.

`NoPromiseCheckMultiPaxos` drops the acceptor's ballot guard on ACCEPT,
so dueling proposers get two values majority-accepted in one slot.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from ..engine.machine import (
    Machine, Outbox, make_payload, node_row, send_all_if, send_if, set_at, set_timer_if, write_row,
)
from ..utils import take

# messages: [mtype, slot, b, v/acc_b, acc_v]
M_PREPARE, M_PROMISE, M_ACCEPT, M_ACCEPTED, M_NACK, M_LEARN = 1, 2, 3, 4, 5, 6

# timers
T_BOOT, T_PROPOSE, T_RETRY, T_NEXT = 0, 1, 2, 3

AGREEMENT_MULTI = 150
LEARN_DIVERGED = 151

PROPOSE_MIN_US = 20_000
PROPOSE_SPAN_US = 180_000
RETRY_MIN_US = 150_000
RETRY_SPAN_US = 250_000
NEXT_US = 15_000

IDLE, PREPARING, ACCEPTING = 0, 1, 2

# the fields a handler reads and writes on the handling node's row; the
# ghost registers (chosen_any, chosen_val, bad) are row 0's alone
_GHOST = ("chosen_any", "chosen_val", "bad")


@dataclasses.dataclass
class MultiPaxosState:
    # acceptor (durable per-slot stable storage)
    promised: torch.Tensor  # int32[L, N, S] highest ballot promised (-1 none)
    acc_ballot: torch.Tensor  # int32[L, N, S] ballot of the accepted value (-1 none)
    acc_value: torch.Tensor  # int32[L, N, S] accepted value (0 none)
    # learned log (durable)
    learned: torch.Tensor  # int32[L, N, S] (0 = unknown)
    round: torch.Tensor  # int32[L, N] rising ballot round (durable)
    # proposer (volatile)
    phase: torch.Tensor  # int32[L, N]
    cur_slot: torch.Tensor  # int32[L, N] slot being driven
    ballot: torch.Tensor  # int32[L, N]
    promises: torch.Tensor  # int32[L, N]
    best_ballot: torch.Tensor  # int32[L, N]
    best_value: torch.Tensor  # int32[L, N]
    accepts: torch.Tensor  # int32[L, N]
    # ghost chosen registers (row 0, spec-only)
    chosen_any: torch.Tensor  # bool[L, N, S]
    chosen_val: torch.Tensor  # int32[L, N, S]
    bad: torch.Tensor  # bool[L, N]


def _first_unlearned(learned_row, s: int):
    """[L] index of the first unlearned slot of each row [L, S], or S."""
    unk = learned_row == 0
    return torch.where(unk.any(dim=1), unk.to(torch.uint8).argmax(dim=1), s).to(torch.int32)


class MultiPaxosMachine(Machine):
    PAYLOAD_WIDTH = 6
    MAX_TIMERS = 2
    NUM_PROPOSERS = 2
    state_type = MultiPaxosState

    def __init__(self, num_nodes: int = 5, log_slots: int = 8):
        self.NUM_NODES = num_nodes
        self.MAX_MSGS = num_nodes - 1
        self.majority = num_nodes // 2 + 1
        self.S = log_slots

    def init(self, rng_key) -> MultiPaxosState:
        lanes, n, s = rng_key.shape[0], self.NUM_NODES, self.S
        kw = {"dtype": torch.int32, "device": rng_key.device}
        zns = torch.zeros((lanes, n, s), **kw)
        z = torch.zeros((lanes, n), **kw)
        return MultiPaxosState(
            promised=zns - 1,
            acc_ballot=zns - 1,
            acc_value=zns,
            learned=zns,
            round=z,
            phase=z,
            cur_slot=z,
            ballot=z - 1,
            promises=z,
            best_ballot=z - 1,
            best_value=z,
            accepts=z,
            chosen_any=torch.zeros((lanes, n, s), dtype=torch.bool, device=rng_key.device),
            chosen_val=zns,
            bad=torch.zeros((lanes, n), dtype=torch.bool, device=rng_key.device),
        )

    def restart_if(self, nodes: MultiPaxosState, i, cond, rng_key) -> MultiPaxosState:
        """Acceptor slots, the learned log and the round counter are
        stable storage; the proposer side restarts idle and re-derives
        its working slot from the learned log."""
        row = (torch.arange(self.NUM_NODES, device=i.device)[None, :] == i[:, None]) & cond[:, None]
        first = _first_unlearned(take(nodes.learned, i), self.S)
        return dataclasses.replace(
            nodes,
            phase=torch.where(row, IDLE, nodes.phase),
            cur_slot=torch.where(row, first[:, None], nodes.cur_slot),
            ballot=torch.where(row, -1, nodes.ballot),
            promises=torch.where(row, 0, nodes.promises),
            best_ballot=torch.where(row, -1, nodes.best_ballot),
            best_value=torch.where(row, 0, nodes.best_value),
            accepts=torch.where(row, 0, nodes.accepts),
        )

    # -- helpers ---------------------------------------------------------------

    def _row(self, nodes: MultiPaxosState, node) -> dict:
        r = node_row(nodes, node)
        for k in _GHOST:
            del r[k]
        return r

    def _peers(self, node):
        offs = torch.arange(1, self.NUM_NODES, device=node.device, dtype=torch.int32)
        return (node.to(torch.int32)[:, None] + offs) % self.NUM_NODES

    def _is_proposer(self, node):
        return node < self.NUM_PROPOSERS

    def _my_value(self, node, slot):
        return (slot + 1) * 16 + node + 1  # distinct non-zero per (slot, proposer)

    def _accept_guard(self, r: dict, slot, b) -> torch.Tensor:
        """The ballot check the bug variant drops."""
        return b >= take(r["promised"], slot)

    def _learn(self, r: dict, slot, value, cond) -> None:
        """Record a learned value and advance the working slot past the
        learned prefix (in place on the row dict)."""
        unknown = cond & (take(r["learned"], slot) == 0)
        r["learned"] = set_at(r["learned"], slot, value, unknown)
        nxt = _first_unlearned(r["learned"], self.S)
        bump = cond & (slot == r["cur_slot"])
        r["cur_slot"] = torch.where(bump, nxt, r["cur_slot"])
        r["phase"] = torch.where(bump, IDLE, r["phase"])

    def _start_prepare(self, r: dict, node, outbox: Outbox, cond) -> Outbox:
        """Begin a new ballot for the current slot (self-promise +
        broadcast PREPARE). The round jumps past whatever our own
        acceptor promised for the slot, so the ballot is always
        self-promisable."""
        n = self.NUM_NODES
        slot = torch.clamp(r["cur_slot"], max=self.S - 1)
        round_eff = torch.maximum(
            r["round"], torch.div(take(r["promised"], slot) - node, n, rounding_mode="floor") + 1
        )
        new_ballot = round_eff * n + node
        best_ballot = take(r["acc_ballot"], slot)
        best_value = take(r["acc_value"], slot)
        r["phase"] = torch.where(cond, PREPARING, r["phase"])
        r["ballot"] = torch.where(cond, new_ballot, r["ballot"])
        r["round"] = torch.where(cond, round_eff + 1, r["round"])
        r["promises"] = torch.where(cond, 1, r["promises"])
        r["best_ballot"] = torch.where(cond, best_ballot, r["best_ballot"])
        r["best_value"] = torch.where(cond, best_value, r["best_value"])
        r["accepts"] = torch.where(cond, 0, r["accepts"])
        r["promised"] = set_at(r["promised"], slot, new_ballot, cond)
        prepare = make_payload(self.PAYLOAD_WIDTH, M_PREPARE, slot, new_ballot)
        return send_all_if(outbox, cond, self._peers(node), prepare)

    # -- timers ----------------------------------------------------------------

    def on_timer(self, nodes: MultiPaxosState, node, timer_id, now_us, rand_u32) -> Tuple[MultiPaxosState, Outbox]:
        r = self._row(nodes, node)
        outbox = self.empty_outbox(node.shape[0], node.device)
        is_prop = self._is_proposer(node)
        delay = PROPOSE_MIN_US + (rand_u32[:, 0] % PROPOSE_SPAN_US).to(torch.int32)
        outbox = set_timer_if(outbox, 0, (timer_id == T_BOOT) & is_prop, delay, T_PROPOSE)

        fire = (timer_id == T_PROPOSE) | (timer_id == T_RETRY) | (timer_id == T_NEXT)
        behind = r["cur_slot"] < self.S
        start = fire & is_prop & behind
        outbox = self._start_prepare(r, node, outbox, start)
        retry_delay = RETRY_MIN_US + (rand_u32[:, 1] % RETRY_SPAN_US).to(torch.int32)
        outbox = set_timer_if(outbox, 1, (timer_id != T_NEXT) & start, retry_delay, T_RETRY)
        return write_row(nodes, node, r), outbox

    # -- messages --------------------------------------------------------------

    def on_message(self, nodes: MultiPaxosState, node, src, payload, now_us, rand_u32) -> Tuple[MultiPaxosState, Outbox]:
        r = self._row(nodes, node)
        outbox = self.empty_outbox(node.shape[0], node.device)
        mtype, slot = payload[:, 0], payload[:, 1].clamp(0, self.S - 1)
        peers = self._peers(node)
        pay = lambda *vals: make_payload(self.PAYLOAD_WIDTH, *vals)  # noqa: E731
        cur = torch.clamp(r["cur_slot"], max=self.S - 1)

        # ---- acceptor: PREPARE -> PROMISE or NACK ----
        is_prep = mtype == M_PREPARE
        b = payload[:, 2]
        grant = is_prep & (b > take(r["promised"], slot))
        r["promised"] = set_at(r["promised"], slot, b, grant)
        promise = pay(M_PROMISE, slot, b, take(r["acc_ballot"], slot), take(r["acc_value"], slot))
        outbox = send_if(outbox, 0, grant, src, promise)
        outbox = send_if(outbox, 0, is_prep & ~grant, src, pay(M_NACK, slot, b))

        # ---- proposer: PROMISE ----
        is_promise = (mtype == M_PROMISE) & self._is_proposer(node)
        p_b, p_accb, p_accv = payload[:, 2], payload[:, 3], payload[:, 4]
        counts = is_promise & (r["phase"] == PREPARING) & (p_b == r["ballot"]) & (slot == cur)
        better = counts & (p_accb > r["best_ballot"])
        new_promises = r["promises"] + counts.to(torch.int32)
        r["promises"] = new_promises
        r["best_ballot"] = torch.where(better, p_accb, r["best_ballot"])
        r["best_value"] = torch.where(better, p_accv, r["best_value"])
        quorum = counts & (new_promises >= self.majority)
        value = torch.where(r["best_ballot"] >= 0, r["best_value"], self._my_value(node, slot))
        self_ok = quorum & self._accept_guard(r, slot, r["ballot"])
        r["phase"] = torch.where(quorum, ACCEPTING, r["phase"])
        r["accepts"] = torch.where(quorum, self_ok.to(torch.int32), r["accepts"])
        r["acc_ballot"] = set_at(r["acc_ballot"], slot, r["ballot"], self_ok)
        r["acc_value"] = set_at(r["acc_value"], slot, value, self_ok)
        outbox = send_all_if(outbox, quorum, peers, pay(M_ACCEPT, slot, r["ballot"], value))

        # ---- acceptor: ACCEPT -> ACCEPTED or NACK ----
        a_b, a_v = payload[:, 2], payload[:, 3]
        took = (mtype == M_ACCEPT) & self._accept_guard(r, slot, a_b)
        r["promised"] = set_at(r["promised"], slot, torch.maximum(a_b, take(r["promised"], slot)), took)
        r["acc_ballot"] = set_at(r["acc_ballot"], slot, a_b, took)
        r["acc_value"] = set_at(r["acc_value"], slot, a_v, took)
        outbox = send_if(outbox, 0, took, src, pay(M_ACCEPTED, slot, a_b, a_v))

        # ---- proposer: ACCEPTED -> chosen on majority ----
        is_acked = (mtype == M_ACCEPTED) & self._is_proposer(node)
        k_b, k_v = payload[:, 2], payload[:, 3]
        counts2 = is_acked & (r["phase"] == ACCEPTING) & (k_b == r["ballot"]) & (slot == cur)
        new_accepts = r["accepts"] + counts2.to(torch.int32)
        chosen = counts2 & (new_accepts >= self.majority)
        r["accepts"] = new_accepts

        # ghost per-slot chosen register (agreement check, row 0)
        any0, val0 = nodes.chosen_any[:, 0], nodes.chosen_val[:, 0]
        conflict = chosen & take(any0, slot) & (take(val0, slot) != k_v)
        first = chosen & ~take(any0, slot)
        on_row0 = torch.arange(self.NUM_NODES, device=node.device) == 0
        ghost = {
            "chosen_any": torch.where(on_row0[None, :, None], set_at(any0, slot, True, first)[:, None, :],
                                      nodes.chosen_any),
            "chosen_val": torch.where(on_row0[None, :, None], set_at(val0, slot, k_v, first)[:, None, :],
                                      nodes.chosen_val),
            "bad": nodes.bad | (conflict[:, None] & on_row0[None, :]),
        }
        # learn locally, advance to the next slot soon, tell everyone
        self._learn(r, slot, k_v, chosen)
        outbox = send_all_if(outbox, chosen, peers, pay(M_LEARN, slot, k_v))
        outbox = set_timer_if(outbox, 0, chosen & (r["cur_slot"] < self.S), NEXT_US, T_NEXT)

        # ---- anyone: LEARN ----
        self._learn(r, slot, payload[:, 2], mtype == M_LEARN)
        return dataclasses.replace(write_row(nodes, node, r), **ghost), outbox

    # -- invariants / results --------------------------------------------------

    def invariant(self, nodes: MultiPaxosState, now_us):
        agree_viol = nodes.bad[:, 0]
        chosen_any, chosen_val = nodes.chosen_any[:, :1], nodes.chosen_val[:, :1]
        diverged = ((nodes.learned != 0) & chosen_any & (nodes.learned != chosen_val)).flatten(1).any(dim=1)
        ok = ~(agree_viol | diverged)
        code = torch.where(agree_viol, AGREEMENT_MULTI, torch.where(diverged, LEARN_DIVERGED, 0))
        return ok, code.to(torch.int32)

    def is_done(self, nodes: MultiPaxosState, now_us):
        return (nodes.learned[:, : self.NUM_PROPOSERS] != 0).flatten(1).all(dim=1)

    def summary(self, nodes: MultiPaxosState):
        return {
            "slots_chosen": nodes.chosen_any[:, 0].sum(dim=1, dtype=torch.int32),
            "max_round": nodes.round[:, : self.NUM_PROPOSERS].amax(dim=1),
        }


class NoPromiseCheckMultiPaxos(MultiPaxosMachine):
    """Bug variant: acceptors take any ACCEPT regardless of their
    promise, so dueling proposers get two values majority-accepted in
    one slot (AGREEMENT_MULTI)."""

    def _accept_guard(self, r: dict, slot, b) -> torch.Tensor:
        return torch.ones_like(slot, dtype=torch.bool)
