"""Single-decree Paxos (synod) as a lane-batched Machine.

The port of `madsim_tpu/models/paxos.py`. Every node is an acceptor with
durable (promised, accepted) state; nodes 0 and 1 are also proposers,
each proposing its own value and retrying with ever-higher ballots on
timeout (ballot = round * N + node). A ghost chosen-register on row 0
records the first value a proposer saw majority-accepted.

Every handler runs on the whole batch at once, on the handling node's
row (`node_row` / `write_row`); the ghost registers are row 0's alone
and are written as whole tensors. The message types are not switched:
each type's updates are masked by its own condition, in the reference's
order.

Invariant: AGREEMENT (140), at most one value is ever chosen.
`NoPromiseCheckPaxos` (`demo-nopromise-paxos`) drops the acceptor's
ballot guard on ACCEPT, so dueling proposers get two values chosen.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from ..engine.machine import Machine, Outbox, make_payload, node_row, send_all_if, send_if, set_timer_if, write_row

# messages
M_PREPARE, M_PROMISE, M_ACCEPT, M_ACCEPTED, M_NACK = 1, 2, 3, 4, 5

# timers
T_BOOT, T_PROPOSE, T_RETRY = 0, 1, 2

AGREEMENT = 140

PROPOSE_MIN_US = 20_000
PROPOSE_SPAN_US = 180_000
RETRY_MIN_US = 150_000
RETRY_SPAN_US = 250_000

IDLE, PREPARING, ACCEPTING, DECIDED = 0, 1, 2, 3

# the ghost chosen-register and violation flag: row 0's alone
_GHOST = ("chosen_any", "chosen_val", "bad")


@dataclasses.dataclass
class PaxosState:
    # acceptor (durable: Paxos stable storage)
    promised: torch.Tensor  # int32[L, N] highest ballot promised (-1 none)
    acc_ballot: torch.Tensor  # int32[L, N] ballot of the accepted value (-1 none)
    acc_value: torch.Tensor  # int32[L, N] accepted value (0 none)
    # proposer (volatile)
    phase: torch.Tensor  # int32[L, N]
    ballot: torch.Tensor  # int32[L, N] current ballot
    round: torch.Tensor  # int32[L, N] retry round counter
    promises: torch.Tensor  # int32[L, N] promise count this ballot
    best_ballot: torch.Tensor  # int32[L, N] highest accepted ballot among promises
    best_value: torch.Tensor  # int32[L, N] its value
    accepts: torch.Tensor  # int32[L, N] ACCEPTED count this ballot
    decided: torch.Tensor  # bool[L, N]
    # ghost chosen-register (spec-only, row 0)
    chosen_any: torch.Tensor  # bool[L, N]
    chosen_val: torch.Tensor  # int32[L, N]
    bad: torch.Tensor  # bool[L, N]


class PaxosMachine(Machine):
    PAYLOAD_WIDTH = 5
    MAX_TIMERS = 2
    NUM_PROPOSERS = 2
    state_type = PaxosState

    def __init__(self, num_nodes: int = 5):
        self.NUM_NODES = num_nodes
        self.MAX_MSGS = num_nodes - 1
        self.majority = num_nodes // 2 + 1

    def init(self, rng_key) -> PaxosState:
        lanes, n, dev = rng_key.shape[0], self.NUM_NODES, rng_key.device
        z = torch.zeros((lanes, n), dtype=torch.int32, device=dev)
        f = torch.zeros((lanes, n), dtype=torch.bool, device=dev)
        return PaxosState(promised=z - 1, acc_ballot=z - 1, acc_value=z, phase=z, ballot=z - 1, round=z,
                          promises=z, best_ballot=z - 1, best_value=z, accepts=z, decided=f, chosen_any=f,
                          chosen_val=z, bad=f)

    def durable_spec(self) -> PaxosState:
        """The acceptor's promised / accepted state and the round counter
        are stable storage, the proposer's phase is volatile; the ghost
        register and the violation flag are spec state."""
        return PaxosState(
            promised=True, acc_ballot=True, acc_value=True, phase=False, ballot=False, round=True,
            promises=False, best_ballot=False, best_value=False, accepts=False, decided=False,
            chosen_any=True, chosen_val=True, bad=True,
        )

    def restart_if(self, nodes: PaxosState, i, cond, rng_key) -> PaxosState:
        """The acceptor state survives; the proposer side restarts idle
        and re-proposes from its surviving round counter."""
        row = (torch.arange(self.NUM_NODES, device=i.device)[None, :] == i[:, None]) & cond[:, None]
        return dataclasses.replace(
            nodes,
            phase=torch.where(row, IDLE, nodes.phase),
            ballot=torch.where(row, -1, nodes.ballot),
            promises=torch.where(row, 0, nodes.promises),
            best_ballot=torch.where(row, -1, nodes.best_ballot),
            best_value=torch.where(row, 0, nodes.best_value),
            accepts=torch.where(row, 0, nodes.accepts),
            decided=torch.where(row, False, nodes.decided),
        )

    # -- helpers ---------------------------------------------------------------

    def _row(self, nodes: PaxosState, node) -> dict:
        r = node_row(nodes, node)
        for k in _GHOST:
            del r[k]
        return r

    def _peers(self, node):
        offs = torch.arange(1, self.NUM_NODES, device=node.device, dtype=torch.int32)
        return (node.to(torch.int32)[:, None] + offs) % self.NUM_NODES

    def _is_proposer(self, node):
        return node < self.NUM_PROPOSERS

    def _accept_guard(self, r: dict, b) -> torch.Tensor:
        """The acceptor's ballot check on ACCEPT: the line the bug drops."""
        return b >= r["promised"]

    def _start_prepare(self, r: dict, node, outbox: Outbox, cond) -> Outbox:
        """Begin a new ballot: self-promise and broadcast PREPARE. The
        round jumps past whatever our own acceptor promised, so the new
        ballot is always self-promisable."""
        n = self.NUM_NODES
        round_eff = torch.maximum(r["round"], torch.div(r["promised"] - node, n, rounding_mode="floor") + 1)
        new_ballot = round_eff * n + node
        r["phase"] = torch.where(cond, PREPARING, r["phase"])
        r["ballot"] = torch.where(cond, new_ballot, r["ballot"])
        r["round"] = torch.where(cond, round_eff + 1, r["round"])
        r["promises"] = torch.where(cond, 1, r["promises"])
        r["best_ballot"] = torch.where(cond, r["acc_ballot"], r["best_ballot"])
        r["best_value"] = torch.where(cond, r["acc_value"], r["best_value"])
        r["accepts"] = torch.where(cond, 0, r["accepts"])
        r["promised"] = torch.where(cond, new_ballot, r["promised"])
        prepare = make_payload(self.PAYLOAD_WIDTH, M_PREPARE, new_ballot)
        return send_all_if(outbox, cond, self._peers(node), prepare)

    # -- timers ---------------------------------------------------------------

    def on_timer(self, nodes: PaxosState, node, timer_id, now_us, rand_u32) -> Tuple[PaxosState, Outbox]:
        r = self._row(nodes, node)
        outbox = self.empty_outbox(node.shape[0], node.device)
        is_prop = self._is_proposer(node)
        delay = PROPOSE_MIN_US + (rand_u32[:, 0] % PROPOSE_SPAN_US).to(torch.int32)
        outbox = set_timer_if(outbox, 0, (timer_id == T_BOOT) & is_prop, delay, T_PROPOSE)
        fire = (timer_id == T_PROPOSE) | (timer_id == T_RETRY)
        outbox = self._start_prepare(r, node, outbox, fire & is_prop & ~r["decided"])
        # the retry timer: still undecided later, go again with a higher ballot
        retry_delay = RETRY_MIN_US + (rand_u32[:, 1] % RETRY_SPAN_US).to(torch.int32)
        outbox = set_timer_if(outbox, 1, fire & is_prop, retry_delay, T_RETRY)
        return write_row(nodes, node, r), outbox

    # -- messages -------------------------------------------------------------

    def on_message(self, nodes: PaxosState, node, src, payload, now_us, rand_u32) -> Tuple[PaxosState, Outbox]:
        r = self._row(nodes, node)
        outbox = self.empty_outbox(node.shape[0], node.device)
        mtype = payload[:, 0]
        pay = lambda *vals: make_payload(self.PAYLOAD_WIDTH, *vals)  # noqa: E731

        # ---- acceptor: PREPARE -> PROMISE or NACK ----
        is_prep = mtype == M_PREPARE
        b = payload[:, 1]
        grant = is_prep & (b > r["promised"])
        r["promised"] = torch.where(grant, b, r["promised"])
        outbox = send_if(outbox, 0, grant, src, pay(M_PROMISE, b, r["acc_ballot"], r["acc_value"]))
        outbox = send_if(outbox, 0, is_prep & ~grant, src, pay(M_NACK, b))

        # ---- proposer: PROMISE ----
        is_promise = (mtype == M_PROMISE) & self._is_proposer(node)
        p_b, p_accb, p_accv = payload[:, 1], payload[:, 2], payload[:, 3]
        counts = is_promise & (r["phase"] == PREPARING) & (p_b == r["ballot"])
        better = counts & (p_accb > r["best_ballot"])
        new_promises = r["promises"] + counts.to(torch.int32)
        r["promises"] = new_promises
        r["best_ballot"] = torch.where(better, p_accb, r["best_ballot"])
        r["best_value"] = torch.where(better, p_accv, r["best_value"])
        quorum = counts & (new_promises >= self.majority)
        # constrained choice: the highest accepted value among promises, else own
        value = torch.where(r["best_ballot"] >= 0, r["best_value"], node.to(torch.int32) + 1)
        self_ok = quorum & self._accept_guard(r, r["ballot"])
        r["phase"] = torch.where(quorum, ACCEPTING, r["phase"])
        r["accepts"] = torch.where(quorum, self_ok.to(torch.int32), r["accepts"])
        r["acc_ballot"] = torch.where(self_ok, r["ballot"], r["acc_ballot"])
        r["acc_value"] = torch.where(self_ok, value, r["acc_value"])
        outbox = send_all_if(outbox, quorum, self._peers(node), pay(M_ACCEPT, r["ballot"], value))

        # ---- acceptor: ACCEPT -> ACCEPTED ----
        a_b, a_v = payload[:, 1], payload[:, 2]
        took = (mtype == M_ACCEPT) & self._accept_guard(r, a_b)
        r["promised"] = torch.where(took, torch.maximum(a_b, r["promised"]), r["promised"])
        r["acc_ballot"] = torch.where(took, a_b, r["acc_ballot"])
        r["acc_value"] = torch.where(took, a_v, r["acc_value"])
        outbox = send_if(outbox, 0, took, src, pay(M_ACCEPTED, a_b, a_v))

        # ---- proposer: ACCEPTED -> chosen on a majority ----
        is_acked = (mtype == M_ACCEPTED) & self._is_proposer(node)
        k_b, k_v = payload[:, 1], payload[:, 2]
        counts2 = is_acked & (r["phase"] == ACCEPTING) & (k_b == r["ballot"])
        new_accepts = r["accepts"] + counts2.to(torch.int32)
        chosen = counts2 & (new_accepts >= self.majority)
        r["accepts"] = new_accepts
        r["phase"] = torch.where(chosen, DECIDED, r["phase"])
        r["decided"] = r["decided"] | chosen

        # the ghost chosen-register on row 0 (the agreement check)
        any0, val0 = nodes.chosen_any[:, 0], nodes.chosen_val[:, 0]
        conflict = chosen & any0 & (val0 != k_v)
        first = chosen & ~any0
        row0 = (torch.arange(self.NUM_NODES, device=node.device) == 0)[None, :]
        ghost = {
            "chosen_any": nodes.chosen_any | (first[:, None] & row0),
            "chosen_val": torch.where(first[:, None] & row0, k_v[:, None], nodes.chosen_val),
            "bad": nodes.bad | (conflict[:, None] & row0),
        }
        return dataclasses.replace(write_row(nodes, node, r), **ghost), outbox

    # -- invariants / results --------------------------------------------------

    def invariant(self, nodes: PaxosState, now_us):
        ok = ~nodes.bad[:, 0]
        return ok, torch.where(ok, 0, AGREEMENT).to(torch.int32)

    def is_done(self, nodes: PaxosState, now_us):
        return nodes.decided[:, : self.NUM_PROPOSERS].all(dim=1)

    def summary(self, nodes: PaxosState):
        return {
            "chosen": nodes.chosen_any[:, 0],
            "value": nodes.chosen_val[:, 0],
            "rounds": nodes.round[:, : self.NUM_PROPOSERS].amax(dim=1),
        }

    def coverage_projection(self, nodes: PaxosState, now_us):
        """Highest ballot bucket (phase) x proposer-phase spread x
        decisions landed x chosen-register state x promise bucket."""
        ballot_b = nodes.ballot.amax(dim=1).clamp(0, 7)
        max_phase = nodes.phase[:, : self.NUM_PROPOSERS].amax(dim=1).clamp(0, 3)
        decided_n = nodes.decided[:, : self.NUM_PROPOSERS].sum(dim=1, dtype=torch.int32).clamp(0, 3)
        promised_b = (nodes.promised.amax(dim=1) + 1).clamp(0, 7)
        word = (ballot_b | (max_phase << 3) | (decided_n << 5)
                | (nodes.chosen_any[:, 0].to(torch.int32) << 7) | (promised_b << 8))
        return word.to(torch.int64) & 0xFFFFFFFF


class NoPromiseCheckPaxos(PaxosMachine):
    """Bug variant: acceptors take any ACCEPT regardless of their
    promise, so dueling proposers get two values chosen (AGREEMENT)."""

    def _accept_guard(self, r: dict, b) -> torch.Tensor:
        return torch.ones_like(b, dtype=torch.bool)
