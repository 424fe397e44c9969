"""Echo / hello-RPC machine as a lane-batched Machine: the client pings,
the server echoes, K rounds.

The port of `madsim_tpu/models/echo.py`, the JAX suite's fixture model:
node 0 is the client, node 1 the server. The client sends PING(n) on
boot and on each retry timer; it is done when K replies arrived.
Invariant: replies arrive in order (BAD_ORDER, 100). It declares no
`durable_spec`, so the engine refuses strict and torn restarts for it.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from ..engine.machine import Machine, Outbox, make_payload, send_if, set_at, set_timer_if

PING = 1
PONG = 2

CLIENT = 0
SERVER = 1

# fail codes
BAD_ORDER = 100


@dataclasses.dataclass
class EchoState:
    sent: torch.Tensor  # int32[L, N] pings sent (client)
    acked: torch.Tensor  # int32[L, N] replies received in order (client)
    served: torch.Tensor  # int32[L, N] pings served (server)
    bad: torch.Tensor  # bool[L, N] ordering violation observed


class EchoMachine(Machine):
    NUM_NODES = 2
    PAYLOAD_WIDTH = 4
    MAX_MSGS = 1
    MAX_TIMERS = 1
    state_type = EchoState

    def __init__(self, rounds: int = 10, retry_us: int = 100_000):
        self.rounds = rounds
        self.retry_us = retry_us

    def init(self, rng_key) -> EchoState:
        z = torch.zeros((rng_key.shape[0], self.NUM_NODES), dtype=torch.int32, device=rng_key.device)
        return EchoState(sent=z, acked=z, served=z, bad=torch.zeros_like(z, dtype=torch.bool))

    @staticmethod
    def _at(lanes_of, node: int, device):
        return torch.full((lanes_of,), node, dtype=torch.int32, device=device)

    def on_timer(self, nodes: EchoState, node, timer_id, now_us, rand_u32) -> Tuple[EchoState, Outbox]:
        lanes, dev = node.shape[0], node.device
        outbox = self.empty_outbox(lanes, dev)
        # BOOT or the retry timer: (re)send the current ping
        seq = nodes.acked[:, CLIENT]
        want = (node == CLIENT) & (seq < self.rounds)
        outbox = send_if(outbox, 0, want, SERVER, make_payload(self.PAYLOAD_WIDTH, PING, seq))
        outbox = set_timer_if(outbox, 0, want, self.retry_us, 1)  # retry on loss
        sent = torch.where(want, nodes.sent[:, CLIENT] + 1, nodes.sent[:, CLIENT])
        return dataclasses.replace(nodes, sent=set_at(nodes.sent, self._at(lanes, CLIENT, dev), sent)), outbox

    def on_message(self, nodes: EchoState, node, src, payload, now_us, rand_u32) -> Tuple[EchoState, Outbox]:
        lanes, dev = node.shape[0], node.device
        outbox = self.empty_outbox(lanes, dev)
        mtype, seq = payload[:, 0], payload[:, 1]
        client, server = self._at(lanes, CLIENT, dev), self._at(lanes, SERVER, dev)

        # server: echo back
        is_ping = (node == SERVER) & (mtype == PING)
        outbox = send_if(outbox, 0, is_ping, CLIENT, make_payload(self.PAYLOAD_WIDTH, PONG, seq))
        served = torch.where(is_ping, nodes.served[:, SERVER] + 1, nodes.served[:, SERVER])

        # client: accept the in-order reply (retries make duplicates
        # possible; a reply ahead of order is a protocol violation)
        is_pong = (node == CLIENT) & (mtype == PONG)
        acked = nodes.acked[:, CLIENT]
        new_acked = torch.where(is_pong & (seq == acked), acked + 1, acked)
        bad = nodes.bad[:, CLIENT] | (is_pong & (seq > acked))
        return dataclasses.replace(
            nodes,
            served=set_at(nodes.served, server, served),
            acked=set_at(nodes.acked, client, new_acked),
            bad=set_at(nodes.bad, client, bad),
        ), outbox

    def invariant(self, nodes: EchoState, now_us):
        ok = ~nodes.bad.any(dim=1)
        return ok, torch.where(ok, 0, BAD_ORDER).to(torch.int32)

    def is_done(self, nodes: EchoState, now_us):
        return nodes.acked[:, CLIENT] >= self.rounds

    def summary(self, nodes: EchoState):
        return {"acked": nodes.acked[:, CLIENT], "served": nodes.served[:, SERVER]}
