"""Lint fixture (torch twin): C002/C003/C004 model-contract violations.

Unlike the other fixtures this one IS imported (the C import half
instantiates each class) — it must construct, and its bugs live in the
contracts, not the syntax.
"""

import torch

from madsim_tpu_torch.engine.machine import Machine, TORN_LOSE
import dataclasses


@dataclasses.dataclass
class _State:
    log: torch.Tensor
    commit: torch.Tensor


class BadDurableSpecMachine(Machine):
    NUM_NODES = 3

    def init(self, rng_key):
        return _State(
            log=torch.zeros((rng_key.shape[0], self.NUM_NODES, 4), dtype=torch.int32),
            commit=torch.zeros((rng_key.shape[0], self.NUM_NODES), dtype=torch.int32),
        )

    def durable_spec(self):
        # LINT C002: not congruent — missing the `commit` leaf
        return {"log": True}

    def on_timer(self, nodes, node, timer_id, now_us, rand_u32):
        return nodes, self.empty_outbox(now_us.shape[0], now_us.device)

    def on_message(self, nodes, node, src, payload, now_us, rand_u32):
        return nodes, self.empty_outbox(now_us.shape[0], now_us.device)


class BadTornSpecMachine(Machine):
    NUM_NODES = 3

    def init(self, rng_key):
        return _State(
            log=torch.zeros((rng_key.shape[0], self.NUM_NODES, 4), dtype=torch.int32),
            commit=torch.zeros((rng_key.shape[0], self.NUM_NODES), dtype=torch.int32),
        )

    def durable_spec(self):
        return _State(log=True, commit=True)

    def torn_spec(self):
        # LINT C003: 99 is not a legal atomicity class
        return _State(log=TORN_LOSE, commit=99)

    def on_timer(self, nodes, node, timer_id, now_us, rand_u32):
        return nodes, self.empty_outbox(now_us.shape[0], now_us.device)

    def on_message(self, nodes, node, src, payload, now_us, rand_u32):
        return nodes, self.empty_outbox(now_us.shape[0], now_us.device)


class VectorProjectionMachine(Machine):
    NUM_NODES = 3

    def init(self, rng_key):
        return _State(
            log=torch.zeros((rng_key.shape[0], self.NUM_NODES, 4), dtype=torch.int32),
            commit=torch.zeros((rng_key.shape[0], self.NUM_NODES), dtype=torch.int32),
        )

    def coverage_projection(self, nodes, now_us):
        # LINT C004: a row per node, not the one word per lane the map folds
        return nodes.commit.to(torch.int64)

    def on_timer(self, nodes, node, timer_id, now_us, rand_u32):
        return nodes, self.empty_outbox(now_us.shape[0], now_us.device)

    def on_message(self, nodes, node, src, payload, now_us, rand_u32):
        return nodes, self.empty_outbox(now_us.shape[0], now_us.device)


class HonestContractMachine(Machine):
    NUM_NODES = 3

    def init(self, rng_key):
        return _State(
            log=torch.zeros((rng_key.shape[0], self.NUM_NODES, 4), dtype=torch.int32),
            commit=torch.zeros((rng_key.shape[0], self.NUM_NODES), dtype=torch.int32),
        )

    def durable_spec(self):
        return _State(log=True, commit=False)

    def torn_spec(self):
        return _State(log=TORN_LOSE, commit=TORN_LOSE)

    def coverage_projection(self, nodes, now_us):
        return nodes.commit.amax(dim=1).to(torch.int64)

    def on_timer(self, nodes, node, timer_id, now_us, rand_u32):
        return nodes, self.empty_outbox(now_us.shape[0], now_us.device)

    def on_message(self, nodes, node, src, payload, now_us, rand_u32):
        return nodes, self.empty_outbox(now_us.shape[0], now_us.device)
