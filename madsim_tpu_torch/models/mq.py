"""Message-queue ordering machine (the rdkafka-class workload) as a
lane-batched Machine.

The port of `madsim_tpu/models/mq.py`. Node 0 is a single-partition
broker with an idempotent-producer protocol (dedup by each producer's
expected seq, as Kafka's producer idempotence); nodes 1..N-2 are
producers appending with at-least-once retries; the last node is a
consumer polling fetches. The broker's log and dedup cursors survive
restart faults, and acks carry the broker's cumulative cursor.

Checked invariant (DUP_OR_GAP, 120): the consumed stream holds every
producer's sequence exactly once and in order. It holds under loss,
partitions and kill/restart; the tests' `NoDedupBroker` (retries append
duplicates) breaks it.

The broker's log is `[L, N, log_capacity]` with appends at a moving
head; every append is a masked select, never a scatter.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from ..engine.machine import Machine, Outbox, make_payload, send_if, set_at, set_timer_if
from ..utils import take

BROKER = 0

# messages
M_PRODUCE, M_ACK, M_FETCH, M_BATCH = 1, 2, 3, 4

# timers
T_BOOT, T_PRODUCE, T_POLL, T_RETRY = 0, 1, 2, 3

DUP_OR_GAP = 120

PRODUCE_US = 30_000
POLL_US = 25_000
RETRY_US = 100_000


@dataclasses.dataclass
class MqState:
    # broker
    log_producer: torch.Tensor  # int32[L, N, CAP] producer id per log slot
    log_seq: torch.Tensor  # int32[L, N, CAP]
    log_len: torch.Tensor  # int32[L, N]
    expected: torch.Tensor  # int32[L, N, N] the broker's dedup cursor per producer
    # producers
    next_seq: torch.Tensor  # int32[L, N] next seq to produce
    inflight: torch.Tensor  # bool[L, N] waiting for an ack
    # consumer
    offset: torch.Tensor  # int32[L, N] next log offset to fetch
    seen: torch.Tensor  # int32[L, N, N] the consumer's next expected seq per producer
    bad: torch.Tensor  # bool[L, N]


def _put_row(arr, row_idx: int, row):
    """arr [L, N, ...] with row `row_idx` of every lane replaced by `row` [L, ...]."""
    mask = torch.arange(arr.shape[1], device=arr.device) == row_idx
    mask = mask.reshape((1, -1) + (1,) * (arr.dim() - 2))
    return torch.where(mask, row.unsqueeze(1), arr)


class MqMachine(Machine):
    """num_nodes = 1 broker + (num_nodes - 2) producers + 1 consumer."""

    PAYLOAD_WIDTH = 5
    MAX_MSGS = 1
    MAX_TIMERS = 2
    state_type = MqState

    def __init__(self, num_nodes: int = 4, log_capacity: int = 24, max_seq: int = 10):
        self.NUM_NODES = num_nodes
        self.log_capacity = log_capacity
        self.max_seq = max_seq
        self.consumer = num_nodes - 1

    def init(self, rng_key) -> MqState:
        lanes, n, cap, dev = rng_key.shape[0], self.NUM_NODES, self.log_capacity, rng_key.device
        i32 = {"dtype": torch.int32, "device": dev}
        z = torch.zeros((lanes, n), **i32)
        f = torch.zeros((lanes, n), dtype=torch.bool, device=dev)
        return MqState(log_producer=torch.zeros((lanes, n, cap), **i32), log_seq=torch.zeros((lanes, n, cap), **i32),
                       log_len=z, expected=torch.zeros((lanes, n, n), **i32), next_seq=z, inflight=f, offset=z,
                       seen=torch.zeros((lanes, n, n), **i32), bad=f)

    def init_node(self, nodes: MqState, i, rng_key) -> MqState:
        """Restart: the broker is durable (log and dedup cursors persist,
        as Kafka's on-disk partitions); producers and the consumer reset
        their volatile state."""
        return self.restart_if(nodes, i, torch.ones_like(i, dtype=torch.bool), rng_key)

    def restart_if(self, nodes: MqState, i, cond, rng_key) -> MqState:
        mask = (torch.arange(self.NUM_NODES, device=i.device)[None, :] == i[:, None]) & \
            (cond & (i != BROKER))[:, None]
        return dataclasses.replace(
            nodes,
            next_seq=torch.where(mask, 0, nodes.next_seq),
            inflight=nodes.inflight & ~mask,
            offset=torch.where(mask, 0, nodes.offset),
            seen=torch.where(mask[:, :, None], 0, nodes.seen),
        )

    def _is_producer(self, node):
        return (node != BROKER) & (node != self.consumer)

    # -- broker-side append with dedup ---------------------------------------

    def _accepts(self, nodes: MqState, producer, seq) -> torch.Tensor:
        """The idempotence predicate: the one line the NoDedup bug
        variant overrides."""
        return seq == take(nodes.expected[:, BROKER], producer)

    def _append(self, nodes: MqState, producer, seq, do) -> MqState:
        log_len = nodes.log_len[:, BROKER]
        fresh = do & self._accepts(nodes, producer, seq) & (log_len < self.log_capacity)
        slot = torch.clamp(log_len, max=self.log_capacity - 1)
        row_p = set_at(nodes.log_producer[:, BROKER], slot, producer, fresh)
        row_s = set_at(nodes.log_seq[:, BROKER], slot, seq, fresh)
        exp_row = set_at(nodes.expected[:, BROKER], producer, seq + 1, fresh)
        return dataclasses.replace(
            nodes,
            log_producer=_put_row(nodes.log_producer, BROKER, row_p),
            log_seq=_put_row(nodes.log_seq, BROKER, row_s),
            log_len=_put_row(nodes.log_len, BROKER, log_len + fresh.to(torch.int32)),
            expected=_put_row(nodes.expected, BROKER, exp_row),
        )

    # -- timers ---------------------------------------------------------------

    def on_timer(self, nodes: MqState, node, timer_id, now_us, rand_u32) -> Tuple[MqState, Outbox]:
        outbox = self.empty_outbox(node.shape[0], node.device)
        is_boot = timer_id == T_BOOT
        is_prod = self._is_producer(node)
        is_cons = node == self.consumer

        outbox = set_timer_if(outbox, 0, is_boot & is_prod, PRODUCE_US, T_PRODUCE)
        outbox = set_timer_if(outbox, 0, is_boot & is_cons, POLL_US, T_POLL)

        # producer: send the next seq when idle
        tick = (timer_id == T_PRODUCE) & is_prod
        inflight, next_seq = take(nodes.inflight, node), take(nodes.next_seq, node)
        start = tick & ~inflight & (next_seq < self.max_seq)
        produce = make_payload(self.PAYLOAD_WIDTH, M_PRODUCE, node, next_seq)
        outbox = send_if(outbox, 0, start, BROKER, produce)
        inflight = inflight | start
        nodes = dataclasses.replace(nodes, inflight=set_at(nodes.inflight, node, inflight))
        outbox = set_timer_if(outbox, 0, tick, PRODUCE_US, T_PRODUCE)
        outbox = set_timer_if(outbox, 1, start, RETRY_US, T_RETRY)

        # producer retry (at-least-once)
        retry = (timer_id == T_RETRY) & is_prod & inflight
        outbox = send_if(outbox, 0, retry, BROKER, produce)
        outbox = set_timer_if(outbox, 1, retry, RETRY_US, T_RETRY)

        # consumer: poll for the next offset
        poll = (timer_id == T_POLL) & is_cons
        fetch = make_payload(self.PAYLOAD_WIDTH, M_FETCH, node, take(nodes.offset, node))
        outbox = send_if(outbox, 0, poll, BROKER, fetch)
        outbox = set_timer_if(outbox, 0, poll, POLL_US, T_POLL)
        return nodes, outbox

    # -- messages -------------------------------------------------------------

    def on_message(self, nodes: MqState, node, src, payload, now_us, rand_u32) -> Tuple[MqState, Outbox]:
        outbox = self.empty_outbox(node.shape[0], node.device)
        mtype = payload[:, 0]

        # broker: PRODUCE -> append (dedup) + a cumulative ack ("I have
        # everything below `expected`"; a stale or duplicate PRODUCE still
        # gets an informative ack)
        is_produce = (node == BROKER) & (mtype == M_PRODUCE)
        producer, seq = payload[:, 1], payload[:, 2]
        nodes = self._append(nodes, producer, seq, is_produce)
        ack = make_payload(self.PAYLOAD_WIDTH, M_ACK, take(nodes.expected[:, BROKER], producer))
        outbox = send_if(outbox, 0, is_produce, producer, ack)

        # broker: FETCH -> the entry at the offset (if any)
        is_fetch = (node == BROKER) & (mtype == M_FETCH)
        consumer, offset = payload[:, 1], payload[:, 2]
        have = offset < nodes.log_len[:, BROKER]
        slot = torch.clamp(offset, max=self.log_capacity - 1)
        batch = make_payload(self.PAYLOAD_WIDTH, M_BATCH, offset, take(nodes.log_producer[:, BROKER], slot),
                             take(nodes.log_seq[:, BROKER], slot))
        outbox = send_if(outbox, 0, is_fetch & have, consumer, batch)

        # producer: a cumulative ack advances next_seq; an ack that does
        # not cover the outstanding record keeps it in flight (the retry
        # goes on), so a full log degrades to retries, never to loss
        is_ack = self._is_producer(node) & (mtype == M_ACK)
        next_seq, inflight = take(nodes.next_seq, node), take(nodes.inflight, node)
        acked = is_ack & (payload[:, 1] > next_seq) & inflight
        nodes = dataclasses.replace(nodes, inflight=set_at(nodes.inflight, node, inflight & ~acked),
                                    next_seq=set_at(nodes.next_seq, node, torch.where(acked, payload[:, 1], next_seq)))

        # consumer: a BATCH at the expected offset advances; per-producer order
        is_batch = (node == self.consumer) & (mtype == M_BATCH)
        b_off, b_prod, b_seq = payload[:, 1], payload[:, 2], payload[:, 3]
        my_offset, seen = take(nodes.offset, node), take(nodes.seen, node)
        took = is_batch & (b_off == my_offset)
        in_order = b_seq == take(seen, b_prod)
        row = {
            "offset": torch.where(took, my_offset + 1, my_offset),
            "bad": take(nodes.bad, node) | (took & ~in_order),
            "seen": set_at(seen, b_prod, b_seq + 1, took & in_order),
        }
        return dataclasses.replace(nodes, **{k: set_at(getattr(nodes, k), node, v) for k, v in row.items()}), outbox

    # -- invariants / results ---------------------------------------------------

    def invariant(self, nodes: MqState, now_us):
        ok = ~nodes.bad.any(dim=1)
        return ok, torch.where(ok, 0, DUP_OR_GAP).to(torch.int32)

    def is_done(self, nodes: MqState, now_us):
        total = (self.NUM_NODES - 2) * self.max_seq
        return nodes.offset[:, self.consumer] >= min(total, self.log_capacity)

    def summary(self, nodes: MqState):
        return {
            "log_len": nodes.log_len[:, BROKER],
            "consumed": nodes.offset[:, self.consumer],
            "produced": (nodes.next_seq.sum(dim=1, dtype=torch.int32) - nodes.next_seq[:, BROKER]
                         - nodes.next_seq[:, self.consumer]),
        }
