"""Consumer-group chaos example: a group survives member crashes.

The port's copy of `examples/group_consumers.py`, importing
`madsim_tpu_torch`; it prints the same lines for the same seed.

The rdkafka consumer-group story end to end on the host engine (the
batched twin is models/kafka_group.py): one broker, one producer
publishing N records, and a group of consumers that the supervisor
randomly kills and restarts. Rebalancing hands dead members' partitions
to survivors, committed offsets make every hand-off lossless, and the
run asserts at-least-once delivery of every record. Same seed, same
output, every time.

Run:  python examples/group_consumers_torch.py [seed]
"""

from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import madsim_tpu_torch
from madsim_tpu_torch import time as sim_time
from madsim_tpu_torch.runtime import Handle, Runtime
from madsim_tpu_torch.services import kafka

TOPIC = "events"
PARTITIONS = 3
RECORDS = 30
GROUP = "workers"


async def consumer_proc(name: str, seen: set) -> None:
    cfg = kafka.ClientConfig(
        {
            "bootstrap.servers": "10.8.0.1:9092",
            "group.id": GROUP,
            "session.timeout.ms": "300",
            "enable.auto.commit": "false",
        }
    )
    c = await cfg.create_base_consumer()
    await c.subscribe([TOPIC])
    while True:
        msg = await c.poll(timeout=0.5)
        if msg is None:
            continue
        seen.add(int(msg.payload.decode()))
        try:
            await c.commit()
        except kafka.KafkaError:
            # fenced commit: a rebalance bumped the generation while this
            # record was in flight (we were partitioned/slow). The record
            # stays uncommitted — the new owner redelivers it, which is
            # exactly the at-least-once contract. Next poll rejoins.
            continue


async def main_async() -> tuple:
    handle = Handle.current()
    rng = madsim_tpu_torch.rand.thread_rng()

    async def serve():
        await kafka.SimBroker().serve("0.0.0.0:9092")

    handle.create_node().name("broker").ip("10.8.0.1").init(serve).build()
    await sim_time.sleep(0.2)

    # producer: publish RECORDS numbered records round-robin
    prod_node = handle.create_node().name("producer").ip("10.8.0.2").build()

    async def produce():
        cfg = kafka.ClientConfig({"bootstrap.servers": "10.8.0.1:9092"})
        admin = await cfg.create_admin()
        await admin.create_topics([kafka.NewTopic(TOPIC, PARTITIONS)])
        p = await cfg.create_future_producer()
        for i in range(RECORDS):
            await p.send_and_wait(
                kafka.FutureRecord(TOPIC, payload=str(i).encode(), partition=i % PARTITIONS)
            )
            await sim_time.sleep(0.05)

    prod_node.spawn(produce())

    # the group: 3 members, restarted with fresh state on every kill
    seen: set = set()
    members = []
    for i in range(3):
        node = (
            handle.create_node()
            .name(f"worker-{i}")
            .ip(f"10.8.0.{10 + i}")
            .init(lambda i=i: consumer_proc(f"worker-{i}", seen))
            .build()
        )
        members.append(node)

    # chaos: random member kill/restart while the stream flows
    for _ in range(4):
        await sim_time.sleep(0.3 + rng.random() * 0.4)
        victim = rng.choice(members)
        handle.kill(victim.id)
        await sim_time.sleep(0.2 + rng.random() * 0.3)
        handle.restart(victim.id)

    # drain: wait until the group has consumed everything
    deadline = sim_time.now() + 20.0
    while len(seen) < RECORDS and sim_time.now() < deadline:
        await sim_time.sleep(0.25)
    return tuple(sorted(seen))


def main() -> int:
    seed = int(sys.argv[1]) if len(sys.argv) > 1 else 7
    out = Runtime(seed=seed).block_on(main_async())
    ok = out == tuple(range(RECORDS))
    print(
        f"seed {seed}: group consumed {len(out)}/{RECORDS} records "
        f"under member crashes -> {'at-least-once holds' if ok else 'LOST RECORDS: ' + str(out)}"
    )
    # determinism: the same seed reproduces the same consumption set
    again = Runtime(seed=seed).block_on(main_async())
    assert again == out, "nondeterministic run!"
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
