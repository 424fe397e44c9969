"""A service pipeline under chaos: gRPC + etcd + kafka + S3, one seed.

The port's copy of `examples/chaos_pipeline.py`, importing
`madsim_tpu_torch`; it prints the same lines for the same seed.

Shows the host engine's ecosystem surface in one place (the reference's
tonic-example + etcd/rdkafka integration tests rolled together). Every
run with the same seed prints the same thing, byte for byte.

Run:  python examples/chaos_pipeline_torch.py [seed]
"""

from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from madsim_tpu_torch import grpc, time as sim_time
from madsim_tpu_torch.runtime import Handle, Runtime
from madsim_tpu_torch.services import etcd, kafka, s3


@grpc.service("pipeline.Ingest")
class Ingest:
    def __init__(self, producer):
        self.producer = producer

    @grpc.unary
    async def push(self, request):
        part, off = await self.producer.send_and_wait(
            kafka.FutureRecord("events", payload=request.into_inner().encode())
        )
        return grpc.Response(f"events[{part}]@{off}")


async def scenario():
    handle = Handle.current()
    handle.create_node().name("etcd").ip("10.0.8.1").init(
        lambda: etcd.SimServer().serve("0.0.0.0:2379")
    ).build()
    handle.create_node().name("kafka").ip("10.0.8.2").init(
        lambda: kafka.SimBroker().serve("0.0.0.0:9092")
    ).build()
    handle.create_node().name("s3").ip("10.0.8.3").init(
        lambda: s3.SimServer().serve("0.0.0.0:9000")
    ).build()
    await sim_time.sleep(0.3)

    async def ingest_app():
        cfg = kafka.ClientConfig({"bootstrap.servers": "10.0.8.2:9092"})
        await (await cfg.create_admin()).create_topics([kafka.NewTopic("events", 1)])
        producer = await cfg.create_future_producer()
        await grpc.Server.builder().add_service(Ingest(producer)).serve("0.0.0.0:50051")

    app = handle.create_node().name("ingest").ip("10.0.8.10").init(ingest_app).build()
    await sim_time.sleep(0.3)

    async def client():
        # coordination: become the pipeline leader via etcd election
        ecli = await etcd.Client.connect("10.0.8.1:2379")
        lease = await ecli.lease_grant(30)
        await ecli.campaign("pipeline", "worker-1", lease["id"])

        ch = await grpc.connect("http://10.0.8.10:50051")
        placed = [await ch.unary("/pipeline.Ingest/Push", f"evt-{i}") for i in range(3)]

        # chaos: the ingest service crashes and recovers
        handle.kill(app.id)
        await sim_time.sleep(0.2)
        handle.restart(app.id)
        await sim_time.sleep(0.4)
        ch2 = await grpc.connect("http://10.0.8.10:50051")
        placed.append(await ch2.unary("/pipeline.Ingest/Push", "evt-after-crash"))

        # drain the log and snapshot it to S3
        consumer = await kafka.ClientConfig(
            {"bootstrap.servers": "10.0.8.2:9092"}
        ).create_stream_consumer()
        await consumer.subscribe(["events"])
        events = [(await consumer.recv()).payload.decode() for _ in range(4)]
        scli = s3.Client.from_conf(s3.Config(endpoint_url="http://10.0.8.3:9000"))
        await scli.create_bucket().bucket("snapshots").send()
        await scli.put_object().bucket("snapshots").key("events").body(
            ",".join(events).encode()
        ).send()
        snap = await scli.get_object().bucket("snapshots").key("events").send()
        return placed, snap["body"].decode()

    worker = handle.create_node().name("worker").ip("10.0.8.20").build()
    return await worker.spawn(client())


def main():
    seed = int(sys.argv[1]) if len(sys.argv) > 1 else 42
    placed, snapshot = Runtime(seed=seed).block_on(scenario())
    print(f"seed {seed}:")
    print(f"  placed:   {placed}")
    print(f"  snapshot: {snapshot}")


if __name__ == "__main__":
    main()
