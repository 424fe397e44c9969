"""One etcd app, two worlds — the dual-build story end to end.

The port's copy of `examples/etcd_dual.py`, importing
`madsim_tpu_torch`; it prints the same lines in both modes.

`workload(client)` below is ordinary application code against the
`services.etcd.Client` surface. It runs UNMODIFIED in both modes
(reference: madsim-etcd-client/src/lib.rs:1-8 re-exports the real client
under `cfg(not(madsim))` so app code is identical in test and prod):

  sim (default):  python examples/etcd_dual_torch.py
      -> deterministic simulation; the server is a sim node, seeds
         reproduce, chaos applies

  real:           MADSIM_TPU_MODE=real python -m madsim_tpu_torch serve --service etcd --addr 127.0.0.1:23790 &
                  MADSIM_TPU_MODE=real python examples/etcd_dual_torch.py 127.0.0.1:23790
      -> the same client code over real asyncio TCP to a real server

  real + genuine etcd:
                  MADSIM_TPU_MODE=real python examples/etcd_dual_torch.py <etcd-host>:2379
      -> Client.connect probes the endpoint with an etcd v3 Status rpc;
         a genuine etcd (or `python -m madsim_tpu_torch serve --service etcd --grpc`)
         answers, and every call goes over the real etcd wire protocol
         (services/etcd/real_client.py — the analogue of the reference
         re-exporting etcd_client in non-sim builds, lib.rs:5-6).
         Unreachable/non-etcd endpoints fall back to the pickle
         sim-protocol server above.
"""

from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from madsim_tpu_torch import dual
from madsim_tpu_torch.services.etcd import Client, Compare, SimServer, Txn, TxnOp


async def workload(client: Client) -> dict:
    """App logic — identical bytes in sim and production."""
    await client.put("config/region", "us-east")
    await client.put("config/replicas", "3")
    got = await client.get("config/region")
    assert got["kvs"][0].value == b"us-east", got

    # prefix scan
    pfx = await client.get("config/", prefix=True)
    keys = sorted(kv.key.decode() for kv in pfx["kvs"])

    # lease + attached key + keepalive
    lease = await client.lease_grant(60)
    await client.put("live/worker-1", "up", lease=lease["id"])
    await client.lease_keep_alive(lease["id"])

    # CAS via txn
    txn = (
        Txn()
        .when([Compare.value("config/replicas", "=", "3")])
        .and_then([TxnOp.put("config/replicas", "5")])
        .or_else([TxnOp.put("config/conflict", "1")])
    )
    txn_rsp = await client.txn(txn)
    after = await client.get("config/replicas")

    return {
        "keys": keys,
        "txn_succeeded": txn_rsp["succeeded"],
        "replicas": after["kvs"][0].value.decode(),
        "lease": lease["id"] > 0,
    }


def main() -> None:
    if dual.IS_SIM:
        from madsim_tpu_torch.runtime import Handle, Runtime

        async def scenario():
            handle = Handle.current()

            async def server():
                await SimServer().serve("0.0.0.0:2379")

            handle.create_node().name("etcd").ip("10.5.0.1").init(server).build()
            client_node = handle.create_node().name("app").ip("10.5.0.2").build()

            async def app():
                client = await Client.connect("10.5.0.1:2379")
                return await workload(client)

            return await client_node.spawn(app())

        result = Runtime(seed=1).block_on(scenario())
        print(f"[sim] {result}")
    else:
        import asyncio

        addr = sys.argv[1] if len(sys.argv) > 1 else "127.0.0.1:23790"

        async def app():
            client = await Client.connect(addr)
            return await workload(client)

        result = asyncio.run(app())
        print(f"[real] {result}")


if __name__ == "__main__":
    main()
