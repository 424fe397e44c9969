"""RPC microbenchmarks of the port's host engine — parity with the
reference's criterion suite (reference: madsim/benches/rpc.rs: "empty
RPC" latency and "RPC with data" throughput at 16 B / 256 B / 4 KiB /
64 KiB / 1 MiB).

The port copy of benches/rpc_bench.py, on `madsim_tpu_torch`'s host
engine (`time`, `net`, `runtime`). It touches no device: the host engine
is the seeded single-threaded async runtime, and no simulated RPC runs a
kernel, so the figures are the host's.

Run:  python benches/rpc_bench_torch.py
      MADSIM_TPU_NO_NATIVE=1 python benches/rpc_bench_torch.py   # pure Python
Prints one human-readable line per case plus a final JSON summary, the
same lines and keys as benches/rpc_bench.py. By default the host engine
runs on its native core (`madsim_tpu_torch/_native/hostcore.cc`, built
with g++ at first use); MADSIM_TPU_NO_NATIVE=1 runs the same loop in
pure Python.
"""

from __future__ import annotations

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from madsim_tpu_torch import time as sim_time
from madsim_tpu_torch.net import Endpoint, Request
from madsim_tpu_torch.runtime import Handle, Runtime


class Empty(Request):
    pass


class WithData(Request):
    pass


def bench_empty_rpc(calls: int = 2000) -> float:
    """Wall-clock per simulated empty RPC round trip (reference: rpc.rs:11-26)."""

    async def main():
        handle = Handle.current()
        server = handle.create_node().ip("10.1.1.1").build()
        client = handle.create_node().ip("10.1.1.2").build()

        async def serve():
            ep = await Endpoint.bind("0.0.0.0:1")

            async def h(req, data):
                return None

            ep.add_rpc_handler(Empty, h)
            await sim_time.sleep(1e9)

        server.spawn(serve())

        async def drive():
            ep = await Endpoint.bind("0.0.0.0:0")
            for _ in range(calls):
                await ep.call("10.1.1.1:1", Empty())

        await client.spawn(drive())

    t0 = time.perf_counter()
    Runtime(seed=1).block_on(main())
    return (time.perf_counter() - t0) / calls


def bench_rpc_with_data(size: int, calls: int = 200) -> float:
    """Bytes/sec of simulated payload moved (reference: rpc.rs:28-54)."""
    payload = bytes(size)

    async def main():
        handle = Handle.current()
        server = handle.create_node().ip("10.1.1.1").build()
        client = handle.create_node().ip("10.1.1.2").build()

        async def serve():
            ep = await Endpoint.bind("0.0.0.0:1")

            async def h(req, data):
                return len(data)

            ep.add_rpc_handler(WithData, h)
            await sim_time.sleep(1e9)

        server.spawn(serve())

        async def drive():
            ep = await Endpoint.bind("0.0.0.0:0")
            for _ in range(calls):
                await ep.call_with_data("10.1.1.1:1", WithData(), payload)

        await client.spawn(drive())

    t0 = time.perf_counter()
    Runtime(seed=1).block_on(main())
    elapsed = time.perf_counter() - t0
    return size * calls / elapsed


def main() -> None:
    lat = bench_empty_rpc()
    print(f"empty RPC:        {lat * 1e6:8.1f} us/call (wall) — "
          f"{1 / lat:,.0f} simulated calls/sec")
    results = {"empty_rpc_us": round(lat * 1e6, 1)}
    for size, label in [(16, "16 B"), (256, "256 B"), (4096, "4 KiB"),
                        (65536, "64 KiB"), (1 << 20, "1 MiB")]:
        bps = bench_rpc_with_data(size)
        print(f"RPC w/ data {label:>6}: {bps / 1e6:8.1f} MB/s (payloads move "
              f"zero-copy between sim nodes)")
        results[f"throughput_{label.replace(' ', '')}_MBps"] = round(bps / 1e6, 1)
    print(json.dumps(results))


if __name__ == "__main__":
    main()
