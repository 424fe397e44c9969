"""The port's real-mode backend (`madsim_tpu_torch.real`, `.dual`):
the same tag / RPC API over actual sockets on 127.0.0.1, mirroring
tests/test_real_mode.py. Each workload runs on the port and on the JAX
package (`torch_host_util.both`) and gives equal values; the
`MADSIM_TPU_MODE` switch selects the port's sim or asyncio Endpoint.
The service cases run the JAX file's own cases and their port copies
(`torch_mirror_util`): the port's copy starts `python -m
madsim_tpu_torch serve` and runs the same client script on the port."""

import asyncio
import os
import subprocess
import sys

import pytest

import madsim_tpu.dual  # noqa: F401  (binds `madsim_tpu.dual`, `.real`)
import madsim_tpu.real.compat  # noqa: F401
import madsim_tpu_torch.dual  # noqa: F401
import madsim_tpu_torch.real.compat  # noqa: F401
from torch_host_util import both
from torch_mirror_util import load_pair, run_both

PAIR = load_pair("test_real_mode")

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class PortPing(madsim_tpu_torch.net.Request):
    def __init__(self, v):
        self.v = v


class JaxPing(madsim_tpu.net.Request):
    def __init__(self, v):
        self.v = v


def _ping(m):
    """Each package's request class (at module level: real mode pickles it)."""
    return PortPing if m is madsim_tpu_torch else JaxPing


def test_real_endpoint_send_recv():
    def work(m):
        Endpoint = m.real.Endpoint

        async def main():
            server = await Endpoint.bind("127.0.0.1:0")
            client = await Endpoint.bind("127.0.0.1:0")
            await client.send_to(server.local_addr, 7, b"hello")
            data, frm = await server.recv_from(7)
            same_peer = tuple(frm) == tuple(client.local_addr)
            # reply routes back via the announced bound address
            await server.send_to(frm, 8, b"world")
            data2, _ = await client.recv_from(8)
            server.close()
            client.close()
            return data, same_peer, data2

        return asyncio.run(main())

    assert both(work) == (b"hello", True, b"world")


def test_real_rpc_roundtrip():
    def work(m):
        Endpoint, Ping = m.real.Endpoint, _ping(m)

        async def main():
            server = await Endpoint.bind("127.0.0.1:0")

            async def on_ping(req, data):
                return req.v * 2, bytes(reversed(data))

            server.add_rpc_handler(Ping, on_ping)
            client = await Endpoint.bind("127.0.0.1:0")
            rsp, data = await client.call_with_data(server.local_addr, Ping(21), b"abc")
            with pytest.raises((asyncio.TimeoutError, ConnectionRefusedError)):
                # closed port: refused (or timed out) rather than hanging
                dead = await Endpoint.bind("127.0.0.1:0")
                dead.close()
                await dead.wait_closed()
                await client.call_with_data(dead.local_addr, Ping(1), b"", timeout=0.3)
            server.close()
            client.close()
            return rsp, data

        return asyncio.run(main())

    assert both(work) == (42, b"cba")


def test_real_tag_matching_out_of_order():
    def work(m):
        Endpoint = m.real.Endpoint

        async def main():
            server = await Endpoint.bind("127.0.0.1:0")
            client = await Endpoint.bind("127.0.0.1:0")
            await client.send_to(server.local_addr, 1, b"one")
            await client.send_to(server.local_addr, 2, b"two")
            d2, _ = await server.recv_from(2)  # out of order
            d1, _ = await server.recv_from(1)
            server.close()
            client.close()
            return d1, d2

        return asyncio.run(main())

    assert both(work) == (b"one", b"two")


@pytest.mark.parametrize("mode,want", [
    (None, ["sim", "True", "madsim_tpu_torch.net.endpoint"]),
    ("real", ["real", "False", "madsim_tpu_torch.real.net"]),
])
def test_dual_mode_switch(mode, want):
    code = "import madsim_tpu_torch.dual as d; print(d.MODE, d.IS_SIM, d.net.Endpoint.__module__)"
    env = dict(os.environ, PYTHONPATH=_REPO)
    env.pop("MADSIM_TPU_MODE", None)
    if mode:
        env["MADSIM_TPU_MODE"] = mode
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True, text=True, timeout=120)
    assert out.stdout.split() == want, out.stderr


def test_real_connect1_stream():
    def work(m):
        Endpoint = m.real.Endpoint

        async def main():
            server = await Endpoint.bind("127.0.0.1:0")
            client = await Endpoint.bind("127.0.0.1:0")
            tx, rx = await client.connect1(server.local_addr)
            stx, srx, peer = await server.accept1()
            got = [tuple(peer) == tuple(client.local_addr)]
            tx.send({"op": "hello", "n": 1})
            tx.send([1, 2, 3])
            got += [await srx.recv(), await srx.recv()]
            stx.send("reply")
            got.append(await rx.recv())
            tx.close()
            got.append(await srx.recv())  # EOF == closed channel, sim parity
            server.close()
            client.close()
            return got

        return asyncio.run(main())

    assert both(work) == [True, {"op": "hello", "n": 1}, [1, 2, 3], "reply", None]


def test_real_compat_surface():
    """The real-mode task/time/rand shims the services bind to in
    `MADSIM_TPU_MODE=real`: spawn and abort, sleep, timeout, a first
    interval tick at once, and the GlobalRng draw surface."""
    def work(m):
        compat = m.real.compat

        async def main():
            async def slow():
                await compat.time.sleep(10)

            h = compat.task.spawn(slow())
            await compat.time.sleep(0)
            h.abort()
            with pytest.raises(asyncio.CancelledError):
                await h
            with pytest.raises(TimeoutError):
                await compat.time.timeout(0.01, slow())
            t0 = compat.time.monotonic()
            await compat.time.interval(5.0).tick()
            rng = compat.rand.thread_rng()
            draws = (0 <= rng.random() < 1, 0 <= rng.next_u32() < 2**32, 3 <= rng.gen_range(3, 4) < 4,
                     rng.gen_bool(1.0), rng.choice("x"))
            return h.is_finished(), compat.time.monotonic() - t0 < 1.0, draws

        return asyncio.run(main())

    assert both(work) == (True, True, (True, True, True, True, "x"))


@pytest.mark.parametrize("service", ["etcd", "kafka", "s3"])
def test_services_run_in_real_mode(service, tmp_path):
    """The same service client code runs in production mode against a
    real TCP server that `python -m madsim_tpu_torch serve` starts."""
    run_both(PAIR, "test_services_run_in_real_mode", service=service, tmp_path=tmp_path)


def test_real_mode_server_down_is_typed_error(tmp_path):
    """Connect-refused surfaces as the drop-in clients' typed errors."""
    run_both(PAIR, "test_real_mode_server_down_is_typed_error", tmp_path=tmp_path)
