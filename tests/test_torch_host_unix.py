"""The port's Unix domain sockets (`madsim_tpu_torch.net.UnixListener`,
`UnixStream`, `UnixDatagram`), mirroring tests/test_unix.py case for
case: node-local IPC with stream rendezvous, datagrams, a namespace per
node that dies with it. Each workload runs on the port and on the JAX
package (`torch_host_util.both`): the values, or the exceptions' types
and messages, are equal."""

import pytest

import madsim_tpu.net.network  # noqa: F401  (binds `madsim_tpu.net.network`)
import madsim_tpu_torch.net.network  # noqa: F401
from torch_host_util import both


def run(m, factory, seed=1):
    return m.Runtime(seed=seed).block_on(factory())


def test_stream_echo_roundtrip():
    def work(m):
        net = m.net

        async def main():
            node = m.Handle.current().create_node().build()

            async def app():
                listener = await net.UnixListener.bind("/run/app.sock")

                async def server():
                    stream, _peer = await listener.accept()
                    while (data := await stream.read()) != b"":
                        await stream.write_all(b"echo:" + data)
                    stream.shutdown()

                m.task.spawn(server())
                client = await net.UnixStream.connect("/run/app.sock")
                await client.write_all(b"hello")
                r1 = await client.read_exact(10)
                await client.write_all(b"again")
                r2 = await client.read_exact(10)
                client.shutdown()
                return r1, r2, m.time.now_ns()

            return await node.spawn(app())

        return run(m, main)

    r1, r2, _now = both(work)
    assert (r1, r2) == (b"echo:hello", b"echo:again")


def test_paths_are_node_local_and_exclusive():
    def work(m):
        net, errors = m.net, m.net.network

        async def main():
            handle = m.Handle.current()
            a = handle.create_node().build()
            b = handle.create_node().build()

            async def on_a():
                await net.UnixListener.bind("/tmp/x.sock")
                with pytest.raises(errors.AddrInUse) as ei:
                    await net.UnixListener.bind("/tmp/x.sock")
                return str(ei.value)

            async def on_b():
                # node B's namespace is separate: the path A bound as a
                # listener binds fine here, and connecting to it from B is
                # refused
                await net.UnixDatagram.bind("/tmp/y.sock")
                with pytest.raises(errors.ConnectionRefused) as ei:
                    await net.UnixStream.connect("/tmp/x.sock")
                await net.UnixListener.bind("/tmp/x.sock")
                return str(ei.value)

            return await a.spawn(on_a()), await b.spawn(on_b())

        return run(m, main)

    assert all(isinstance(msg, str) for msg in both(work))


def test_kill_wipes_namespace_and_eofs_streams():
    def work(m):
        net, errors = m.net, m.net.network

        async def main():
            handle = m.Handle.current()
            node = handle.create_node().build()
            state = {}

            async def app():
                listener = await net.UnixListener.bind("/run/dead.sock")

                async def server():
                    stream, _ = await listener.accept()
                    state["got"] = await stream.read()

                m.task.spawn(server())
                client = await net.UnixStream.connect("/run/dead.sock")
                await client.write_all(b"pre-kill")
                state["client"] = client
                await m.time.sleep(10)

            node.spawn(app())
            await m.time.sleep(0.1)
            got = state.get("got")
            handle.kill(node.id)
            handle.restart(node.id)
            await m.time.sleep(0.1)

            # the restarted node's namespace is fresh: the old path is gone
            async def probe():
                with pytest.raises(errors.ConnectionRefused):
                    await net.UnixStream.connect("/run/dead.sock")
                # ...and re-binding it works (no stale registration)
                await net.UnixListener.bind("/run/dead.sock")
                return True

            return got, await node.spawn(probe()), m.time.now_ns()

        return run(m, main)

    got, probed, _now = both(work)
    assert got == b"pre-kill" and probed


def test_kill_resets_parked_cross_context_waiters():
    """A waiter parked in accept()/recv_from() (possibly from another
    task context holding the socket) sees a reset when the binding node
    dies — it does not hang forever."""

    def work(m):
        net, errors = m.net, m.net.network

        async def main():
            handle = m.Handle.current()
            node = handle.create_node().build()
            state = {}

            async def app():
                state["listener"] = await net.UnixListener.bind("/run/k.sock")
                state["dgram"] = await net.UnixDatagram.bind("/run/kd.sock")
                await m.time.sleep(10)

            node.spawn(app())
            await m.time.sleep(0.05)

            outcomes = []

            async def wait_accept():
                try:
                    await state["listener"].accept()
                except errors.ConnectionReset:
                    outcomes.append("accept-reset")

            async def wait_recv():
                try:
                    await state["dgram"].recv_from()
                except errors.ConnectionReset:
                    outcomes.append("recv-reset")

            m.task.spawn(wait_accept())
            m.task.spawn(wait_recv())
            await m.time.sleep(0.05)
            handle.kill(node.id)
            await m.time.sleep(0.05)
            return outcomes

        return run(m, main)

    assert sorted(both(work)) == ["accept-reset", "recv-reset"]


def test_datagram_send_recv_and_connect():
    def work(m):
        net, errors = m.net, m.net.network

        async def main():
            node = m.Handle.current().create_node().build()

            async def app():
                server = await net.UnixDatagram.bind("/run/dgram.sock")
                client = await net.UnixDatagram.bind("/run/client.sock")
                client.connect("/run/dgram.sock")
                await client.send(b"one")
                await client.send_to("/run/dgram.sock", b"two")
                d1, from1 = await server.recv_from()
                d2, from2 = await server.recv_from()
                with pytest.raises(errors.ConnectionRefused):
                    await client.send_to("/run/nope.sock", b"x")
                unbound = await net.UnixDatagram.unbound()
                await unbound.send_to("/run/dgram.sock", b"three")
                d3, from3 = await server.recv_from()
                return (d1, from1), (d2, from2), (d3, from3)

            return await node.spawn(app())

        return run(m, main)

    (d1, f1), (d2, f2), (d3, f3) = both(work)
    assert (d1, f1) == (b"one", "/run/client.sock")
    assert (d2, f2) == (b"two", "/run/client.sock")
    assert (d3, f3) == (b"three", "")


def test_listener_close_unbinds_and_resets_backlog():
    def work(m):
        net, errors = m.net, m.net.network

        async def main():
            node = m.Handle.current().create_node().build()

            async def app():
                listener = await net.UnixListener.bind("/run/c.sock")
                client = await net.UnixStream.connect("/run/c.sock")  # backlogged
                listener.close()  # from the same node but a driver-style task
                reread = await client.read()  # reset backlog -> EOF
                with pytest.raises(errors.ConnectionRefused):
                    await net.UnixStream.connect("/run/c.sock")
                await net.UnixListener.bind("/run/c.sock")  # path released
                return reread

            return await node.spawn(app())

        return run(m, main)

    assert both(work) == b""


def test_unix_deterministic_across_runs():
    def work(m):
        net = m.net

        async def main():
            node = m.Handle.current().create_node().build()
            out = []

            async def app():
                listener = await net.UnixListener.bind("/run/d.sock")

                async def worker(i):
                    s = await net.UnixStream.connect("/run/d.sock")
                    await s.write_all(f"w{i}".encode())

                async def server():
                    for _ in range(3):
                        stream, _ = await listener.accept()
                        out.append(await stream.read())

                m.task.spawn(server())
                for i in range(3):
                    m.task.spawn(worker(i))
                await m.time.sleep(0.1)
                return tuple(out)

            return await node.spawn(app())

        return run(m, main, seed=7), run(m, main, seed=7)

    first, second = both(work)
    assert first == second and len(first) == 3
