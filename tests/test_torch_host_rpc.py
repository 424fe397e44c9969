"""The port's typed RPC layer (`madsim_tpu_torch.net.rpc`), mirroring
tests/test_rpc.py case for case. Each workload runs on the port and on
the JAX package (`torch_host_util.both`): the values, or the
exceptions' types and messages, are equal. The request classes are
defined once for each package under the same module and qualified
name, so their type ids are equal too."""

import functools

import pytest

from torch_host_util import JAX, PORT, both


@functools.lru_cache(maxsize=None)
def requests(m):
    """(Ping, Add) as subclasses of package `m`'s `Request`."""

    class Ping(m.net.Request):
        def __init__(self, value: int):
            self.value = value

    class Add(m.net.Request):
        def __init__(self, a: int, b: int):
            self.a = a
            self.b = b

    return Ping, Add


def run(m, factory, seed=1):
    return m.Runtime(seed=seed).block_on(factory())


def test_request_ids_stable_and_distinct():
    Ping, Add = requests(PORT)
    assert Ping.type_id() == Ping.type_id()
    assert Ping.type_id() != Add.type_id()
    assert [c.type_id() for c in requests(PORT)] == [c.type_id() for c in requests(JAX)]


def test_rpc_call_roundtrip():
    def work(m):
        Ping, Add = requests(m)

        async def main():
            handle = m.Handle.current()
            server = handle.create_node().name("server").ip("10.1.0.1").build()
            client = handle.create_node().name("client").ip("10.1.0.2").build()

            async def serve():
                ep = await m.net.Endpoint.bind("0.0.0.0:500")

                async def on_ping(req, data):
                    return req.value * 2

                async def on_add(req, data):
                    return req.a + req.b

                ep.add_rpc_handler(Ping, on_ping)
                ep.add_rpc_handler(Add, on_add)
                await m.time.sleep(1e9)

            server.spawn(serve())

            async def do_calls():
                ep = await m.net.Endpoint.bind("0.0.0.0:0")
                r1 = await ep.call("10.1.0.1:500", Ping(21))
                r2 = await ep.call("10.1.0.1:500", Add(2, 3))
                return r1, r2, m.time.now_ns()

            return await client.spawn(do_calls())

        return run(m, main)

    r1, r2, _now = both(work)
    assert (r1, r2) == (42, 5)


def test_rpc_with_data_payload():
    def work(m):
        Ping, _Add = requests(m)

        async def main():
            handle = m.Handle.current()
            server = handle.create_node().name("server").ip("10.1.0.1").build()
            client = handle.create_node().name("client").ip("10.1.0.2").build()

            async def serve():
                ep = await m.net.Endpoint.bind("0.0.0.0:500")

                async def on_ping(req, data):
                    return req.value, bytes(reversed(data))

                ep.add_rpc_handler(Ping, on_ping)
                await m.time.sleep(1e9)

            server.spawn(serve())

            async def do_call():
                ep = await m.net.Endpoint.bind("0.0.0.0:0")
                rsp, data = await ep.call_with_data("10.1.0.1:500", Ping(7), b"abcdef")
                return rsp, data

            return await client.spawn(do_call())

        return run(m, main)

    assert both(work) == (7, b"fedcba")


def test_rpc_call_timeout_on_partition():
    def work(m):
        Ping, _Add = requests(m)

        async def main():
            handle = m.Handle.current()
            server = handle.create_node().name("server").ip("10.1.0.1").build()
            client = handle.create_node().name("client").ip("10.1.0.2").build()
            net = m.plugin.simulator(m.net.NetSim)

            async def serve():
                ep = await m.net.Endpoint.bind("0.0.0.0:500")

                async def on_ping(req, data):
                    return req.value

                ep.add_rpc_handler(Ping, on_ping)
                await m.time.sleep(1e9)

            server.spawn(serve())
            await m.time.sleep(0.5)
            net.partition([server.id], [client.id])

            async def do_call():
                ep = await m.net.Endpoint.bind("0.0.0.0:0")
                with pytest.raises(TimeoutError):
                    await ep.call_timeout("10.1.0.1:500", Ping(1), 2.0)
                net.heal([server.id], [client.id])
                return await ep.call_timeout("10.1.0.1:500", Ping(1), 2.0), m.time.now_ns()

            return await client.spawn(do_call())

        return run(m, main)

    assert both(work)[0] == 1


def test_service_decorator():
    def work(m):
        Ping, Add = requests(m)

        async def main():
            handle = m.Handle.current()
            server = handle.create_node().name("server").ip("10.1.0.1").build()
            client = handle.create_node().name("client").ip("10.1.0.2").build()

            @m.net.service
            class Calculator:
                def __init__(self):
                    self.counter = 0

                @m.net.rpc(Ping)
                async def ping(self, req):
                    self.counter += 1
                    return req.value + self.counter

                @m.net.rpc(Add)
                async def add(self, req):
                    return req.a * req.b

            async def serve():
                ep = await m.net.Endpoint.bind("0.0.0.0:500")
                Calculator().serve_on(ep)
                await m.time.sleep(1e9)

            server.spawn(serve())

            async def do_calls():
                ep = await m.net.Endpoint.bind("0.0.0.0:0")
                r1 = await ep.call("10.1.0.1:500", Ping(10))
                r2 = await ep.call("10.1.0.1:500", Ping(10))
                r3 = await ep.call("10.1.0.1:500", Add(6, 7))
                return r1, r2, r3

            return await client.spawn(do_calls())

        return run(m, main)

    assert both(work) == (11, 12, 42)


def test_server_crash_and_restart_e2e():
    # tonic-example server_crash-style test (reference: tests/test.rs:233+)
    def work(m):
        Ping, _Add = requests(m)

        async def main():
            handle = m.Handle.current()

            async def serve():
                ep = await m.net.Endpoint.bind("0.0.0.0:500")

                async def on_ping(req, data):
                    return req.value

                ep.add_rpc_handler(Ping, on_ping)
                await m.time.sleep(1e9)

            server = handle.create_node().name("server").ip("10.1.0.1").init(serve).build()
            client = handle.create_node().name("client").ip("10.1.0.2").build()

            async def do_calls():
                ep = await m.net.Endpoint.bind("0.0.0.0:0")
                ok = await ep.call_timeout("10.1.0.1:500", Ping(1), 2.0)
                handle.kill(server.id)
                with pytest.raises(TimeoutError):
                    await ep.call_timeout("10.1.0.1:500", Ping(2), 2.0)
                handle.restart(server.id)
                await m.time.sleep(1.0)
                ok2 = await ep.call_timeout("10.1.0.1:500", Ping(3), 5.0)
                return ok, ok2

            return await client.spawn(do_calls())

        return run(m, main)

    assert both(work) == (1, 3)


def test_client_crash_loop_deterministic():
    # tonic-example client_crash-style loop (reference: tests/test.rs:155-201):
    # clients restart randomly in a loop; assert the run is seed-deterministic.
    def work(m):
        Ping, _Add = requests(m)

        def run_seed(seed):
            async def main():
                handle = m.Handle.current()
                served = []

                async def serve():
                    ep = await m.net.Endpoint.bind("0.0.0.0:500")

                    async def on_ping(req, data):
                        served.append(req.value)
                        return req.value

                    ep.add_rpc_handler(Ping, on_ping)
                    await m.time.sleep(1e9)

                server = handle.create_node().name("server").ip("10.1.0.1").build()
                server.spawn(serve())

                async def client_loop(i):
                    ep = await m.net.Endpoint.bind("0.0.0.0:0")
                    n = 0
                    while True:
                        await ep.call("10.1.0.1:500", Ping(i * 1000 + n))
                        n += 1

                rng = m.rand.thread_rng()
                clients = []
                for i in range(3):
                    node = handle.create_node().name(f"c{i}").ip(f"10.1.0.{i+2}").build()
                    node.spawn(client_loop(i))
                    clients.append(node)
                for _ in range(10):
                    await m.time.sleep(rng.random() * 2)
                    victim = rng.choice(clients)
                    handle.kill(victim.id)
                    await m.time.sleep(rng.random())
                    handle.restart(victim.id)
                return tuple(served)

            return m.Runtime(seed=seed).block_on(main())

        return run_seed(5), run_seed(5), run_seed(6)

    a, b, c = both(work)
    assert a == b
    assert len(a) > 0
    assert a != c


def test_rsp_hook_drops_only_responses():
    # hook_rpc_rsp must not drop requests
    def work(m):
        Ping, _Add = requests(m)

        async def main():
            handle = m.Handle.current()
            server = handle.create_node().name("server").ip("10.1.0.1").build()
            client = handle.create_node().name("client").ip("10.1.0.2").build()
            net = m.plugin.simulator(m.net.NetSim)
            served = []

            async def serve():
                ep = await m.net.Endpoint.bind("0.0.0.0:500")

                async def on_ping(req, data):
                    served.append(req.value)
                    return req.value

                ep.add_rpc_handler(Ping, on_ping)
                await m.time.sleep(1e9)

            server.spawn(serve())
            net.hook_rpc_rsp(lambda src, dst, tag, payload: False)  # drop all responses

            async def do_call():
                ep = await m.net.Endpoint.bind("0.0.0.0:0")
                with pytest.raises(TimeoutError):
                    await ep.call_timeout("10.1.0.1:500", Ping(9), 2.0)
                return True

            await client.spawn(do_call())
            return served

        return run(m, main)

    assert both(work) == [9]  # request arrived, response dropped
