"""The port's network fabric (`madsim_tpu_torch.net`), mirroring
tests/test_net.py case for case. Each workload runs on the port and on
the JAX package (`torch_host_util.both`): the values, or the
exceptions' types and messages, are equal."""

import pytest

from torch_host_util import both


def run(m, factory, seed=1, config=None):
    return m.Runtime(seed=seed, config=config).block_on(factory())


def two_nodes(m):
    handle = m.Handle.current()
    a = handle.create_node().name("a").ip("10.1.0.1").build()
    b = handle.create_node().name("b").ip("10.1.0.2").build()
    return a, b


def test_endpoint_send_recv():
    def work(m):
        Endpoint = m.net.Endpoint

        async def main():
            a, b = two_nodes(m)

            async def server():
                ep = await Endpoint.bind("0.0.0.0:500")
                data, frm = await ep.recv_from(7)
                await ep.send_to(frm, 8, data + b" world")
                return frm

            async def client():
                ep = await Endpoint.bind("0.0.0.0:0")
                await ep.send_to("10.1.0.1:500", 7, b"hello")
                data, _ = await ep.recv_from(8)
                return data

            b_h = a.spawn(server())
            c_h = b.spawn(client())
            result = await c_h
            frm = await b_h
            return result, frm, m.time.now_ns()

        return run(m, main)

    assert both(work)[0] == b"hello world"


def test_tag_matching_out_of_order():
    # unmatched messages buffer; receivers match by tag regardless of order
    # (reference: endpoint.rs mailbox tests)
    def work(m):
        Endpoint = m.net.Endpoint

        async def main():
            a, b = two_nodes(m)

            async def server():
                ep = await Endpoint.bind("0.0.0.0:500")
                # receive tag 2 first even though tag 1 arrives first
                d2, _ = await ep.recv_from(2)
                d1, _ = await ep.recv_from(1)
                return d1, d2

            async def client():
                ep = await Endpoint.bind("0.0.0.0:0")
                await ep.send_to("10.1.0.1:500", 1, b"one")
                await m.time.sleep(0.1)
                await ep.send_to("10.1.0.1:500", 2, b"two")

            s = a.spawn(server())
            b.spawn(client())
            return await s

        return run(m, main)

    assert both(work) == (b"one", b"two")


def test_localhost_loopback():
    def work(m):
        Endpoint = m.net.Endpoint

        async def main():
            ep1 = await Endpoint.bind("127.0.0.1:600")
            ep2 = await Endpoint.bind("0.0.0.0:0")
            await ep2.send_to("127.0.0.1:600", 5, b"local")
            data, frm = await ep1.recv_from(5)
            return data, frm

        return run(m, main)

    assert both(work)[0] == b"local"


def test_clog_node_blocks_datagrams():
    def work(m):
        Endpoint = m.net.Endpoint

        async def main():
            a, b = two_nodes(m)
            net = m.plugin.simulator(m.net.NetSim)
            got = []

            async def server():
                ep = await Endpoint.bind("0.0.0.0:500")
                while True:
                    data, _ = await ep.recv_from(1)
                    got.append(data)

            async def client():
                ep = await Endpoint.bind("0.0.0.0:0")
                await ep.send_to("10.1.0.1:500", 1, b"m1")
                await m.time.sleep(1.0)
                net.clog_node(a.id)
                await ep.send_to("10.1.0.1:500", 1, b"m2")  # dropped
                await m.time.sleep(1.0)
                net.unclog_node(a.id)
                await ep.send_to("10.1.0.1:500", 1, b"m3")

            a.spawn(server())
            c = b.spawn(client())
            await c
            await m.time.sleep(2.0)
            return got

        return run(m, main)

    assert both(work) == [b"m1", b"m3"]


def test_clog_link_directional():
    def work(m):
        Endpoint = m.net.Endpoint

        async def main():
            a, b = two_nodes(m)
            net = m.plugin.simulator(m.net.NetSim)

            async def server():
                ep = await Endpoint.bind("0.0.0.0:500")
                while True:
                    data, frm = await ep.recv_from(1)
                    await ep.send_to(frm, 2, b"ack:" + data)

            a.spawn(server())

            async def client():
                ep = await Endpoint.bind("0.0.0.0:0")
                # b -> a clogged: request lost
                net.clog_link(b.id, a.id)
                await ep.send_to("10.1.0.1:500", 1, b"lost")
                try:
                    await m.time.timeout(2.0, ep.recv_from(2))
                    return "unexpected"
                except TimeoutError:
                    pass
                net.unclog_link(b.id, a.id)
                await ep.send_to("10.1.0.1:500", 1, b"ok")
                data, _ = await ep.recv_from(2)
                return data

            return await b.spawn(client())

        return run(m, main)

    assert both(work) == b"ack:ok"


def test_packet_loss_config():
    def work(m):
        Endpoint = m.net.Endpoint

        async def main():
            a, b = two_nodes(m)
            received = []

            async def server():
                ep = await Endpoint.bind("0.0.0.0:500")
                while True:
                    data, _ = await ep.recv_from(1)
                    received.append(data)

            async def client():
                ep = await Endpoint.bind("0.0.0.0:0")
                for i in range(100):
                    await ep.send_to("10.1.0.1:500", 1, bytes([i]))

            a.spawn(server())
            c = b.spawn(client())
            await c
            await m.time.sleep(5.0)
            return received

        cfg = m.config.Config()
        cfg.net.packet_loss_rate = 0.5
        return run(m, main, seed=3, config=cfg)

    # the same packets lost on both packages
    assert 20 < len(both(work)) < 80  # ~50% loss


def test_kill_node_closes_sockets_and_port_released():
    def work(m):
        Endpoint = m.net.Endpoint

        async def main():
            handle = m.Handle.current()
            a, b = two_nodes(m)

            async def server():
                ep = await Endpoint.bind("0.0.0.0:500")
                await ep.recv_from(1)

            a.spawn(server())
            await m.time.sleep(0.5)
            handle.kill(a.id)
            await m.time.sleep(0.5)

            async def client():
                ep = await Endpoint.bind("0.0.0.0:0")
                await ep.send_to("10.1.0.1:500", 1, b"x")  # silently dropped (no listener)
                return True

            return await b.spawn(client())

        return run(m, main)

    assert both(work)


def test_datagram_not_delivered_after_sender_kill():
    # the 0-5 us processing delay runs as a timer callback; a datagram
    # whose sender is killed between the send and the wire moment must
    # be dropped, matching the reference where kill cancels the sender
    # task inside rand_delay (sim/net/mod.rs:287).
    def work(m):
        Endpoint = m.net.Endpoint

        async def main():
            handle = m.Handle.current()
            a, b = two_nodes(m)
            received = []

            async def server():
                ep = await Endpoint.bind("0.0.0.0:500")
                while True:
                    data, _ = await ep.recv_from(1)
                    received.append(data)

            async def client():
                ep = await Endpoint.bind("0.0.0.0:0")
                await ep.send_to("10.1.0.1:500", 1, b"zombie")

            a.spawn(server())
            await b.spawn(client())
            handle.kill(b.id)  # same virtual instant: wire moment not reached
            await m.time.sleep(2.0)
            return received

        return [run(m, main, seed=seed) for seed in (1, 2, 3, 4, 5)]

    assert both(work) == [[]] * 5


def test_udp_socket():
    def work(m):
        async def main():
            a, b = two_nodes(m)

            async def server():
                sock = await m.net.UdpSocket.bind("0.0.0.0:900")
                data, frm = await sock.recv_from()
                await sock.send_to(b"pong:" + data, frm)

            async def client():
                sock = await m.net.UdpSocket.bind("0.0.0.0:0")
                await sock.send_to(b"ping", "10.1.0.1:900")
                return await sock.recv()

            a.spawn(server())
            return await b.spawn(client())

        return run(m, main)

    assert both(work) == b"pong:ping"


def test_tcp_roundtrip_and_eof():
    def work(m):
        async def main():
            a, b = two_nodes(m)

            async def server():
                lis = await m.net.TcpListener.bind("0.0.0.0:700")
                stream, peer = await lis.accept()
                while True:
                    data = await stream.read()
                    if not data:
                        return "eof"
                    await stream.write_all(b"echo:" + data)

            async def client():
                stream = await m.net.TcpStream.connect("10.1.0.1:700")
                await stream.write_all(b"abc")
                r1 = await stream.read_exact(8)
                await stream.write_all(b"def")
                r2 = await stream.read_exact(8)
                stream.shutdown()
                return r1, r2

            s = a.spawn(server())
            c = b.spawn(client())
            r1, r2 = await c
            assert await s == "eof"
            return r1, r2, m.time.now_ns()

        return run(m, main)

    r1, r2, _now = both(work)
    assert (r1, r2) == (b"echo:abc", b"echo:def")


def test_tcp_connect_refused_when_partitioned():
    def work(m):
        async def main():
            a, b = two_nodes(m)
            net = m.plugin.simulator(m.net.NetSim)

            async def server():
                lis = await m.net.TcpListener.bind("0.0.0.0:700")
                await lis.accept()

            a.spawn(server())
            await m.time.sleep(0.5)
            net.partition([a.id], [b.id])

            async def client():
                try:
                    await m.net.TcpStream.connect("10.1.0.1:700")
                    return "connected"
                except m.net.ConnectionRefused as exc:
                    return "refused", str(exc)

            return await b.spawn(client())

        return run(m, main)

    assert both(work)[0] == "refused"


def test_tcp_clog_unclog_recovery():
    # messages stall during a partition and flow after healing
    # (reference: tcp/mod.rs clog/unclog test)
    def work(m):
        async def main():
            a, b = two_nodes(m)
            net = m.plugin.simulator(m.net.NetSim)

            async def server():
                lis = await m.net.TcpListener.bind("0.0.0.0:700")
                stream, _ = await lis.accept()
                await stream.read_exact(4)
                await stream.write_all(b"ack!")

            a.spawn(server())

            async def client():
                stream = await m.net.TcpStream.connect("10.1.0.1:700")
                net.partition([a.id], [b.id])
                await stream.write_all(b"data")  # buffered/in-flight while clogged
                m.task.spawn(healer())
                t0 = m.time.now()
                ack = await stream.read_exact(4)
                return ack, m.time.now() - t0

            async def healer():
                await m.time.sleep(5.0)
                net.heal([a.id], [b.id])

            return await b.spawn(client())

        return run(m, main)

    ack, waited = both(work)
    assert ack == b"ack!"
    assert waited >= 4.9  # stalled until heal


def test_dns_and_lookup():
    def work(m):
        async def main():
            two_nodes(m)
            net = m.plugin.simulator(m.net.NetSim)
            net.add_dns_record("server.local", "10.1.0.1")
            ips = await m.net.lookup_host("server.local")
            ips_port = await m.net.lookup_host("server.local:80")
            with pytest.raises(OSError) as ei:
                await m.net.lookup_host("missing.example")
            return ips, ips_port, str(ei.value)

        return run(m, main)

    ips, ips_port, _err = both(work)
    assert ips == ["10.1.0.1"]
    assert ips_port == ["10.1.0.1:80"]


def test_ipvs_round_robin():
    # (reference: tcp/mod.rs IPVS round-robin test + ipvs.rs)
    def work(m):
        async def main():
            handle = m.Handle.current()
            net = m.plugin.simulator(m.net.NetSim)
            servers = []
            for i in range(3):
                node = handle.create_node().name(f"s{i}").ip(f"10.2.0.{i+1}").build()

                async def serve(i=i):
                    lis = await m.net.TcpListener.bind("0.0.0.0:80")
                    while True:
                        stream, _ = await lis.accept()
                        await stream.write_all(f"server-{i}".encode())

                node.spawn(serve(i))
                servers.append(node)
            client = handle.create_node().name("c").ip("10.2.0.99").build()

            svc = m.net.ServiceAddr.tcp("10.9.9.9:80")
            net.global_ipvs().add_service(svc)
            for i in range(3):
                net.global_ipvs().add_server(svc, f"10.2.0.{i+1}:80")

            async def run_client():
                got = []
                for _ in range(6):
                    stream = await m.net.TcpStream.connect("10.9.9.9:80")
                    got.append((await stream.read_exact(8)).decode())
                return got

            return await client.spawn(run_client())

        return run(m, main)

    assert both(work) == ["server-0", "server-1", "server-2"] * 2


def test_stat_msg_count():
    def work(m):
        async def main():
            net = m.plugin.simulator(m.net.NetSim)
            ep1 = await m.net.Endpoint.bind("127.0.0.1:600")
            ep2 = await m.net.Endpoint.bind("0.0.0.0:0")
            before = net.stat().msg_count
            for _ in range(5):
                await ep2.send_to("127.0.0.1:600", 5, b"x")
            for _ in range(5):
                await ep1.recv_from(5)
            return net.stat().msg_count - before

        return run(m, main)

    assert both(work) == 5


def test_dns_name_in_connect_and_send():
    # DNS names resolve on every send/connect path
    def work(m):
        async def main():
            a, b = two_nodes(m)
            net = m.plugin.simulator(m.net.NetSim)
            net.add_dns_record("svc.local", "10.1.0.1")

            async def server():
                lis = await m.net.TcpListener.bind("0.0.0.0:80")
                stream, _ = await lis.accept()
                await stream.write_all(b"via-dns")
                ep = await m.net.Endpoint.bind("0.0.0.0:81")
                data, _ = await ep.recv_from(3)
                return data

            s = a.spawn(server())

            async def client():
                stream = await m.net.TcpStream.connect("svc.local:80")
                got = await stream.read_exact(7)
                ep = await m.net.Endpoint.bind("0.0.0.0:0")
                await ep.send_to("svc.local:81", 3, b"dgram")
                return got

            got = await b.spawn(client())
            assert await s == b"dgram"
            return got

        return run(m, main)

    assert both(work) == b"via-dns"


def test_peer_kill_breaks_both_directions():
    # killing the server breaks the client's write path too
    def work(m):
        async def main():
            handle = m.Handle.current()
            a, b = two_nodes(m)

            async def server():
                lis = await m.net.TcpListener.bind("0.0.0.0:700")
                await lis.accept()
                await m.time.sleep(1e9)

            a.spawn(server())

            async def client():
                stream = await m.net.TcpStream.connect("10.1.0.1:700")
                await stream.write_all(b"x")
                await m.time.sleep(1.0)
                handle.kill(a.id)
                await m.time.sleep(1.0)
                try:
                    await stream.write_all(b"y")
                    return "write-succeeded"
                except m.net.ConnectionReset:
                    return "write-reset"

            return await b.spawn(client())

        return run(m, main)

    assert both(work) == "write-reset"
