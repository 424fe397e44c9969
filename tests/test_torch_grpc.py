"""The port's simulated gRPC (`madsim_tpu_torch.grpc`) and its .proto
ingestion (`madsim_tpu_torch.grpc.build`), mirroring tests/test_grpc.py
case for case: named-IP nodes, DNS, all four call shapes, statuses,
crashes, metadata and interceptors. Each workload runs on the port and
on the JAX package (`torch_host_util.both`) and gives equal values. The
.proto cases skip without `protoc`, as the reference's do; a module that
the port's `build.emit()` writes loads the port's `build`, never the JAX
package's."""

import importlib.util
import os
import shutil
import subprocess
import sys

import pytest

import madsim_tpu.grpc.build  # noqa: F401  (binds `madsim_tpu.grpc`, `.grpc.build`)
import madsim_tpu.plugin  # noqa: F401
import madsim_tpu_torch.grpc.build  # noqa: F401
import madsim_tpu_torch.plugin  # noqa: F401
from madsim_tpu_torch.grpc import Code
from torch_host_util import both

# .proto ingestion shells out to protoc; skip (not fail) on boxes
# without the protobuf compiler — environment capability, not a
# code regression
needs_protoc = pytest.mark.skipif(shutil.which("protoc") is None, reason="protoc not on PATH")

_PROTO = os.path.join(os.path.dirname(os.path.abspath(__file__)), "protos", "helloworld.proto")
_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def greeter(m):
    """The 4-shape greeter (reference: tonic-example/src/lib.rs:13-120)
    on package `m`."""
    grpc, sim_time = m.grpc, m.time

    @grpc.service("helloworld.Greeter")
    class Greeter:
        @grpc.unary
        async def say_hello(self, request):
            name = request.into_inner()
            if name == "error":
                raise grpc.Status(grpc.Code.INVALID_ARGUMENT, "bad name")
            return grpc.Response(f"Hello {name}!")

        @grpc.server_streaming
        async def lots_of_replies(self, request):
            name = request.into_inner()
            for i in range(3):
                await sim_time.sleep(0.1)
                yield f"{name} #{i}"

        @grpc.client_streaming
        async def lots_of_greetings(self, stream):
            names = []
            while (msg := await stream.message()) is not None:
                names.append(msg)
            return grpc.Response(f"Hello {', '.join(names)}!")

        @grpc.streaming
        async def bidi_hello(self, stream):
            while (msg := await stream.message()) is not None:
                yield f"Hello {msg}!"

    return Greeter


def run(m, factory, seed=1):
    return m.Runtime(seed=seed).block_on(factory())


async def _start_server(m, handle, ip="10.5.0.1", port=50051):
    Greeter = greeter(m)

    async def serve():
        await m.grpc.Server.builder().add_service(Greeter()).serve(f"0.0.0.0:{port}")

    node = handle.create_node().name("server").ip(ip).init(serve).build()
    await m.time.sleep(0.2)
    return node


def test_all_four_shapes():
    def work(m):
        grpc = m.grpc

        async def main():
            handle = m.Handle.current()
            await _start_server(m, handle)
            net = m.plugin.simulator(m.net.NetSim)
            net.add_dns_record("greeter.local", "10.5.0.1")
            client = handle.create_node().name("client").ip("10.5.0.2").build()

            async def go():
                ch = await grpc.connect("http://greeter.local:50051")
                r1 = await ch.unary("/helloworld.Greeter/SayHello", "world")
                stream = await ch.server_streaming("/helloworld.Greeter/LotsOfReplies", "srv")
                r2 = [x async for x in stream]
                r3 = await ch.client_streaming("/helloworld.Greeter/LotsOfGreetings", ["a", "b", "c"])
                stream = await ch.streaming("/helloworld.Greeter/BidiHello", ["x", "y"])
                r4 = [x async for x in stream]
                return r1, r2, r3, r4, m.time.now_ns()

            return await client.spawn(go())

        return run(m, main)

    r1, r2, r3, r4, _now = both(work)
    assert r1 == "Hello world!"
    assert r2 == ["srv #0", "srv #1", "srv #2"]
    assert r3 == "Hello a, b, c!"
    assert r4 == ["Hello x!", "Hello y!"]


def test_status_propagates():
    def work(m):
        grpc = m.grpc

        async def main():
            handle = m.Handle.current()
            await _start_server(m, handle)
            client = handle.create_node().ip("10.5.0.2").build()

            async def go():
                ch = await grpc.connect("http://10.5.0.1:50051")
                codes = []
                for path, arg in (("/helloworld.Greeter/SayHello", "error"), ("/helloworld.Greeter/Nope", "x"),
                                  ("/wrong.Service/SayHello", "x")):
                    with pytest.raises(grpc.Status) as ei:
                        await ch.unary(path, arg)
                    codes.append((ei.value.code, str(ei.value)))
                return codes

            return await client.spawn(go())

        return run(m, main)

    codes = both(work)
    assert [c for c, _ in codes] == [Code.INVALID_ARGUMENT, Code.UNIMPLEMENTED, Code.UNIMPLEMENTED]


def test_connect_unreachable_is_unavailable():
    def work(m):
        async def main():
            client = m.Handle.current().create_node().ip("10.5.0.2").build()

            async def go():
                with pytest.raises(m.grpc.Status) as ei:
                    await m.grpc.connect("http://10.9.9.9:1")
                return ei.value.code, m.time.now_ns()

            return await client.spawn(go())

        return run(m, main)

    assert both(work)[0] == Code.UNAVAILABLE


def test_server_crash_and_restart():
    # reference: tonic-example/tests/test.rs server_crash (:233+)
    def work(m):
        grpc = m.grpc

        async def main():
            handle = m.Handle.current()
            server = await _start_server(m, handle)
            client = handle.create_node().ip("10.5.0.2").build()

            async def go():
                ch = await grpc.connect("http://10.5.0.1:50051")
                ok = await ch.unary("/helloworld.Greeter/SayHello", "one")
                handle.kill(server.id)
                await m.time.sleep(0.1)
                with pytest.raises(grpc.Status) as ei:
                    ch2 = await grpc.connect("http://10.5.0.1:50051")
                    await ch2.unary("/helloworld.Greeter/SayHello", "two")
                handle.restart(server.id)
                await m.time.sleep(0.5)
                ch3 = await grpc.connect("http://10.5.0.1:50051")
                ok2 = await ch3.unary("/helloworld.Greeter/SayHello", "three")
                return ok, ei.value.code, ok2, m.time.now_ns()

            return await client.spawn(go())

        return run(m, main)

    ok, _down, ok2, _now = both(work)
    assert ok == "Hello one!"
    assert ok2 == "Hello three!"


def test_client_crash_loop_deterministic():
    # reference: tonic-example/tests/test.rs client_crash (:155-201)
    def run_seed(m, seed):
        grpc = m.grpc

        async def main():
            handle = m.Handle.current()
            await _start_server(m, handle)
            served = []

            async def client_loop(i):
                ch = await grpc.connect("http://10.5.0.1:50051")
                n = 0
                while True:
                    rsp = await ch.unary("/helloworld.Greeter/SayHello", f"c{i}-{n}")
                    served.append(rsp)
                    n += 1
                    await m.time.sleep(0.05)

            rng = m.rand.thread_rng()
            nodes = []
            for i in range(2):
                node = handle.create_node().ip(f"10.5.0.{i+2}").build()
                node.spawn(client_loop(i))
                nodes.append(node)
            for _ in range(6):
                await m.time.sleep(rng.random())
                victim = rng.choice(nodes)
                handle.kill(victim.id)
                await m.time.sleep(rng.random() * 0.2)
                handle.restart(victim.id)
            return tuple(served)

        return m.Runtime(seed=seed).block_on(main())

    def work(m):
        a = run_seed(m, 4)
        assert run_seed(m, 4) == a
        return a

    assert len(both(work)) > 0


def test_metadata_and_interceptors():
    """Metadata rides the call both ways, a client interceptor injects
    it, and a server interceptor rejects calls missing it with
    UNAUTHENTICATED."""

    def work(m):
        grpc = m.grpc

        @grpc.service("auth.Echo")
        class AuthedEcho:
            @grpc.unary
            async def echo(self, request):
                return grpc.Response(request.into_inner(), {"served-by": "auth-echo"})

        def require_token(request):
            if request.metadata.get("authorization") != "Bearer ok":
                raise grpc.Status.unauthenticated("missing or bad token")
            return request

        async def main():
            handle = m.Handle.current()

            async def serve():
                await grpc.Server.builder().add_service(AuthedEcho()).intercept(require_token).serve(
                    "0.0.0.0:50061")

            handle.create_node().name("authsrv").ip("10.5.0.7").init(serve).build()
            await m.time.sleep(0.2)
            client = handle.create_node().ip("10.5.0.8").build()

            async def go():
                # no token: the server interceptor rejects
                ch = await grpc.connect("http://10.5.0.7:50061")
                with pytest.raises(grpc.Status) as ei:
                    await ch.unary("/auth.Echo/Echo", "nope")
                rejected = ei.value.code
                # explicit Request metadata: accepted, Response carries
                # the handler's metadata back
                rsp = await ch.unary("/auth.Echo/Echo", grpc.Request("hi", {"authorization": "Bearer ok"}))
                assert isinstance(rsp, grpc.Response)

                # client interceptor injects the token on every call
                def add_token(request):
                    request.metadata["authorization"] = "Bearer ok"
                    return request

                ch2 = await grpc.connect("http://10.5.0.7:50061", interceptor=add_token)
                out = await ch2.unary("/auth.Echo/Echo", "raw-in-raw-out")
                return rejected, rsp.into_inner(), rsp.metadata["served-by"], out

            return await client.spawn(go())

        return run(m, main)

    # raw message in => raw out
    assert both(work) == (Code.UNAUTHENTICATED, "hi", "auth-echo", "raw-in-raw-out")


def test_metadata_case_insensitive():
    """Mixed-case metadata keys work on both ends: keys are stored
    lowercase like gRPC wire metadata, lookups are case-insensitive."""

    def work(m):
        grpc = m.grpc
        req = grpc.Request("m", {"X-Trace-Id": "t1", "Authorization": "Bearer x"})
        rsp = grpc.Response("r", {"Served-By": "n1"})
        rsp.metadata["X-Extra"] = "v"
        st = grpc.Status(grpc.Code.INTERNAL, "boom", {"Retry-After": "1"})
        return (req.metadata["X-Trace-Id"], req.metadata["x-trace-id"], req.metadata.get("AUTHORIZATION"),
                "x-Trace-ID" in req.metadata, sorted(req.metadata.keys()), rsp.metadata["served-by"],
                rsp.metadata["Served-By"], rsp.metadata.pop("x-EXTRA"), st.metadata.get("retry-after"))

    assert both(work) == ("t1", "t1", "Bearer x", True, ["authorization", "x-trace-id"], "n1", "n1", "v", "1")


# -- .proto ingestion (reference: madsim-tonic-build) -------------------------


def _hello_ns(m):
    return m.grpc.build.load(_PROTO)


@needs_protoc
def test_proto_ingestion_four_shapes_no_handwritten_stubs():
    """helloworld.proto drives server and client end to end: messages are
    real protobuf classes, stubs are synthesized from the descriptor."""

    def work(m):
        hw, grpc = _hello_ns(m), m.grpc

        class MyGreeter(hw.GreeterServer):
            async def say_hello(self, request):
                return hw.HelloReply(message=f"Hello {request.into_inner().name}!")

            async def lots_of_replies(self, request):
                name = request.into_inner().name
                for i in range(3):
                    await m.time.sleep(0.05)
                    yield hw.HelloReply(message=f"{name} #{i}")

            async def lots_of_greetings(self, stream):
                names = [x.name async for x in stream]
                return hw.HelloReply(message=f"Hello {', '.join(names)}!")

            async def bidi_hello(self, stream):
                async for x in stream:
                    yield hw.HelloReply(message=f"Hello {x.name}!")

        async def main():
            handle = m.Handle.current()

            async def serve():
                await grpc.Server.builder().add_service(MyGreeter()).serve("0.0.0.0:50051")

            handle.create_node().name("server").ip("10.5.0.1").init(serve).build()
            await m.time.sleep(0.2)
            client = handle.create_node().name("client").ip("10.5.0.2").build()

            async def go():
                cl = await hw.GreeterClient.connect("http://10.5.0.1:50051")
                r1 = await cl.say_hello(hw.HelloRequest(name="world"))
                stream = await cl.lots_of_replies(hw.HelloRequest(name="srv"))
                r2 = [x.message async for x in stream]
                r3 = await cl.lots_of_greetings([hw.HelloRequest(name=n) for n in "abc"])
                stream = await cl.bidi_hello([hw.HelloRequest(name=n) for n in ("x", "y")])
                r4 = [x.message async for x in stream]
                return r1.message, r2, r3.message, r4, m.time.now_ns()

            return await client.spawn(go())

        return run(m, main)

    r1, r2, r3, r4, _now = both(work)
    assert r1 == "Hello world!"
    assert r2 == ["srv #0", "srv #1", "srv #2"]
    assert r3 == "Hello a, b, c!"
    assert r4 == ["Hello x!", "Hello y!"]


@needs_protoc
def test_proto_ingestion_wrapper_impl_and_unimplemented():
    """`GreeterServer(MyGreeter())` wraps a plain impl object; rpcs the
    impl doesn't define come back UNIMPLEMENTED; two services from one
    proto coexist on one server."""

    def work(m):
        hw, grpc = _hello_ns(m), m.grpc

        class PlainImpl:
            async def say_hello(self, request):
                return hw.HelloReply(message=f"hi {request.into_inner().name}")

        async def main():
            handle = m.Handle.current()

            async def serve():
                await (grpc.Server.builder().add_service(hw.GreeterServer(PlainImpl()))
                       .add_service(hw.AnotherGreeterServer(PlainImpl())).serve("0.0.0.0:50051"))

            handle.create_node().name("server").ip("10.5.0.1").init(serve).build()
            await m.time.sleep(0.2)
            client = handle.create_node().ip("10.5.0.2").build()

            async def go():
                cl = await hw.GreeterClient.connect("http://10.5.0.1:50051")
                r1 = await cl.say_hello(hw.HelloRequest(name="a"))
                cl2 = await hw.AnotherGreeterClient.connect("http://10.5.0.1:50051")
                r2 = await cl2.say_hello(hw.HelloRequest(name="b"))
                with pytest.raises(grpc.Status) as ei:
                    stream = await cl.lots_of_replies(hw.HelloRequest(name="x"))
                    [x async for x in stream]
                return r1.message, r2.message, ei.value.code

            return await client.spawn(go())

        return run(m, main)

    assert both(work) == ("hi a", "hi b", Code.UNIMPLEMENTED)


@needs_protoc
def test_proto_emit_module(tmp_path):
    """`python -m madsim_tpu_torch.grpc.build x.proto -o x_pb.py` emits an
    importable generated module (the build-script route)."""

    def work(m):
        out = tmp_path / f"{m.__name__}_helloworld_pb.py"
        m.grpc.build.emit(_PROTO, str(out))
        spec = importlib.util.spec_from_file_location(f"{m.__name__}_helloworld_pb", out)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return (mod.HelloRequest(name="x").name, "helloworld.Greeter" in mod.services,
                mod.GreeterServer.__grpc_methods__["SayHello"], mod.GreeterServer.__grpc_methods__["BidiHello"])

    assert both(work) == ("x", True, ("say_hello", "unary"), ("bidi_hello", "streaming"))


@needs_protoc
def test_emitted_module_loads_the_port_build(tmp_path):
    """A module the port's `build.emit()` writes imports
    `madsim_tpu_torch.grpc.build`, and loading it in a fresh interpreter
    imports nothing of the JAX package; its server class is the port's
    `grpc.service`."""
    from madsim_tpu_torch.grpc import build

    out = tmp_path / "helloworld_pb.py"
    build.emit(_PROTO, str(out))
    text = out.read_text()
    assert "from madsim_tpu_torch.grpc.build import load_descriptor_set_bytes" in text
    assert "madsim_tpu." not in text.replace("madsim_tpu_torch.", "")
    code = (
        "import importlib.util, sys\n"
        f"spec = importlib.util.spec_from_file_location('helloworld_pb', {str(out)!r})\n"
        "mod = importlib.util.module_from_spec(spec); spec.loader.exec_module(mod)\n"
        "import madsim_tpu_torch.grpc as g\n"
        "print(sorted(n for n in sys.modules if n == 'madsim_tpu' or n.startswith('madsim_tpu.')),\n"
        "      mod.GreeterServer.__grpc_service_name__, isinstance(g.Status, type))\n"
    )
    env = dict(os.environ, PYTHONPATH=_REPO)
    r = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-800:]
    assert r.stdout.split() == ["[]", "helloworld.Greeter", "True"]


def test_client_drops_response_stream():
    """Reference: tonic-example/tests/test.rs client_drops_response_stream
    (:203-231) — a client that abandons a server stream mid-flight must
    not wedge or crash the server; later calls keep working."""

    def work(m):
        async def main():
            handle = m.Handle.current()
            await _start_server(m, handle)
            client = handle.create_node().ip("10.5.0.2").build()

            async def go():
                ch = await m.grpc.connect("http://10.5.0.1:50051")
                stream = await ch.server_streaming("/helloworld.Greeter/LotsOfReplies", "dropme")
                first = await stream.message()  # consume one, then abandon
                del stream
                await m.time.sleep(2.0)  # server keeps streaming into the void
                ok = await ch.unary("/helloworld.Greeter/SayHello", "after")
                return first, ok, m.time.now_ns()

            return await client.spawn(go())

        return run(m, main)

    first, ok, _now = both(work)
    assert first == "dropme #0"
    assert ok == "Hello after!"
