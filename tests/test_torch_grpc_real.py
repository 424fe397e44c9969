"""The port's generated gRPC stubs in real mode
(`madsim_tpu_torch.grpc.real`), mirroring tests/test_grpc_real.py case
for case: the same classes that run on the sim fabric speak genuine
protobuf over HTTP/2 through grpc.aio, in process, on 127.0.0.1. The
in-process cases run on the port and on the JAX package
(`torch_host_util.both`) and give equal values; the mode-switch cases
run the port in a subprocess under `MADSIM_TPU_MODE=real`."""

import asyncio
import os
import shutil
import subprocess
import sys

import pytest

pytest.importorskip("grpc")

import madsim_tpu.grpc.build  # noqa: E402,F401  (binds `madsim_tpu.grpc.build`)
import madsim_tpu_torch.grpc.build  # noqa: E402,F401
from torch_host_util import both  # noqa: E402

# .proto ingestion shells out to protoc; skip (not fail) on boxes
# without the protobuf compiler — environment capability, not a
# code regression
needs_protoc = pytest.mark.skipif(shutil.which("protoc") is None, reason="protoc not on PATH")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_PROTO = os.path.join(os.path.dirname(os.path.abspath(__file__)), "protos", "helloworld.proto")


def _impl(m, hw):
    sgrpc = m.grpc

    class Impl:
        async def say_hello(self, request):
            name = request.into_inner().name
            if name == "error":
                raise sgrpc.Status(sgrpc.Code.INVALID_ARGUMENT, "bad name")
            return hw.HelloReply(message=f"Hello {name}!")

        async def lots_of_replies(self, request):
            name = request.into_inner().name
            for i in range(3):
                yield hw.HelloReply(message=f"{name} #{i}")

        async def lots_of_greetings(self, stream):
            names = []
            while (msg := await stream.message()) is not None:
                names.append(msg.name)
            return hw.HelloReply(message=f"Hello {', '.join(names)}!")

        async def bidi_hello(self, stream):
            while (msg := await stream.message()) is not None:
                yield hw.HelloReply(message=f"Hello {msg.name}!")

    return Impl


@needs_protoc
def test_real_mode_four_shapes_and_status():
    def work(m):
        import importlib

        real = importlib.import_module(f"{m.__name__}.grpc.real")
        sgrpc, hw = m.grpc, m.grpc.build.load(_PROTO)

        async def main():
            router = real.RealRouter().add_service(hw.GreeterServer(_impl(m, hw)()))
            port = await router.start("127.0.0.1:0")
            ch = await real.RealChannel.connect(f"127.0.0.1:{port}", hw.GreeterClient._METHODS, timeout=5.0)
            try:
                r1 = await ch.unary("/helloworld.Greeter/SayHello", hw.HelloRequest(name="real"))
                stream = await ch.server_streaming("/helloworld.Greeter/LotsOfReplies", hw.HelloRequest(name="s"))
                r2 = [x.message async for x in stream]
                r3 = await ch.client_streaming("/helloworld.Greeter/LotsOfGreetings",
                                               [hw.HelloRequest(name=n) for n in "ab"])
                stream = await ch.streaming("/helloworld.Greeter/BidiHello",
                                            [hw.HelloRequest(name=n) for n in ("x", "y")])
                r4 = [x.message async for x in stream]
                with pytest.raises(sgrpc.Status) as ei:
                    await ch.unary("/helloworld.Greeter/SayHello", hw.HelloRequest(name="error"))
                return r1.message, r2, r3.message, r4, ei.value.code
            finally:
                await ch.close()
                await router.stop()

        return asyncio.run(main())

    r1, r2, r3, r4, code = both(work)
    assert r1 == "Hello real!"
    assert r2 == ["s #0", "s #1", "s #2"]
    assert r3 == "Hello a, b!"
    assert r4 == ["Hello x!", "Hello y!"]
    assert code == madsim_tpu_torch.grpc.Code.INVALID_ARGUMENT


@needs_protoc
def test_real_mode_metadata_rides_both_ways():
    def work(m):
        import importlib

        real = importlib.import_module(f"{m.__name__}.grpc.real")
        sgrpc, hw = m.grpc, m.grpc.build.load(_PROTO)
        seen = {}

        class MdImpl(_impl(m, hw)):
            async def say_hello(self, request):
                seen.update(request.metadata)
                return hw.HelloReply(message="ok")

        async def main():
            router = real.RealRouter().add_service(hw.GreeterServer(MdImpl()))
            port = await router.start("127.0.0.1:0")
            ch = await real.RealChannel.connect(f"127.0.0.1:{port}", hw.GreeterClient._METHODS, timeout=5.0)
            try:
                rsp = await ch.unary("/helloworld.Greeter/SayHello",
                                     sgrpc.Request(hw.HelloRequest(name="m"), {"x-token": "t1"}))
                return seen.get("x-token"), rsp.into_inner().message
            finally:
                await ch.close()
                await router.stop()

        return asyncio.run(main())

    assert both(work) == ("t1", "ok")


def _run_real(code):
    env = dict(os.environ, MADSIM_TPU_MODE="real")
    env.pop("JAX_PLATFORMS", None)
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    return out.stdout


@needs_protoc
def test_generated_client_mode_switch_subprocess():
    """MADSIM_TPU_MODE=real flips GeneratedClient.connect to the grpc.aio
    path — the `#[cfg(madsim)]` dual-build switch, end to end."""
    code = f"""
import asyncio, sys
sys.path.insert(0, {REPO!r})
from madsim_tpu_torch.grpc import build
from madsim_tpu_torch.grpc.real import RealRouter

hw = build.load({_PROTO!r})

class Impl:
    async def say_hello(self, request):
        return hw.HelloReply(message="via " + request.into_inner().name)

async def main():
    router = RealRouter().add_service(hw.GreeterServer(Impl()))
    port = await router.start("127.0.0.1:0")
    cl = await hw.GreeterClient.connect(f"127.0.0.1:{{port}}", timeout=5.0)
    rsp = await cl.say_hello(hw.HelloRequest(name="realmode"))
    print("GOT:" + rsp.message)
    print("JAX:", sorted(n for n in sys.modules if n == "madsim_tpu" or n.startswith("madsim_tpu.")))
    await router.stop()

asyncio.run(main())
"""
    out = _run_real(code)
    assert "GOT:via realmode" in out
    assert "JAX: []" in out


@needs_protoc
def test_server_builder_dual_mode_and_interceptor():
    """`grpc.Server.builder()` returns the grpc.aio-backed router under
    MADSIM_TPU_MODE=real, so the same server code (builder, add_service,
    serve, interceptors included) runs in both worlds."""
    code = f"""
import asyncio, sys
sys.path.insert(0, {REPO!r})
from madsim_tpu_torch import grpc as sgrpc
from madsim_tpu_torch.grpc import build

hw = build.load({_PROTO!r})

class Impl:
    async def say_hello(self, request):
        return hw.HelloReply(message="hi " + request.into_inner().name)

    async def bidi_hello(self, stream):
        while (m := await stream.message()) is not None:
            yield hw.HelloReply(message="S:" + m.name)

def guard(request):
    if request.metadata.get("x-token") != "secret":
        raise sgrpc.Status.unauthenticated("missing token")
    return request

async def main():
    router = sgrpc.Server.builder().add_service(hw.GreeterServer(Impl()))
    router.tcp_nodelay().timeout(5)   # no-op knob surface
    router.intercept(guard)
    port = await router.start("127.0.0.1:0")
    cl = await hw.GreeterClient.connect(f"127.0.0.1:{{port}}", timeout=5.0)
    try:
        await cl.say_hello(hw.HelloRequest(name="x"))
        print("UNEXPECTED: unauthenticated call passed")
    except sgrpc.Status as st:
        print("REJECTED:", st.code == sgrpc.Code.UNAUTHENTICATED)
    rsp = await cl.say_hello(sgrpc.Request(hw.HelloRequest(name="x"), {{"x-token": "secret"}}))
    print("GOT:", rsp.into_inner().message)
    # the guard must also fence streaming shapes
    try:
        stream = await cl.bidi_hello([hw.HelloRequest(name="z")])
        [m async for m in stream]
        print("UNEXPECTED: unauthenticated bidi passed")
    except sgrpc.Status as st:
        print("BIDI-REJECTED:", st.code == sgrpc.Code.UNAUTHENTICATED)
    stream = await cl.bidi_hello([hw.HelloRequest(name="z")],
                                 metadata={{"x-token": "secret"}})
    msgs = [m.message async for m in stream]
    print("BIDI-GOT:", msgs)
    await router.stop()

asyncio.run(main())
"""
    out = _run_real(code)
    assert "REJECTED: True" in out
    assert "GOT: hi x" in out
    assert "BIDI-REJECTED: True" in out
    assert "BIDI-GOT: ['S:z']" in out
