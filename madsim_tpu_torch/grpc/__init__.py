"""Simulated gRPC over the message fabric (reference: madsim-tonic).

Same architecture as the reference's tonic shim: no HTTP/2, no protobuf
serialization — a "call" is one `connect1` exchange carrying
(path, server_streaming flag, request object) and response objects
streamed back terminated by an end-of-stream marker
(reference: madsim-tonic/src/transport/server.rs:210-336, client.rs:38-110,
message-type matrix comment client.rs:33-37). Messages move between sim
nodes as Python objects, zero-copy, like the reference's `Box<dyn Any>`.

The reference generates client/server stubs with a forked tonic-build
(madsim-tonic-build); Python needs no codegen — `@service("pkg.Name")`
plus `@unary` / `@client_streaming` / `@server_streaming` / `@streaming`
decorators define the same four call shapes.
"""

from __future__ import annotations

import inspect
from typing import Any, AsyncIterator, Callable, Dict, List, Optional

from .. import _context
from ..errors import SimError
from ..net import Endpoint, lookup_host
from ..net.endpoint import PayloadReceiver, PayloadSender
from ..net.network import ConnectionRefused, ConnectionReset, parse_addr

__all__ = [
    "Server",
    "Router",
    "Channel",
    "connect",
    "Status",
    "Code",
    "Request",
    "Response",
    "Metadata",
    "Streaming",
    "service",
    "unary",
    "client_streaming",
    "server_streaming",
    "streaming",
]

_EOS = ("__eos__",)  # end-of-stream marker (reference streams `()` as terminator)


class _RspEnvelope:
    """Wire wrapper carrying a final response value + its metadata
    (tonic carries metadata in HTTP/2 headers/trailers; the sim moves it
    alongside the message object)."""

    __slots__ = ("value", "metadata")

    def __init__(self, value, metadata):
        self.value = value
        self.metadata = metadata


class Code:
    """gRPC status codes (subset; reference: tonic::Code)."""

    OK = 0
    CANCELLED = 1
    UNKNOWN = 2
    INVALID_ARGUMENT = 3
    DEADLINE_EXCEEDED = 4
    NOT_FOUND = 5
    ALREADY_EXISTS = 6
    PERMISSION_DENIED = 7
    RESOURCE_EXHAUSTED = 8
    FAILED_PRECONDITION = 9
    ABORTED = 10
    OUT_OF_RANGE = 11
    UNIMPLEMENTED = 12
    INTERNAL = 13
    UNAVAILABLE = 14
    DATA_LOSS = 15
    UNAUTHENTICATED = 16


class Status(SimError):
    """RPC error status (reference: tonic::Status)."""

    def __init__(self, code: int, message: str, metadata: Optional[Dict[str, str]] = None):
        super().__init__(f"status {code}: {message}")
        self.code = code
        self.message = message
        self.metadata: "Metadata" = Metadata(metadata)  # trailers; case-insensitive

    @staticmethod
    def unauthenticated(msg: str) -> "Status":
        return Status(Code.UNAUTHENTICATED, msg)

    @staticmethod
    def unavailable(msg: str) -> "Status":
        return Status(Code.UNAVAILABLE, msg)

    @staticmethod
    def not_found(msg: str) -> "Status":
        return Status(Code.NOT_FOUND, msg)

    @staticmethod
    def unimplemented(msg: str) -> "Status":
        return Status(Code.UNIMPLEMENTED, msg)

    @staticmethod
    def internal(msg: str) -> "Status":
        return Status(Code.INTERNAL, msg)


class Metadata(dict):
    """Case-insensitive metadata map (reference: tonic::metadata::MetadataMap).

    Keys are STORED lowercased — matching gRPC wire metadata, so
    sim-tested code behaves identically against a genuine server in real
    mode — but every lookup/mutation is case-insensitive, so an app that
    sets "X-Trace-Id" and reads "X-Trace-Id" works in both modes rather
    than silently missing."""

    def __init__(self, items: Optional[Dict[str, str]] = None):
        super().__init__()
        for k, v in (items or {}).items():
            self[k] = v

    def __setitem__(self, key: str, value: str) -> None:
        super().__setitem__(key.lower(), value)

    def __getitem__(self, key: str) -> str:
        return super().__getitem__(key.lower())

    def __contains__(self, key) -> bool:
        return super().__contains__(key.lower() if isinstance(key, str) else key)

    def get(self, key: str, default=None):
        return super().get(key.lower(), default)

    def pop(self, key: str, *default):
        return super().pop(key.lower(), *default)

    def setdefault(self, key: str, default=None):
        return super().setdefault(key.lower(), default)

    def __delitem__(self, key: str) -> None:
        super().__delitem__(key.lower())

    def copy(self) -> "Metadata":
        return Metadata(self)

    def update(self, other=None, **kw):  # type: ignore[override]
        for k, v in dict(other or {}, **kw).items():
            self[k] = v


class Request:
    """Request wrapper (reference: tonic::Request). `metadata` travels
    with the call (tonic: HTTP/2 headers) — populate it client-side and
    read it in handlers via `request.metadata` (case-insensitive, stored
    lowercase like gRPC wire metadata)."""

    def __init__(self, message: Any, metadata: Optional[Dict[str, str]] = None):
        self.message = message
        self.metadata: Metadata = Metadata(metadata)

    def into_inner(self) -> Any:
        return self.message


class Response:
    """Response wrapper (reference: tonic::Response). Handler-set
    `metadata` rides back to the caller (tonic: response headers) and is
    visible when the client passed a `Request` wrapper in. Lookups are
    case-insensitive (see Metadata)."""

    def __init__(self, message: Any, metadata: Optional[Dict[str, str]] = None):
        self.message = message
        self.metadata: Metadata = Metadata(metadata)

    def into_inner(self) -> Any:
        return self.message


class Streaming:
    """Async response/request stream (reference: madsim-tonic/src/codec.rs)."""

    def __init__(self, rx: PayloadReceiver):
        self._rx = rx
        self._done = False

    def __aiter__(self) -> "Streaming":
        return self

    async def __anext__(self) -> Any:
        item = await self.message()
        if item is None:
            raise StopAsyncIteration
        return item

    async def message(self) -> Optional[Any]:
        """Next message or None at end of stream."""
        if self._done:
            return None
        item = await self._rx.recv()
        if item is None or item == _EOS:
            self._done = True
            return None
        if isinstance(item, Status):
            self._done = True
            raise item
        return item


# -- service definition (codegen replacement) --------------------------------

SHAPE_UNARY = "unary"
SHAPE_CLIENT_STREAMING = "client_streaming"
SHAPE_SERVER_STREAMING = "server_streaming"
SHAPE_STREAMING = "streaming"


def _mark(shape: str):
    def deco(fn):
        fn.__grpc_shape__ = shape
        return fn

    return deco


unary = _mark(SHAPE_UNARY)
client_streaming = _mark(SHAPE_CLIENT_STREAMING)
server_streaming = _mark(SHAPE_SERVER_STREAMING)
streaming = _mark(SHAPE_STREAMING)


def _camel(name: str) -> str:
    return "".join(part.capitalize() for part in name.split("_"))


def service(service_name: str):
    """Class decorator: registers `@unary`/`@streaming`-marked methods
    under "/{service_name}/{CamelCaseMethod}" paths."""

    def deco(cls):
        methods: Dict[str, tuple] = {}
        for name in dir(cls):
            fn = getattr(cls, name, None)
            shape = getattr(fn, "__grpc_shape__", None)
            if shape is not None:
                methods[_camel(name)] = (name, shape)
        cls.__grpc_service_name__ = service_name
        cls.__grpc_methods__ = methods
        return cls

    return deco


# -- server ------------------------------------------------------------------


class Server:
    """Reference: madsim-tonic transport::Server builder (the ~20 HTTP/2
    tuning knobs are accepted and ignored, like the reference).

    Dual-build: under MADSIM_TPU_MODE=real the builder returns the
    grpc.aio-backed RealRouter, so `Server.builder().add_service(...)
    .serve(addr)` written against generated stubs hosts a genuine gRPC
    server in production — the server-side half of the reference's
    `#[cfg(madsim)]` re-export (madsim-tonic/src/lib.rs:1-8)."""

    @staticmethod
    def builder():
        from ..dual import IS_SIM

        if IS_SIM:
            return Router()
        from .real import RealRouter

        return RealRouter()


class ConfigKnobs:
    """No-op HTTP/2 config surface (parity with the reference's builder)
    — shared by the sim Router and the real-mode RealRouter so the knob
    surface cannot drift between modes."""

    def timeout(self, *_a, **_k):
        return self

    def concurrency_limit_per_connection(self, *_a, **_k):
        return self

    def tcp_nodelay(self, *_a, **_k):
        return self

    def http2_keepalive_interval(self, *_a, **_k):
        return self

    def max_frame_size(self, *_a, **_k):
        return self


class Router(ConfigKnobs):
    """Reference: transport/server.rs `Router`."""

    def __init__(self) -> None:
        self._services: Dict[str, Any] = {}
        self._interceptor: Optional[Callable[[Request], Request]] = None

    def intercept(self, fn: Callable[[Request], Request]) -> "Router":
        """Server interceptor (tonic: `service_with_interceptor` /
        tower layer): runs on every incoming Request before dispatch;
        raise `Status` to reject (e.g. UNAUTHENTICATED)."""
        self._interceptor = fn
        return self

    def add_service(self, svc: Any) -> "Router":
        name = getattr(type(svc), "__grpc_service_name__", None)
        if name is None:
            raise SimError(f"{type(svc).__name__} is not a @grpc.service class")
        self._services[name] = svc
        return self

    async def serve(self, addr: Any) -> None:
        await self.serve_with_shutdown(addr, None)

    async def serve_with_shutdown(self, addr: Any, shutdown) -> None:
        """Accept loop: one task per request
        (reference: server.rs:217-240 serve_with_shutdown)."""
        from ..task import spawn

        ep = await Endpoint.bind(addr)
        serve_task = spawn(self._accept_loop(ep), name="grpc-serve")
        if shutdown is None:
            await serve_task
        else:
            shutdown_task = spawn(shutdown, name="grpc-shutdown") if inspect.iscoroutine(shutdown) else shutdown
            await shutdown_task
            serve_task.abort()
            ep.close()

    async def _accept_loop(self, ep: Endpoint) -> None:
        from ..task import spawn

        while True:
            tx, rx, peer = await ep.accept1()
            spawn(self._handle(tx, rx, peer), name="grpc-conn")

    async def _handle(self, tx: PayloadSender, rx: PayloadReceiver, peer) -> None:
        """Decode (path, server_streaming, request), route by service name,
        stream responses terminated by EOS (reference: server.rs:232-334)."""
        head = await rx.recv()
        if head is None:
            return
        path, _server_streaming, shape, first, req_md = head
        try:
            _, svc_name, method = path.split("/")
        except ValueError:
            tx.send(Status(Code.INVALID_ARGUMENT, f"bad path {path!r}"))
            return
        svc = self._services.get(svc_name)
        if svc is None:
            tx.send(Status.unimplemented(f"unknown service {svc_name}"))
            return
        entry = type(svc).__grpc_methods__.get(method)
        if entry is None:
            tx.send(Status.unimplemented(f"unknown method {method} on {svc_name}"))
            return
        attr, decl_shape = entry
        handler = getattr(svc, attr)
        request = Request(first, req_md)
        if self._interceptor is not None:
            try:
                request = self._interceptor(request)
            except Status as status:
                tx.send(status)
                return

        def _final(rsp) -> _RspEnvelope:
            if isinstance(rsp, Response):
                return _RspEnvelope(rsp.into_inner(), rsp.metadata)
            return _RspEnvelope(rsp, {})

        try:
            if decl_shape == SHAPE_UNARY:
                tx.send(_final(await handler(request)))
            elif decl_shape == SHAPE_CLIENT_STREAMING:
                tx.send(_final(await handler(Streaming(rx))))
            elif decl_shape == SHAPE_SERVER_STREAMING:
                async for item in handler(request):
                    tx.send(item)
            else:  # bidi
                async for item in handler(Streaming(rx)):
                    tx.send(item)
        except Status as status:
            tx.send(status)
            return
        except (ConnectionReset, ConnectionRefused):
            return
        except Exception as exc:  # noqa: BLE001 - handler panic -> INTERNAL
            tx.send(Status.internal(repr(exc)))
            return
        tx.send(_EOS)


# -- client ------------------------------------------------------------------


class Channel:
    """Client channel (reference: transport/channel.rs `Endpoint`/`Channel`).

    connect = DNS lookup + ephemeral bind; `timeout` honored on calls,
    other knobs ignored (reference: channel.rs:23-140)."""

    def __init__(
        self,
        target: str,
        timeout: Optional[float] = None,
        interceptor: Optional[Callable[[Request], Request]] = None,
    ):
        self._target = target
        self._timeout = timeout
        self._interceptor = interceptor
        self._ep: Optional[Endpoint] = None
        self._addr = None

    def with_interceptor(self, fn: Callable[[Request], Request]) -> "Channel":
        """Client interceptor (tonic: `GreeterClient::with_interceptor`):
        runs on every outgoing Request — inject metadata (auth tokens),
        or raise `Status` to fail the call locally."""
        self._interceptor = fn
        return self

    # tonic 0.12 compression / message-size API surface: accepted and
    # ignored, like the reference's no-op HTTP/2 knobs (messages move as
    # objects — there is nothing to compress or size-limit)
    def accept_compressed(self, *_a, **_k) -> "Channel":
        return self

    def send_compressed(self, *_a, **_k) -> "Channel":
        return self

    def max_decoding_message_size(self, *_a, **_k) -> "Channel":
        return self

    def max_encoding_message_size(self, *_a, **_k) -> "Channel":
        return self

    async def _connect(self) -> None:
        target = self._target
        if target.startswith("http://") or target.startswith("https://"):
            target = target.split("://", 1)[1]
        results = await lookup_host(target)
        self._addr = parse_addr(results[0])
        self._ep = await Endpoint.bind(("0.0.0.0", 0))
        # handshake: verify the server is reachable (reference connect1
        # handshake at channel.rs:74-108)
        tx, rx = await self._ep.connect1(self._addr)
        tx.close()

    def _prepare(self, msg: Any) -> tuple:
        """Normalize a raw message or Request wrapper through the
        interceptor. Returns (payload, metadata, wrapped) — `wrapped`
        decides whether the caller gets a Response wrapper back."""
        wrapped = isinstance(msg, Request)
        request = msg if wrapped else Request(msg)
        if self._interceptor is not None:
            request = self._interceptor(request)
        return request.into_inner(), request.metadata, wrapped

    async def _open(self, path: str, shape: str, first: Any, metadata: Dict[str, str]):
        assert self._ep is not None
        tx, rx = await self._ep.connect1(self._addr)
        tx.send((path, shape in (SHAPE_SERVER_STREAMING, SHAPE_STREAMING), shape, first, metadata))
        return tx, rx

    @staticmethod
    def _unwrap(rsp: Any, wrapped: bool) -> Any:
        if isinstance(rsp, _RspEnvelope):
            return Response(rsp.value, rsp.metadata) if wrapped else rsp.value
        return Response(rsp) if wrapped else rsp

    async def unary(self, path: str, msg: Any) -> Any:
        """Reference: client.rs Grpc::unary. Pass a `Request` to send
        metadata and receive a `Response` (with metadata) back; raw
        messages round-trip as raw messages."""
        from ..time import timeout as time_timeout

        payload, md, wrapped = self._prepare(msg)

        async def go():
            tx, rx = await self._open(path, SHAPE_UNARY, payload, md)
            rsp = await rx.recv()
            if isinstance(rsp, Status):
                raise rsp
            if rsp is None:
                raise Status.unavailable("connection closed")
            return self._unwrap(rsp, wrapped)

        if self._timeout is not None:
            return await time_timeout(self._timeout, go())
        return await go()

    async def client_streaming(self, path: str, messages, metadata: Optional[Dict[str, str]] = None) -> Any:
        from ..time import timeout as time_timeout

        _p, md, wrapped = self._prepare(Request(None, metadata) if metadata else None)

        async def go():
            tx, rx = await self._open(path, SHAPE_CLIENT_STREAMING, None, md)
            async for m in _aiter(messages):
                tx.send(m)
            tx.send(_EOS)
            rsp = await rx.recv()
            if isinstance(rsp, Status):
                raise rsp
            if rsp is None:
                raise Status.unavailable("connection closed")
            return self._unwrap(rsp, wrapped)

        if self._timeout is not None:
            return await time_timeout(self._timeout, go())
        return await go()

    async def server_streaming(self, path: str, msg: Any) -> Streaming:
        """The channel timeout covers stream *setup*; per-message read
        deadlines are the caller's (wrap `stream.message()` in
        `time.timeout`), matching tonic where the timeout is per-request
        not per-stream-element."""
        from ..time import timeout as time_timeout

        payload, md, _wrapped = self._prepare(msg)
        if self._timeout is not None:
            tx, rx = await time_timeout(
                self._timeout, self._open(path, SHAPE_SERVER_STREAMING, payload, md)
            )
        else:
            tx, rx = await self._open(path, SHAPE_SERVER_STREAMING, payload, md)
        return Streaming(rx)

    async def streaming(self, path: str, messages, metadata: Optional[Dict[str, str]] = None) -> Streaming:
        from ..task import spawn

        _p, md, _wrapped = self._prepare(Request(None, metadata) if metadata else None)
        tx, rx = await self._open(path, SHAPE_STREAMING, None, md)

        async def feed():
            async for m in _aiter(messages):
                tx.send(m)
            tx.send(_EOS)

        spawn(feed(), name="grpc-feed")
        return Streaming(rx)


async def connect(
    target: str,
    timeout: Optional[float] = None,
    interceptor: Optional[Callable[[Request], Request]] = None,
) -> Channel:
    """Connect a channel (reference: Endpoint::connect).

    Raises `Status(UNAVAILABLE)` if the server is unreachable."""
    ch = Channel(target, timeout=timeout, interceptor=interceptor)
    try:
        await ch._connect()
    except (ConnectionRefused, ConnectionReset, OSError) as exc:
        raise Status.unavailable(str(exc)) from exc
    return ch


async def _aiter(it) -> AsyncIterator[Any]:
    if hasattr(it, "__aiter__"):
        async for x in it:
            yield x
    else:
        for x in it:
            yield x
