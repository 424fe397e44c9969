"""Real-mode gRPC backend for generated stubs — genuine protobuf wire
format over `grpc.aio` (the analogue of the reference's non-sim build
where madsim-tonic re-exports real tonic, madsim-tonic/src/lib.rs:1-8).

The classes `build.load()` synthesizes call into `RealChannel` /
`RealRouter` under ``MADSIM_TPU_MODE=real``: the *same* generated client
and server classes that run on the sim fabric then speak interoperable
gRPC to any real peer (tested in-process against grpc.aio itself,
tests/test_real_mode.py). Sim-style `Status` / `Request` / `Response` /
stream surfaces are preserved so application code is mode-agnostic.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import grpc as _grpc
import grpc.aio as _aio

from . import (
    Code,
    ConfigKnobs,
    Request,
    Response,
    SHAPE_CLIENT_STREAMING,
    SHAPE_SERVER_STREAMING,
    SHAPE_STREAMING,
    SHAPE_UNARY,
    Status,
    Streaming,
)

__all__ = ["RealChannel", "RealRouter", "RealStreaming"]

_CODE_TO_GRPC = {sc.value[0]: sc for sc in _grpc.StatusCode}


def _to_status(err: _aio.AioRpcError) -> Status:
    code = err.code().value[0] if err.code() is not None else Code.UNKNOWN
    md = {k: v for k, v in (err.trailing_metadata() or ())}
    return Status(code, err.details() or "", md)


def _strip_scheme(target: str) -> str:
    if "://" in target:
        return target.split("://", 1)[1]
    return target


def _serialize(msg: Any) -> bytes:
    return msg.SerializeToString()


class RealStreaming:
    """Response-stream adapter with the sim `Streaming` surface
    (`async for` + `await stream.message()`), translating grpc.aio
    errors to sim `Status`."""

    def __init__(self, call):
        self._call = call
        self._it = call.__aiter__()
        self._done = False

    def __aiter__(self) -> "RealStreaming":
        return self

    async def __anext__(self) -> Any:
        try:
            return await self._it.__anext__()
        except StopAsyncIteration:
            self._done = True
            raise
        except _aio.AioRpcError as err:
            self._done = True
            raise _to_status(err) from None

    async def message(self) -> Optional[Any]:
        if self._done:
            return None
        try:
            return await self.__anext__()
        except StopAsyncIteration:
            return None


class RealChannel:
    """grpc.aio-backed channel exposing the sim `Channel` call surface
    (`unary`/`client_streaming`/`server_streaming`/`streaming` by path);
    serializers come from the generated `_METHODS` type map."""

    def __init__(self, channel, types: Dict[str, Tuple[str, type, type]],
                 timeout: Optional[float], interceptor=None):
        self._chan = channel
        self._types = types
        self._timeout = timeout
        self._interceptor = interceptor

    @classmethod
    async def connect(
        cls,
        target: str,
        methods: Dict[str, Tuple[str, str, type, type]],
        timeout: Optional[float] = None,
        interceptor=None,
    ) -> "RealChannel":
        chan = _aio.insecure_channel(_strip_scheme(target))
        try:
            import asyncio

            await asyncio.wait_for(chan.channel_ready(), timeout or 10.0)
        except Exception as exc:
            await chan.close()
            raise Status.unavailable(f"{target}: {exc}") from exc
        types = {path: (shape, req, rsp) for (path, shape, req, rsp) in methods.values()}
        return cls(chan, types, timeout, interceptor)

    async def close(self) -> None:
        await self._chan.close()

    def set_default_timeout(self, timeout: Optional[float]) -> None:
        """Per-call deadline for subsequent RPCs. Callers that probe
        with a short deadline must reset it afterwards, or long-lived
        streams (watch, blocking Campaign) inherit the probe deadline."""
        self._timeout = timeout

    def _prepare(self, msg: Any) -> tuple:
        wrapped = isinstance(msg, Request)
        request = msg if wrapped else Request(msg)
        if self._interceptor is not None:
            request = self._interceptor(request)
        md = tuple((k.lower(), v) for k, v in request.metadata.items())
        return request.into_inner(), md, wrapped

    def _pair(self, path: str) -> Tuple[type, type]:
        if path not in self._types:
            raise Status.unimplemented(f"no descriptor types for {path}")
        _shape, req, rsp = self._types[path]
        return req, rsp

    async def unary(self, path: str, msg: Any) -> Any:
        req_cls, rsp_cls = self._pair(path)
        payload, md, wrapped = self._prepare(msg)
        mc = self._chan.unary_unary(
            path, request_serializer=_serialize, response_deserializer=rsp_cls.FromString
        )
        call = mc(payload, timeout=self._timeout, metadata=md)
        try:
            rsp = await call
        except _aio.AioRpcError as err:
            raise _to_status(err) from None
        if wrapped:
            headers = {k: v for k, v in (await call.initial_metadata() or ())}
            return Response(rsp, headers)
        return rsp

    async def client_streaming(self, path: str, messages, metadata=None) -> Any:
        req_cls, rsp_cls = self._pair(path)
        _p, md, wrapped = self._prepare(Request(None, metadata) if metadata else None)
        mc = self._chan.stream_unary(
            path, request_serializer=_serialize, response_deserializer=rsp_cls.FromString
        )
        call = mc(_agen(messages), timeout=self._timeout, metadata=md)
        try:
            rsp = await call
        except _aio.AioRpcError as err:
            raise _to_status(err) from None
        if wrapped:
            headers = {k: v for k, v in (await call.initial_metadata() or ())}
            return Response(rsp, headers)
        return rsp

    async def server_streaming(self, path: str, msg: Any) -> RealStreaming:
        req_cls, rsp_cls = self._pair(path)
        payload, md, _w = self._prepare(msg)
        mc = self._chan.unary_stream(
            path, request_serializer=_serialize, response_deserializer=rsp_cls.FromString
        )
        return RealStreaming(mc(payload, timeout=self._timeout, metadata=md))

    async def streaming(self, path: str, messages, metadata=None) -> RealStreaming:
        req_cls, rsp_cls = self._pair(path)
        _p, md, _w = self._prepare(Request(None, metadata) if metadata else None)
        mc = self._chan.stream_stream(
            path, request_serializer=_serialize, response_deserializer=rsp_cls.FromString
        )
        return RealStreaming(mc(_agen(messages), timeout=self._timeout, metadata=md))


async def _agen(it):
    if hasattr(it, "__aiter__"):
        async for x in it:
            yield x
    else:
        for x in it:
            yield x


# -- real server --------------------------------------------------------------


class _RequestStream(Streaming):
    """Adapts grpc.aio's request_iterator to the sim handler-side
    `Streaming` surface."""

    def __init__(self, request_iterator):
        self._it = request_iterator.__aiter__()
        self._done = False

    async def message(self) -> Optional[Any]:
        if self._done:
            return None
        try:
            return await self._it.__anext__()
        except StopAsyncIteration:
            self._done = True
            return None


def _abort_args(status: Status):
    return _CODE_TO_GRPC.get(status.code, _grpc.StatusCode.UNKNOWN), status.message


class _GeneratedServiceHandler(_grpc.GenericRpcHandler):
    """Routes /pkg.Service/Method to a generated server instance's
    shape-decorated handlers, with protobuf (de)serialization from the
    descriptor-derived `__grpc_method_types__` map."""

    def __init__(self, svc, interceptor=None):
        cls = type(svc)
        self._svc = svc
        self._name = cls.__grpc_service_name__
        self._methods = cls.__grpc_methods__
        self._type_map = getattr(cls, "__grpc_method_types__", {})
        self._interceptor = interceptor

    def service(self, handler_call_details):
        path = handler_call_details.method
        try:
            _, svc_name, method = path.split("/")
        except ValueError:
            return None
        if svc_name != self._name or method not in self._methods:
            return None
        py_name, shape = self._methods[method]
        req_cls, rsp_cls = self._type_map.get(method, (None, None))
        handler = getattr(self._svc, py_name)
        deser = req_cls.FromString if req_cls is not None else None

        get_interceptor = self._interceptor

        def _req(msg, context) -> Request:
            md = {k: v for k, v in (context.invocation_metadata() or ())}
            request = Request(msg, md)
            interceptor = get_interceptor() if get_interceptor is not None else None
            if interceptor is not None:
                request = interceptor(request)  # may raise Status
            return request

        def _guard_stream(context) -> None:
            """Interceptor check for the streaming-request shapes — the
            sim Router runs the interceptor on EVERY shape before
            dispatch (message=None for streams), and an auth guard that
            only fires for unary in real mode would be a silent
            production bypass."""
            interceptor = get_interceptor() if get_interceptor is not None else None
            if interceptor is not None:
                md = {k: v for k, v in (context.invocation_metadata() or ())}
                interceptor(Request(None, md))  # may raise Status

        def _unwrap(rsp):
            return rsp.into_inner() if isinstance(rsp, Response) else rsp

        if shape == SHAPE_UNARY:

            async def u(msg, context):
                try:
                    return _unwrap(await handler(_req(msg, context)))
                except Status as st:
                    await context.abort(*_abort_args(st))

            return _grpc.unary_unary_rpc_method_handler(
                u, request_deserializer=deser, response_serializer=_serialize
            )
        if shape == SHAPE_CLIENT_STREAMING:

            async def cs(request_iterator, context):
                try:
                    _guard_stream(context)
                    return _unwrap(await handler(_RequestStream(request_iterator)))
                except Status as st:
                    await context.abort(*_abort_args(st))

            return _grpc.stream_unary_rpc_method_handler(
                cs, request_deserializer=deser, response_serializer=_serialize
            )
        if shape == SHAPE_SERVER_STREAMING:

            async def ss(msg, context):
                try:
                    async for item in handler(_req(msg, context)):
                        yield _unwrap(item)
                except Status as st:
                    await context.abort(*_abort_args(st))

            return _grpc.unary_stream_rpc_method_handler(
                ss, request_deserializer=deser, response_serializer=_serialize
            )

        async def bidi(request_iterator, context):
            try:
                _guard_stream(context)
                async for item in handler(_RequestStream(request_iterator)):
                    yield _unwrap(item)
            except Status as st:
                await context.abort(*_abort_args(st))

        return _grpc.stream_stream_rpc_method_handler(
            bidi, request_deserializer=deser, response_serializer=_serialize
        )


class RealRouter(ConfigKnobs):
    """Real-mode `Server.builder()` twin: `.add_service(...).serve(addr)`
    hosts generated services on a genuine grpc.aio server. The sim
    Router's no-op HTTP/2 knobs and serve/shutdown surface apply here
    too, so dual-mode app code runs unchanged."""

    def __init__(self) -> None:
        self._handlers = []
        self._server = None
        self._interceptor = None

    def intercept(self, fn) -> "RealRouter":
        """Server interceptor (sim Router.intercept twin): runs on every
        incoming Request before dispatch; raise `Status` to reject."""
        self._interceptor = fn
        return self

    def add_service(self, svc) -> "RealRouter":
        if not hasattr(type(svc), "__grpc_service_name__"):
            raise Status.internal(f"{type(svc).__name__} is not a generated/decorated service")
        # late-bound: intercept() may be called after add_service, and it
        # must cover every service (sim Router semantics)
        self._handlers.append(_GeneratedServiceHandler(svc, lambda: self._interceptor))
        return self

    async def start(self, addr: str) -> int:
        """Bind + start; returns the bound port (0 picks a free one)."""
        self._server = _aio.server()
        self._server.add_generic_rpc_handlers(tuple(self._handlers))
        port = self._server.add_insecure_port(_strip_scheme(addr))
        await self._server.start()
        return port

    async def serve(self, addr: str) -> None:
        await self.start(addr)
        await self._server.wait_for_termination()

    async def serve_with_shutdown(self, addr: str, shutdown) -> None:
        """Sim Router surface: serve until `shutdown` (an awaitable or
        None) completes, then stop gracefully."""
        if shutdown is None:
            await self.serve(addr)
            return
        await self.start(addr)
        await shutdown
        await self.stop()

    async def stop(self, grace: Optional[float] = None) -> None:
        if self._server is not None:
            await self._server.stop(grace)
