"""Typed request/response RPC over Endpoint tags
(reference: madsim/src/sim/net/rpc.rs + madsim-macros).

Shape parity with the reference:
  * a request type has a stable u64 ID derived from its name
    (reference: rpc.rs:82 `hash_str`; macro `#[derive(Request)]`
    madsim-macros/src/request.rs)
  * `call` sends (rsp_tag=random u64, req, data) on tag=ID and awaits
    rsp_tag (reference: rpc.rs:108-132)
  * `add_rpc_handler` runs a loop that spawns one task per request
    (reference: rpc.rs:143-167)

Python has no proc macros; `Request` subclassing replaces
`#[derive(Request)]`, and the `@service`/`@rpc` decorators replace
`#[madsim::service]` (madsim-macros/src/service.rs).
"""

from __future__ import annotations

from typing import Any, Awaitable, Callable, Dict, Optional, Tuple, Type

from .. import rand
from .. import time as sim_time
from ..future import await_
from ..rand.philox import splitmix64
from ..task import spawn
from ..task.join import JoinHandle
from .endpoint import Endpoint
from .network import Addr, ConnectionReset, parse_addr


def hash_str(s: str) -> int:
    """Stable string -> u64 (reference: rpc.rs:82 const hash)."""
    h = 0xCBF29CE484222325  # FNV offset basis as a start value
    for b in s.encode():
        h = splitmix64(h ^ b)
    return h


class Request:
    """Base class for RPC requests (reference: rpc.rs:73-79 `Request` trait).

    Subclass and (optionally) set `Response`; the type ID is derived from
    the class name, like the derive macro hashes type name + rtype."""

    @classmethod
    def type_id(cls) -> int:
        # per-class cache (__dict__ check: subclasses must not inherit it)
        tid = cls.__dict__.get("_type_id_cache")
        if tid is None:
            tid = hash_str(f"{cls.__module__}.{cls.__qualname__}")
            cls._type_id_cache = tid
        return tid


Handler = Callable[..., Awaitable[Any]]


async def call(ep: Endpoint, dst: Any, req: Request, timeout: Optional[float] = None) -> Any:
    """RPC round trip (reference: rpc.rs:108-132 `call`/`call_with_data`)."""
    rsp, _data = await call_with_data(ep, dst, req, b"", timeout=timeout)
    return rsp


_NATIVE_MAILBOX = None
_NATIVE_RECV_DEADLINE = None
_native_resolved = False


def _resolve_native_rpc():
    """The fused recv-with-deadline pollable (hostcore.RecvDeadline):
    one native poll replaces the timeout()/race/inline-future tower on
    the RPC hot path. Resolved lazily, once."""
    global _NATIVE_MAILBOX, _NATIVE_RECV_DEADLINE, _native_resolved
    _native_resolved = True
    from .. import _native

    if _native.available():
        mod = _native.get_mod()
        _NATIVE_MAILBOX = mod.Mailbox
        _NATIVE_RECV_DEADLINE = mod.RecvDeadline


async def call_with_data(
    ep: Endpoint, dst: Any, req: Request, data: bytes, timeout: Optional[float] = None
) -> Tuple[Any, bytes]:
    if timeout is not None:
        if not _native_resolved:
            _resolve_native_rpc()
        net = ep._net
        nc = getattr(net, "_netcore", None)
        mb = ep._mailbox
        if (
            nc is not None
            and _NATIVE_RECV_DEADLINE is not None
            and type(mb) is _NATIVE_MAILBOX
        ):
            # fully fused native initiation: rsp-tag draw (the same
            # thread_rng().next_u64() the Python path makes), the
            # recv-with-deadline registration (anchored at call start,
            # like timeout() anchors before its first inner poll;
            # register-before-send is equivalent since the response
            # cannot arrive before the request leaves), and the send
            th = net.time
            resolved_dst = parse_addr(dst)
            wait, blocking = nc.rpc_call(
                mb, ep.node_id, ep.local_addr, resolved_dst,
                net.resolve_name(resolved_dst), type(req).type_id(), req,
                data, th.now_ns() + sim_time.to_ns(timeout),
            )
            if blocking is not None:
                _mode, delay_ns, payload = blocking
                await sim_time.sleep_ns(delay_ns)
                net._send_phase2(
                    ep.node_id, ep.local_addr, resolved_dst,
                    net.resolve_name(resolved_dst), type(req).type_id(),
                    payload, "rpc_req",
                )
            if ep._closed:
                # the Python path consumes the same draws and sends the
                # request, then raises at the recv step (recv_from_raw's
                # closed check) — mirror it exactly so the RNG streams
                # stay bit-identical across engines
                wait.drop()
                raise ConnectionReset("endpoint closed")
            msg = await await_(wait)
            if msg is None:
                raise TimeoutError(f"timed out after {timeout}s (virtual)")
            rsp, rsp_data = msg.payload
            return rsp, rsp_data

    rsp_tag = rand.thread_rng().next_u64()

    async def round_trip() -> Tuple[Any, bytes]:
        await ep.send_to_raw(dst, type(req).type_id(), (rsp_tag, req, data), kind="rpc_req")
        payload, _from = await ep.recv_from_raw(rsp_tag)
        rsp, rsp_data = payload
        return rsp, rsp_data

    if timeout is None:
        return await round_trip()
    # call_timeout (reference: rpc.rs:96)
    return await sim_time.timeout(timeout, round_trip())


async def _handle_one(ep: Endpoint, handler: Handler, rsp_tag, req, data, from_addr) -> None:
    result = await handler(req, data)
    if isinstance(result, tuple) and len(result) == 2 and isinstance(result[1], (bytes, bytearray)):
        rsp, rsp_data = result
    else:
        rsp, rsp_data = result, b""
    pend = ep.send_fast(from_addr, rsp_tag, (rsp, bytes(rsp_data)), "rpc_rsp")
    if pend is not None:
        await pend


_RPC_HANDLER_LOC = (__file__, "rpc-handler")  # static spawn-site key


def add_rpc_handler(ep: Endpoint, req_type: Type[Request], handler: Handler) -> JoinHandle:
    """Serve `req_type` on this endpoint: one spawned task per request
    (reference: rpc.rs:143-167)."""
    from .. import _context

    tid = req_type.type_id()

    async def loop_() -> None:
        mb = ep._mailbox
        # the loop's own node/executor are fixed for its lifetime
        ctx = _context.current()
        node = ctx.current_task.node
        ex_spawn = ctx.executor.spawn
        recv = mb.recv
        while True:
            if ep._closed:
                # recv_from_raw's per-call closed check: a closed
                # endpoint stops serving (buffered requests included)
                raise ConnectionReset("endpoint closed")
            msg = await await_(recv(tid))
            rsp_tag, req, data = msg.payload
            # fire-and-forget handler task: low-level spawn skips the
            # JoinHandle + caller-frame walk of the public task.spawn
            ex_spawn(
                _handle_one(ep, handler, rsp_tag, req, data, msg.from_addr),
                node,
                location=_RPC_HANDLER_LOC,
            )

    return spawn(loop_())


# Ergonomic methods on Endpoint (the reference implements these as
# inherent methods on Endpoint in rpc.rs).
async def _ep_call(self: Endpoint, dst, req, timeout=None):
    rsp, _data = await call_with_data(self, dst, req, b"", timeout=timeout)
    return rsp


async def _ep_call_with_data(self: Endpoint, dst, req, data, timeout=None):
    return await call_with_data(self, dst, req, data, timeout=timeout)


async def _ep_call_timeout(self: Endpoint, dst, req, timeout):
    rsp, _data = await call_with_data(self, dst, req, b"", timeout=timeout)
    return rsp


def _ep_add_rpc_handler(self: Endpoint, req_type, handler):
    return add_rpc_handler(self, req_type, handler)


Endpoint.call = _ep_call  # type: ignore[attr-defined]
Endpoint.call_with_data = _ep_call_with_data  # type: ignore[attr-defined]
Endpoint.call_timeout = _ep_call_timeout  # type: ignore[attr-defined]
Endpoint.add_rpc_handler = _ep_add_rpc_handler  # type: ignore[attr-defined]


# -- service decorators (macro parity: #[madsim::service] / #[rpc]) ---------


def rpc(req_type: Type[Request]) -> Callable[[Handler], Handler]:
    """Mark a method as the handler for `req_type`
    (reference: madsim-macros/src/service.rs `#[rpc]`)."""

    def mark(fn: Handler) -> Handler:
        fn.__rpc_request_type__ = req_type  # type: ignore[attr-defined]
        return fn

    return mark


def service(cls: type) -> type:
    """Collect `@rpc` methods and add `serve_on(self, ep)`
    (reference: madsim-macros/src/service.rs `service2`)."""
    handlers: Dict[Type[Request], str] = {}
    for name in dir(cls):
        fn = getattr(cls, name, None)
        req_type = getattr(fn, "__rpc_request_type__", None)
        if req_type is not None:
            handlers[req_type] = name

    def serve_on(self, ep: Endpoint):
        import inspect

        joins = []
        for req_type, name in handlers.items():
            method = getattr(self, name)
            wants_data = len(inspect.signature(method).parameters) >= 2

            async def handler(req, data, method=method, wants_data=wants_data):
                if wants_data:
                    return await method(req, data)
                return await method(req)

            joins.append(add_rpc_handler(ep, req_type, handler))
        return joins

    cls.serve_on = serve_on  # type: ignore[attr-defined]
    cls.__rpc_handlers__ = handlers  # type: ignore[attr-defined]
    return cls
