"""Real-network Endpoint: the sim tag API over asyncio TCP.

Wire format (reference: std/net/tcp.rs length-delimited frames):
  frame := u32 length | u64 tag | payload bytes (pickle for raw objects)
One TCP connection per peer pair, created lazily by the sender and kept
open; the receiver side runs one reader task per connection
(reference: std/net/tcp.rs:42-100 per-peer connection tasks).
RPC uses the same (rsp_tag, request, data) scheme as the sim layer, with
pickle standing in for bincode (reference: std/net/rpc.rs:100-140).
"""

from __future__ import annotations

import asyncio
import os
import pickle
import struct
from collections import defaultdict
from typing import Any, Awaitable, Callable, Dict, List, Optional, Tuple, Type

from ..net.network import parse_addr
from ..net.rpc import Request

Addr = Tuple[str, int]

_HDR = struct.Struct("<IQ")  # length (excl. header), tag

# hello-frame tags: the first frame of every connection announces the
# peer's bound address and the connection kind
_HELLO_DGRAM = 0   # tag-matched datagram/RPC traffic (multiplexed)
_HELLO_STREAM = 1  # one connect1 stream (dedicated connection)


class _Mailbox:
    """Tag-matched mailbox over asyncio futures (same semantics as the
    sim mailbox, reference: sim/net/endpoint.rs:298-352)."""

    def __init__(self) -> None:
        self._waiting: List[Tuple[int, asyncio.Future]] = []
        self._msgs: List[Tuple[int, Any, Addr]] = []

    def deliver(self, tag: int, payload: Any, frm: Addr) -> None:
        # prune waiters cancelled by call timeouts so delivery stays O(live)
        self._waiting = [(t, f) for (t, f) in self._waiting if not f.done()]
        for i, (t, fut) in enumerate(self._waiting):
            if t == tag:
                del self._waiting[i]
                fut.set_result((payload, frm))
                return
        self._msgs.append((tag, payload, frm))

    async def recv(self, tag: int) -> Tuple[Any, Addr]:
        for i, (t, payload, frm) in enumerate(self._msgs):
            if t == tag:
                del self._msgs[i]
                return payload, frm
        fut: asyncio.Future = asyncio.get_running_loop().create_future()
        self._waiting.append((tag, fut))
        return await fut


class PayloadSender:
    """Sync-send side of a connect1 stream (same surface as the sim
    net.endpoint.PayloadSender: `send` buffers without awaiting)."""

    def __init__(self, writer: asyncio.StreamWriter, peer_addr: Addr):
        self._writer = writer
        self.peer_addr = peer_addr
        self._closed = False

    def send(self, payload: Any) -> None:
        from ..net.network import ConnectionReset

        if self._closed or self._writer.is_closing():
            raise ConnectionReset("send on closed channel")
        body = pickle.dumps(payload)
        self._writer.write(_HDR.pack(len(body), 0) + body)

    def close(self) -> None:
        if not self._closed:
            self._closed = True
            self._writer.close()

    def is_closed(self) -> bool:
        return self._closed or self._writer.is_closing()


class PayloadReceiver:
    """Async-recv side of a connect1 stream; EOF -> None (sim parity)."""

    def __init__(self, reader: asyncio.StreamReader, peer_addr: Addr):
        self._reader = reader
        self.peer_addr = peer_addr

    async def recv(self) -> Any:
        from ..net.network import ConnectionReset

        try:
            hdr = await self._reader.readexactly(_HDR.size)
        except asyncio.IncompleteReadError as exc:
            if not exc.partial:
                return None  # clean EOF == channel closed (sim parity)
            raise ConnectionReset("connection reset mid-frame") from exc
        except ConnectionResetError as exc:
            # sim parity: a broken connection raises, only a clean close
            # returns None
            raise ConnectionReset("connection reset by peer") from exc
        length, _tag = _HDR.unpack(hdr)
        try:
            return pickle.loads(await self._reader.readexactly(length))
        except (asyncio.IncompleteReadError, ConnectionResetError) as exc:
            raise ConnectionReset("connection reset mid-frame") from exc


class Endpoint:
    """Real-mode Endpoint with the sim Endpoint's surface."""

    def __init__(self) -> None:
        self.local_addr: Addr = ("0.0.0.0", 0)
        self._server: Optional[asyncio.AbstractServer] = None
        self._mailbox = _Mailbox()
        self._peers: Dict[Addr, asyncio.StreamWriter] = {}
        self._conn_locks: Dict[Addr, asyncio.Lock] = defaultdict(asyncio.Lock)
        self._reader_tasks: set = set()  # pruned on completion
        self._handler_tasks: set = set()
        self._accept_queue: asyncio.Queue = asyncio.Queue()

    # -- lifecycle ----------------------------------------------------------

    @staticmethod
    async def bind(addr: Any) -> "Endpoint":
        ep = Endpoint()
        host, port = parse_addr(addr)
        server = await asyncio.start_server(ep._on_connection, host or "0.0.0.0", port)
        ep._server = server
        sock = server.sockets[0]
        ep.local_addr = sock.getsockname()[:2]
        return ep

    def close(self) -> None:
        """Synchronous, like the sim Endpoint.close() — the dual-build
        contract requires one spelling for both modes. Use `wait_closed`
        to await full teardown."""
        for t in self._reader_tasks:
            t.cancel()
        for t in self._handler_tasks:
            t.cancel()
        for w in self._peers.values():
            w.close()
        self._peers.clear()
        if self._server is not None:
            self._server.close()

    async def wait_closed(self) -> None:
        # Handlers are cancelled in close() BEFORE waiting: since 3.12,
        # Server.wait_closed waits for all handler tasks, and ours block
        # reading until peer EOF.
        if self._server is not None:
            await self._server.wait_closed()

    # -- framing ------------------------------------------------------------

    async def _on_connection(self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter) -> None:
        task = asyncio.current_task()
        if task is not None:
            self._reader_tasks.add(task)
            task.add_done_callback(self._reader_tasks.discard)
        keep_open = False
        try:
            # peer announces its *bound* address + connection kind first
            # (so replies route to the listener, not the ephemeral port)
            hdr = await reader.readexactly(_HDR.size)
            length, hello_tag = _HDR.unpack(hdr)
            frm: Addr = tuple(pickle.loads(await reader.readexactly(length)))  # type: ignore[assignment]
            if hello_tag == _HELLO_STREAM:
                # a connect1 stream: hand the connection to accept1()
                tx = PayloadSender(writer, frm)
                rx = PayloadReceiver(reader, frm)
                self._accept_queue.put_nowait((tx, rx, frm))
                keep_open = True
                return
            while True:
                hdr = await reader.readexactly(_HDR.size)
                length, tag = _HDR.unpack(hdr)
                payload = pickle.loads(await reader.readexactly(length))
                self._mailbox.deliver(tag, payload, frm)
        except (asyncio.IncompleteReadError, ConnectionResetError, asyncio.CancelledError):
            pass
        finally:
            if not keep_open:
                writer.close()

    async def _conn_to(self, dst: Addr) -> asyncio.StreamWriter:
        writer = self._peers.get(dst)
        if writer is not None and not writer.is_closing():
            return writer
        async with self._conn_locks[dst]:  # one connection per peer pair
            writer = self._peers.get(dst)
            if writer is not None and not writer.is_closing():
                return writer
            _reader, writer = await asyncio.open_connection(dst[0], dst[1])
            hello = pickle.dumps(self.local_addr)
            writer.write(_HDR.pack(len(hello), 0) + hello)
            await writer.drain()
            self._peers[dst] = writer
            return writer

    # -- datagram API -------------------------------------------------------

    async def send_to(self, dst: Any, tag: int, data: bytes) -> None:
        await self.send_to_raw(dst, tag, bytes(data))

    async def send_to_raw(self, dst: Any, tag: int, payload: Any, kind: Optional[str] = None) -> None:
        writer = await self._conn_to(parse_addr(dst))
        body = pickle.dumps(payload)
        writer.write(_HDR.pack(len(body), tag) + body)
        await writer.drain()

    async def recv_from(self, tag: int) -> Tuple[Any, Addr]:
        return await self._mailbox.recv(tag)

    recv_from_raw = recv_from

    # -- connection API (sim parity: endpoint.rs connect1/accept1) -----------

    async def connect1(self, dst: Any) -> Tuple[PayloadSender, PayloadReceiver]:
        """Open a reliable bidirectional stream: one dedicated TCP
        connection, length-delimited pickled payloads."""
        d = parse_addr(dst)
        reader, writer = await asyncio.open_connection(d[0], d[1])
        hello = pickle.dumps(self.local_addr)
        writer.write(_HDR.pack(len(hello), _HELLO_STREAM) + hello)
        await writer.drain()
        return PayloadSender(writer, d), PayloadReceiver(reader, d)

    async def accept1(self) -> Tuple[PayloadSender, PayloadReceiver, Addr]:
        """Accept one incoming connect1 stream."""
        return await self._accept_queue.get()

    # -- RPC (reference: std/net/rpc.rs) -------------------------------------

    async def call(self, dst: Any, req: Request, timeout: Optional[float] = None) -> Any:
        rsp, _ = await self.call_with_data(dst, req, b"", timeout=timeout)
        return rsp

    async def call_timeout(self, dst: Any, req: Request, timeout: float) -> Any:
        return await self.call(dst, req, timeout=timeout)

    async def call_with_data(
        self, dst: Any, req: Request, data: bytes, timeout: Optional[float] = None
    ) -> Tuple[Any, bytes]:
        # madsim: allow(D002) — real-socket mode: tag collisions are
        # the only stake, OS entropy is fine (and sim mode never runs this)
        rsp_tag = int.from_bytes(os.urandom(8), "little")

        async def round_trip() -> Tuple[Any, bytes]:
            await self.send_to_raw(dst, type(req).type_id(), (rsp_tag, req, data))
            payload, _frm = await self.recv_from(rsp_tag)
            return payload

        if timeout is None:
            return await round_trip()
        return await asyncio.wait_for(round_trip(), timeout)

    def add_rpc_handler(
        self, req_type: Type[Request], handler: Callable[..., Awaitable[Any]]
    ) -> asyncio.Task:
        async def loop_() -> None:
            while True:
                (rsp_tag, req, data), frm = await self.recv_from(req_type.type_id())

                async def handle_one(rsp_tag=rsp_tag, req=req, data=data, frm=frm) -> None:
                    result = await handler(req, data)
                    if (
                        isinstance(result, tuple)
                        and len(result) == 2
                        and isinstance(result[1], (bytes, bytearray))
                    ):
                        rsp, rsp_data = result
                    else:
                        rsp, rsp_data = result, b""
                    await self.send_to_raw(frm, rsp_tag, (rsp, bytes(rsp_data)))

                # keep strong refs: the loop holds tasks only weakly
                task = asyncio.ensure_future(handle_one())
                self._handler_tasks.add(task)
                task.add_done_callback(self._handler_tasks.discard)

        task = asyncio.ensure_future(loop_())
        self._handler_tasks.add(task)
        task.add_done_callback(self._handler_tasks.discard)
        return task
