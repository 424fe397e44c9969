"""Endpoint — the tag-matched message socket
(reference: madsim/src/sim/net/endpoint.rs).

A UDP-like bound socket whose mailbox matches messages by u64 tag:
waiting receivers register per-tag cells, unmatched messages buffer
(reference :298-352). `send_to_raw` moves ANY Python object between sim
nodes zero-copy (the reference moves `Box<dyn Any>`); `send_to` restricts
to bytes for datagram realism. `connect1`/`accept1` create a pair of
reliable ordered payload channels for connection-oriented protocols
(reference :178-215).
"""

from __future__ import annotations

from collections import deque
from typing import Any, Callable, Deque, Dict, List, NamedTuple, Optional, Tuple

from .. import _context
from .. import time as sim_time
from ..errors import SimError
from ..future import PENDING, OneShotCell, Pollable, Ready, await_
from .network import (
    Addr,
    ConnectionRefused,
    ConnectionReset,
    NetError,
    format_addr,
    parse_addr,
)


class Message(NamedTuple):
    # a NamedTuple, not a __slots__ class: messages are minted on the
    # datagram hot path (incl. by the native NetCore) and tuple.__new__
    # skips the Python __init__ frame entirely
    tag: int
    payload: Any
    from_addr: Addr


class Mailbox:
    """Tag-matched mailbox (reference: endpoint.rs:298-352)."""

    def __init__(self) -> None:
        self.registered: List[Tuple[int, OneShotCell]] = []
        self.msgs: List[Message] = []

    def deliver(self, msg: Message) -> None:
        for i, (tag, cell) in enumerate(self.registered):
            if tag == msg.tag and not cell.is_set():
                del self.registered[i]
                cell.set(msg)
                return
        self.msgs.append(msg)

    def recv_cell(self, tag: int) -> OneShotCell:
        cell = OneShotCell()
        for i, msg in enumerate(self.msgs):
            if msg.tag == tag:
                del self.msgs[i]
                cell.set(msg)
                return cell
        self.registered.append((tag, cell))
        return cell

    def deregister(self, cell: OneShotCell) -> None:
        self.registered = [(t, c) for (t, c) in self.registered if c is not cell]

    def recv(self, tag: int) -> "_MailboxRecv":
        """Pollable for the next `tag` message (same surface as the
        native hostcore.Mailbox.recv)."""
        return _MailboxRecv(self, tag)


def _new_mailbox():
    """Native tag-matched mailbox when the toolchain built hostcore
    (one C object replaces the recv_cell/OneShotCell/_MailboxRecv stack
    on the RPC hot path); Python twin otherwise — same deliver/recv
    semantics, asserted by tests/test_torch_native.py."""
    from .. import _native

    mod = _native.get_mod()
    return mod.Mailbox() if mod is not None else Mailbox()


class _MailboxRecv(Pollable):
    """Awaits a tag-matched message; deregisters on cancellation so an
    aborted receiver (e.g. a timed-out RPC call) cannot swallow a later
    message for the same tag."""

    __slots__ = ("mailbox", "cell", "returned")

    def __init__(self, mailbox: Mailbox, tag: int):
        self.mailbox = mailbox
        self.cell = mailbox.recv_cell(tag)
        self.returned = False

    def poll(self, waker: Callable[[], None]):
        r = self.cell.poll(waker)
        if r is not PENDING:
            self.returned = True
        return r

    def drop(self) -> None:
        if not self.returned:
            self.mailbox.deregister(self.cell)


class PayloadChannel:
    """One direction of a connect1 stream — reliable & ordered, but the
    receiver re-tests the link per message and backs off while partitioned
    (reference: sim/net/mod.rs:337-414)."""

    def __init__(self, net: "NetSimRef", src_node: int, dst_node: int):
        self.net = net
        self.src_node = src_node
        self.dst_node = dst_node
        self.buf: Deque[Any] = deque()
        self.closed = False  # sender closed (EOF)
        self.reset = False  # connection broken (node killed)
        self.wakers: List[Callable[[], None]] = []

    def _wake(self) -> None:
        wakers, self.wakers = self.wakers, []
        for w in wakers:
            w()

    def send(self, payload: Any) -> None:
        if self.reset:
            raise ConnectionReset("connection reset by peer")
        if self.closed:
            raise ConnectionReset("send on closed channel")
        self.buf.append(payload)
        self._wake()

    def close(self) -> None:
        self.closed = True
        self._wake()

    def do_reset(self) -> None:
        self.reset = True
        self.buf.clear()
        self._wake()


class _PopFuture(Pollable):
    __slots__ = ("chan",)

    def __init__(self, chan: PayloadChannel):
        self.chan = chan

    def poll(self, waker: Callable[[], None]):
        ch = self.chan
        if ch.reset:
            raise ConnectionReset("connection reset by peer")
        if ch.buf:
            return Ready(ch.buf.popleft())
        if ch.closed:
            return Ready(None)  # EOF
        if waker not in ch.wakers:
            ch.wakers.append(waker)
        return PENDING


class PayloadSender:
    """Reference: sim/net/mod.rs `PayloadSender`."""

    def __init__(self, chan: PayloadChannel, peer_addr: Addr):
        self._chan = chan
        self.peer_addr = peer_addr

    def send(self, payload: Any) -> None:
        self._chan.send(payload)

    def close(self) -> None:
        self._chan.close()

    def is_closed(self) -> bool:
        return self._chan.closed or self._chan.reset


class PayloadReceiver:
    """Reference: sim/net/mod.rs `PayloadReceiver`."""

    def __init__(self, chan: PayloadChannel, peer_addr: Addr):
        self._chan = chan
        self.peer_addr = peer_addr

    async def recv(self) -> Optional[Any]:
        """Next payload, or None on EOF. Backs off while the link is
        partitioned; applies per-message latency (reference :337-414)."""
        payload = await await_(_PopFuture(self._chan))
        if payload is None:
            return None
        net = self._chan.net
        # Back off while clogged: the message is "in flight" until the
        # partition heals (reference: backoff loop at mod.rs:390-400).
        while net.network.is_clogged(self._chan.src_node, self._chan.dst_node):
            await sim_time.sleep_ns(net.rng.gen_range(10_000_000, 100_000_000))
        _, latency = net.network.test_link(
            self._chan.src_node, self._chan.dst_node, reliable=True
        )
        await sim_time.sleep_ns(latency)
        return payload


class NetSimRef:
    """Typed alias for NetSim to avoid a circular import at runtime."""


class EndpointSocket:
    """The object registered in the Network socket table."""

    def __init__(self, endpoint: "Endpoint"):
        self.endpoint = endpoint

    def deliver(self, msg: Message) -> None:
        """Reference: endpoint.rs:310-322 `EndpointSocket::deliver`."""
        self.endpoint._mailbox.deliver(msg)

    def new_connection(self, conn: "IncomingConn") -> None:
        ep = self.endpoint
        ep._accept_queue.append(conn)
        if ep._accept_wakers:
            wakers, ep._accept_wakers = ep._accept_wakers, []
            for w in wakers:
                w()

    def on_reset(self) -> None:
        self.endpoint._on_reset()


class IncomingConn:
    __slots__ = ("tx", "rx", "peer_addr")

    def __init__(self, tx: PayloadSender, rx: PayloadReceiver, peer_addr: Addr):
        self.tx = tx
        self.rx = rx
        self.peer_addr = peer_addr


class _AcceptFuture(Pollable):
    __slots__ = ("ep",)

    def __init__(self, ep: "Endpoint"):
        self.ep = ep

    def poll(self, waker: Callable[[], None]):
        if self.ep._closed:
            raise ConnectionReset("endpoint closed")
        if self.ep._accept_queue:
            return Ready(self.ep._accept_queue.popleft())
        if waker not in self.ep._accept_wakers:
            self.ep._accept_wakers.append(waker)
        return PENDING


class Endpoint:
    """Reference: endpoint.rs:13 `Endpoint`."""

    def __init__(self, net, node_id: int, local_addr: Addr):
        self._net = net
        self.node_id = node_id
        self.local_addr = local_addr
        self.peer: Optional[Addr] = None
        self._mailbox = _new_mailbox()
        self._accept_queue: Deque[IncomingConn] = deque()
        self._accept_wakers: List[Callable[[], None]] = []
        self._closed = False
        self._socket = EndpointSocket(self)

    # -- construction -------------------------------------------------------

    @staticmethod
    async def bind(addr: Any) -> "Endpoint":
        """Bind on the current node (reference: endpoint.rs:23)."""
        from . import NetSim
        from ..plugin import simulator
        from ..task import current_node_id

        net = simulator(NetSim)
        node_id = current_node_id()
        parsed = parse_addr(addr)
        ep = Endpoint(net, node_id, parsed)
        bound = net.network.bind(node_id, parsed, ep._socket)
        ep.local_addr = bound
        net.register_endpoint(node_id, ep)
        return ep

    @staticmethod
    async def connect(addr: Any) -> "Endpoint":
        """Bind an ephemeral port and set default peer
        (reference: endpoint.rs:38)."""
        ep = await Endpoint.bind(("0.0.0.0", 0))
        ep.peer = parse_addr(addr)
        return ep

    async def send(self, tag: int, data: bytes) -> None:
        """Send to the default peer set by `connect`."""
        if self.peer is None:
            raise NetError("endpoint has no default peer; use connect()")
        await self.send_to(self.peer, tag, data)

    async def recv(self, tag: int) -> Any:
        """Receive from any sender on `tag` (peer-filtered recv is not in
        the reference either; the tag IS the conversation)."""
        payload, _ = await self.recv_from(tag)
        return payload

    def close(self) -> None:
        if not self._closed:
            self._closed = True
            self._net.network.unbind(self.node_id, self.local_addr[1])
            self._net.unregister_endpoint(self.node_id, self)

    def _on_reset(self) -> None:
        self._closed = True

    # -- datagram API -------------------------------------------------------

    async def send_to(self, dst: Any, tag: int, data: bytes) -> None:
        """Reference: endpoint.rs:66 `send_to`."""
        await self.send_to_raw(dst, tag, bytes(data))

    async def recv_from(self, tag: int) -> Tuple[Any, Addr]:
        """Reference: endpoint.rs:85 `recv_from`."""
        payload, addr = await self.recv_from_raw(tag)
        return payload, addr

    async def send_to_raw(self, dst: Any, tag: int, payload: Any, kind: Optional[str] = None) -> None:
        """Move any object to the destination mailbox
        (reference: endpoint.rs:118-133 + NetSim::send mod.rs:298-334).
        `kind` ("rpc_req"/"rpc_rsp") routes RPC drop hooks."""
        pend = self.send_fast(dst, tag, payload, kind)
        if pend is not None:
            await pend

    def send_fast(self, dst: Any, tag: int, payload: Any, kind: Optional[str] = None):
        """Non-async send: None when fully scheduled, else a coroutine to
        await (see NetSim.send_fast) — the RPC hot path uses this to skip
        two coroutine frames per datagram."""
        return self._net.send_fast(
            self.node_id, self.local_addr, parse_addr(dst), tag, payload, kind
        )

    async def recv_from_raw(self, tag: int) -> Tuple[Any, Addr]:
        """Reference: endpoint.rs:135-147."""
        if self._closed:
            raise ConnectionReset("endpoint closed")
        msg: Message = await await_(self._mailbox.recv(tag))
        return msg.payload, msg.from_addr

    # -- connection API -----------------------------------------------------

    async def connect1(self, dst: Any) -> Tuple[PayloadSender, PayloadReceiver]:
        """Open a reliable bidirectional stream to a listening endpoint
        (reference: endpoint.rs:178 + mod.rs:337-388)."""
        return await self._net.connect1(self, parse_addr(dst))

    async def accept1(self) -> Tuple[PayloadSender, PayloadReceiver, Addr]:
        """Accept one incoming stream (reference: endpoint.rs:197)."""
        conn: IncomingConn = await await_(_AcceptFuture(self))
        return conn.tx, conn.rx, conn.peer_addr
