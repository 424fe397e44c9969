"""Unix domain sockets — FUNCTIONAL node-local IPC.

The reference declares this API with `todo!()` bodies
(madsim/src/sim/net/unix/{stream,datagram}.rs — C12 in SURVEY.md §2);
here it works, like the functional etcd watch and fs power_fail that
also go beyond the reference's stubs.

Semantics: paths are NODE-LOCAL (a Unix socket never crosses machines).
Binding registers the path in the node's namespace; `connect` is a
same-node rendezvous producing a connected byte-stream pair with the
TcpStream read/write surface. Killing a node wipes its namespace (the
tmpfs socket dir dies with the process) and EOFs the open pipes. All
scheduling nondeterminism comes from the executor — there is no wire,
so no latency/loss faults apply (matching real Unix sockets, which the
chaos fabric cannot partition either).
"""

from __future__ import annotations

from collections import deque
from typing import Any, Callable, Deque, Dict, List, Optional, Tuple

from ..future import PENDING, Pollable, Ready, await_
from .network import AddrInUse, ConnectionRefused, ConnectionReset


def _net():
    from ..plugin import simulator
    from . import NetSim

    return simulator(NetSim)


def _node_id() -> int:
    from ..task import current_node_id

    return current_node_id()


def _namespace(net, node_id: int) -> Dict[str, Any]:
    return net.unix_paths.setdefault(node_id, {})


class _QueueWait(Pollable):
    """The one wait shape every unix primitive needs: pop from the
    owner's `queue`, EOF as Ready(None) when `closed`, else park the
    waker (duplicate-registration guarded, like endpoint._PopFuture)."""

    __slots__ = ("owner",)

    def __init__(self, owner):
        self.owner = owner

    def poll(self, waker):
        o = self.owner
        if o.queue:
            return Ready(o.queue.popleft())
        if o.closed:
            return Ready(None)
        if waker not in o.wakers:
            o.wakers.append(waker)
        return PENDING

    def drop(self) -> None:
        pass


class _Waitable:
    """queue + closed + wakers, the _QueueWait contract."""

    def __init__(self) -> None:
        self.queue: Deque[Any] = deque()
        self.closed = False
        self.wakers: List[Callable[[], None]] = []

    def _wake(self) -> None:
        wakers, self.wakers = self.wakers, []
        for w in wakers:
            w()

    def _push(self, item) -> None:
        self.queue.append(item)
        self._wake()

    def close(self) -> None:
        self.closed = True
        self._wake()


class _Pipe(_Waitable):
    """One direction of a stream pair: byte chunks + EOF."""

    def push(self, data: bytes) -> None:
        if self.closed:
            raise ConnectionReset("unix stream closed")
        if data:
            self._push(bytes(data))


class UnixStream:
    """Connected byte stream (TcpStream surface: buffered write/flush,
    read/read_exact, EOF as b"")."""

    def __init__(self, rpipe: _Pipe, wpipe: _Pipe, local_addr: str, peer_addr: str):
        self._rpipe = rpipe
        self._wpipe = wpipe
        self.local_addr = local_addr
        self.peer_addr = peer_addr
        self._wbuf = bytearray()
        self._rbuf = bytearray()
        self._eof = False

    @staticmethod
    async def connect(path: str) -> "UnixStream":
        """Same-node rendezvous with a listener bound at `path`."""
        net = _net()
        node = _node_id()
        listener = _namespace(net, node).get(str(path))
        if not isinstance(listener, UnixListener) or listener.closed:
            raise ConnectionRefused(f"connect {path}: no such unix socket")
        a2b, b2a = _Pipe(), _Pipe()
        # track open pipes for EOF-on-kill; prune finished ones so a
        # long-lived node's connect churn doesn't accumulate
        pipes = net.unix_pipes.setdefault(node, [])
        pipes[:] = [p for p in pipes if not p.closed]
        pipes.extend([a2b, b2a])
        client = UnixStream(b2a, a2b, "", str(path))
        server = UnixStream(a2b, b2a, str(path), "")
        listener._push(server)
        return client

    def write(self, data: bytes) -> int:
        """Buffered until flush (TcpStream parity)."""
        self._wbuf.extend(data)
        return len(data)

    async def flush(self) -> None:
        if self._wbuf:
            payload, self._wbuf = bytes(self._wbuf), bytearray()
            self._wpipe.push(payload)

    async def write_all(self, data: bytes) -> None:
        self.write(data)
        await self.flush()

    async def read(self, n: int = 65536) -> bytes:
        """Up to n bytes; b"" at EOF."""
        while not self._rbuf and not self._eof:
            chunk = await await_(_QueueWait(self._rpipe))
            if chunk is None:
                self._eof = True
                break
            self._rbuf.extend(chunk)
        out = bytes(self._rbuf[:n])
        del self._rbuf[:n]
        return out

    async def read_exact(self, n: int) -> bytes:
        out = bytearray()
        while len(out) < n:
            chunk = await self.read(n - len(out))
            if not chunk:
                raise ConnectionReset("unix stream closed mid-read")
            out.extend(chunk)
        return bytes(out)

    def shutdown(self) -> None:
        self._wpipe.close()


class UnixListener(_Waitable):
    def __init__(self, path: str, net, node_id: int):
        super().__init__()
        self.path = path
        # the BINDING node's namespace — close() must unbind there even
        # when called from another task/node context
        self._net = net
        self._node_id = node_id

    @staticmethod
    async def bind(path: str) -> "UnixListener":
        net = _net()
        node = _node_id()
        ns = _namespace(net, node)
        path = str(path)
        if path in ns:
            raise AddrInUse(f"unix path already bound: {path}")
        listener = UnixListener(path, net, node)
        ns[path] = listener
        return listener

    async def accept(self) -> Tuple[UnixStream, str]:
        stream = await await_(_QueueWait(self))
        if stream is None:
            raise ConnectionReset("unix listener closed")
        return stream, stream.peer_addr

    def close(self) -> None:
        ns = _namespace(self._net, self._node_id)
        if ns.get(self.path) is self:
            del ns[self.path]
        # backlogged, never-accepted connections get reset (real Unix
        # resets the backlog on listener close) — without this the
        # connected client would block forever
        for stream in self.queue:
            stream._rpipe.close()
            stream._wpipe.close()
        self.queue.clear()
        super().close()


class UnixDatagram(_Waitable):
    def __init__(self, path: Optional[str], net=None, node_id: Optional[int] = None):
        super().__init__()
        self.path = path
        self._peer: Optional[str] = None
        self._net = net
        self._node_id = node_id

    @staticmethod
    async def bind(path: str) -> "UnixDatagram":
        net = _net()
        node = _node_id()
        ns = _namespace(net, node)
        path = str(path)
        if path in ns:
            raise AddrInUse(f"unix path already bound: {path}")
        sock = UnixDatagram(path, net, node)
        ns[path] = sock
        return sock

    @staticmethod
    async def unbound() -> "UnixDatagram":
        """Send-only socket (real API: UnixDatagram::unbound)."""
        return UnixDatagram(None)

    def connect(self, path: str) -> None:
        self._peer = str(path)

    async def send(self, data: bytes) -> int:
        if self._peer is None:
            raise ConnectionRefused("unix datagram not connected")
        return await self.send_to(self._peer, data)

    async def send_to(self, path: str, data: bytes) -> int:
        ns = _namespace(_net(), _node_id())
        dst = ns.get(str(path))
        if not isinstance(dst, UnixDatagram) or dst.closed:
            raise ConnectionRefused(f"send_to {path}: no such unix socket")
        dst._push((bytes(data), self.path or ""))
        return len(data)

    async def recv_from(self) -> Tuple[bytes, str]:
        item = await await_(_QueueWait(self))
        if item is None:
            raise ConnectionReset("unix datagram closed")
        return item

    async def recv(self) -> bytes:
        data, _from = await self.recv_from()
        return data

    def close(self) -> None:
        if self.path is not None and self._net is not None:
            ns = _namespace(self._net, self._node_id)
            if ns.get(self.path) is self:
                del ns[self.path]
        super().close()
