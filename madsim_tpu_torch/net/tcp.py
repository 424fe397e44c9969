"""Simulated TCP (reference: madsim/src/sim/net/tcp/).

`TcpListener`/`TcpStream` over a connect1 payload channel: writes are
buffered until flush (reference: stream.rs:137-187), EOF on channel
close, partition => connect refused / reads stall until unclogged
(reference: tcp/mod.rs tests :58-308)."""

from __future__ import annotations

from typing import Any, Optional, Tuple

from .endpoint import Endpoint, PayloadReceiver, PayloadSender
from .network import Addr, ConnectionReset


class TcpStream:
    """Reference: tcp/stream.rs `TcpStream`."""

    def __init__(self, tx: PayloadSender, rx: PayloadReceiver, local_addr: Addr, peer_addr: Addr):
        self._tx = tx
        self._rx = rx
        self.local_addr = local_addr
        self.peer_addr = peer_addr
        self._wbuf = bytearray()
        self._rbuf = bytearray()
        self._eof = False

    @staticmethod
    async def connect(addr: Any) -> "TcpStream":
        """Reference: tcp/stream.rs:47-90."""
        ep = await Endpoint.bind(("0.0.0.0", 0))
        tx, rx = await ep.connect1(addr)
        from .network import parse_addr

        return TcpStream(tx, rx, ep.local_addr, parse_addr(addr))

    def write(self, data: bytes) -> int:
        """Buffered until flush (reference: stream.rs poll_write)."""
        self._wbuf.extend(data)
        return len(data)

    async def flush(self) -> None:
        if self._wbuf:
            payload, self._wbuf = bytes(self._wbuf), bytearray()
            self._tx.send(payload)

    async def write_all(self, data: bytes) -> None:
        self.write(data)
        await self.flush()

    async def read(self, n: int = 65536) -> bytes:
        """Up to n bytes; b"" at EOF (reference: stream.rs poll_read)."""
        while not self._rbuf and not self._eof:
            chunk = await self._rx.recv()
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
                raise ConnectionReset("early EOF in read_exact")
            out.extend(chunk)
        return bytes(out)

    def shutdown(self) -> None:
        self._tx.close()


class TcpListener:
    """Reference: tcp/listener.rs `TcpListener`."""

    def __init__(self, ep: Endpoint):
        self._ep = ep

    @staticmethod
    async def bind(addr: Any) -> "TcpListener":
        """Reference: tcp/listener.rs:34-50."""
        return TcpListener(await Endpoint.bind(addr))

    @property
    def local_addr(self) -> Addr:
        return self._ep.local_addr

    async def accept(self) -> Tuple[TcpStream, Addr]:
        """Reference: tcp/listener.rs:52-70."""
        tx, rx, peer = await self._ep.accept1()
        return TcpStream(tx, rx, self._ep.local_addr, peer), peer

    def close(self) -> None:
        self._ep.close()
