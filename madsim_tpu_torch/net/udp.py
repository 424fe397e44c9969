"""Simulated UDP socket — thin wrapper over Endpoint tag 0
(reference: madsim/src/sim/net/udp.rs:9-73)."""

from __future__ import annotations

from typing import Any, Optional, Tuple

from .endpoint import Endpoint
from .network import Addr, NetError, parse_addr

TAG_UDP = 0


class UdpSocket:
    def __init__(self, ep: Endpoint):
        self._ep = ep
        self._peer: Optional[Addr] = None

    @staticmethod
    async def bind(addr: Any) -> "UdpSocket":
        return UdpSocket(await Endpoint.bind(addr))

    @property
    def local_addr(self) -> Addr:
        return self._ep.local_addr

    async def send_to(self, data: bytes, dst: Any) -> int:
        await self._ep.send_to(dst, TAG_UDP, data)
        return len(data)

    async def recv_from(self) -> Tuple[bytes, Addr]:
        return await self._ep.recv_from(TAG_UDP)

    def connect(self, dst: Any) -> None:
        self._peer = parse_addr(dst)

    async def send(self, data: bytes) -> int:
        if self._peer is None:
            raise NetError("UdpSocket not connected")
        return await self.send_to(data, self._peer)

    async def recv(self) -> bytes:
        data, _ = await self.recv_from()
        return data

    def close(self) -> None:
        self._ep.close()
