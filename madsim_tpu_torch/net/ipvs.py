"""IP Virtual Server — in-sim L4 load balancing
(reference: madsim/src/sim/net/ipvs.rs).

A virtual service address maps to a set of real servers; every send /
connect consults the table and rewrites the destination (reference:
ipvs.rs:48-110 + mod.rs:304-309,:344-348). Scheduler: round-robin.
"""

from __future__ import annotations

from typing import Dict, List, Optional

from .network import Addr, format_addr, parse_addr


class Scheduler:
    RoundRobin = "rr"


class ServiceAddr:
    """A virtual TCP/UDP service address (reference: ipvs.rs `ServiceAddr`)."""

    def __init__(self, proto: str, addr: str):
        self.proto = proto
        self.addr = addr  # "ip:port" string

    @staticmethod
    def tcp(addr: str) -> "ServiceAddr":
        return ServiceAddr("tcp", addr)

    @staticmethod
    def udp(addr: str) -> "ServiceAddr":
        return ServiceAddr("udp", addr)

    def key(self) -> str:
        return f"{self.proto}://{self.addr}"


class IpVirtualServer:
    """Reference: ipvs.rs:48-110 `IpVirtualServer`."""

    def __init__(self) -> None:
        self._services: Dict[str, List[str]] = {}
        self._rr_next: Dict[str, int] = {}

    def add_service(self, svc: ServiceAddr, scheduler: str = Scheduler.RoundRobin) -> None:
        self._services.setdefault(svc.key(), [])
        self._rr_next.setdefault(svc.key(), 0)

    def del_service(self, svc: ServiceAddr) -> None:
        self._services.pop(svc.key(), None)
        self._rr_next.pop(svc.key(), None)

    def add_server(self, svc: ServiceAddr, server: str) -> None:
        self._services.setdefault(svc.key(), []).append(server)

    def del_server(self, svc: ServiceAddr, server: str) -> None:
        servers = self._services.get(svc.key())
        if servers and server in servers:
            servers.remove(server)

    def rewrite(self, proto: str, dst: Addr) -> Optional[Addr]:
        """Rewrite a virtual dst to the next real server (round-robin);
        returns None when dst is not a virtual service."""
        key = f"{proto}://{format_addr(dst)}"
        servers = self._services.get(key)
        if servers is None:
            return None
        if not servers:
            return ("0.0.0.0", 0)  # service exists but no backend: black-hole
        idx = self._rr_next.get(key, 0) % len(servers)
        self._rr_next[key] = idx + 1
        return parse_addr(servers[idx])
