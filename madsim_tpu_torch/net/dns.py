"""In-simulation DNS (reference: madsim/src/sim/net/dns.rs + addr.rs).

A per-simulation record table with `localhost` preloaded; `lookup_host`
is the DNS-aware resolver used by connect paths (reference:
addr.rs:225-247 vendored tokio `ToSocketAddrs`).
"""

from __future__ import annotations

from typing import Dict, List, Optional


class DnsServer:
    """Reference: dns.rs:6-27 `DnsServer`."""

    def __init__(self) -> None:
        self._records: Dict[str, str] = {"localhost": "127.0.0.1"}

    def add_record(self, name: str, ip: str) -> None:
        self._records[name] = ip

    def remove_record(self, name: str) -> None:
        self._records.pop(name, None)

    def lookup(self, name: str) -> Optional[str]:
        return self._records.get(name)


def _is_ip(host: str) -> bool:
    parts = host.split(".")
    return len(parts) == 4 and all(p.isdigit() for p in parts)


async def lookup_host(host: str) -> List[str]:
    """Resolve a hostname inside the simulation (reference: addr.rs:33-36).

    Accepts "name" or "name:port"; returns IPs (or "ip:port" strings when
    a port was given).
    """
    from . import NetSim
    from ..plugin import simulator

    name, sep, port = host.rpartition(":")
    if not sep:
        name, port = host, ""
    if _is_ip(name or host):
        return [host]
    net = simulator(NetSim)
    ip = net.dns.lookup(name or host)
    if ip is None:
        raise OSError(f"failed to lookup address information: {host}")
    return [f"{ip}:{port}" if port else ip]
