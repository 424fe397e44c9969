"""Network core — the message fabric state (reference: madsim/src/sim/net/network.rs).

Per-node IP + socket table, directional link state (clog node in/out,
clog link src->dst), per-message link test = clog check + Bernoulli
packet loss + uniform latency sample (reference :261-270), destination
resolution incl. 0.0.0.0 wildcard and loopback (:296-325), ephemeral
port allocation (:196-244), message stats (:101).

All latency arithmetic is integer nanoseconds drawn from the global RNG,
so the fabric is replayable on the TPU engine lane-for-lane.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Set, Tuple

from ..config import NetConfig
from ..errors import SimError

Addr = Tuple[str, int]  # (ip, port)


class NetError(SimError):
    pass


class AddrInUse(NetError):
    pass


class ConnectionRefused(NetError):
    pass


class ConnectionReset(NetError):
    pass


_ADDR_MEMO: dict = {}


def parse_addr(addr: Any) -> Addr:
    """Accept "ip:port", (ip, port), or bare port int."""
    if isinstance(addr, tuple):
        return (str(addr[0]), int(addr[1]))
    if isinstance(addr, int):
        return ("0.0.0.0", addr)
    if isinstance(addr, str):
        # per-string memo: address strings are a small finite set per
        # sim, and this sits on the datagram hot path
        got = _ADDR_MEMO.get(addr)
        if got is None:
            host, _, port = addr.rpartition(":")
            got = (host or "0.0.0.0", int(port))
            if len(_ADDR_MEMO) > 4096:
                _ADDR_MEMO.clear()
            _ADDR_MEMO[addr] = got
        return got
    raise ValueError(f"cannot parse address: {addr!r}")


def format_addr(addr: Addr) -> str:
    return f"{addr[0]}:{addr[1]}"


# Link-test outcomes
PASS = "pass"
CLOGGED = "clogged"
DROPPED = "dropped"


class Direction:
    """Reference: network.rs:108 `Direction`."""

    In = "in"
    Out = "out"
    Both = "both"


class Stat:
    """Reference: network.rs:98-102."""

    def __init__(self) -> None:
        self.msg_count = 0


class Network:
    """Fabric state shared by all sockets of one simulation
    (reference: network.rs:20 `Network`)."""

    def __init__(self, rng, time, config: NetConfig):
        self.rng = rng
        self.time = time
        self.config = config
        self.stat = Stat()
        self.node_ip: Dict[int, str] = {}
        self.ip_node: Dict[str, int] = {}
        # sockets[node_id][port] -> socket object (has .deliver(msg))
        self.sockets: Dict[int, Dict[int, Any]] = {}
        self.clogged_in: Set[int] = set()
        self.clogged_out: Set[int] = set()
        self.clogged_links: Set[Tuple[int, int]] = set()

    # -- topology -----------------------------------------------------------

    def create_node(self, node_id: int) -> None:
        self.sockets.setdefault(node_id, {})
        if node_id not in self.node_ip:
            # Auto-assign a unique IP; NodeBuilder.ip() overrides.
            self.set_node_ip(node_id, f"10.0.0.{node_id}")

    def set_node_ip(self, node_id: int, ip: str) -> None:
        old = self.node_ip.get(node_id)
        if old is not None:
            self.ip_node.pop(old, None)
        if ip in self.ip_node and self.ip_node[ip] != node_id:
            raise NetError(f"IP {ip} already assigned to node {self.ip_node[ip]}")
        self.node_ip[node_id] = ip
        self.ip_node[ip] = node_id

    def reset_node(self, node_id: int) -> None:
        """Close all sockets on node kill/restart (reference: network.rs:142-148)."""
        socks = self.sockets.get(node_id, {})
        for sock in list(socks.values()):
            close = getattr(sock, "on_reset", None)
            if close is not None:
                close()
        socks.clear()

    # -- partitions / chaos (reference: clog_* APIs) ------------------------

    def clog_node(self, node_id: int, direction: str = Direction.Both) -> None:
        if direction in (Direction.In, Direction.Both):
            self.clogged_in.add(node_id)
        if direction in (Direction.Out, Direction.Both):
            self.clogged_out.add(node_id)

    def unclog_node(self, node_id: int, direction: str = Direction.Both) -> None:
        if direction in (Direction.In, Direction.Both):
            self.clogged_in.discard(node_id)
        if direction in (Direction.Out, Direction.Both):
            self.clogged_out.discard(node_id)

    def clog_link(self, src: int, dst: int) -> None:
        self.clogged_links.add((src, dst))

    def unclog_link(self, src: int, dst: int) -> None:
        self.clogged_links.discard((src, dst))

    def is_clogged(self, src: int, dst: int) -> bool:
        return (
            src in self.clogged_out
            or dst in self.clogged_in
            or (src, dst) in self.clogged_links
        )

    def test_link(self, src: int, dst: int, reliable: bool = False) -> Tuple[str, int]:
        """Per-message link test (reference: network.rs:261-270).

        Returns (outcome, latency_ns). Reliable (connection) traffic is
        exempt from Bernoulli loss but still subject to clogging.
        """
        if self.is_clogged(src, dst):
            return (CLOGGED, 0)
        if not reliable and self.config.packet_loss_rate > 0.0:
            if self.rng.gen_bool(self.config.packet_loss_rate):
                return (DROPPED, 0)
        latency = self.rng.gen_range(
            self.config.send_latency_min_ns, self.config.send_latency_max_ns + 1
        )
        if self.config.delay_spike_prob > 0.0 and self.rng.gen_bool(
            self.config.delay_spike_prob
        ):
            # delay-spike window (config.py NetConfig): late, not lost
            latency += self.rng.gen_range(
                self.config.delay_spike_min_ns, self.config.delay_spike_max_ns
            )
        return (PASS, latency)

    # -- sockets ------------------------------------------------------------

    def bind(self, node_id: int, addr: Addr, socket: Any) -> Addr:
        """Bind a socket; port 0 allocates an ephemeral port
        (reference: network.rs:196-244)."""
        ip, port = addr
        if ip not in ("0.0.0.0", "127.0.0.1") and ip != self.node_ip.get(node_id):
            raise NetError(f"cannot bind {ip}: node {node_id} has IP {self.node_ip.get(node_id)}")
        socks = self.sockets.setdefault(node_id, {})
        if port == 0:
            # Deterministic ephemeral allocation from the global RNG.
            for _ in range(100):
                cand = self.rng.gen_range(32768, 61000)
                if cand not in socks:
                    port = cand
                    break
            else:  # pragma: no cover
                raise AddrInUse("no free ephemeral port")
        elif port in socks:
            raise AddrInUse(f"address already in use: {format_addr(addr)}")
        socks[port] = socket
        return (ip, port)

    def unbind(self, node_id: int, port: int) -> None:
        self.sockets.get(node_id, {}).pop(port, None)

    def resolve_dst(self, src_node: int, dst: Addr) -> Optional[Tuple[int, Any]]:
        """Find the destination node + socket (reference: network.rs:296-325).

        Handles loopback (127.x -> same node) and 0.0.0.0-bound wildcard
        sockets. Returns None when nothing listens.
        """
        ip, port = dst
        if ip.startswith("127.") or ip == "localhost":
            dst_node = src_node
        else:
            dst_node = self.ip_node.get(ip)
            if dst_node is None:
                return None
        sock = self.sockets.get(dst_node, {}).get(port)
        if sock is None:
            return None
        return (dst_node, sock)

    def try_send(
        self,
        src_node: int,
        src_addr: Addr,
        dst: Addr,
        deliver: Callable[[Any], None],
        payload: Any,
        reliable: bool = False,
    ) -> bool:
        """Datagram send: resolve, test link, schedule delivery at
        now+latency (reference: network.rs:296-325 + mod.rs:327-333).

        Returns False if the message was lost/clogged/no-listener
        (datagram semantics: silent drop).
        """
        resolved = self.resolve_dst(src_node, dst)
        if resolved is None:
            return False
        dst_node, sock = resolved
        outcome, latency = self.test_link(src_node, dst_node, reliable=reliable)
        if outcome != PASS:
            return False
        self.stat.msg_count += 1
        self.time.add_timer_ns(self.time.now_ns() + latency, lambda: deliver(sock))
        return True
