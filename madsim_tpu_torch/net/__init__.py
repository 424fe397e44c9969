"""Simulated network (reference: madsim/src/sim/net/).

`NetSim` owns the Network fabric + DNS + IPVS. The datagram send path is
rand_delay (0-5 us, buggified to 1-5 s at 10%) -> RPC hook filter ->
IPVS rewrite -> link test (clog/loss/latency) -> timer-scheduled
delivery at arrival time (reference: sim/net/mod.rs:287-334).
Connection streams (`connect1`) are reliable and ordered but re-test the
link per message and back off while partitioned (mod.rs:337-414).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Set, Tuple

from ..config import Config
from ..plugin import Simulator
from ..time import SEC, US
from .dns import DnsServer, lookup_host
from .endpoint import (
    Endpoint,
    IncomingConn,
    Mailbox,
    Message,
    PayloadChannel,
    PayloadReceiver,
    PayloadSender,
)
from .. import _context
from .. import time as sim_time
from .ipvs import IpVirtualServer, Scheduler, ServiceAddr
from .network import (
    Addr,
    AddrInUse,
    ConnectionRefused,
    ConnectionReset,
    Direction,
    NetError,
    Network,
    format_addr,
    parse_addr,
)

__all__ = [
    "NetSim",
    "Endpoint",
    "TcpListener",
    "TcpStream",
    "UdpSocket",
    "UnixDatagram",
    "UnixListener",
    "UnixStream",
    "Request",
    "rpc",
    "service",
    "hash_str",
    "PayloadSender",
    "PayloadReceiver",
    "Network",
    "Direction",
    "NetError",
    "AddrInUse",
    "ConnectionRefused",
    "ConnectionReset",
    "DnsServer",
    "lookup_host",
    "IpVirtualServer",
    "ServiceAddr",
    "Scheduler",
    "parse_addr",
    "format_addr",
]

# RPC drop hook: fn(src_addr, dst_addr, tag, payload) -> bool (True = keep)
Hook = Callable[[Addr, Addr, int, Any], bool]


# Imported at module bottom to finish wiring (rpc attaches Endpoint.call etc.).
from .tcp import TcpListener, TcpStream  # noqa: E402
from .udp import UdpSocket  # noqa: E402
from .unix import UnixDatagram, UnixListener, UnixStream  # noqa: E402
from .rpc import Request, hash_str, rpc, service  # noqa: E402


class NetSim(Simulator):
    """Reference: sim/net/mod.rs:84 `NetSim`."""

    def __init__(self, rng, time, config: Config):
        super().__init__(rng, time, config)
        self.network = Network(rng, time, config.net)
        self.dns = DnsServer()
        self.ipvs = IpVirtualServer()
        self._endpoints: Dict[int, List[Endpoint]] = {}
        self._channels: Dict[int, List[PayloadChannel]] = {}
        self._hooks_req: List[Hook] = []
        self._hooks_rsp: List[Hook] = []
        # Unix-domain namespace: per-node path -> listener/datagram
        # (node-local IPC; kill wipes the namespace like a tmpfs socket
        # dir) + open stream pipes for EOF-on-kill
        self.unix_paths: Dict[int, Dict[str, Any]] = {}
        self.unix_pipes: Dict[int, List[Any]] = {}
        # Per-node incarnation, bumped on every kill/restart reset. Timer-
        # scheduled datagram deliveries capture the sender's incarnation at
        # send time and drop at the wire moment if the node died in between
        # — matching the reference, where kill cancels the sender task
        # mid-rand_delay (sim/net/mod.rs:287-296).
        self._incarnation: Dict[int, int] = {}
        self._send_seq = 0
        # Native datagram hot path (hostcore.NetCore): the send -> wire
        # -> delivery moments run in C when the native RNG + clock cores
        # are live. State stays in THIS object (the core holds refs);
        # hooks/ipvs/DNS fall back to the Python path automatically.
        self._netcore = None
        from .. import _native

        rng_core = getattr(rng, "_core", None)
        time_core = getattr(time, "_core", None)
        if _native.available() and rng_core is not None and time_core is not None:
            from .. import _context
            from .endpoint import Message as _Msg

            self._netcore = _native.get_mod().NetCore(
                self, self.network, rng, rng_core, time_core, _Msg,
                _context.current,
            )

    # -- Simulator lifecycle ------------------------------------------------

    def create_node(self, node_id: int) -> None:
        self.network.create_node(node_id)

    def set_node_ip(self, node_id: int, ip: str) -> None:
        self.network.set_node_ip(node_id, ip)

    def reset_node(self, node_id: int) -> None:
        """Node kill/restart: close sockets + break connections
        (reference: mod.rs reset_node -> network.rs:142-148)."""
        self.network.reset_node(node_id)
        self._incarnation[node_id] = self._incarnation.get(node_id, 0) + 1
        for ep in self._endpoints.pop(node_id, []):
            ep._on_reset()
        for chan in self._channels.pop(node_id, []):
            chan.do_reset()
        # close (not just discard) the namespace entries: a waiter
        # parked in accept()/recv_from() from another context must see
        # reset, matching the EOF the stream pipes get below
        for sock in self.unix_paths.pop(node_id, {}).values():
            sock.close()
        for pipe in self.unix_pipes.pop(node_id, []):
            pipe.close()

    def register_endpoint(self, node_id: int, ep: Endpoint) -> None:
        self._endpoints.setdefault(node_id, []).append(ep)

    def unregister_endpoint(self, node_id: int, ep: Endpoint) -> None:
        eps = self._endpoints.get(node_id)
        if eps is not None:
            try:
                eps.remove(ep)
            except ValueError:
                pass

    # -- chaos API (reference: mod.rs:160-236) -------------------------------

    def clog_node(self, node_id: int, direction: str = Direction.Both) -> None:
        self.network.clog_node(node_id, direction)

    def unclog_node(self, node_id: int, direction: str = Direction.Both) -> None:
        self.network.unclog_node(node_id, direction)

    def clog_link(self, src: int, dst: int) -> None:
        """Directional partition src -> dst (reference: mod.rs:221)."""
        self.network.clog_link(src, dst)

    def unclog_link(self, src: int, dst: int) -> None:
        self.network.unclog_link(src, dst)

    def partition(self, group_a: List[int], group_b: List[int]) -> None:
        """Symmetric partition between two node groups (convenience)."""
        for a in group_a:
            for b in group_b:
                self.network.clog_link(a, b)
                self.network.clog_link(b, a)

    def heal(self, group_a: List[int], group_b: List[int]) -> None:
        for a in group_a:
            for b in group_b:
                self.network.unclog_link(a, b)
                self.network.unclog_link(b, a)

    def add_dns_record(self, name: str, ip: str) -> None:
        """Reference: mod.rs:226."""
        self.dns.add_record(name, ip)

    def global_ipvs(self) -> IpVirtualServer:
        """Reference: mod.rs:236."""
        return self.ipvs

    def hook_rpc_req(self, hook: Hook) -> None:
        """Drop-filter outbound messages (reference: mod.rs:245)."""
        self._hooks_req.append(hook)

    def hook_rpc_rsp(self, hook: Hook) -> None:
        """Reference: mod.rs:268. Applied to the same send path; the RPC
        layer routes responses through it by tag convention."""
        self._hooks_rsp.append(hook)

    def stat(self):
        return self.network.stat

    # -- send path ----------------------------------------------------------

    async def rand_delay(self) -> None:
        """Random processing delay before each send: 0-5 us, buggified to
        1-5 s with 10% probability (reference: mod.rs:287-296)."""
        if self.rng.buggify_with_prob(0.1):
            delay = self.rng.gen_range(1 * SEC, 5 * SEC)
        else:
            delay = self.rng.gen_range(0, 5 * US)
        await sim_time.sleep_ns(delay)

    def resolve_name(self, addr: Addr) -> Addr:
        """DNS-resolve a hostname destination (reference: addr.rs:225-247
        ToSocketAddrs resolution on every send/connect)."""
        host, port = addr
        if host == "localhost":
            return ("127.0.0.1", port)
        if host and not host[0].isdigit():
            ip = self.dns.lookup(host)
            if ip is None:
                raise NetError(f"failed to lookup address information: {host}")
            return (ip, port)
        return addr

    async def send_raw(
        self,
        src_node: int,
        src_addr: Addr,
        dst: Addr,
        tag: int,
        payload: Any,
        kind: Optional[str] = None,
    ) -> None:
        """Datagram send (reference: NetSim::send mod.rs:298-334).

        `kind` marks RPC traffic so request/response drop hooks apply to
        the right direction only (reference applies hooks by payload type,
        mod.rs:308-312).

        The 0-5 us processing delay normally runs as a TIMER callback,
        not a coroutine suspension: the wire outcome (hooks, clog/loss
        test, latency draw) still happens at t+delay like the reference,
        but the sender resumes immediately — two task polls cheaper per
        datagram on the executor's hot loop. Every 16th datagram keeps
        the reference's blocking await so a tight send loop still drives
        virtual time forward (without it, a loop that never awaits
        recv/sleep would starve the clock). The buggified 1-5 s delay
        always blocks: there the backpressure IS the injected chaos
        (reference: mod.rs:287-296)."""
        pend = self.send_fast(src_node, src_addr, dst, tag, payload, kind)
        if pend is not None:
            await pend

    def send_fast(
        self, src_node, src_addr, dst, tag, payload, kind=None
    ) -> Optional[Any]:
        """The non-async datagram send: returns None when the send was
        fully scheduled synchronously (the common case — zero coroutine
        frames on the hot path), or a coroutine the caller must await
        (the buggified 1-5 s / every-16th blocking-send cases, and the
        whole Python path when the native core is absent).

        DNS errors surface to the caller (reference: lookup failure is
        the send's error); hooks still observe the ORIGINAL destination
        the sender used, and clog/loss/latency stay at the wire moment."""
        resolved = self.resolve_name(dst)
        nc = self._netcore
        if nc is not None:
            out = nc.send(src_node, src_addr, dst, resolved, tag, payload, kind)
            if out is None:
                return None
            return self._send_blocking_tail(
                out[1], src_node, src_addr, dst, resolved, tag, payload, kind
            )
        return self._send_slow(src_node, src_addr, dst, resolved, tag, payload, kind)

    async def _send_blocking_tail(
        self, delay_ns, src_node, src_addr, dst, resolved, tag, payload, kind
    ) -> None:
        # the two blocking-send cases: the buggified 1-5 s chaos delay
        # and the every-16th suspension that keeps send-only loops
        # driving virtual time (kill cancels the sender here, like the
        # reference's rand_delay)
        await sim_time.sleep_ns(delay_ns)
        self._send_phase2(src_node, src_addr, dst, resolved, tag, payload, kind)

    async def _send_slow(
        self, src_node, src_addr, dst, resolved, tag, payload, kind
    ) -> None:
        """Pure-Python send path (no native core): same draws, same
        timer-scheduled wire moment."""
        if self.rng.buggify_with_prob(0.1):
            await sim_time.sleep_ns(self.rng.gen_range(1 * SEC, 5 * SEC))
            self._send_phase2(src_node, src_addr, dst, resolved, tag, payload, kind)
            return
        delay = self.rng.gen_range(0, 5 * US)
        self._send_seq += 1
        if self._send_seq % 16 == 0:
            await sim_time.sleep_ns(delay)
            self._send_phase2(src_node, src_addr, dst, resolved, tag, payload, kind)
            return
        incarnation = self._incarnation.get(src_node, 0)
        self.time.add_timer_ns(
            self.time.now_ns() + delay,
            lambda: self._send_phase2_guarded(
                src_node, src_addr, dst, resolved, tag, payload, kind,
                sender=(src_node, incarnation),
            ),
        )

    def _send_phase2_guarded(self, *args, sender=None) -> None:
        """Timer-context wrapper: a raising drop-hook must surface as a
        simulation panic (the standard loud-failure path), not unwind
        the executor's timer machinery.

        `sender=(node_id, incarnation)` drops the datagram if the sending
        node was killed or restarted after the send was issued — the
        reference gets this for free because kill cancels the sender task
        inside rand_delay; here the wire moment is a detached timer, so
        the liveness check is explicit."""
        if sender is not None:
            node_id, incarnation = sender
            if self._incarnation.get(node_id, 0) != incarnation:
                return  # sender died between send and wire moment
        try:
            self._send_phase2(*args)
        except BaseException as exc:  # noqa: BLE001 - routed, not swallowed
            _context.current().executor.panic = exc

    def _send_phase2(self, src_node, src_addr, dst, resolved, tag, payload, kind) -> None:
        """On-the-wire moment: drop hooks (seeing the sender's `dst`),
        IPVS rewrite, clog/loss/latency."""
        if kind == "rpc_req":
            hooks = self._hooks_req
        elif kind == "rpc_rsp":
            hooks = self._hooks_rsp
        else:
            hooks = []
        for hook in hooks:
            if not hook(src_addr, dst, tag, payload):
                return  # dropped by hook
        rewritten = self.ipvs.rewrite("udp", resolved)
        if rewritten is not None:
            resolved = rewritten
        msg = Message(tag, payload, (self._src_ip(src_node, resolved), src_addr[1]))
        self.network.try_send(
            src_node, src_addr, resolved, lambda sock: sock.deliver(msg), payload
        )

    def _src_ip(self, src_node: int, dst: Addr) -> str:
        """The source address a peer observes: loopback for local sends,
        the node IP otherwise."""
        if dst[0].startswith("127.") or dst[0] == "localhost":
            return "127.0.0.1"
        return self.network.node_ip.get(src_node, "0.0.0.0")

    # -- connection path (reference: mod.rs:337-414) ------------------------

    async def connect1(self, ep: Endpoint, dst: Addr) -> Tuple[PayloadSender, PayloadReceiver]:
        await self.rand_delay()
        dst = self.resolve_name(dst)
        rewritten = self.ipvs.rewrite("tcp", dst)
        if rewritten is not None:
            dst = rewritten
        resolved = self.network.resolve_dst(ep.node_id, dst)
        if resolved is None:
            raise ConnectionRefused(f"connection refused: {format_addr(dst)}")
        dst_node, sock = resolved
        if self.network.is_clogged(ep.node_id, dst_node):
            # A partition shows up as connect timeout -> refused.
            raise ConnectionRefused(f"connection refused (partitioned): {format_addr(dst)}")
        if not hasattr(sock, "new_connection"):
            raise ConnectionRefused(f"no listener at {format_addr(dst)}")

        fwd = PayloadChannel(self, ep.node_id, dst_node)  # client -> server
        bwd = PayloadChannel(self, dst_node, ep.node_id)  # server -> client
        # Each channel registers under BOTH ends: killing either node must
        # break the whole connection (reference: reset closes the stream).
        for node in (ep.node_id, dst_node):
            chans = self._channels.setdefault(node, [])
            # Amortized prune of dead channels keeps reset_node O(live).
            if len(chans) > 64 and len(chans) % 64 == 0:
                chans[:] = [c for c in chans if not (c.closed or c.reset)]
            chans.append(fwd)
            chans.append(bwd)

        client_addr = (self._src_ip(ep.node_id, dst), ep.local_addr[1])
        conn = IncomingConn(
            PayloadSender(bwd, client_addr), PayloadReceiver(fwd, client_addr), client_addr
        )
        _, latency = self.network.test_link(ep.node_id, dst_node, reliable=True)
        self.time.add_timer_ns(
            self.time.now_ns() + latency, lambda: sock.new_connection(conn)
        )
        return PayloadSender(fwd, dst), PayloadReceiver(bwd, dst)
