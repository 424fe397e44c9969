"""Simulated etcd v3 — client + in-sim server
(reference: madsim-etcd-client).

`SimServer` speaks a request protocol over `Endpoint.connect1`
(reference: src/server.rs:104-167) with an injectable `timeout_rate`
(:21-24); `Client` exposes the etcd-client surface: kv / lease /
election / maintenance / watch, plus state `dump`/`load`
(reference: src/sim.rs:27-78). The reference's watch API is a type stub
(src/watch.rs:1-8); here it is fully functional (streaming put/delete
events over a held-open connection).
"""

from __future__ import annotations

from typing import Any, List, Optional, Sequence, Tuple, Union

from ...dual import rand, time as sim_time  # mode-selected (sim or asyncio)
from ...errors import SimError
from ...net.network import ConnectionReset, parse_addr
from ...dual import net as _dual_net
from ...dual import task as _dual_task

Endpoint = _dual_net.Endpoint
spawn = _dual_task.spawn
from .._conn import StreamCaller
from .service import EtcdError, EtcdService, Event, KeyValue, MAX_REQUEST_BYTES

__all__ = [
    "Client",
    "SimServer",
    "WatchFilter",
    "EtcdError",
    "KeyValue",
    "Event",
    "Txn",
    "Compare",
    "TxnOp",
]

Key = Union[str, bytes]


def _b(x: Key) -> bytes:
    return x.encode() if isinstance(x, str) else bytes(x)


def _prefix_end(key: bytes) -> bytes:
    """The etcd range_end for a prefix scan: key with last byte +1."""
    for i in reversed(range(len(key))):
        if key[i] < 0xFF:
            return key[:i] + bytes([key[i] + 1])
    return b"\xff" * (len(key) + 1)


# -- txn building blocks (reference: etcd-client Compare/Txn/TxnOp) ----------


class Compare:
    def __init__(self, target: str, key: Key, op: str, operand: Any):
        self.tuple = (target, _b(key), op, operand if not isinstance(operand, (str, bytes)) else _b(operand))

    @staticmethod
    def value(key: Key, op: str, v: Key) -> "Compare":
        return Compare("value", key, op, v)

    @staticmethod
    def version(key: Key, op: str, v: int) -> "Compare":
        return Compare("version", key, op, v)

    @staticmethod
    def create_revision(key: Key, op: str, v: int) -> "Compare":
        return Compare("create_revision", key, op, v)

    @staticmethod
    def mod_revision(key: Key, op: str, v: int) -> "Compare":
        return Compare("mod_revision", key, op, v)


class TxnOp:
    @staticmethod
    def put(key: Key, value: Key, lease: int = 0) -> tuple:
        return ("put", _b(key), _b(value), lease)

    @staticmethod
    def get(key: Key, prefix: bool = False) -> tuple:
        k = _b(key)
        return ("get", k, _prefix_end(k) if prefix else b"")

    @staticmethod
    def delete(key: Key, prefix: bool = False) -> tuple:
        k = _b(key)
        return ("delete", k, _prefix_end(k) if prefix else b"")


class Txn:
    def __init__(self) -> None:
        self._when: List[tuple] = []
        self._then: List[tuple] = []
        self._else: List[tuple] = []

    def when(self, compares: Sequence[Compare]) -> "Txn":
        self._when = [c.tuple for c in compares]
        return self

    def and_then(self, ops: Sequence[tuple]) -> "Txn":
        self._then = list(ops)
        return self

    def or_else(self, ops: Sequence[tuple]) -> "Txn":
        self._else = list(ops)
        return self


# -- server -------------------------------------------------------------------


class SimServer:
    """Reference: src/server.rs `SimServer` (+ sim.rs builder)."""

    def __init__(self, timeout_rate: float = 0.0, progress_interval: float = 1.0,
                 history_limit: int = 10_000):
        self.timeout_rate = timeout_rate
        # period of watch progress notifications (etcd's is ~10 min wall
        # time; 1 s of virtual time keeps sim tests snappy)
        self.progress_interval = progress_interval
        self.history_limit = history_limit
        self.service: Optional[EtcdService] = None

    async def serve(self, addr: Any, on_bound=None) -> None:
        rng = rand.thread_rng()
        self.service = EtcdService(rng, history_limit=self.history_limit)
        ep = await Endpoint.bind(addr)
        if on_bound is not None:
            on_bound(ep)

        async def ticker():
            # 1 s lease countdown (reference: service.rs:25-35)
            it = sim_time.interval(1.0)
            while True:
                await it.tick()
                self.service.tick()

        spawn(ticker(), name="etcd-lease-tick")
        while True:
            tx, rx, peer = await ep.accept1()
            spawn(self._handle(tx, rx), name="etcd-conn")

    async def _handle(self, tx, rx) -> None:
        """One connection serves one long-lived subscription (watch/
        observe) or a loop of unary requests — the same dual shape the
        kafka/s3 servers speak, so real-mode clients can keep one
        persistent stream (StreamCaller) instead of a socket per call."""
        svc = self.service
        rng = rand.thread_rng()
        try:
            while True:
                req = await rx.recv()
                if req is None:
                    return
                if self.timeout_rate > 0 and rng.gen_bool(self.timeout_rate):
                    tx.send(("err", "etcdserver: request timed out"))
                    continue
                kind = req[0]
                if kind == "watch":
                    await self._watch(tx, rx, req[1], req[2],
                                      req[3] if len(req) > 3 else {})
                    return
                if kind == "observe":
                    await self._observe(tx, rx, req[1])
                    return
                try:
                    result = self._apply(svc, req)
                    tx.send(("ok", result))
                except EtcdError as e:
                    tx.send(("err", str(e)))
        except ConnectionReset:
            pass
        finally:
            tx.close()  # real mode: a finished connection must not linger

    def _apply(self, svc: EtcdService, req: tuple):
        kind = req[0]
        if kind == "put":
            return svc.put(req[1], req[2], lease=req[3], prev_kv=req[4])
        if kind == "get":
            return svc.get(req[1], range_end=req[2], limit=req[3], count_only=req[4], keys_only=req[5])
        if kind == "delete":
            return svc.delete(req[1], range_end=req[2], prev_kv=req[3])
        if kind == "txn":
            return svc.txn(req[1], req[2], req[3])
        if kind == "lease_grant":
            return svc.lease_grant(req[1], req[2])
        if kind == "lease_revoke":
            return svc.lease_revoke(req[1])
        if kind == "lease_keep_alive":
            return svc.lease_keep_alive(req[1])
        if kind == "lease_time_to_live":
            return svc.lease_time_to_live(req[1])
        if kind == "lease_list":
            return svc.lease_list()
        if kind == "campaign":
            return svc.campaign(req[1], req[2], req[3])
        if kind == "leader":
            return svc.leader(req[1])
        if kind == "proclaim":
            return svc.proclaim(req[1], req[2])
        if kind == "resign":
            return svc.resign(req[1])
        if kind == "compact":
            return svc.compact(req[1])
        if kind == "status":
            return svc.status()
        if kind == "dump":
            return svc.dump()
        if kind == "load":
            return svc.load(req[1])
        raise EtcdError(f"unknown request {kind}")

    async def _watch(self, tx, rx, lo: bytes, hi: bytes, opts: dict) -> None:
        """WatchCreateRequest options (reference class: etcd v3 watch —
        the reference sim's watch.rs is a type stub; this is functional):
        `filters` ("noput"/"nodelete"), `prev_kv`, `start_revision`
        (history replay, ErrCompacted past the compaction point), and
        `progress_notify` (periodic revision heartbeats; the client can
        also request one on demand, like WatchProgressRequest)."""
        svc = self.service
        filters = set(opts.get("filters", ()))
        want_prev = opts.get("prev_kv", False)
        start_rev = opts.get("start_revision", 0)
        entry_box: list = [None]

        def emit(ev: Event) -> None:
            # a future start_revision is a resume point: hold the watch
            # and deliver nothing below it (real etcd parks the watcher
            # until the store revision catches up)
            if start_rev and ev.kv.mod_revision < start_rev:
                return
            if ev.kind == Event.PUT and "noput" in filters:
                return
            if ev.kind == Event.DELETE and "nodelete" in filters:
                return
            if not want_prev and ev.prev_kv is not None:
                ev = Event(ev.kind, ev.kv, None)
            self._safe_send(tx, ("event", ev), entry_box)

        # no awaits between head/replay/subscribe: the deterministic
        # executor makes this block atomic, so replay never races a
        # concurrent put (no gap, no duplicate)
        if start_rev:
            try:
                backlog = svc.history_since(start_rev, lo, hi)
            except EtcdError as e:
                tx.send(("err", str(e)))
                return
            tx.send(("ok", {"watching": True}))
            for ev in backlog:
                emit(ev)
        else:
            tx.send(("ok", {"watching": True}))
        entry_box[0] = entry = svc.add_watcher(lo, hi, emit)

        stop = [False]
        if opts.get("progress_notify", False):
            async def ticker():
                while not stop[0]:
                    await sim_time.sleep(self.progress_interval)
                    if stop[0]:
                        return
                    try:
                        tx.send(("progress", svc.revision))
                    except ConnectionReset:
                        return

            spawn(ticker(), name="etcd-watch-progress")

        # hold open until the client goes away; serve manual progress
        # requests in the meantime
        while (req := await rx.recv()) is not None:
            if req and req[0] == "progress_req":
                # distinct tag: an on-demand reply must reflect the
                # revision at request-processing time, so the client must
                # not satisfy it with a stale queued periodic notification
                try:
                    tx.send(("progress_resp", svc.revision))
                except ConnectionReset:
                    break
        stop[0] = True
        svc.remove_watcher(entry)

    def _safe_send(self, tx, msg, entry_box) -> None:
        try:
            tx.send(msg)
        except ConnectionReset:
            if entry_box[0] is not None:
                self.service.remove_watcher(entry_box[0])

    async def _observe(self, tx, rx, name: bytes) -> None:
        """Stream leadership changes (reference: election observe)."""
        svc = self.service
        lo, hi = svc._election_prefix(name)

        def on_change(_ev: Event) -> None:
            try:
                info = svc.is_leader(name, b"")
                if info["leader"] is not None:
                    tx.send(("leader", info))
            except ConnectionReset:
                svc.remove_watcher(entry)

        entry = svc.add_watcher(lo, hi, on_change)
        info = svc.is_leader(name, b"")
        tx.send(("ok", {"observing": True}))
        if info["leader"] is not None:
            tx.send(("leader", info))
        while (await rx.recv()) is not None:
            pass
        svc.remove_watcher(entry)


# -- client -------------------------------------------------------------------


class WatchFilter:
    """Event-type filters for watch (reference class: etcd v3
    WatchCreateRequest.filters)."""

    NOPUT = "noput"
    NODELETE = "nodelete"


class Watcher:
    """Async stream of watch events (functional, unlike the reference's
    stub watch.rs). Progress notifications never surface as events:
    they update `progress_revision` (the keyspace revision the stream is
    guaranteed to have reached) and can be requested on demand with
    `progress()`."""

    def __init__(self, tx, rx):
        self._tx = tx
        self._rx = rx
        self._pending: List[tuple] = []
        self.progress_revision = 0

    def __aiter__(self) -> "Watcher":
        return self

    async def __anext__(self) -> Event:
        while True:
            msg = self._pending.pop(0) if self._pending else await self._rx.recv()
            if msg is None:
                raise StopAsyncIteration
            if msg[0] in ("progress", "progress_resp"):
                self.progress_revision = msg[1]
                continue
            return msg[1]

    async def progress(self) -> int:
        """Request + await a progress notification (reference class:
        etcd WatchProgressRequest); events arriving in between are
        buffered for the next `__anext__`. Only the tagged on-demand
        reply resolves the call — a stale queued periodic notification
        must not masquerade as "synced through the current revision"."""
        self._tx.send(("progress_req",))
        while True:
            msg = await self._rx.recv()
            if msg is None:
                raise EtcdError("watch stream closed")
            if msg[0] == "progress":
                self.progress_revision = msg[1]
                continue
            if msg[0] == "progress_resp":
                self.progress_revision = msg[1]
                return msg[1]
            self._pending.append(msg)

    def cancel(self) -> None:
        self._tx.close()


class Observer:
    def __init__(self, tx, rx):
        self._tx = tx
        self._rx = rx

    def __aiter__(self) -> "Observer":
        return self

    async def __anext__(self) -> dict:
        msg = await self._rx.recv()
        if msg is None:
            raise StopAsyncIteration
        return msg[1]

    def cancel(self) -> None:
        self._tx.close()


class Client:
    """etcd-client surface (reference: src/sim.rs:27-78 `Client` with
    kv/lease/election/maintenance sub-clients, flattened pythonically)."""

    def __init__(self, addr):
        self._addr = addr
        self._caller = StreamCaller()
        # real mode with a genuine etcd reachable: every op goes through
        # the etcd wire protocol instead of the sim pickle protocol
        # (reference: madsim-etcd-client/src/lib.rs:5-6 `pub use
        # etcd_client::*` in the non-sim build)
        self._real = None

    @staticmethod
    async def connect(endpoints: Union[str, Sequence[str]], timeout: Optional[float] = None) -> "Client":
        if isinstance(endpoints, str):
            endpoints = [endpoints]
        from ...dual import IS_SIM, real_passthrough_enabled

        if not IS_SIM and real_passthrough_enabled():
            from .real_client import try_connect_real

            backend = await try_connect_real(endpoints, probe_timeout=timeout or 2.0)
            if backend is not None:
                client = Client(endpoints[0])
                client._real = backend
                return client
        client = Client(parse_addr(endpoints[0]))
        await client._caller.open(client._addr)
        return client

    async def close(self) -> None:
        if self._real is not None:
            await self._real.close()
        if self._caller is not None:
            self._caller.close()

    # reads are safe to transparently re-send after an ambiguous response
    # loss in real mode; mutations (put/txn/delete/lease_grant/campaign)
    # are not — a blind retry could double-apply against MVCC revisions
    _IDEMPOTENT = {"get", "leader", "status", "dump",
                   "lease_time_to_live", "lease_list"}

    async def _call(self, req: tuple):
        if self._real is not None:
            return await self._real.call(req)
        rsp = await self._caller.call(req, idempotent=req[0] in self._IDEMPOTENT)
        if rsp is None:
            raise EtcdError("etcd server unavailable")
        status, payload = rsp
        if status == "err":
            raise EtcdError(payload)
        return payload

    # -- kv --

    async def put(self, key: Key, value: Key, lease: int = 0, prev_kv: bool = False):
        return await self._call(("put", _b(key), _b(value), lease, prev_kv))

    async def get(
        self,
        key: Key,
        prefix: bool = False,
        range_end: Optional[Key] = None,
        limit: int = 0,
        count_only: bool = False,
        keys_only: bool = False,
    ):
        k = _b(key)
        end = _b(range_end) if range_end is not None else (_prefix_end(k) if prefix else b"")
        return await self._call(("get", k, end, limit, count_only, keys_only))

    async def delete(self, key: Key, prefix: bool = False, prev_kv: bool = False):
        k = _b(key)
        end = _prefix_end(k) if prefix else b""
        return await self._call(("delete", k, end, prev_kv))

    async def txn(self, txn: Txn):
        return await self._call(("txn", txn._when, txn._then, txn._else))

    # -- lease --

    async def lease_grant(self, ttl: int, lease_id: int = 0):
        return await self._call(("lease_grant", ttl, lease_id))

    async def lease_revoke(self, lease_id: int):
        return await self._call(("lease_revoke", lease_id))

    async def lease_keep_alive(self, lease_id: int):
        return await self._call(("lease_keep_alive", lease_id))

    async def lease_time_to_live(self, lease_id: int):
        return await self._call(("lease_time_to_live", lease_id))

    async def leases(self):
        return await self._call(("lease_list",))

    # -- election --

    async def campaign(self, name: Key, value: Key, lease: int, poll_interval: float = 0.1):
        """Blocks until this candidate is the leader
        (reference: election campaign semantics)."""
        while True:
            info = await self._call(("campaign", _b(name), _b(value), lease))
            if info["is_leader"]:
                return info
            await sim_time.sleep(poll_interval)

    async def leader(self, name: Key):
        return await self._call(("leader", _b(name)))

    async def proclaim(self, value: Key, leader: dict):
        return await self._call(("proclaim", leader["leader"], _b(value)))

    async def resign(self, leader: dict):
        return await self._call(("resign", leader["leader"]))

    async def observe(self, name: Key) -> Observer:
        if self._real is not None:
            return await self._real.observe(_b(name))
        tx, rx = await self._open_sub()
        tx.send(("observe", _b(name)))
        head = await rx.recv()
        if head is None or head[0] != "ok":
            tx.close()  # both ends release the failed subscription
            raise EtcdError(f"observe failed: {head}")
        return Observer(tx, rx)

    async def _open_sub(self):
        """Dedicated channel for a subscription; server-down surfaces as
        the typed error, not a raw OSError."""
        try:
            return await self._caller.open_stream()
        except ConnectionReset as e:
            raise EtcdError(f"etcd server unavailable: {e}") from e

    # -- watch --

    async def watch(
        self,
        key: Key,
        prefix: bool = False,
        range_end: Optional[Key] = None,
        start_revision: int = 0,
        filters: Sequence[str] = (),
        prev_kv: bool = False,
        progress_notify: bool = False,
    ) -> Watcher:
        """WatchCreateRequest surface: `start_revision` replays history
        from that revision (ErrCompacted if compacted away), `filters`
        drop event kinds (WatchFilter.NOPUT/NODELETE), `prev_kv`
        includes each event's previous value, `progress_notify` enables
        periodic revision heartbeats."""
        k = _b(key)
        if range_end is not None:
            hi = _b(range_end)
        else:
            hi = _prefix_end(k) if prefix else b""
        if self._real is not None:
            return await self._real.watch(k, hi, {
                "start_revision": start_revision,
                "filters": tuple(filters),
                "prev_kv": prev_kv,
                "progress_notify": progress_notify,
            })
        tx, rx = await self._open_sub()
        tx.send(("watch", k, hi, {
            "start_revision": start_revision,
            "filters": tuple(filters),
            "prev_kv": prev_kv,
            "progress_notify": progress_notify,
        }))
        head = await rx.recv()
        if head is None or head[0] != "ok":
            tx.close()  # both ends release the failed subscription
            raise EtcdError(f"watch failed: {head}")
        return Watcher(tx, rx)

    async def compact(self, revision: int):
        """Discard watchable history below `revision` (etcd compaction)."""
        return await self._call(("compact", revision))

    # -- maintenance / persistence --

    async def status(self):
        return await self._call(("status",))

    async def dump(self) -> str:
        return await self._call(("dump",))

    async def load(self, text: str):
        return await self._call(("load", text))
