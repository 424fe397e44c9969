"""Real-client passthrough for etcd — the analogue of the reference's
non-sim build re-exporting the genuine client
(`madsim-etcd-client/src/lib.rs:5-6`
``pub use etcd_client::*``).

Under ``MADSIM_TPU_MODE=real``, `services.etcd.Client.connect` probes
the endpoint with a genuine etcd v3 gRPC Status call; if it answers,
every Client operation is translated onto the real etcd wire protocol
(etcdserverpb / mvccpb / v3electionpb stubs generated from the bundled
protos by `madsim_tpu_torch.grpc.build` — the same .proto ingestion the
reference drives through tonic-build). If the endpoint is not a real
etcd, the Client falls back to the sim-protocol server
(`python -m madsim_tpu_torch serve`), as before the passthrough existed.

No `etcd3`-style third-party client is required: grpcio + the published
v3 API field numbers *are* the genuine client, exactly as the
reference's etcd-client crate is tonic + these same protos.

Also here: `EtcdGrpcGateway`, the inverse adapter — an etcd-wire gRPC
server backed by the sim `EtcdService` state machine, used to test the
passthrough in-process and to serve real clients from
`python -m madsim_tpu_torch serve --service etcd --grpc`.
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Sequence

from .service import EtcdError, Event, KeyValue

_PROTO_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "protos")

_ns_cache = None


def protos():
    """Generated etcd stubs (KV/Watch/Lease/Maintenance/Election)."""
    global _ns_cache
    if _ns_cache is None:
        from ...grpc import build

        _ns_cache = build.load(
            os.path.join(_PROTO_DIR, "mvcc.proto"),
            os.path.join(_PROTO_DIR, "rpc.proto"),
            os.path.join(_PROTO_DIR, "election.proto"),
            includes=[_PROTO_DIR],
        )
    return _ns_cache


def _merged_methods(ns) -> Dict:
    out = {}
    for client_cls in (
        ns.KVClient, ns.WatchClient, ns.LeaseClient, ns.MaintenanceClient, ns.ElectionClient
    ):
        out.update(client_cls._METHODS)
    return out


# -- pb <-> sim-shape translation ---------------------------------------------

_CMP_RESULT = {"=": 0, ">": 1, "<": 2, "!=": 3}
_CMP_TARGET = {"version": 0, "create_revision": 1, "mod_revision": 2, "value": 3}
_CMP_FIELD = {
    "version": "version",
    "create_revision": "create_revision",
    "mod_revision": "mod_revision",
    "value": "value",
}


def _kv_from_pb(pb) -> KeyValue:
    return KeyValue(
        bytes(pb.key), bytes(pb.value), pb.create_revision, pb.mod_revision,
        pb.version, pb.lease,
    )


def _compare_pb(ns, tup):
    target, key, op, operand = tup
    if target not in _CMP_TARGET:
        raise EtcdError(f"unsupported compare target {target!r}")
    if op not in _CMP_RESULT:
        raise EtcdError(f"unsupported compare op {op!r}")
    cmp = ns.Compare(result=_CMP_RESULT[op], target=_CMP_TARGET[target], key=key)
    setattr(cmp, _CMP_FIELD[target], operand)
    return cmp


def _request_op_pb(ns, op):
    kind = op[0]
    if kind == "put":
        return ns.RequestOp(
            request_put=ns.PutRequest(key=op[1], value=op[2], lease=op[3] if len(op) > 3 else 0)
        )
    if kind == "get":
        return ns.RequestOp(request_range=ns.RangeRequest(key=op[1], range_end=op[2]))
    if kind == "delete":
        return ns.RequestOp(request_delete_range=ns.DeleteRangeRequest(key=op[1], range_end=op[2]))
    raise EtcdError(f"unsupported txn op {kind!r}")


def _response_op_sim(pb):
    which = pb.WhichOneof("response")
    if which == "response_put":
        r = pb.response_put
        return ("put", {
            "revision": r.header.revision,
            "prev_kv": _kv_from_pb(r.prev_kv) if r.HasField("prev_kv") else None,
        })
    if which == "response_range":
        r = pb.response_range
        return ("get", {
            "revision": r.header.revision,
            "kvs": [_kv_from_pb(kv) for kv in r.kvs],
            "count": r.count,
        })
    if which == "response_delete_range":
        r = pb.response_delete_range
        return ("delete", {
            "revision": r.header.revision,
            "deleted": r.deleted,
            "prev_kvs": [_kv_from_pb(kv) for kv in r.prev_kvs],
        })
    raise EtcdError(f"unsupported txn response {which!r}")


def _leader_key_sim(lk) -> dict:
    return {"name": bytes(lk.name), "key": bytes(lk.key), "rev": lk.rev, "lease": lk.lease}


def _leader_key_pb(ns, d):
    return ns.LeaderKey(name=d["name"], key=d["key"], rev=d["rev"], lease=d["lease"])


class RealWatcher:
    """Genuine-etcd watch stream with the sim `Watcher` surface
    (`async for`, `progress_revision`, `progress()`, `cancel()`)."""

    def __init__(self, ns, req_q, stream):
        self._ns = ns
        self._req_q = req_q
        self._stream = stream
        self._pending = []
        self.progress_revision = 0

    def __aiter__(self):
        return self

    async def __anext__(self) -> Event:
        while True:
            if self._pending:
                return self._pending.pop(0)
            rsp = await self._stream.message()
            if rsp is None or rsp.canceled:
                raise StopAsyncIteration
            evs = self._translate(rsp)
            if not evs:
                continue
            self._pending.extend(evs[1:])
            return evs[0]

    def _translate(self, rsp):
        if rsp.compact_revision:
            raise EtcdError(
                f"required revision has been compacted (compact_revision "
                f"{rsp.compact_revision})"
            )
        self.progress_revision = max(self.progress_revision, rsp.header.revision)
        out = []
        for ev in rsp.events:
            kind = Event.DELETE if ev.type == 1 else Event.PUT
            prev = _kv_from_pb(ev.prev_kv) if ev.HasField("prev_kv") else None
            out.append(Event(kind, _kv_from_pb(ev.kv), prev))
        return out

    async def progress(self) -> int:
        """Request + await a progress notification
        (WatchProgressRequest); events in between are buffered."""
        ns = self._ns
        await self._req_q.put(ns.WatchRequest(progress_request=ns.WatchProgressRequest()))
        while True:
            rsp = await self._stream.message()
            if rsp is None:
                raise EtcdError("watch stream closed")
            if rsp.canceled:
                raise EtcdError(
                    f"watch canceled by server: {rsp.cancel_reason or 'unknown'}"
                )
            evs = self._translate(rsp)
            if evs:
                self._pending.extend(evs)
                continue
            return self.progress_revision

    def cancel(self) -> None:
        self._req_q.put_nowait(None)


class RealObserver:
    """Election observe stream with the sim `Observer` surface."""

    def __init__(self, stream, name: bytes):
        self._stream = stream
        self._name = name

    def __aiter__(self):
        return self

    async def __anext__(self) -> dict:
        rsp = await self._stream.message()
        if rsp is None:
            raise StopAsyncIteration
        kv = rsp.kv
        return {
            "leader": {"name": self._name, "key": bytes(kv.key),
                       "rev": kv.create_revision, "lease": kv.lease},
            "is_leader": False,
            "value": bytes(kv.value),
        }

    def cancel(self) -> None:
        self._stream._call.cancel()


class RealEtcdBackend:
    """Translates the sim Client's request tuples onto genuine etcd
    gRPC, returning the exact payload shapes `EtcdService` produces —
    app code cannot tell which backend answered."""

    def __init__(self, channel, ns):
        self._chan = channel
        self._ns = ns
        # One long-lived LeaseKeepAlive bidi stream for ALL keepalives
        # (etcd clients multiplex keepalives this way); opening a fresh
        # stream per call churns grpc.aio call objects and server-side
        # generators under frequent keepalives.
        self._ka = None  # (request queue, RealStreaming) or None
        self._ka_lock = None

    @classmethod
    async def connect(cls, endpoint: str, probe_timeout: float = 2.0) -> "RealEtcdBackend":
        """Open + probe with Maintenance.Status; raises on anything that
        is not a live etcd-wire server."""
        from ...grpc.real import RealChannel

        ns = protos()
        chan = await RealChannel.connect(
            endpoint, _merged_methods(ns), timeout=probe_timeout
        )
        try:
            await chan.unary("/etcdserverpb.Maintenance/Status", ns.StatusRequest())
        except Exception:
            await chan.close()
            raise
        # the probe deadline must not become the per-RPC deadline:
        # watch/observe streams are long-lived and Campaign blocks until
        # leadership — they would all die after probe_timeout seconds
        chan.set_default_timeout(None)
        return cls(RealChannelHolder(chan), ns)

    async def close(self) -> None:
        if self._ka is not None:
            self._ka[0].put_nowait(None)  # end the feeder generator
            self._ka = None
        await self._chan.chan.close()

    async def _keep_alive_once(self, lease_id: int):
        """One keepalive round-trip on the cached bidi stream; reopens
        the stream once if the server ended it (e.g. idle timeout)."""
        import asyncio

        ns = self._ns
        if self._ka_lock is None:
            self._ka_lock = asyncio.Lock()
        async with self._ka_lock:  # pair each request with its response
            for attempt in (0, 1):
                if self._ka is None:
                    q: asyncio.Queue = asyncio.Queue()

                    async def feed(q=q):
                        while True:
                            item = await q.get()
                            if item is None:
                                return
                            yield item

                    stream = await self._chan.chan.streaming(
                        "/etcdserverpb.Lease/LeaseKeepAlive", feed()
                    )
                    self._ka = (q, stream)
                q, stream = self._ka
                q.put_nowait(ns.LeaseKeepAliveRequest(ID=lease_id))
                try:
                    rsp = await stream.message()
                except BaseException as exc:
                    # the response is (or may be) in flight: the stream
                    # cannot be reused or later keepalives would read
                    # this call's response (request/response desync)
                    self._ka = None
                    q.put_nowait(None)  # end the feeder generator
                    if not isinstance(exc, Exception):
                        raise  # cancellation propagates
                    rsp = None
                if rsp is None:
                    self._ka = None
                    if attempt == 0:
                        continue  # stream was stale; retry on a fresh one
                    raise EtcdError("lease keepalive stream closed")
                return rsp
        raise AssertionError("unreachable")

    async def call(self, req: tuple):
        """The SimServer._apply dispatch, against the real wire."""
        from ...grpc import Status as GrpcStatus

        ns = self._ns
        ch = self._chan.chan
        kind = req[0]
        try:
            if kind == "put":
                r = await ch.unary(
                    "/etcdserverpb.KV/Put",
                    ns.PutRequest(key=req[1], value=req[2], lease=req[3], prev_kv=req[4]),
                )
                return {
                    "revision": r.header.revision,
                    "prev_kv": _kv_from_pb(r.prev_kv) if r.HasField("prev_kv") else None,
                }
            if kind == "get":
                r = await ch.unary(
                    "/etcdserverpb.KV/Range",
                    ns.RangeRequest(
                        key=req[1], range_end=req[2], limit=req[3],
                        count_only=req[4], keys_only=req[5],
                    ),
                )
                return {
                    "revision": r.header.revision,
                    "kvs": [] if req[4] else [_kv_from_pb(kv) for kv in r.kvs],
                    "count": r.count,
                }
            if kind == "delete":
                r = await ch.unary(
                    "/etcdserverpb.KV/DeleteRange",
                    ns.DeleteRangeRequest(key=req[1], range_end=req[2], prev_kv=req[3]),
                )
                return {
                    "revision": r.header.revision,
                    "deleted": r.deleted,
                    "prev_kvs": [_kv_from_pb(kv) for kv in r.prev_kvs],
                }
            if kind == "txn":
                r = await ch.unary(
                    "/etcdserverpb.KV/Txn",
                    ns.TxnRequest(
                        compare=[_compare_pb(ns, c) for c in req[1]],
                        success=[_request_op_pb(ns, o) for o in req[2]],
                        failure=[_request_op_pb(ns, o) for o in req[3]],
                    ),
                )
                return {
                    "revision": r.header.revision,
                    "succeeded": r.succeeded,
                    "responses": [_response_op_sim(op) for op in r.responses],
                }
            if kind == "compact":
                r = await ch.unary(
                    "/etcdserverpb.KV/Compact", ns.CompactionRequest(revision=req[1])
                )
                return {"revision": r.header.revision, "compact_revision": req[1]}
            if kind == "lease_grant":
                r = await ch.unary(
                    "/etcdserverpb.Lease/LeaseGrant",
                    ns.LeaseGrantRequest(TTL=req[1], ID=req[2]),
                )
                if r.error:
                    raise EtcdError(r.error)
                return {"id": r.ID, "ttl": r.TTL}
            if kind == "lease_revoke":
                r = await ch.unary(
                    "/etcdserverpb.Lease/LeaseRevoke", ns.LeaseRevokeRequest(ID=req[1])
                )
                return {"revision": r.header.revision}
            if kind == "lease_keep_alive":
                rsp = await self._keep_alive_once(req[1])
                if rsp.TTL <= 0:
                    raise EtcdError("etcdserver: requested lease not found")
                return {"id": rsp.ID, "ttl": rsp.TTL}
            if kind == "lease_time_to_live":
                r = await ch.unary(
                    "/etcdserverpb.Lease/LeaseTimeToLive",
                    ns.LeaseTimeToLiveRequest(ID=req[1], keys=True),
                )
                if r.TTL < 0:
                    raise EtcdError("etcdserver: requested lease not found")
                return {"id": r.ID, "granted_ttl": r.grantedTTL, "ttl": r.TTL,
                        "keys": [bytes(k) for k in r.keys]}
            if kind == "lease_list":
                r = await ch.unary(
                    "/etcdserverpb.Lease/LeaseLeases", ns.LeaseLeasesRequest()
                )
                return {"leases": sorted(s.ID for s in r.leases)}
            if kind == "campaign":
                # genuine Campaign blocks until leadership; the Client's
                # poll loop then sees is_leader on the first iteration
                r = await ch.unary(
                    "/v3electionpb.Election/Campaign",
                    ns.CampaignRequest(name=req[1], value=req[2], lease=req[3]),
                )
                return {
                    "leader": _leader_key_sim(r.leader),
                    "is_leader": True,
                    "value": req[2],
                }
            if kind == "leader":
                r = await ch.unary(
                    "/v3electionpb.Election/Leader", ns.LeaderRequest(name=req[1])
                )
                kv = r.kv
                return {
                    "leader": {"name": req[1], "key": bytes(kv.key),
                               "rev": kv.create_revision, "lease": kv.lease},
                    "is_leader": False,
                    "value": bytes(kv.value),
                }
            if kind == "proclaim":
                await ch.unary(
                    "/v3electionpb.Election/Proclaim",
                    ns.ProclaimRequest(leader=_leader_key_pb(ns, req[1]), value=req[2]),
                )
                return {"ok": True}
            if kind == "resign":
                await ch.unary(
                    "/v3electionpb.Election/Resign",
                    ns.ResignRequest(leader=_leader_key_pb(ns, req[1])),
                )
                return {"ok": True}
            if kind == "status":
                r = await ch.unary(
                    "/etcdserverpb.Maintenance/Status", ns.StatusRequest()
                )
                return {"version": r.version, "db_size": r.dbSize,
                        "revision": r.header.revision}
            if kind in ("dump", "load"):
                raise EtcdError(f"{kind} is sim-only (a genuine etcd has no TOML state API)")
            raise EtcdError(f"unknown request {kind}")
        except GrpcStatus as st:
            raise EtcdError(st.message or f"etcd rpc failed (code {st.code})") from None

    async def watch(self, lo: bytes, hi: bytes, opts: dict) -> RealWatcher:
        import asyncio

        ns = self._ns
        filters = []
        if "noput" in opts.get("filters", ()):
            filters.append(0)
        if "nodelete" in opts.get("filters", ()):
            filters.append(1)
        create = ns.WatchCreateRequest(
            key=lo, range_end=hi,
            start_revision=opts.get("start_revision", 0),
            progress_notify=opts.get("progress_notify", False),
            prev_kv=opts.get("prev_kv", False),
            filters=filters,
        )
        q: asyncio.Queue = asyncio.Queue()
        await q.put(ns.WatchRequest(create_request=create))

        async def feed():
            while True:
                item = await q.get()
                if item is None:
                    return
                yield item

        stream = await self._chan.chan.streaming("/etcdserverpb.Watch/Watch", feed())
        head = await stream.message()
        if head is not None and head.compact_revision:
            raise EtcdError(
                f"required revision has been compacted (compact_revision "
                f"{head.compact_revision})"
            )
        if head is None or not head.created:
            raise EtcdError(f"watch failed: {head}")
        return RealWatcher(ns, q, stream)

    async def observe(self, name: bytes) -> RealObserver:
        ns = self._ns
        stream = await self._chan.chan.server_streaming(
            "/v3electionpb.Election/Observe", ns.LeaderRequest(name=name)
        )
        return RealObserver(stream, name)


class RealChannelHolder:
    """Tiny indirection so the backend survives channel recreation."""

    def __init__(self, chan):
        self.chan = chan


async def try_connect_real(endpoints: Sequence[str], probe_timeout: float = 2.0) -> Optional[RealEtcdBackend]:
    """Probe each endpoint for a genuine etcd; None -> caller falls back
    to the sim-protocol server (the reference's dual behavior)."""
    for ep in endpoints:
        target = ep if isinstance(ep, str) else f"{ep[0]}:{ep[1]}"
        try:
            return await RealEtcdBackend.connect(target, probe_timeout)
        except Exception:
            continue
    return None
