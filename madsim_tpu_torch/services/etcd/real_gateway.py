"""EtcdGrpcGateway — the inverse of `real_client.py`: a genuine
etcd-wire gRPC server (etcdserverpb/mvccpb/v3electionpb over grpc.aio)
backed by the sim `EtcdService` state machine.

Used two ways:
  * in-process tests proving the real-client passthrough speaks the
    actual etcd protocol (tests/test_etcd_real.py) without needing an
    etcd binary;
  * `python -m madsim_tpu_torch serve --service etcd --grpc` — real-mode
    apps (or genuine etcd clients) get an etcd-compatible server whose
    semantics are bit-aligned with the simulated one (beyond the
    reference, whose SimServer exists only inside the sim).

Runs on asyncio (real mode); virtual-time has no meaning here, so lease
TTLs tick on wall-clock seconds like genuine etcd.
"""

from __future__ import annotations

import asyncio
import random
from typing import Optional

from ...grpc import Code, Status
from .service import EtcdError, EtcdService, Event
from .real_client import protos

__all__ = ["EtcdGrpcGateway"]

_CMP_OP = {0: "=", 1: ">", 2: "<", 3: "!="}
_CMP_TARGET = {0: "version", 1: "create_revision", 2: "mod_revision", 3: "value"}


class _Rng:
    def gen_range(self, lo: int, hi: int) -> int:
        # madsim: allow(D002) — real-gateway lease ids face real
        # clients; sim mode injects the seeded Rng instead
        return random.randrange(lo, hi)


def _err(e: EtcdError) -> Status:
    msg = str(e)
    code = Code.NOT_FOUND if "not found" in msg else (
        Code.OUT_OF_RANGE if "compacted" in msg else Code.UNKNOWN
    )
    return Status(code, msg)


class _Base:
    def __init__(self, gw: "EtcdGrpcGateway"):
        self.gw = gw
        self.ns = gw.ns
        self.svc = gw.svc

    def hdr(self):
        return self.ns.ResponseHeader(revision=self.svc.revision)

    def kv_pb(self, kv):
        return self.ns.KeyValue(
            key=kv.key, value=kv.value, create_revision=kv.create_revision,
            mod_revision=kv.mod_revision, version=kv.version, lease=kv.lease,
        )


class _KV(_Base):
    async def range(self, request):
        r = request.into_inner()
        try:
            out = self.svc.get(
                bytes(r.key), range_end=bytes(r.range_end), limit=r.limit,
                count_only=r.count_only, keys_only=r.keys_only,
            )
        except EtcdError as e:
            raise _err(e)
        return self.ns.RangeResponse(
            header=self.hdr(), kvs=[self.kv_pb(kv) for kv in out["kvs"]],
            count=out["count"],
        )

    async def put(self, request):
        r = request.into_inner()
        try:
            out = self.svc.put(bytes(r.key), bytes(r.value), lease=r.lease, prev_kv=r.prev_kv)
        except EtcdError as e:
            raise _err(e)
        rsp = self.ns.PutResponse(header=self.hdr())
        if out.get("prev_kv") is not None:
            rsp.prev_kv.CopyFrom(self.kv_pb(out["prev_kv"]))
        return rsp

    async def delete_range(self, request):
        r = request.into_inner()
        try:
            out = self.svc.delete(bytes(r.key), range_end=bytes(r.range_end), prev_kv=r.prev_kv)
        except EtcdError as e:
            raise _err(e)
        return self.ns.DeleteRangeResponse(
            header=self.hdr(), deleted=out["deleted"],
            prev_kvs=[self.kv_pb(kv) for kv in out["prev_kvs"]],
        )

    def _sim_compare(self, c):
        which = c.WhichOneof("target_union")
        operand = getattr(c, which) if which else 0
        if isinstance(operand, (bytes, bytearray, memoryview)):
            operand = bytes(operand)
        return (_CMP_TARGET[c.target], bytes(c.key), _CMP_OP[c.result], operand)

    def _sim_op(self, op):
        which = op.WhichOneof("request")
        if which == "request_put":
            p = op.request_put
            return ("put", bytes(p.key), bytes(p.value), p.lease)
        if which == "request_range":
            p = op.request_range
            return ("get", bytes(p.key), bytes(p.range_end))
        if which == "request_delete_range":
            p = op.request_delete_range
            return ("delete", bytes(p.key), bytes(p.range_end))
        raise Status(Code.UNIMPLEMENTED, f"txn op {which}")

    def _pb_response_op(self, kind, out):
        ns = self.ns
        if kind == "put":
            rsp = ns.PutResponse(header=ns.ResponseHeader(revision=out["revision"]))
            if out.get("prev_kv") is not None:
                rsp.prev_kv.CopyFrom(self.kv_pb(out["prev_kv"]))
            return ns.ResponseOp(response_put=rsp)
        if kind == "get":
            return ns.ResponseOp(response_range=ns.RangeResponse(
                header=ns.ResponseHeader(revision=out["revision"]),
                kvs=[self.kv_pb(kv) for kv in out["kvs"]], count=out["count"],
            ))
        return ns.ResponseOp(response_delete_range=ns.DeleteRangeResponse(
            header=ns.ResponseHeader(revision=out["revision"]), deleted=out["deleted"],
            prev_kvs=[self.kv_pb(kv) for kv in out["prev_kvs"]],
        ))

    async def txn(self, request):
        r = request.into_inner()
        try:
            out = self.svc.txn(
                [self._sim_compare(c) for c in r.compare],
                [self._sim_op(o) for o in r.success],
                [self._sim_op(o) for o in r.failure],
            )
        except EtcdError as e:
            raise _err(e)
        return self.ns.TxnResponse(
            header=self.hdr(), succeeded=out["succeeded"],
            responses=[self._pb_response_op(k, o) for k, o in out["responses"]],
        )

    async def compact(self, request):
        r = request.into_inner()
        try:
            self.svc.compact(r.revision)
        except EtcdError as e:
            raise _err(e)
        return self.ns.CompactionResponse(header=self.hdr())


class _Lease(_Base):
    async def lease_grant(self, request):
        r = request.into_inner()
        try:
            out = self.svc.lease_grant(r.TTL, r.ID)
        except EtcdError as e:
            return self.ns.LeaseGrantResponse(header=self.hdr(), error=str(e))
        return self.ns.LeaseGrantResponse(header=self.hdr(), ID=out["id"], TTL=out["ttl"])

    async def lease_revoke(self, request):
        try:
            self.svc.lease_revoke(request.into_inner().ID)
        except EtcdError as e:
            raise _err(e)
        return self.ns.LeaseRevokeResponse(header=self.hdr())

    async def lease_keep_alive(self, stream):
        while (req := await stream.message()) is not None:
            try:
                out = self.svc.lease_keep_alive(req.ID)
                yield self.ns.LeaseKeepAliveResponse(
                    header=self.hdr(), ID=out["id"], TTL=out["ttl"]
                )
            except EtcdError:
                # genuine etcd reports an expired lease as TTL=0, stream open
                yield self.ns.LeaseKeepAliveResponse(header=self.hdr(), ID=req.ID, TTL=0)

    async def lease_time_to_live(self, request):
        r = request.into_inner()
        try:
            out = self.svc.lease_time_to_live(r.ID)
        except EtcdError:
            return self.ns.LeaseTimeToLiveResponse(header=self.hdr(), ID=r.ID, TTL=-1)
        return self.ns.LeaseTimeToLiveResponse(
            header=self.hdr(), ID=out["id"], TTL=out["ttl"], grantedTTL=out["granted_ttl"],
            keys=out.get("keys", []),
        )

    async def lease_leases(self, request):
        out = self.svc.lease_list()
        return self.ns.LeaseLeasesResponse(
            header=self.hdr(),
            leases=[self.ns.LeaseStatus(ID=i) for i in out["leases"]],
        )


class _Watch(_Base):
    async def watch(self, stream):
        """One queue carries both client requests and store events, so
        there is a single await point (no racy cancellation of a
        half-consumed request iterator). Watches multiplex over the
        stream keyed by watch_id, like genuine etcd: each
        create_request gets its own id (client-chosen via
        WatchCreateRequest.watch_id or server-assigned), events carry
        it, and cancel_request tears down only that watch."""
        ns = self.ns
        q: asyncio.Queue = asyncio.Queue()
        # watch_id -> (svc watcher entry, filters, want_prev)
        watches: dict = {}
        next_id = [1]

        async def reader():
            while True:
                req = await stream.message()
                q.put_nowait(("req", req, None))
                if req is None:
                    return

        rt = asyncio.ensure_future(reader())
        try:
            while True:
                tag, item, wid = await q.get()
                if tag == "ev":
                    if wid not in watches:
                        continue  # canceled while queued
                    _entry, filters, want_prev = watches[wid]
                    ev = item
                    if ev.kind == Event.PUT and 0 in filters:
                        continue
                    if ev.kind == Event.DELETE and 1 in filters:
                        continue
                    pb = ns.Event(
                        type=1 if ev.kind == Event.DELETE else 0, kv=self.kv_pb(ev.kv)
                    )
                    if want_prev and ev.prev_kv is not None:
                        pb.prev_kv.CopyFrom(self.kv_pb(ev.prev_kv))
                    yield ns.WatchResponse(header=self.hdr(), watch_id=wid, events=[pb])
                    continue
                req = item
                if req is None:
                    return
                which = req.WhichOneof("request_union")
                if which == "create_request":
                    c = req.create_request
                    wid = c.watch_id or next_id[0]
                    if wid in watches:
                        # real etcd: re-using a live id cancels the
                        # request, never silently replaces the watcher
                        yield ns.WatchResponse(
                            header=self.hdr(), watch_id=wid, canceled=True,
                            cancel_reason="watcher with ID exists",
                        )
                        continue
                    next_id[0] = max(next_id[0], wid) + 1
                    lo, hi = bytes(c.key), bytes(c.range_end)
                    backlog = []
                    if c.start_revision:
                        try:
                            backlog = self.svc.history_since(c.start_revision, lo, hi)
                        except EtcdError:
                            yield ns.WatchResponse(
                                header=self.hdr(), watch_id=wid, canceled=True,
                                compact_revision=max(
                                    self.svc.compact_revision, self.svc.history_floor, 1
                                ),
                            )
                            continue
                    # snapshot -> register -> THEN yield: the yield
                    # suspends this generator (other tasks may mutate the
                    # store), so the watcher must exist before it or
                    # events in that window would be lost. No awaits
                    # between history_since and add_watcher => no gap,
                    # no duplicate.
                    entry = self.svc.add_watcher(
                        lo, hi, lambda ev, w=wid: q.put_nowait(("ev", ev, w))
                    )
                    watches[wid] = (entry, set(c.filters), c.prev_kv)
                    for ev in backlog:
                        q.put_nowait(("ev", ev, wid))
                    yield ns.WatchResponse(header=self.hdr(), watch_id=wid, created=True)
                elif which == "progress_request":
                    yield ns.WatchResponse(header=self.hdr(), watch_id=-1)
                elif which == "cancel_request":
                    wid = req.cancel_request.watch_id
                    if wid in watches:
                        self.svc.remove_watcher(watches.pop(wid)[0])
                    yield ns.WatchResponse(header=self.hdr(), watch_id=wid, canceled=True)
        finally:
            rt.cancel()
            for entry, _f, _p in watches.values():
                self.svc.remove_watcher(entry)


class _Election(_Base):
    def _lk(self, d):
        return self.ns.LeaderKey(
            name=d["name"], key=d["key"], rev=d["rev"], lease=d["lease"]
        )

    async def campaign(self, request):
        r = request.into_inner()
        # genuine etcd blocks until this candidate leads
        while True:
            try:
                info = self.svc.campaign(bytes(r.name), bytes(r.value), r.lease)
            except EtcdError as e:
                raise _err(e)
            if info["is_leader"]:
                return self.ns.CampaignResponse(
                    header=self.hdr(), leader=self._lk(info["leader"])
                )
            await asyncio.sleep(0.05)

    async def proclaim(self, request):
        r = request.into_inner()
        d = {"name": bytes(r.leader.name), "key": bytes(r.leader.key),
             "rev": r.leader.rev, "lease": r.leader.lease}
        try:
            self.svc.proclaim(d, bytes(r.value))
        except EtcdError as e:
            raise _err(e)
        return self.ns.ProclaimResponse(header=self.hdr())

    async def leader(self, request):
        try:
            info = self.svc.leader(bytes(request.into_inner().name))
        except EtcdError as e:
            raise _err(e)
        lk = info["leader"]
        return self.ns.LeaderResponse(
            header=self.hdr(),
            kv=self.ns.KeyValue(key=lk["key"], value=info["value"],
                                create_revision=lk["rev"], lease=lk["lease"]),
        )

    async def observe(self, request):
        name = bytes(request.into_inner().name)
        lo, hi = self.svc._election_prefix(name)
        q: asyncio.Queue = asyncio.Queue()
        entry = self.svc.add_watcher(lo, hi, q.put_nowait)
        try:
            info = self.svc.is_leader(name, b"")
            if info["leader"] is not None:
                yield self._leader_rsp(info)
            while True:
                await q.get()
                info = self.svc.is_leader(name, b"")
                if info["leader"] is not None:
                    yield self._leader_rsp(info)
        finally:
            self.svc.remove_watcher(entry)

    def _leader_rsp(self, info):
        lk = info["leader"]
        return self.ns.LeaderResponse(
            header=self.hdr(),
            kv=self.ns.KeyValue(key=lk["key"], value=info["value"],
                                create_revision=lk["rev"], lease=lk["lease"]),
        )

    async def resign(self, request):
        r = request.into_inner()
        d = {"name": bytes(r.leader.name), "key": bytes(r.leader.key),
             "rev": r.leader.rev, "lease": r.leader.lease}
        try:
            self.svc.resign(d)
        except EtcdError as e:
            raise _err(e)
        return self.ns.ResignResponse(header=self.hdr())


class _Maintenance(_Base):
    async def status(self, request):
        out = self.svc.status()
        return self.ns.StatusResponse(
            header=self.hdr(), version=out["version"], dbSize=out["db_size"]
        )


class EtcdGrpcGateway:
    """etcd-wire gRPC server over a sim `EtcdService`."""

    def __init__(self, history_limit: int = 10_000):
        self.ns = protos()
        self.svc = EtcdService(_Rng(), history_limit=history_limit)
        self._router = None
        self._tick_task: Optional[asyncio.Task] = None

    async def start(self, addr: str = "127.0.0.1:0") -> int:
        from ...grpc.real import RealRouter

        ns = self.ns
        self._router = (
            RealRouter()
            .add_service(ns.KVServer(_KV(self)))
            .add_service(ns.LeaseServer(_Lease(self)))
            .add_service(ns.WatchServer(_Watch(self)))
            .add_service(ns.ElectionServer(_Election(self)))
            .add_service(ns.MaintenanceServer(_Maintenance(self)))
        )
        port = await self._router.start(addr)

        async def tick():
            while True:
                await asyncio.sleep(1.0)
                self.svc.tick()

        self._tick_task = asyncio.ensure_future(tick())
        return port

    async def wait(self) -> None:
        """Block until the server terminates (public CLI surface)."""
        await self._router._server.wait_for_termination()

    async def serve(self, addr: str) -> None:
        await self.start(addr)
        await self.wait()

    async def stop(self) -> None:
        if self._tick_task is not None:
            self._tick_task.cancel()
        if self._router is not None:
            await self._router.stop()
