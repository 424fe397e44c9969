"""KafkaWireGateway — the genuine Kafka wire protocol served from the
sim `Broker` state machine over asyncio streams; the kafka twin of
`EtcdGrpcGateway` and `S3HttpGateway`, completing the passthrough
triad.

Real clients (kafka-python, librdkafka, or this repo's own
`KafkaWireClient`) can point at the gateway and produce/fetch/commit/
coordinate exactly as against a real broker: the gateway answers
ApiVersions, Metadata, Produce (v0-v3), Fetch (v0-v4), ListOffsets,
CreateTopics, FindCoordinator, OffsetCommit/Fetch, DescribeGroups and
the classic group protocol (JoinGroup/SyncGroup/Heartbeat/LeaveGroup)
with bit-accurate frames. Record payloads use RecordBatch v2 for
Fetch v4+ (headers preserved) and MessageSet v1 below that.

The group protocol is served with broker-side assignment: the sim
`Broker`'s coordinator (range/roundrobin, session-timeout eviction,
generation fencing) owns assignments, and SyncGroup returns them in
ConsumerProtocol form regardless of what a leader submitted — a genuine
client still sees a fully conformant join/sync/heartbeat cycle.

Reference: madsim-rdkafka's non-sim build vendors genuine rdkafka
(madsim-rdkafka/src/lib.rs:5-12); here the real-mode
surface is the broker side of the same wire.
"""

from __future__ import annotations

import asyncio
import struct
# madsim: allow-file(D001) — genuine-wire Kafka gateway: log append
# timestamps are protocol fields real clients read; real mode only.
import time
from typing import Dict, List, Optional, Tuple

from . import Broker, ErrorCode, KafkaError
from .wire import (
    ApiKey,
    Err,
    Reader,
    UnsupportedCodec,
    Writer,
    decode_record_blob,
    decode_subscription,
    encode_assignment,
    encode_message_set,
    encode_record_batch,
    encode_subscription,
)

__all__ = ["KafkaWireGateway"]

_CODE_MAP = {
    ErrorCode.UNKNOWN_TOPIC_OR_PART: Err.UNKNOWN_TOPIC_OR_PARTITION,
    ErrorCode.TOPIC_ALREADY_EXISTS: Err.TOPIC_ALREADY_EXISTS,
    ErrorCode.MSG_SIZE_TOO_LARGE: Err.MESSAGE_TOO_LARGE,
    ErrorCode.OFFSET_OUT_OF_RANGE: Err.OFFSET_OUT_OF_RANGE,
    ErrorCode.INVALID_ARG: Err.INVALID_REQUEST,
    ErrorCode.UNKNOWN_GROUP: Err.COORDINATOR_NOT_AVAILABLE,
    ErrorCode.UNKNOWN_MEMBER_ID: Err.UNKNOWN_MEMBER_ID,
    ErrorCode.ILLEGAL_GENERATION: Err.ILLEGAL_GENERATION,
    ErrorCode.REBALANCE_IN_PROGRESS: Err.REBALANCE_IN_PROGRESS,
}

# (api_key, min_version, max_version) advertised by ApiVersions; genuine
# clients pick call versions from these ranges (kafka-python infers a
# ~0.11-era broker, matching what the gateway actually parses).
_SUPPORTED: List[Tuple[int, int, int]] = [
    (ApiKey.PRODUCE, 0, 3),
    (ApiKey.FETCH, 0, 4),
    (ApiKey.LIST_OFFSETS, 0, 1),
    (ApiKey.METADATA, 0, 1),
    (ApiKey.OFFSET_COMMIT, 0, 2),
    (ApiKey.OFFSET_FETCH, 0, 1),
    (ApiKey.FIND_COORDINATOR, 0, 0),
    (ApiKey.JOIN_GROUP, 0, 1),
    (ApiKey.HEARTBEAT, 0, 0),
    (ApiKey.LEAVE_GROUP, 0, 0),
    (ApiKey.SYNC_GROUP, 0, 0),
    (ApiKey.DESCRIBE_GROUPS, 0, 0),
    (ApiKey.API_VERSIONS, 0, 0),
    (ApiKey.CREATE_TOPICS, 0, 0),
]

_NODE_ID = 0  # the gateway is a single-broker "cluster"


def _kafka_code(e: KafkaError) -> int:
    return _CODE_MAP.get(e.code, Err.INVALID_REQUEST)


class KafkaWireGateway:
    """Serve the genuine Kafka protocol from a sim Broker."""

    def __init__(self, broker: Optional[Broker] = None,
                 advertised_host: str = "127.0.0.1"):
        self.broker = broker if broker is not None else Broker()
        self.advertised_host = advertised_host
        self.advertised_port = 0  # set on start()
        self._server: Optional[asyncio.AbstractServer] = None
        self._writers: set = set()

    # -- lifecycle ----------------------------------------------------------

    async def start(self, addr: str = "127.0.0.1:0") -> int:
        host, _, port = addr.rpartition(":")
        self._server = await asyncio.start_server(
            self._conn, host or "127.0.0.1", int(port)
        )
        self.advertised_port = self._server.sockets[0].getsockname()[1]
        return self.advertised_port

    async def wait(self) -> None:
        await self._server.serve_forever()

    async def serve(self, addr: str) -> None:
        await self.start(addr)
        await self.wait()

    async def stop(self) -> None:
        for w in list(self._writers):
            w.close()
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()

    # -- connection loop ----------------------------------------------------

    async def _conn(self, reader: asyncio.StreamReader,
                    writer: asyncio.StreamWriter) -> None:
        self._writers.add(writer)
        try:
            while True:
                head = await reader.readexactly(4)
                (n,) = struct.unpack(">i", head)
                if n <= 0 or n > 64 * 1024 * 1024:
                    return
                frame = await reader.readexactly(n)
                r = Reader(frame)
                api_key = r.i16()
                api_version = r.i16()
                correlation_id = r.i32()
                _client_id = r.string()
                body = self._dispatch(api_key, api_version, r)
                if body is None:
                    continue  # acks=0 produce: real brokers send nothing
                rsp = struct.pack(">i", correlation_id) + body
                writer.write(struct.pack(">i", len(rsp)) + rsp)
                await writer.drain()
        except (asyncio.IncompleteReadError, ConnectionError, ValueError):
            pass
        finally:
            self._writers.discard(writer)
            writer.close()

    def _dispatch(self, api_key: int, v: int, r: Reader) -> bytes:
        now_ms = int(time.time() * 1000)
        if api_key == ApiKey.API_VERSIONS:
            # v1+ requests get UNSUPPORTED_VERSION in v0 encoding — the
            # standard downgrade dance (librdkafka opens with v3 and
            # retries with v0 on code 35); the version array still rides
            # along so the client can pick without a second round-trip
            return self._api_versions(
                Err.UNSUPPORTED_VERSION if v > 0 else Err.NONE
            )
        if api_key == ApiKey.METADATA:
            return self._metadata(v, r)
        if api_key == ApiKey.PRODUCE:
            return self._produce(v, r, now_ms)
        if api_key == ApiKey.FETCH:
            return self._fetch(v, r)
        if api_key == ApiKey.LIST_OFFSETS:
            return self._list_offsets(v, r)
        if api_key == ApiKey.CREATE_TOPICS:
            return self._create_topics(r)
        if api_key == ApiKey.FIND_COORDINATOR:
            return self._find_coordinator(r)
        if api_key == ApiKey.OFFSET_COMMIT:
            return self._offset_commit(v, r, now_ms)
        if api_key == ApiKey.OFFSET_FETCH:
            return self._offset_fetch(r)
        if api_key == ApiKey.DESCRIBE_GROUPS:
            return self._describe_groups(r, now_ms)
        if api_key == ApiKey.JOIN_GROUP:
            return self._join_group(v, r, now_ms)
        if api_key == ApiKey.SYNC_GROUP:
            return self._sync_group(r, now_ms)
        if api_key == ApiKey.HEARTBEAT:
            return self._heartbeat(r, now_ms)
        if api_key == ApiKey.LEAVE_GROUP:
            return self._leave_group(r, now_ms)
        # unknown api: an empty error response would desync framing —
        # close instead (matches broker behavior for unsupported keys)
        raise ValueError(f"unsupported api_key {api_key}")

    # -- api bodies ---------------------------------------------------------

    def _api_versions(self, code: int = Err.NONE) -> bytes:
        w = Writer().i16(code)
        w.array(_SUPPORTED, lambda t: w.i16(t[0]).i16(t[1]).i16(t[2]))
        return w.build()

    def _metadata(self, v: int, r: Reader) -> bytes:
        n = r.i32()
        topics = [t for t in (r.string() for _ in range(max(0, n))) if t is not None]
        # v0: null or empty array = all topics; v1+: null = all topics,
        # empty = NONE (the published semantics real clients rely on)
        if n < 0 or (v == 0 and n == 0):
            names = list(self.broker.topics)
        else:
            names = topics
        w = Writer()
        # brokers
        def broker_entry(_):
            w.i32(_NODE_ID).string(self.advertised_host).i32(self.advertised_port)
            if v >= 1:
                w.string(None)  # rack

        w.array([0], broker_entry)
        if v >= 1:
            w.i32(_NODE_ID)  # controller_id

        def topic_entry(name: str):
            parts = self.broker.topics.get(name)
            err = Err.NONE if parts is not None else Err.UNKNOWN_TOPIC_OR_PARTITION
            w.i16(err).string(name)
            if v >= 1:
                w.i8(0)  # is_internal
            plist = list(range(len(parts or ())))

            def part_entry(pid: int):
                w.i16(Err.NONE).i32(pid).i32(_NODE_ID)
                w.array([_NODE_ID], w.i32)  # replicas
                w.array([_NODE_ID], w.i32)  # isr

            w.array(plist, part_entry)

        w.array(names, topic_entry)
        return w.build()

    def _produce(self, v: int, r: Reader, now_ms: int) -> Optional[bytes]:
        if v >= 3:
            _txn_id = r.string()
        acks = r.i16()
        _timeout = r.i32()
        results: List[Tuple[str, List[Tuple[int, int, int]]]] = []
        for _ in range(r.i32()):
            topic = r.string() or ""
            parts: List[Tuple[int, int, int]] = []
            for _p in range(r.i32()):
                partition = r.i32()
                blob = r.bytes_() or b""
                try:
                    base = -1
                    for _off, key, value, ts_ms, headers in decode_record_blob(blob):
                        if ts_ms < 0:
                            ts_ms = now_ms
                        _pt, off = self.broker.produce(
                            topic, partition, key, value, ts_ms, headers
                        )
                        if base < 0:
                            base = off
                    parts.append((partition, Err.NONE, base))
                except UnsupportedCodec:
                    parts.append((partition, Err.CORRUPT_MESSAGE, -1))
                except KafkaError as e:
                    parts.append((partition, _kafka_code(e), -1))
            results.append((topic, parts))
        if acks == 0:
            return None  # fire-and-forget: a response would desync framing
        w = Writer()

        def topic_entry(item):
            topic, parts = item
            w.string(topic)

            def part_entry(p):
                partition, err, base = p
                w.i32(partition).i16(err).i64(base)
                if v >= 2:
                    w.i64(-1)  # log_append_time

            w.array(parts, part_entry)

        w.array(results, topic_entry)
        if v >= 1:
            w.i32(0)  # throttle_time_ms
        return w.build()

    def _fetch(self, v: int, r: Reader) -> bytes:
        _replica = r.i32()
        _max_wait = r.i32()
        _min_bytes = r.i32()
        if v >= 3:
            _max_bytes = r.i32()
        if v >= 4:
            _isolation = r.i8()
        reqs: List[Tuple[str, List[Tuple[int, int, int]]]] = []
        for _ in range(r.i32()):
            topic = r.string() or ""
            parts = []
            for _p in range(r.i32()):
                parts.append((r.i32(), r.i64(), r.i32()))
            reqs.append((topic, parts))
        w = Writer()
        if v >= 1:
            w.i32(0)  # throttle_time_ms

        def topic_entry(item):
            topic, parts = item
            w.string(topic)

            def part_entry(p):
                partition, offset, _max_bytes_p = p
                try:
                    msgs = self.broker.fetch(topic, partition, offset, 1000)
                    _lo, hi = self.broker.watermarks(topic, partition)
                    recs = [
                        (m.offset, m.key, m.payload, m.timestamp, m.headers)
                        for m in msgs
                    ]
                    blob = (
                        encode_record_batch(recs)
                        if v >= 4
                        else encode_message_set(recs)
                    )
                    w.i32(partition).i16(Err.NONE).i64(hi)
                    if v >= 4:
                        w.i64(hi)  # last_stable_offset (no txns)
                        w.array([], lambda a: None)  # aborted_transactions
                    w.bytes_(blob)
                except KafkaError as e:
                    w.i32(partition).i16(_kafka_code(e)).i64(-1)
                    if v >= 4:
                        w.i64(-1)
                        w.array([], lambda a: None)
                    w.bytes_(b"")

            w.array(parts, part_entry)

        w.array(reqs, topic_entry)
        return w.build()

    def _list_offsets(self, v: int, r: Reader) -> bytes:
        _replica = r.i32()
        reqs = []
        for _ in range(r.i32()):
            topic = r.string() or ""
            parts = []
            for _p in range(r.i32()):
                partition = r.i32()
                ts = r.i64()
                if v == 0:
                    _max_num = r.i32()
                parts.append((partition, ts))
            reqs.append((topic, parts))
        w = Writer()

        def topic_entry(item):
            topic, parts = item
            w.string(topic)

            def part_entry(p):
                partition, ts = p
                try:
                    lo, hi = self.broker.watermarks(topic, partition)
                    if ts == -2:  # earliest
                        off = lo
                    elif ts == -1:  # latest
                        off = hi
                    else:
                        got = self.broker.offsets_for_time(topic, partition, ts)
                        off = -1 if got is None else got
                    if v == 0:
                        w.i32(partition).i16(Err.NONE)
                        w.array([off] if off >= 0 else [], w.i64)
                    else:
                        w.i32(partition).i16(Err.NONE).i64(-1).i64(off)
                except KafkaError as e:
                    if v == 0:
                        w.i32(partition).i16(_kafka_code(e)).array([], w.i64)
                    else:
                        w.i32(partition).i16(_kafka_code(e)).i64(-1).i64(-1)

            w.array(parts, part_entry)

        w.array(reqs, topic_entry)
        return w.build()

    def _create_topics(self, r: Reader) -> bytes:
        results: List[Tuple[str, int]] = []
        for _ in range(r.i32()):
            name = r.string() or ""
            num_partitions = r.i32()
            _repl = r.i16()
            for _a in range(max(0, r.i32())):  # assignments
                r.i32()
                r.array(r.i32)
            for _c in range(max(0, r.i32())):  # configs
                r.string()
                r.string()
            try:
                self.broker.create_topic(name, num_partitions)
                results.append((name, Err.NONE))
            except KafkaError as e:
                code = (
                    Err.INVALID_PARTITIONS
                    if e.code == ErrorCode.INVALID_ARG
                    else _kafka_code(e)
                )
                results.append((name, code))
        _timeout = r.i32()
        w = Writer()
        w.array(results, lambda t: w.string(t[0]).i16(t[1]))
        return w.build()

    def _find_coordinator(self, r: Reader) -> bytes:
        _group = r.string()
        return (
            Writer()
            .i16(Err.NONE)
            .i32(_NODE_ID)
            .string(self.advertised_host)
            .i32(self.advertised_port)
            .build()
        )

    def _offset_commit(self, v: int, r: Reader, now_ms: int) -> bytes:
        group = r.string() or ""
        member_id = None
        generation = None
        if v >= 1:
            generation = r.i32()
            member_id = r.string()
        if v >= 2:
            _retention = r.i64()
        reqs = []
        for _ in range(r.i32()):
            topic = r.string() or ""
            parts = []
            for _p in range(r.i32()):
                partition = r.i32()
                offset = r.i64()
                if v == 1:
                    _ts = r.i64()
                _meta = r.string()
                parts.append((partition, offset))
            reqs.append((topic, parts))
        results = []
        for topic, parts in reqs:
            out = []
            for partition, offset in parts:
                try:
                    if member_id and generation is not None and generation >= 0:
                        self.broker.commit_offsets(
                            group, {(topic, partition): offset},
                            member_id, generation, now_ms=now_ms,
                        )
                    else:
                        self.broker.commit_offsets(
                            group, {(topic, partition): offset}
                        )
                    out.append((partition, Err.NONE))
                except KafkaError as e:
                    out.append((partition, _kafka_code(e)))
            results.append((topic, out))
        w = Writer()

        def topic_entry(item):
            topic, parts = item
            w.string(topic)
            w.array(parts, lambda p: w.i32(p[0]).i16(p[1]))

        w.array(results, topic_entry)
        return w.build()

    def _offset_fetch(self, r: Reader) -> bytes:
        group = r.string() or ""
        reqs = []
        for _ in range(r.i32()):
            topic = r.string() or ""
            parts = r.array(r.i32)
            reqs.append((topic, parts))
        w = Writer()

        def topic_entry(item):
            topic, parts = item
            w.string(topic)

            def part_entry(partition):
                try:
                    off = self.broker.committed(group, topic, partition)
                    w.i32(partition).i64(-1 if off is None else off)
                    w.string(None).i16(Err.NONE)
                except KafkaError as e:
                    w.i32(partition).i64(-1).string(None).i16(_kafka_code(e))

            w.array(parts, part_entry)

        w.array(reqs, topic_entry)
        return w.build()

    def _describe_groups(self, r: Reader, now_ms: int) -> bytes:
        groups = [g for g in r.array(r.string) if g is not None]
        w = Writer()

        def group_entry(group: str):
            try:
                info = self.broker.describe_group(group, now_ms)
            except KafkaError:
                # real brokers answer unknown groups as state "Dead"
                w.i16(Err.NONE).string(group).string("Dead")
                w.string("consumer").string("")
                w.array([], lambda m: None)
                return
            w.i16(Err.NONE).string(group).string("Stable")
            w.string("consumer").string(info["strategy"])

            def member_entry(item):
                member_id, topics = item
                w.string(member_id).string(member_id).string("/127.0.0.1")
                w.bytes_(encode_subscription(topics))
                w.bytes_(
                    encode_assignment(info["assignments"].get(member_id, []))
                )

            w.array(sorted(info["members"].items()), member_entry)

        w.array(groups, group_entry)
        return w.build()

    # -- classic group protocol --------------------------------------------

    def _join_group(self, v: int, r: Reader, now_ms: int) -> bytes:
        group = r.string() or ""
        session_ms = r.i32()
        if v >= 1:
            _rebalance_timeout = r.i32()
        member_id = r.string() or ""
        _protocol_type = r.string()
        protocols: List[Tuple[str, bytes]] = []
        for _ in range(r.i32()):
            pname = r.string() or ""
            pmeta = r.bytes_() or b""
            protocols.append((pname, pmeta))
        if not protocols:
            return Writer().i16(Err.INCONSISTENT_GROUP_PROTOCOL).i32(-1) \
                .string("").string("").string("").array([], lambda m: None).build()
        strategy, meta = protocols[0]
        topics = decode_subscription(meta)
        try:
            mid, generation = self.broker.join_group(
                group, member_id or None, topics, session_ms,
                strategy if strategy in ("range", "roundrobin") else "range",
                now_ms,
            )
        except KafkaError as e:
            return Writer().i16(_kafka_code(e)).i32(-1).string("") \
                .string("").string("").array([], lambda m: None).build()
        g = self.broker.groups[group]
        leader = sorted(g.members)[0]
        w = Writer()
        w.i16(Err.NONE).i32(generation).string(g.strategy)
        w.string(leader).string(mid)
        member_list = sorted(g.members.items()) if mid == leader else []

        def member_entry(item):
            m, info = item
            w.string(m).bytes_(encode_subscription(info.topics))

        w.array(member_list, member_entry)
        return w.build()

    def _sync_group(self, r: Reader, now_ms: int) -> bytes:
        group = r.string() or ""
        generation = r.i32()
        member_id = r.string() or ""
        for _ in range(r.i32()):  # leader-submitted assignments: broker-
            r.string()  #           side assignment is authoritative here
            r.bytes_()
        try:
            parts = self.broker.sync_group(group, member_id, generation, now_ms)
        except KafkaError as e:
            return Writer().i16(_kafka_code(e)).bytes_(b"").build()
        return Writer().i16(Err.NONE).bytes_(encode_assignment(parts)).build()

    def _heartbeat(self, r: Reader, now_ms: int) -> bytes:
        group = r.string() or ""
        generation = r.i32()
        member_id = r.string() or ""
        try:
            self.broker.heartbeat(group, member_id, generation, now_ms)
        except KafkaError as e:
            return Writer().i16(_kafka_code(e)).build()
        return Writer().i16(Err.NONE).build()

    def _leave_group(self, r: Reader, now_ms: int) -> bytes:
        group = r.string() or ""
        member_id = r.string() or ""
        try:
            self.broker.leave_group(group, member_id, now_ms)
        except KafkaError as e:
            return Writer().i16(_kafka_code(e)).build()
        return Writer().i16(Err.NONE).build()
