"""Simulated Kafka — broker + producer/consumer/admin clients
(reference: madsim-rdkafka sim side, src/sim/).

`Broker` keeps topics/partitions with offsets, watermarks and
timestamp->offset lookup (reference: src/sim/broker.rs:12-60);
`SimBroker` serves the request protocol {CreateTopic, Produce, Fetch,
FetchMetadata, FetchWatermarks, OffsetsForTimes}
(reference: src/sim/sim_broker.rs:14-77). Client surface:
`ClientConfig` (string-keyed, reference: src/sim/config.rs),
`BaseProducer` (buffered + flush + fake transactions,
reference: src/sim/producer/base_producer.rs:154-330), `FutureProducer`
(delivery future, future_producer.rs:191-300), `BaseConsumer` /
`StreamConsumer` with assign/seek/poll/stream
(reference: src/sim/consumer.rs:50-470), `AdminClient` (src/sim/admin.rs).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

from ...dual import rand, time as sim_time  # mode-selected (sim or asyncio)
from ...errors import SimError
from ...net.network import ConnectionReset, parse_addr
from ...dual import net as _dual_net
from ...dual import task as _dual_task

Endpoint = _dual_net.Endpoint
spawn = _dual_task.spawn
from ...net.rpc import hash_str
from .._conn import StreamCaller

__all__ = [
    "KafkaError",
    "ErrorCode",
    "Broker",
    "SimBroker",
    "ClientConfig",
    "BaseProducer",
    "FutureProducer",
    "BaseConsumer",
    "StreamConsumer",
    "AdminClient",
    "NewTopic",
    "Offset",
    "Message",
]


class ErrorCode:
    """rdkafka-style error codes (reference: RDKafkaErrorCode; apps match
    on these, not on message strings)."""

    UNKNOWN_TOPIC_OR_PART = "UnknownTopicOrPartition"
    TOPIC_ALREADY_EXISTS = "TopicAlreadyExists"
    MSG_SIZE_TOO_LARGE = "MessageSizeTooLarge"
    OFFSET_OUT_OF_RANGE = "OffsetOutOfRange"
    INVALID_ARG = "InvalidArgument"
    TIMED_OUT = "TimedOut"
    INVALID_TXN_STATE = "InvalidTxnState"
    UNKNOWN_GROUP = "UnknownGroup"
    UNKNOWN_MEMBER_ID = "UnknownMemberId"
    ILLEGAL_GENERATION = "IllegalGeneration"
    REBALANCE_IN_PROGRESS = "RebalanceInProgress"
    FAIL = "Fail"


class KafkaError(SimError):
    def __init__(self, message: str, code: str = ErrorCode.FAIL):
        super().__init__(message)
        self.code = code


class Message:
    """A delivered record (reference: BorrowedMessage surface, incl.
    headers — src/sim/producer records carry OwnedHeaders)."""

    __slots__ = ("topic", "partition", "offset", "key", "payload", "timestamp", "headers")

    def __init__(self, topic: str, partition: int, offset: int, key: Optional[bytes], payload: Optional[bytes], timestamp: int, headers: Optional[List[Tuple[str, bytes]]] = None):
        self.topic = topic
        self.partition = partition
        self.offset = offset
        self.key = key
        self.payload = payload
        self.timestamp = timestamp
        self.headers = headers or []

    def __repr__(self) -> str:  # pragma: no cover
        return f"Message({self.topic}[{self.partition}]@{self.offset})"


class Offset:
    """Seek positions (reference: rdkafka Offset enum)."""

    Beginning = "beginning"
    End = "end"
    Stored = "stored"  # the group's committed offset (needs group.id)

    @staticmethod
    def at(n: int) -> int:
        return n


class NewTopic:
    def __init__(self, name: str, num_partitions: int = 1):
        self.name = name
        self.num_partitions = num_partitions


# -- broker state (reference: src/sim/broker.rs) ------------------------------


class _GroupMember:
    __slots__ = ("topics", "last_hb_ms", "session_ms")

    def __init__(self, topics: Sequence[str], now_ms: int, session_ms: int):
        self.topics = list(topics)
        self.last_hb_ms = now_ms
        self.session_ms = session_ms


class _Group:
    """Consumer-group coordinator state: generation-fenced membership
    with broker-computed assignments (the classic-protocol subset:
    join/sync/heartbeat/leave, range or roundrobin strategy)."""

    __slots__ = ("generation", "members", "assignments", "next_member", "strategy")

    def __init__(self) -> None:
        self.generation = 0
        self.members: Dict[str, _GroupMember] = {}
        self.assignments: Dict[str, List[Tuple[str, int]]] = {}
        self.next_member = 0
        self.strategy = "range"


class Partition:
    __slots__ = ("records",)

    def __init__(self) -> None:
        # list of (key, payload, timestamp_ms, headers); offset == index
        self.records: List[Tuple[Optional[bytes], Optional[bytes], int, list]] = []

    @property
    def high_watermark(self) -> int:
        return len(self.records)


class Broker:
    """Reference: broker.rs:12-60 (+ committed-offset store and a
    consumer-group coordinator — classic-protocol subset with
    join/sync/heartbeat/leave, range/roundrobin assignment,
    session-timeout eviction and generation-fenced commits; the
    reference sim has no groups at all)."""

    def __init__(self, message_max_bytes: int = 1_000_000,
                 expire_on_traffic: bool = True) -> None:
        self.topics: Dict[str, List[Partition]] = {}
        self._rr: Dict[str, int] = {}
        self.message_max_bytes = message_max_bytes
        # (group, topic, partition) -> committed offset
        self.committed_offsets: Dict[Tuple[str, str, int], int] = {}
        self.groups: Dict[str, _Group] = {}
        # True (default): member expiry sweeps on member traffic, like a
        # coordinator checking sessions inline. False: expiry runs ONLY
        # via sweep_expired() — the timer-driven coordinator model, used
        # by the cross-engine differential to align eviction moments
        # with the device machine's session tick exactly.
        self.expire_on_traffic = expire_on_traffic

    def create_topic(self, name: str, partitions: int) -> None:
        if name in self.topics:
            raise KafkaError(
                f"topic already exists: {name}", ErrorCode.TOPIC_ALREADY_EXISTS
            )
        if partitions < 1:
            raise KafkaError("partitions must be >= 1", ErrorCode.INVALID_ARG)
        self.topics[name] = [Partition() for _ in range(partitions)]
        self._rr[name] = 0
        # groups with members already subscribed to this topic rebalance
        # to pick up its partitions (rdkafka: subscribing to a
        # not-yet-created topic is not fatal — a metadata refresh assigns
        # it once it exists; members learn via the heartbeat fence)
        for g in self.groups.values():
            if any(name in m.topics for m in g.members.values()):
                self._rebalance(g)

    def _partition(self, topic: str, partition: int) -> Partition:
        parts = self.topics.get(topic)
        if parts is None:
            raise KafkaError(f"unknown topic: {topic}", ErrorCode.UNKNOWN_TOPIC_OR_PART)
        if not (0 <= partition < len(parts)):
            raise KafkaError(
                f"unknown partition: {topic}[{partition}]",
                ErrorCode.UNKNOWN_TOPIC_OR_PART,
            )
        return parts[partition]

    def pick_partition(self, topic: str, key: Optional[bytes]) -> int:
        parts = self.topics.get(topic)
        if parts is None:
            raise KafkaError(f"unknown topic: {topic}", ErrorCode.UNKNOWN_TOPIC_OR_PART)
        if key is not None:
            return hash_str(key.decode("latin1")) % len(parts)
        idx = self._rr[topic] % len(parts)
        self._rr[topic] += 1
        return idx

    def produce(self, topic: str, partition: Optional[int], key: Optional[bytes], payload: Optional[bytes], ts_ms: int, headers: Optional[list] = None) -> Tuple[int, int]:
        size = len(key or b"") + len(payload or b"")
        if size > self.message_max_bytes:
            raise KafkaError(
                f"message size {size} > message.max.bytes {self.message_max_bytes}",
                ErrorCode.MSG_SIZE_TOO_LARGE,
            )
        if partition is None or partition < 0:
            partition = self.pick_partition(topic, key)
        part = self._partition(topic, partition)
        part.records.append((key, payload, ts_ms, list(headers or [])))
        return partition, len(part.records) - 1

    def fetch(self, topic: str, partition: int, offset: int, max_records: int) -> List[Message]:
        part = self._partition(topic, partition)
        out = []
        for off in range(max(0, offset), min(len(part.records), offset + max_records)):
            key, payload, ts, headers = part.records[off]
            out.append(Message(topic, partition, off, key, payload, ts, headers))
        return out

    def watermarks(self, topic: str, partition: int) -> Tuple[int, int]:
        part = self._partition(topic, partition)
        return (0, part.high_watermark)

    def offsets_for_time(self, topic: str, partition: int, ts_ms: int) -> Optional[int]:
        """First offset with timestamp >= ts_ms (reference: broker.rs
        timestamp->offset lookup)."""
        part = self._partition(topic, partition)
        for off, (_k, _p, ts, _h) in enumerate(part.records):
            if ts >= ts_ms:
                return off
        return None

    def metadata(self) -> Dict[str, int]:
        return {name: len(parts) for name, parts in self.topics.items()}

    # -- committed offsets (the consumer-group subset) --

    def commit_offsets(
        self,
        group: str,
        offsets: Dict[Tuple[str, int], int],
        member_id: Optional[str] = None,
        generation: Optional[int] = None,
        now_ms: int = 0,
    ) -> None:
        """With (member_id, generation), the commit is generation-fenced:
        a zombie member that missed a rebalance cannot clobber the new
        owner's progress (classic-protocol commit semantics). Without
        them, a simple consumer commits unfenced (real Kafka's
        generation -1 path)."""
        if not group:
            raise KafkaError("group.id required to commit", ErrorCode.UNKNOWN_GROUP)
        if member_id is not None:
            # timer-driven mode: commits validate but do NOT refresh the
            # session (heartbeat-only liveness)
            self._coord_group(group, member_id, now_ms,
                              generation, ErrorCode.ILLEGAL_GENERATION,
                              refresh=self.expire_on_traffic)
        for (topic, partition), off in offsets.items():
            self._partition(topic, partition)  # validates
            self.committed_offsets[(group, topic, partition)] = off

    def committed(self, group: str, topic: str, partition: int) -> Optional[int]:
        self._partition(topic, partition)
        return self.committed_offsets.get((group, topic, partition))

    # -- group coordinator (classic protocol subset) --

    def _rebalance(self, g: _Group) -> None:
        g.generation += 1
        g.assignments = {m: [] for m in g.members}
        members = sorted(g.members)
        topics = sorted({t for m in g.members.values() for t in m.topics})
        if g.strategy == "roundrobin":
            # one circular pass over ALL topic-partitions (Kafka's
            # RoundRobinAssignor: interleaving per topic would hand every
            # single-partition topic to the same first member)
            idx = 0
            for topic in topics:
                parts = self.topics.get(topic)
                if parts is None or not any(
                    topic in g.members[m].topics for m in members
                ):
                    continue
                for p in range(len(parts)):
                    while topic not in g.members[members[idx % len(members)]].topics:
                        idx += 1
                    g.assignments[members[idx % len(members)]].append((topic, p))
                    idx += 1
            return
        for topic in topics:
            parts = self.topics.get(topic)
            if parts is None:
                continue
            subs = [m for m in members if topic in g.members[m].topics]
            if not subs:
                continue
            # range: contiguous chunks per topic; the first n % m members
            # get one extra partition (real range-assignor arithmetic)
            base, extra = divmod(len(parts), len(subs))
            start = 0
            for idx, m in enumerate(subs):
                take = base + (1 if idx < extra else 0)
                for p in range(start, start + take):
                    g.assignments[m].append((topic, p))
                start += take

    def _expire_members(self, g: _Group, now_ms: int) -> None:
        dead = [
            m for m, info in g.members.items()
            if now_ms - info.last_hb_ms > info.session_ms
        ]
        for m in dead:
            del g.members[m]
        if dead:
            self._rebalance(g)

    def sweep_expired(self, group: str, now_ms: int) -> None:
        """Timer-driven expiry sweep: evict members whose sessions
        lapsed and rebalance (the coordinator's periodic job; with
        `expire_on_traffic=False` this is the ONLY eviction path)."""
        g = self.groups.get(group)
        if g is not None:
            self._expire_members(g, now_ms)

    def join_group(
        self,
        group: str,
        member_id: Optional[str],
        topics: Sequence[str],
        session_ms: int,
        strategy: str,
        now_ms: int,
    ) -> Tuple[str, int]:
        if not group:
            raise KafkaError("group.id required to join", ErrorCode.UNKNOWN_GROUP)
        g = self.groups.setdefault(group, _Group())
        if self.expire_on_traffic:
            self._expire_members(g, now_ms)
        if not g.members and strategy:
            g.strategy = strategy  # first joiner picks the strategy
        if member_id is None or member_id not in g.members:
            if member_id is None:
                member_id = f"{group}-member-{g.next_member}"
                g.next_member += 1
            g.members[member_id] = _GroupMember(topics, now_ms, session_ms)
            self._rebalance(g)
        else:
            mem = g.members[member_id]
            mem.last_hb_ms = now_ms
            if sorted(mem.topics) != sorted(topics):
                mem.topics = list(topics)
                self._rebalance(g)
            # plain re-join after a rebalance notice: current generation
        return member_id, g.generation

    def sync_group(self, group: str, member_id: str, generation: int, now_ms: int) -> List[Tuple[str, int]]:
        g = self._coord_group(group, member_id, now_ms, generation)
        return list(g.assignments.get(member_id, []))

    def heartbeat(self, group: str, member_id: str, generation: int, now_ms: int) -> None:
        self._coord_group(group, member_id, now_ms, generation)

    def leave_group(self, group: str, member_id: str, now_ms: int) -> None:
        g = self.groups.get(group)
        if g is None:
            return
        if member_id in g.members:
            del g.members[member_id]
            self._rebalance(g)
        if self.expire_on_traffic:
            self._expire_members(g, now_ms)

    def describe_group(self, group: str, now_ms: int = 0) -> dict:
        g = self.groups.get(group)
        if g is None:
            raise KafkaError(f"unknown group: {group}", ErrorCode.UNKNOWN_GROUP)
        # reflect session-timeout semantics even when no member traffic
        # triggers eviction (a dead group would otherwise show its
        # corpse's assignments forever)
        if self.expire_on_traffic:
            self._expire_members(g, now_ms)
        return {
            "generation": g.generation,
            "strategy": g.strategy,
            "members": {m: list(info.topics) for m, info in g.members.items()},
            "assignments": {m: list(a) for m, a in g.assignments.items()},
        }

    def _coord_group(
        self,
        group: str,
        member_id: str,
        now_ms: int,
        generation: Optional[int] = None,
        stale_code: str = ErrorCode.REBALANCE_IN_PROGRESS,
        refresh: bool = True,
    ) -> _Group:
        """Resolve + expire the group, validate the member, and (when
        `generation` is given) fence it — the single fencing path for
        sync/heartbeat/fenced-commit. A live check refreshes the
        member's heartbeat clock — except commits in timer-driven mode
        (`refresh=False`): there session liveness is heartbeat-only, so
        an in-flight commit from a dying member cannot stretch its
        session past what the heartbeat record supports."""
        g = self.groups.get(group)
        if g is not None and self.expire_on_traffic:
            self._expire_members(g, now_ms)
        if g is None or member_id not in g.members:
            raise KafkaError(f"unknown member: {member_id}", ErrorCode.UNKNOWN_MEMBER_ID)
        if generation is not None and generation != g.generation:
            raise KafkaError(
                f"generation {generation} != {g.generation}", stale_code
            )
        if refresh:
            g.members[member_id].last_hb_ms = now_ms
        return g


# -- server --------------------------------------------------------------------


class SimBroker:
    """Reference: sim_broker.rs:14-77.

    `message_max_bytes` is the broker-side limit (like a real broker's
    message.max.bytes); the client's ClientConfig key of the same name is
    its own produce-time check — raise BOTH to ship larger messages."""

    def __init__(self, message_max_bytes: int = 1_000_000) -> None:
        self.broker = Broker(message_max_bytes=message_max_bytes)

    async def serve(self, addr: Any, on_bound=None) -> None:
        ep = await Endpoint.bind(addr)
        if on_bound is not None:
            on_bound(ep)
        while True:
            tx, rx, _peer = await ep.accept1()
            spawn(self._handle(tx, rx), name="kafka-conn")

    async def _handle(self, tx, rx) -> None:
        b = self.broker
        try:
            while (req := await rx.recv()) is not None:
                kind = req[0]
                now_ms = int(sim_time.now() * 1000)  # one clock per request
                try:
                    if kind == "create_topic":
                        b.create_topic(req[1], req[2])
                        rsp: Any = None
                    elif kind == "produce":
                        rsp = b.produce(req[1], req[2], req[3], req[4], req[5], req[6])
                    elif kind == "fetch":
                        rsp = b.fetch(req[1], req[2], req[3], req[4])
                    elif kind == "metadata":
                        rsp = b.metadata()
                    elif kind == "watermarks":
                        rsp = b.watermarks(req[1], req[2])
                    elif kind == "offsets_for_time":
                        rsp = b.offsets_for_time(req[1], req[2], req[3])
                    elif kind == "commit_offsets":
                        if len(req) > 3:  # generation-fenced commit
                            b.commit_offsets(req[1], req[2], req[3], req[4],
                                             now_ms=now_ms)
                        else:
                            b.commit_offsets(req[1], req[2])
                        rsp = None
                    elif kind == "committed":
                        rsp = b.committed(req[1], req[2], req[3])
                    elif kind == "join_group":
                        rsp = b.join_group(req[1], req[2], req[3], req[4], req[5], now_ms)
                    elif kind == "sync_group":
                        rsp = b.sync_group(req[1], req[2], req[3], now_ms)
                    elif kind == "heartbeat":
                        b.heartbeat(req[1], req[2], req[3], now_ms)
                        rsp = None
                    elif kind == "leave_group":
                        b.leave_group(req[1], req[2], now_ms)
                        rsp = None
                    elif kind == "describe_group":
                        rsp = b.describe_group(req[1], now_ms)
                    else:
                        raise KafkaError(f"unknown request {kind}", ErrorCode.INVALID_ARG)
                    tx.send(("ok", rsp))
                except KafkaError as e:
                    tx.send(("err", (e.code, str(e))))
        except ConnectionReset:
            pass
        finally:
            tx.close()  # real mode: one fd per connection must not linger


# -- client config (reference: src/sim/config.rs) -------------------------------


class ClientConfig:
    def __init__(self, conf: Optional[Dict[str, str]] = None):
        self.conf: Dict[str, str] = dict(conf or {})

    def set(self, key: str, value: str) -> "ClientConfig":
        self.conf[key] = value
        return self

    def get(self, key: str, default: str = "") -> str:
        return self.conf.get(key, default)

    def _addr(self):
        servers = self.conf.get("bootstrap.servers")
        if not servers:
            raise KafkaError("bootstrap.servers not set", ErrorCode.INVALID_ARG)
        return parse_addr(servers.split(",")[0])

    async def create_base_producer(self) -> "BaseProducer":
        return await BaseProducer._create(self)

    async def create_future_producer(self) -> "FutureProducer":
        p = FutureProducer()
        p._inner = await BaseProducer._create(self)
        return p

    async def create_base_consumer(self) -> "BaseConsumer":
        return await BaseConsumer._create(self)

    async def create_stream_consumer(self) -> "StreamConsumer":
        c = StreamConsumer()
        c.__dict__.update((await BaseConsumer._create(self)).__dict__)
        return c

    async def create_admin(self) -> "AdminClient":
        return await AdminClient._create(self)


class _Conn:
    """Broker connection handle over the shared StreamCaller (per-call
    channels in sim; a persistent locked stream in real mode — see
    services/_conn.py for the rationale)."""

    def __init__(self) -> None:
        self._caller = StreamCaller()
        # real mode with a genuine broker at bootstrap.servers: the data
        # plane speaks the genuine Kafka wire protocol natively
        # (real_client.RealKafkaConn, stdlib-only — the analogue of the
        # reference vendoring real rdkafka, madsim-rdkafka/src/lib.rs:5-12)
        self._real = None

    async def open(self, addr) -> None:
        from ...dual import IS_SIM, real_passthrough_enabled

        if not IS_SIM and real_passthrough_enabled():
            from .real_client import RealKafkaConn, probe_real_kafka

            host, port = addr
            if await probe_real_kafka(host, port):
                self._real = RealKafkaConn(f"{host}:{port}")
                return
        await self._caller.open(addr)

    # commit_offsets is value-idempotent: it overwrites the same absolute
    # offset, so re-sending after an ambiguous response loss cannot
    # duplicate anything (and not retrying makes auto-commit poll() skip
    # a delivered message whose position already advanced)
    # group ops: heartbeat/sync re-send the same generation check and
    # leave is a no-op on a gone member; join_group is NOT idempotent
    # when member_id is None (a re-send would register a ghost member)
    _IDEMPOTENT = {"fetch", "metadata", "watermarks", "offsets_for_time",
                   "committed", "commit_offsets", "heartbeat", "sync_group",
                   "leave_group", "describe_group"}

    def close(self) -> None:
        """Release the backend: the wire client's broker sockets or the
        sim-protocol stream fd (both teardown paths are non-blocking)."""
        real, self._real = self._real, None
        self._caller.close()
        if real is not None:
            real.close()

    async def call(self, req: tuple):
        if self._real is not None:
            return await self._real.call(req)
        rsp = await self._caller.call(req, idempotent=req[0] in self._IDEMPOTENT)
        if rsp is None:
            raise KafkaError("broker unavailable", ErrorCode.TIMED_OUT)
        status, payload = rsp
        if status == "err":
            code, msg = payload
            raise KafkaError(msg, code)
        return payload


# -- producers -------------------------------------------------------------------


class BaseRecord:
    """Reference: rdkafka BaseRecord/FutureRecord (+ OwnedHeaders as a
    plain list of (name, value) pairs)."""

    def __init__(self, topic: str, key: Optional[bytes] = None, payload: Optional[bytes] = None, partition: Optional[int] = None, timestamp: Optional[int] = None, headers: Optional[List[Tuple[str, bytes]]] = None):
        self.topic = topic
        self.key = key
        self.payload = payload
        self.partition = partition
        self.timestamp = timestamp
        self.headers = list(headers or [])


FutureRecord = BaseRecord


class BaseProducer:
    """Buffered producer: `send` queues locally, `flush` ships to the
    broker; fake transactions are buffer fences
    (reference: base_producer.rs:154-330)."""

    def __init__(self) -> None:
        self._conn = _Conn()
        self._buffer: List[BaseRecord] = []
        self._in_txn = False
        self._max_bytes = 1_000_000

    @staticmethod
    async def _create(cfg: ClientConfig) -> "BaseProducer":
        p = BaseProducer()
        await p._conn.open(cfg._addr())
        # rdkafka rejects oversized messages at produce() time, before
        # any broker round trip (config: message.max.bytes)
        p._max_bytes = int(cfg.get("message.max.bytes", "1000000"))
        return p

    def close(self) -> None:
        """Release the connection (genuine-lib clients or the sim fd)."""
        self._conn.close()

    def _check_size(self, record: BaseRecord) -> None:
        size = len(record.key or b"") + len(record.payload or b"")
        if size > self._max_bytes:
            raise KafkaError(
                f"message size {size} > message.max.bytes {self._max_bytes}",
                ErrorCode.MSG_SIZE_TOO_LARGE,
            )

    def send(self, record: BaseRecord) -> None:
        self._check_size(record)
        self._buffer.append(record)

    async def flush(self) -> List[Tuple[int, int]]:
        out = []
        buffered, self._buffer = self._buffer, []
        for r in buffered:
            ts = r.timestamp if r.timestamp is not None else int(sim_time.now() * 1000)
            out.append(await self._conn.call(("produce", r.topic, r.partition, r.key, r.payload, ts, r.headers)))
        return out

    # fake transactions (reference: base_producer.rs transactions are
    # acknowledged but not isolated)
    def init_transactions(self) -> None:
        pass

    def begin_transaction(self) -> None:
        if self._in_txn:
            raise KafkaError("transaction already in progress", ErrorCode.INVALID_TXN_STATE)
        self._in_txn = True

    async def commit_transaction(self) -> None:
        if not self._in_txn:
            raise KafkaError("no transaction in progress", ErrorCode.INVALID_TXN_STATE)
        await self.flush()
        self._in_txn = False

    def abort_transaction(self) -> None:
        self._buffer.clear()
        self._in_txn = False


class DeliveryFuture:
    """Reference: future_producer.rs `DeliveryFuture`.

    Delivery errors (timeouts, broker unreachable) surface to the
    awaiter, not as a simulation-aborting task panic."""

    def __init__(self, coro):

        async def captured():
            try:
                return ("ok", await coro)
            except Exception as exc:  # noqa: BLE001
                return ("err", exc)

        self._handle = spawn(captured(), name="kafka-delivery")

    def __await__(self):
        return self._await().__await__()

    async def _await(self):
        status, value = await self._handle
        if status == "err":
            raise value
        return value


class FutureProducer:
    """Reference: future_producer.rs:191-300."""

    def __init__(self) -> None:
        self._inner: Optional[BaseProducer] = None

    def close(self) -> None:
        if self._inner is not None:
            self._inner.close()

    def send(self, record: BaseRecord, timeout: Optional[float] = None) -> DeliveryFuture:
        async def deliver():
            self._inner._check_size(record)
            ts = record.timestamp if record.timestamp is not None else int(sim_time.now() * 1000)
            call = self._inner._conn.call(("produce", record.topic, record.partition, record.key, record.payload, ts, record.headers))
            if timeout is not None:
                return await sim_time.timeout(timeout, call)
            return await call

        return DeliveryFuture(deliver())

    async def send_and_wait(self, record: BaseRecord, timeout: Optional[float] = None) -> Tuple[int, int]:
        return await self.send(record, timeout)


# -- consumers --------------------------------------------------------------------


class BaseConsumer:
    """Manual-assignment consumer (reference: consumer.rs:50-470)."""

    def __init__(self) -> None:
        self._conn = _Conn()
        # (topic, partition) -> next offset
        self._positions: Dict[Tuple[str, int], int] = {}
        self._poll_interval = 0.01
        self._group = ""
        self._auto_commit = True
        self._auto_reset = "earliest"
        # group membership (classic protocol, driven from poll())
        self._member_id: Optional[str] = None
        self._generation = -1
        self._sub_topics: List[str] = []
        self._session_ms = 10_000
        self._hb_interval = 3.0
        self._strategy = "range"
        self._next_hb = 0.0

    @staticmethod
    async def _create(cfg: ClientConfig) -> "BaseConsumer":
        c = BaseConsumer()
        await c._conn.open(cfg._addr())
        c._auto_reset = cfg.get("auto.offset.reset", "earliest")
        c._group = cfg.get("group.id", "")
        c._auto_commit = cfg.get("enable.auto.commit", "true") not in ("false", "0")
        c._session_ms = int(cfg.get("session.timeout.ms", "10000"))
        c._hb_interval = int(cfg.get("heartbeat.interval.ms", "3000")) / 1000.0
        c._strategy = cfg.get("partition.assignment.strategy", "range")
        return c

    async def subscribe(self, topics: Sequence[str]) -> None:
        """With a `group.id`: join the consumer group — the broker's
        coordinator assigns this member a share of the partitions
        (range or roundrobin per `partition.assignment.strategy`) and
        rebalances as members join/leave/expire; each owned partition
        resumes from the group's committed offset. Without one: assign
        all partitions from `auto.offset.reset`."""
        meta = await self._conn.call(("metadata",))
        if self._group:
            # group mode: unknown topics are not fatal (rdkafka queues an
            # UNKNOWN_TOPIC_OR_PART event but keeps the subscription; the
            # broker rebalances us in when the topic is created)
            self._sub_topics = list(topics)
            await self._rejoin()
            return
        for t in topics:
            if t not in meta:
                raise KafkaError(f"unknown topic: {t}", ErrorCode.UNKNOWN_TOPIC_OR_PART)
        for t in topics:
            for partid in range(meta[t]):
                start: Union[str, int] = (
                    Offset.Beginning if self._auto_reset == "earliest" else Offset.End
                )
                await self.assign(t, partid, start)

    async def unsubscribe(self) -> None:
        """Leave the group (partitions move to the remaining members)."""
        if self._member_id is not None:
            await self._conn.call(("leave_group", self._group, self._member_id))
            self._member_id = None
            self._generation = -1
        self._positions.clear()
        self._sub_topics = []

    async def close(self) -> None:
        """Commit progress (auto-commit mode) and leave the group."""
        if self._member_id is not None and self._auto_commit and self._positions:
            try:
                await self._commit_positions(dict(self._positions))
            except KafkaError:
                pass  # mid-rebalance: the new owner resumes from the last commit
        await self.unsubscribe()
        self._conn.close()

    # -- group protocol plumbing (poll-driven, like rdkafka) --

    async def _rejoin(self) -> None:
        while True:
            mid, gen = await self._conn.call(
                ("join_group", self._group, self._member_id, list(self._sub_topics),
                 self._session_ms, self._strategy)
            )
            self._member_id, self._generation = mid, gen
            try:
                parts = await self._conn.call(("sync_group", self._group, mid, gen))
                break
            except KafkaError as e:
                if e.code != ErrorCode.REBALANCE_IN_PROGRESS:
                    raise
                # another member joined between our join and sync: loop
                # (not recursion — churny groups would grow the stack)
        old = self._positions
        self._positions = {}
        for (t, p) in parts:
            if (t, p) in old:
                self._positions[(t, p)] = old[(t, p)]  # keep live position
            else:
                await self.assign(t, p, Offset.Stored)
        self._next_hb = sim_time.monotonic() + self._hb_interval

    async def _heartbeat_tick(self) -> None:
        if self._member_id is None or sim_time.monotonic() < self._next_hb:
            return
        try:
            await self._conn.call(
                ("heartbeat", self._group, self._member_id, self._generation)
            )
            self._next_hb = sim_time.monotonic() + self._hb_interval
        except KafkaError as e:
            if e.code in (ErrorCode.REBALANCE_IN_PROGRESS, ErrorCode.ILLEGAL_GENERATION):
                await self._rejoin()
            elif e.code == ErrorCode.UNKNOWN_MEMBER_ID:
                # evicted: rejoin as a new member. In-memory positions are
                # stale — another member may have consumed and committed
                # past them while we were out; keeping them would rewind
                # the group's committed offsets on our next auto-commit.
                self._member_id = None
                self._positions.clear()
                await self._rejoin()
            else:
                raise

    async def _commit_positions(self, offsets: Dict[Tuple[str, int], int]) -> None:
        if self._member_id is not None:
            await self._conn.call(
                ("commit_offsets", self._group, offsets, self._member_id, self._generation)
            )
        else:
            await self._conn.call(("commit_offsets", self._group, offsets))

    async def assign(self, topic: str, partition: int, offset: Union[str, int] = Offset.Beginning) -> None:
        if offset == Offset.Stored:
            if not self._group:
                raise KafkaError("Offset.Stored needs group.id", ErrorCode.UNKNOWN_GROUP)
            stored = await self._conn.call(("committed", self._group, topic, partition))
            if stored is not None:
                self._positions[(topic, partition)] = stored
                return
            offset = Offset.Beginning if self._auto_reset == "earliest" else Offset.End
        lo, hi = await self._conn.call(("watermarks", topic, partition))
        if offset == Offset.Beginning:
            pos = lo
        elif offset == Offset.End:
            pos = hi
        else:
            pos = int(offset)
        self._positions[(topic, partition)] = pos

    async def seek(self, topic: str, partition: int, offset: Union[str, int]) -> None:
        if (topic, partition) not in self._positions:
            raise KafkaError(f"not assigned: {topic}[{partition}]", ErrorCode.INVALID_ARG)
        await self.assign(topic, partition, offset)

    # -- committed offsets (consumer-group subset) --

    async def commit(self) -> None:
        """Commit current positions to the broker for this group.id
        (generation-fenced when this consumer is a group member)."""
        if not self._group:
            raise KafkaError("commit needs group.id", ErrorCode.UNKNOWN_GROUP)
        await self._commit_positions(dict(self._positions))

    async def committed(self, topic: str, partition: int) -> Optional[int]:
        if not self._group:
            raise KafkaError("committed needs group.id", ErrorCode.UNKNOWN_GROUP)
        return await self._conn.call(("committed", self._group, topic, partition))

    async def poll(self, timeout: Optional[float] = None) -> Optional[Message]:
        """Next message across assigned partitions, or None on timeout.
        With group.id + enable.auto.commit, the new position is committed
        after each delivered message (interval-batching simplified to
        per-message; same observable at-least-once semantics)."""
        deadline = sim_time.monotonic() + timeout if timeout is not None else None
        while True:
            await self._heartbeat_tick()  # drives rebalances, like rdkafka
            for (topic, part), pos in sorted(self._positions.items()):
                msgs = await self._conn.call(("fetch", topic, part, pos, 1))
                if msgs:
                    self._positions[(topic, part)] = msgs[0].offset + 1
                    if self._group and self._auto_commit:
                        try:
                            await self._commit_positions(
                                {(topic, part): msgs[0].offset + 1}
                            )
                        except KafkaError as e:
                            if e.code in (ErrorCode.REBALANCE_IN_PROGRESS,
                                          ErrorCode.ILLEGAL_GENERATION,
                                          ErrorCode.UNKNOWN_MEMBER_ID):
                                # mid-rebalance: deliver the message
                                # (at-least-once) and rejoin on the next
                                # poll's heartbeat
                                self._next_hb = 0.0
                            else:
                                raise
                    return msgs[0]
            if deadline is not None and sim_time.monotonic() >= deadline:
                return None
            await sim_time.sleep(self._poll_interval)

    async def fetch_watermarks(self, topic: str, partition: int) -> Tuple[int, int]:
        return tuple(await self._conn.call(("watermarks", topic, partition)))

    async def offsets_for_timestamp(self, topic: str, partition: int, ts_ms: int) -> Optional[int]:
        return await self._conn.call(("offsets_for_time", topic, partition, ts_ms))

    async def fetch_metadata(self) -> Dict[str, int]:
        return await self._conn.call(("metadata",))


class StreamConsumer(BaseConsumer):
    """Reference: consumer.rs `StreamConsumer` (async recv/stream)."""

    async def recv(self) -> Message:
        msg = await self.poll(timeout=None)
        assert msg is not None
        return msg

    def stream(self):
        return self

    def __aiter__(self) -> "StreamConsumer":
        return self

    async def __anext__(self) -> Message:
        return await self.recv()


# -- admin -----------------------------------------------------------------------


class AdminClient:
    """Reference: src/sim/admin.rs."""

    def __init__(self) -> None:
        self._conn = _Conn()

    @staticmethod
    async def _create(cfg: ClientConfig) -> "AdminClient":
        a = AdminClient()
        await a._conn.open(cfg._addr())
        return a

    def close(self) -> None:
        self._conn.close()

    async def create_topics(self, topics: Sequence[NewTopic]) -> List[Tuple[str, Optional[str]]]:
        """Per-topic results, rdkafka-style: (name, None) on success or
        (name, error_string) — creating an existing topic is not fatal
        (reference: admin.rs TopicResult semantics)."""
        results: List[Tuple[str, Optional[str]]] = []
        for t in topics:
            try:
                await self._conn.call(("create_topic", t.name, t.num_partitions))
                results.append((t.name, None))
            except KafkaError as e:
                results.append((t.name, str(e)))
        return results

    async def describe_group(self, group: str) -> dict:
        """Coordinator view of a consumer group: generation, strategy,
        members with their subscriptions, and current assignments."""
        return await self._conn.call(("describe_group", group))
