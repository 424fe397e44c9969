"""Genuine Kafka wire-protocol codec (stdlib-only).

The shared encoding layer for `wire_gateway.KafkaWireGateway` (serves
the real protocol from the sim `Broker`) and
`real_client.KafkaWireClient` (speaks it to genuine brokers) — the
madsim-rdkafka analogue: where the reference vendors the complete
genuine rdkafka API for its non-sim build
(madsim-rdkafka/src/lib.rs:5-12, src/std/), this build
implements the actual Kafka protocol natively so sim-tested code runs
against real brokers with no third-party client.

Covers the classic (non-flexible) protocol era every broker still
serves: int16-length strings, int32-length byte blobs, int32-count
arrays, and BOTH record formats —

* MessageSet v1 (magic 1, CRC-32/IEEE via zlib.crc32): Produce v0-v2 /
  Fetch v0-v3 payloads, what pre-0.11 clients speak;
* RecordBatch v2 (magic 2, CRC-32C, zigzag varints): Produce v3+ /
  Fetch v4+, the only format that carries record headers.

Schemas follow the published Kafka protocol guide (kafka.apache.org/
protocol); field order and sizes must match bit-for-bit to interoperate,
which is the entire point of this module.
"""

from __future__ import annotations

import struct
import zlib
from typing import Any, List, Optional, Sequence, Tuple

__all__ = [
    "ApiKey",
    "Err",
    "Reader",
    "Writer",
    "encode_message_set",
    "decode_record_blob",
    "encode_record_batch",
    "crc32c",
    "encode_subscription",
    "decode_subscription",
    "encode_assignment",
    "decode_assignment",
]


class ApiKey:
    PRODUCE = 0
    FETCH = 1
    LIST_OFFSETS = 2
    METADATA = 3
    OFFSET_COMMIT = 8
    OFFSET_FETCH = 9
    FIND_COORDINATOR = 10
    JOIN_GROUP = 11
    HEARTBEAT = 12
    LEAVE_GROUP = 13
    SYNC_GROUP = 14
    DESCRIBE_GROUPS = 15
    API_VERSIONS = 18
    CREATE_TOPICS = 19


MAX_DECOMPRESSED_BATCH = 64 * 1024 * 1024  # bound for peer-supplied gzip


class UnsupportedCodec(ValueError):
    """A record blob carries a compression codec this stdlib codec does
    not implement — surfaced loudly instead of decoding garbage."""


class Err:
    """Kafka numeric error codes (the subset this codec surfaces)."""

    NONE = 0
    OFFSET_OUT_OF_RANGE = 1
    CORRUPT_MESSAGE = 2
    UNKNOWN_TOPIC_OR_PARTITION = 3
    NOT_LEADER_FOR_PARTITION = 6
    MESSAGE_TOO_LARGE = 10
    COORDINATOR_NOT_AVAILABLE = 15
    NOT_COORDINATOR = 16
    ILLEGAL_GENERATION = 22
    INCONSISTENT_GROUP_PROTOCOL = 23
    UNKNOWN_MEMBER_ID = 25
    INVALID_SESSION_TIMEOUT = 26
    REBALANCE_IN_PROGRESS = 27
    TOPIC_ALREADY_EXISTS = 36
    INVALID_PARTITIONS = 37
    INVALID_REQUEST = 42
    UNSUPPORTED_VERSION = 35


# -- primitive readers/writers ------------------------------------------------


class Reader:
    """Sequential big-endian reader over one frame."""

    __slots__ = ("buf", "pos")

    def __init__(self, buf: bytes, pos: int = 0):
        self.buf = buf
        self.pos = pos

    def _take(self, n: int) -> bytes:
        if n < 0:
            raise ValueError(f"negative read of {n} at {self.pos}")
        b = self.buf[self.pos : self.pos + n]
        if len(b) < n:
            raise ValueError(f"frame truncated at {self.pos}+{n}")
        self.pos += n
        return b

    def i8(self) -> int:
        return struct.unpack(">b", self._take(1))[0]

    def i16(self) -> int:
        return struct.unpack(">h", self._take(2))[0]

    def i32(self) -> int:
        return struct.unpack(">i", self._take(4))[0]

    def i64(self) -> int:
        return struct.unpack(">q", self._take(8))[0]

    def u32(self) -> int:
        return struct.unpack(">I", self._take(4))[0]

    def string(self) -> Optional[str]:
        n = self.i16()
        if n < 0:
            return None
        return self._take(n).decode("utf-8")

    def bytes_(self) -> Optional[bytes]:
        n = self.i32()
        if n < 0:
            return None
        return self._take(n)

    def array(self, elem) -> list:
        n = self.i32()
        if n < 0:
            return []
        return [elem() for _ in range(n)]

    def varint(self) -> int:
        """Zigzag-decoded signed varint (RecordBatch v2 records)."""
        shift = 0
        result = 0
        while True:
            b = self.buf[self.pos]
            self.pos += 1
            result |= (b & 0x7F) << shift
            if not (b & 0x80):
                break
            shift += 7
        return (result >> 1) ^ -(result & 1)

    def remaining(self) -> int:
        return len(self.buf) - self.pos


class Writer:
    """Sequential big-endian writer building one frame."""

    __slots__ = ("parts",)

    def __init__(self) -> None:
        self.parts: List[bytes] = []

    def i8(self, v: int) -> "Writer":
        self.parts.append(struct.pack(">b", v))
        return self

    def i16(self, v: int) -> "Writer":
        self.parts.append(struct.pack(">h", v))
        return self

    def i32(self, v: int) -> "Writer":
        self.parts.append(struct.pack(">i", v))
        return self

    def i64(self, v: int) -> "Writer":
        self.parts.append(struct.pack(">q", v))
        return self

    def u32(self, v: int) -> "Writer":
        self.parts.append(struct.pack(">I", v))
        return self

    def raw(self, b: bytes) -> "Writer":
        self.parts.append(b)
        return self

    def string(self, s: Optional[str]) -> "Writer":
        if s is None:
            return self.i16(-1)
        b = s.encode("utf-8")
        return self.i16(len(b)).raw(b)

    def bytes_(self, b: Optional[bytes]) -> "Writer":
        if b is None:
            return self.i32(-1)
        return self.i32(len(b)).raw(b)

    def array(self, items: Sequence, elem) -> "Writer":
        self.i32(len(items))
        for it in items:
            elem(it)
        return self

    def varint(self, v: int) -> "Writer":
        """Zigzag-encoded signed varint."""
        u = ((v << 1) ^ (v >> 63)) & ((1 << 64) - 1)
        out = bytearray()
        while True:
            if u < 0x80:
                out.append(u)
                break
            out.append((u & 0x7F) | 0x80)
            u >>= 7
        self.parts.append(bytes(out))
        return self

    def build(self) -> bytes:
        return b"".join(self.parts)


# -- CRC-32C (Castagnoli), required by RecordBatch v2 -------------------------

_CRC32C_POLY = 0x82F63B78
_CRC32C_TABLE = []
for _i in range(256):
    _c = _i
    for _ in range(8):
        _c = (_c >> 1) ^ _CRC32C_POLY if _c & 1 else _c >> 1
    _CRC32C_TABLE.append(_c)


def crc32c(data: bytes) -> int:
    crc = 0xFFFFFFFF
    table = _CRC32C_TABLE
    for b in data:
        crc = table[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


# -- record formats -----------------------------------------------------------
# One produce/fetch payload is a "record blob": self-describing by the
# magic byte at a fixed offset, so decode_record_blob handles whatever
# era the peer speaks.

Record = Tuple[int, Optional[bytes], Optional[bytes], int, List[Tuple[str, bytes]]]
# (offset, key, value, timestamp_ms, headers)


def encode_message_set(records: Sequence[Record]) -> bytes:
    """MessageSet with magic-1 messages (CRC-32/IEEE; no headers —
    pre-0.11 clients cannot represent them)."""
    w = Writer()
    for offset, key, value, ts_ms, _headers in records:
        m = Writer()
        m.i8(1).i8(0).i64(ts_ms)  # magic, attributes, timestamp
        m.bytes_(key).bytes_(value)
        body = m.build()
        crc = zlib.crc32(body) & 0xFFFFFFFF
        msg = struct.pack(">I", crc) + body
        w.i64(offset).i32(len(msg)).raw(msg)
    return w.build()


def encode_record_batch(records: Sequence[Record]) -> bytes:
    """One RecordBatch v2 (magic 2) holding `records`; offsets must be
    contiguous ascending (the broker-side invariant of one batch)."""
    if not records:
        return b""
    base_offset = records[0][0]
    first_ts = records[0][3]
    max_ts = max(r[3] for r in records)
    body = Writer()
    for offset, key, value, ts_ms, headers in records:
        r = Writer()
        r.i8(0)  # attributes
        r.varint(ts_ms - first_ts)
        r.varint(offset - base_offset)
        if key is None:
            r.varint(-1)
        else:
            r.varint(len(key)).raw(key)
        if value is None:
            r.varint(-1)
        else:
            r.varint(len(value)).raw(value)
        r.varint(len(headers))
        for hk, hv in headers:
            hkb = hk.encode("utf-8")
            r.varint(len(hkb)).raw(hkb)
            if hv is None:
                r.varint(-1)
            else:
                r.varint(len(hv)).raw(hv)
        rec = r.build()
        body.varint(len(rec)).raw(rec)
    records_blob = body.build()
    # attributes..records: the CRC-covered region
    covered = (
        Writer()
        .i16(0)  # attributes (no compression, no txn)
        .i32(len(records) - 1)  # lastOffsetDelta
        .i64(first_ts)
        .i64(max_ts)
        .i64(-1)  # producerId
        .i16(-1)  # producerEpoch
        .i32(-1)  # baseSequence
        .i32(len(records))
        .raw(records_blob)
        .build()
    )
    head = (
        Writer()
        .i32(-1)  # partitionLeaderEpoch
        .i8(2)  # magic
        .u32(crc32c(covered))
        .raw(covered)
        .build()
    )
    return Writer().i64(base_offset).i32(len(head)).raw(head).build()


def decode_record_blob(blob: bytes) -> List[Record]:
    """Decode a produce/fetch payload of either format (self-describing
    via the magic byte); concatenated batches/sets are walked to the
    end, partial trailing data (fetch truncation) is ignored."""
    out: List[Record] = []
    r = Reader(blob)
    plain_budget = MAX_DECOMPRESSED_BATCH  # aggregate across ALL batches
    while r.remaining() >= 12:
        start = r.pos
        try:
            base_offset = r.i64()
            size = r.i32()
            if size < 0 or r.remaining() < size:
                break  # truncated trailer
            if size < 5:
                break
            # magic sits at byte 4 of the entry in BOTH formats:
            # v0/v1 message = crc(4) magic(1);
            # v2 batch = partitionLeaderEpoch(4) magic(1).
            magic = r.buf[r.pos + 4]
            if magic == 2:
                _ple = r.i32()
                _magic = r.i8()
                _crc = r.u32()
                attrs = r.i16()
                codec = attrs & 0x7
                if codec not in (0, 1):  # 1 = gzip (stdlib-decodable)
                    raise UnsupportedCodec(
                        f"compressed record batch (codec {codec}) not supported"
                    )
                _last_delta = r.i32()
                first_ts = r.i64()
                _max_ts = r.i64()
                _pid = r.i64()
                _pepoch = r.i16()
                _bseq = r.i32()
                n = r.i32()
                if codec == 1:
                    # gzip: the records section (after the count) is one
                    # compressed blob to the end of the batch. Bounded
                    # decompression: peer-controlled bytes must not be
                    # able to balloon memory (a ~1 MB bomb can expand
                    # 1000x), and a lying size field must not read
                    # backwards (_take rejects negative spans).
                    comp = r._take(start + 12 + size - r.pos)
                    try:
                        d = zlib.decompressobj(wbits=31)  # gzip framing
                        # the budget is shared across every batch in the
                        # blob: many small bombs must not add up past it
                        plain = d.decompress(comp, plain_budget + 1)
                        if len(plain) > plain_budget or d.unconsumed_tail:
                            raise UnsupportedCodec(
                                f"gzip batches exceed {MAX_DECOMPRESSED_BATCH} "
                                f"bytes decompressed"
                            )
                        if not d.eof:
                            # size-complete batch but the gzip stream is
                            # cut short: always corruption, never fetch
                            # truncation — reject loudly (a silent 0-
                            # record decode would let the gateway ACK a
                            # produce while dropping its records)
                            raise UnsupportedCodec("truncated gzip batch")
                        plain_budget -= len(plain)
                        sub = Reader(plain)
                    except UnsupportedCodec:
                        raise
                    except Exception as exc:  # noqa: BLE001
                        raise UnsupportedCodec(f"bad gzip batch: {exc}") from None
                else:
                    sub = r
                for _ in range(n):
                    rec_len = sub.varint()
                    rec_end = sub.pos + rec_len
                    _rattrs = sub.i8()
                    ts_delta = sub.varint()
                    off_delta = sub.varint()
                    klen = sub.varint()
                    key = sub._take(klen) if klen >= 0 else None
                    vlen = sub.varint()
                    value = sub._take(vlen) if vlen >= 0 else None
                    headers: List[Tuple[str, bytes]] = []
                    for _h in range(sub.varint()):
                        hklen = sub.varint()
                        hk = sub._take(hklen).decode("utf-8")
                        hvlen = sub.varint()
                        hv = sub._take(hvlen) if hvlen >= 0 else None
                        headers.append((hk, hv))
                    sub.pos = rec_end
                    out.append(
                        (base_offset + off_delta, key, value,
                         first_ts + ts_delta, headers)
                    )
            else:
                _crc = r.u32()
                _magic = r.i8()
                _attrs = r.i8()
                if _attrs & 0x7:  # compression codec bits
                    raise UnsupportedCodec(
                        f"compressed message set (codec {_attrs & 0x7}) not supported"
                    )
                ts_ms = r.i64() if _magic == 1 else -1
                key = r.bytes_()
                value = r.bytes_()
                out.append((base_offset, key, value, ts_ms, []))
            # step exactly one entry (v2 batch already consumed fully)
            r.pos = start + 12 + size
        except UnsupportedCodec:
            raise  # loud: the peer used compression we cannot decode
        except (ValueError, IndexError):
            break
    return out


# -- ConsumerProtocol (group membership metadata/assignment) ------------------


def encode_subscription(topics: Sequence[str], userdata: bytes = b"") -> bytes:
    w = Writer().i16(0)
    w.array(sorted(topics), lambda t: w.string(t))
    w.bytes_(userdata)
    return w.build()


def decode_subscription(blob: bytes) -> List[str]:
    try:
        r = Reader(blob)
        _version = r.i16()
        return [t for t in r.array(r.string) if t is not None]
    except (ValueError, IndexError):
        return []


def encode_assignment(parts: Sequence[Tuple[str, int]], userdata: bytes = b"") -> bytes:
    by_topic: dict = {}
    for t, p in parts:
        by_topic.setdefault(t, []).append(p)
    w = Writer().i16(0)

    def topic(item):
        t, ps = item
        w.string(t)
        w.array(sorted(ps), w.i32)

    w.array(sorted(by_topic.items()), topic)
    w.bytes_(userdata)
    return w.build()


def decode_assignment(blob: bytes) -> List[Tuple[str, int]]:
    try:
        r = Reader(blob)
        _version = r.i16()
        out: List[Tuple[str, int]] = []

        def topic():
            t = r.string()
            for p in r.array(r.i32):
                out.append((t, p))

        r.array(topic)
        return out
    except (ValueError, IndexError):
        return []
