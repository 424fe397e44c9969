"""The port's host services (`madsim_tpu_torch.services`: etcd, Kafka,
S3), mirroring tests/test_services.py case for case: each case's
workload runs on the port (the JAX file's source with the package
renamed) and on the JAX package, and every request its service clients
send, with its response and virtual time, is equal on both
(`torch_mirror_util.run_both`).

Then the services themselves, below the clients: op streams made with
numpy from a fixed seed (puts, deletes, ranges, txns, compactions,
leases and watches for `EtcdService`; produce, fetch, join, sync,
heartbeat and commit for the `Broker`'s group coordinator; put, get,
list, copy, multipart, lifecycle and delete for `S3Service`) go to the
port's and the JAX package's service, and every response, every watch
event and the final state are equal."""

import numpy as np
import pytest

import madsim_tpu.services.etcd.service as jax_etcd
import madsim_tpu.services.kafka as jax_kafka
import madsim_tpu.services.s3 as jax_s3
import madsim_tpu_torch.services.etcd.service as port_etcd
import madsim_tpu_torch.services.kafka as port_kafka
import madsim_tpu_torch.services.s3 as port_s3
from torch_mirror_util import case_names, load_pair, norm, run_both

PAIR = load_pair("test_services")
CASES = [
    "test_etcd_compact_at_current_revision_after_load",
    "test_etcd_election",
    "test_etcd_kv_txn",
    "test_etcd_lease_expiry_deletes_keys",
    "test_etcd_progress_not_satisfied_by_stale_notification",
    "test_etcd_single_key_watch_is_single_key",
    "test_etcd_timeout_rate_injection",
    "test_etcd_watch_and_dump_load",
    "test_etcd_watch_filters_prevkv_and_start_revision",
    "test_etcd_watch_from_compaction_boundary_and_history_bound",
    "test_etcd_watch_future_start_revision_holds",
    "test_etcd_watch_progress_notify",
    "test_kafka_consumer_group_rebalances_across_members",
    "test_kafka_evicted_member_resumes_from_committed_not_stale_position",
    "test_kafka_group_commit_and_resume",
    "test_kafka_group_roundrobin_strategy",
    "test_kafka_group_session_timeout_evicts_dead_member",
    "test_kafka_group_zombie_commit_fenced",
    "test_kafka_headers_and_error_codes",
    "test_kafka_message_max_bytes_config",
    "test_kafka_produce_consume_ordering",
    "test_kafka_roundrobin_interleaves_across_topics",
    "test_kafka_subscribe_before_topic_created",
    "test_kafka_timed_out_call_does_not_desync_connection",
    "test_kafka_transactions_buffered",
    "test_kafka_watermarks_seek_and_timestamps",
    "test_s3_content_type_and_user_metadata",
    "test_s3_delimiter_common_prefixes_and_range",
    "test_s3_lifecycle_expiration_enforced",
    "test_s3_objects_and_multipart",
]
SEEDS = [0, 1, 2]


def test_cases_are_the_jax_files():
    assert CASES == case_names(PAIR["jax"])


@pytest.mark.parametrize("case", CASES)
def test_case_matches_jax(case):
    log = run_both(PAIR, case)
    # the clients really talked to a service (the timeout-injection
    # case sends one request that times out)
    assert log


# -- the services under seeded op streams -------------------------------------


class _Rng:
    """The services' RNG, the same seeded LCG for both packages."""

    def __init__(self, seed: int):
        self.state = seed * 6364136223846793005 + 1442695040888963407

    def next_u64(self) -> int:
        self.state = (self.state * 6364136223846793005 + 1442695040888963407) % (1 << 64)
        return self.state

    def gen_range(self, lo: int, hi: int) -> int:
        return lo + self.next_u64() % (hi - lo)


def _drive(ops, apply):
    """[(op, normalized response or exception)] of `apply` over `ops`."""
    out = []
    for op in ops:
        try:
            out.append((op, norm(apply(op))))
        except Exception as exc:  # noqa: BLE001 - the typed errors are compared
            out.append((op, norm(exc)))
    return out


ETCD_KEYS = [b"a", b"b", b"c", b"d/1", b"d/2", b"d/3", b"e", b"f"]


def _etcd_ops(seed: int, n: int = 400):
    rng = np.random.default_rng(seed)
    kinds = ["put", "put", "put", "get", "range", "delete", "delete_range", "txn", "compact", "grant", "grant_id",
             "revoke", "keep_alive", "ttl", "list", "advance", "history", "put_big"]
    ops = []
    for _ in range(n):
        kind = kinds[rng.integers(len(kinds))]
        k = ETCD_KEYS[rng.integers(len(ETCD_KEYS))]
        k2 = ETCD_KEYS[rng.integers(len(ETCD_KEYS))]
        lo, hi = min(k, k2), max(k, k2) + b"\x00"
        v = int(rng.integers(1000))
        lease = int(rng.integers(-1, 4))  # an index into the live leases, -1 none
        flag = bool(rng.integers(2))
        if kind == "put":
            ops.append(("put", k, b"v%d" % v, lease, flag))
        elif kind == "get":
            ops.append(("get", k, b"", 0, flag, not flag))
        elif kind == "range":
            ops.append(("get", lo, hi, int(rng.integers(3)), False, flag))
        elif kind == "delete":
            ops.append(("delete", k, b"", flag))
        elif kind == "delete_range":
            ops.append(("delete", lo, hi, flag))
        elif kind == "txn":
            target = ["value", "version", "create_revision", "mod_revision"][rng.integers(4)]
            operand = b"v%d" % v if target == "value" else int(rng.integers(6))
            cmp = (target, k, ["=", "!=", ">", "<"][rng.integers(4)], operand)
            ops.append(("txn", (cmp,), (("put", k2, b"t%d" % v, 0), ("get", lo, hi)),
                        (("delete", k, b""), ("put", k2, b"e%d" % v, 0))))
        elif kind == "compact":
            ops.append(("compact", int(rng.integers(-2, 3))))  # relative to the revision
        elif kind == "grant":
            ops.append(("grant", int(rng.integers(1, 8)), 0))
        elif kind == "grant_id":
            ops.append(("grant", int(rng.integers(1, 8)), int(rng.integers(1, 4))))
        elif kind in ("revoke", "keep_alive", "ttl"):
            ops.append((kind, lease))
        elif kind == "list":
            ops.append(("list",))
        elif kind == "advance":
            ops.append(("advance", int(rng.integers(1, 4))))
        elif kind == "history":
            ops.append(("history", int(rng.integers(-6, 2)), lo, hi))
        else:
            ops.append(("put", k, b"x" * 1_600_000, -1, False))  # over the request bound
    return ops


def _run_etcd(mod, seed: int):
    svc = mod.EtcdService(_Rng(seed), history_limit=64)
    events = []
    svc.add_watcher(b"d/", b"d0", lambda ev: events.append(("d", norm(ev))))
    svc.add_watcher(b"a", b"", lambda ev: events.append(("a", norm(ev))))
    svc.add_watcher(b"", b"\xff", lambda ev: events.append(("all", norm(ev))))

    def lease_id(i):
        live = sorted(svc.leases)
        return 0 if i < 0 else (live[i % len(live)] if live else 99)

    def apply(op):
        kind = op[0]
        if kind == "put":
            return svc.put(op[1], op[2], lease=lease_id(op[3]), prev_kv=op[4])
        if kind == "get":
            return svc.get(op[1], range_end=op[2], limit=op[3], count_only=op[4], keys_only=op[5])
        if kind == "delete":
            return svc.delete(op[1], range_end=op[2], prev_kv=op[3])
        if kind == "txn":
            return svc.txn(list(op[1]), list(op[2]), list(op[3]))
        if kind == "compact":
            return svc.compact(svc.revision + op[1])
        if kind == "grant":
            return svc.lease_grant(op[1], lease_id=op[2])
        if kind == "revoke":
            return svc.lease_revoke(lease_id(op[1]))
        if kind == "keep_alive":
            return svc.lease_keep_alive(lease_id(op[1]))
        if kind == "ttl":
            return svc.lease_time_to_live(lease_id(op[1]))
        if kind == "list":
            return svc.lease_list()
        if kind == "advance":
            svc.advance(op[1])
            return svc.lease_list()
        return svc.history_since(svc.revision + op[1], op[2], op[3])

    responses = _drive(_etcd_ops(seed), apply)
    state = (svc.revision, svc.compact_revision, svc.history_floor, norm(svc.kv), norm(svc.leases),
             norm(svc.lease_keys), norm(list(svc.history)), svc.dump())
    return responses, events, state


@pytest.mark.parametrize("seed", SEEDS)
def test_etcd_service_op_stream_matches_jax(seed):
    got, want = _run_etcd(port_etcd, seed), _run_etcd(jax_etcd, seed)
    assert got[0] == want[0]
    assert got[1] == want[1]
    assert got[2] == want[2]
    # the stream reached every path: typed errors, expiries, watch events
    assert any(r[0] == "raise" for _op, r in got[0] if isinstance(r, tuple))
    assert len(got[1]) > 50


TOPICS = {"orders": 3, "audit": 2}
GROUPS = ["g1", "g2"]


def _broker_ops(seed: int, n: int = 500):
    rng = np.random.default_rng(seed)
    kinds = ["produce", "produce", "fetch", "watermarks", "offsets_for_time", "metadata", "join", "join", "sync",
             "heartbeat", "leave", "commit", "commit_plain", "committed", "describe", "sweep", "tick"]
    ops = []
    for _ in range(n):
        kind = kinds[rng.integers(len(kinds))]
        topic = list(TOPICS)[rng.integers(len(TOPICS))]
        part = int(rng.integers(-1, TOPICS[topic] + 1))  # -1: the broker picks; the last one is out of range
        group = GROUPS[rng.integers(len(GROUPS))]
        member = int(rng.integers(-1, 4))  # an index into the members seen, -1 new
        stale = bool(rng.integers(4) == 0)
        if kind == "produce":
            key = None if rng.integers(3) == 0 else b"k%d" % rng.integers(5)
            headers = [("h", b"%d" % rng.integers(9))] if rng.integers(2) else None
            ops.append(("produce", topic, None if part < 0 else part, key, b"p%d" % rng.integers(1000), headers))
        elif kind == "fetch":
            ops.append(("fetch", topic, max(part, 0), int(rng.integers(0, 6)), int(rng.integers(1, 5))))
        elif kind == "watermarks":
            ops.append(("watermarks", topic, max(part, 0)))
        elif kind == "offsets_for_time":
            ops.append(("offsets_for_time", topic, max(part, 0), int(rng.integers(0, 2000))))
        elif kind == "join":
            topics = sorted(TOPICS) if rng.integers(2) else [topic]
            ops.append(("join", group, member, topics, int(rng.integers(200, 900)),
                        ["range", "roundrobin"][rng.integers(2)]))
        elif kind in ("sync", "heartbeat", "leave"):
            ops.append((kind, group, member, stale))
        elif kind == "commit":
            ops.append(("commit", group, member, stale, topic, max(part, 0), int(rng.integers(0, 8))))
        elif kind == "commit_plain":
            ops.append(("commit_plain", group, topic, max(part, 0), int(rng.integers(0, 8))))
        elif kind == "committed":
            ops.append(("committed", group, topic, max(part, 0)))
        elif kind in ("describe", "sweep"):
            ops.append((kind, group))
        else:
            ops.append(("tick", int(rng.integers(1, 400))))
    return ops


def _run_broker(mod, seed: int):
    b = mod.Broker(message_max_bytes=64, expire_on_traffic=bool(seed % 2))
    for topic, n in TOPICS.items():
        b.create_topic(topic, n)
    clock = [0]
    members = {g: [] for g in GROUPS}
    gens = {g: 0 for g in GROUPS}

    def member_id(group, i):
        seen = members[group]
        return seen[i % len(seen)] if seen and i >= 0 else (None if i < 0 else "ghost")

    def apply(op):
        kind = op[0]
        clock[0] += 7
        now = clock[0]
        if kind == "produce":
            return b.produce(op[1], op[2], op[3], op[4], now, op[5])
        if kind == "fetch":
            return b.fetch(*op[1:])
        if kind == "watermarks":
            return b.watermarks(op[1], op[2])
        if kind == "offsets_for_time":
            return b.offsets_for_time(op[1], op[2], op[3])
        if kind == "join":
            mid, gen = b.join_group(op[1], member_id(op[1], op[2]), op[3], op[4], op[5], now)
            if mid not in members[op[1]]:
                members[op[1]].append(mid)
            gens[op[1]] = gen
            return mid, gen
        if kind == "sync":
            return b.sync_group(op[1], member_id(op[1], op[2]), gens[op[1]] - op[3], now)
        if kind == "heartbeat":
            return b.heartbeat(op[1], member_id(op[1], op[2]), gens[op[1]] - op[3], now)
        if kind == "leave":
            return b.leave_group(op[1], member_id(op[1], op[2]), now)
        if kind == "commit":
            return b.commit_offsets(op[1], {(op[4], op[5]): op[6]}, member_id(op[1], op[2]), gens[op[1]] - op[3], now)
        if kind == "commit_plain":
            return b.commit_offsets(op[1], {(op[2], op[3]): op[4]})
        if kind == "committed":
            return b.committed(op[1], op[2], op[3])
        if kind == "describe":
            return b.describe_group(op[1], now)
        if kind == "sweep":
            return b.sweep_expired(op[1], now)
        clock[0] += op[1]
        return b.metadata()

    responses = _drive(_broker_ops(seed), apply)
    state = (norm(b.committed_offsets), norm({t: [p.records for p in ps] for t, ps in b.topics.items()}),
             norm({g: b.describe_group(g, clock[0]) for g in sorted(b.groups)}))
    return responses, state


@pytest.mark.parametrize("seed", SEEDS)
def test_broker_op_stream_matches_jax(seed):
    got, want = _run_broker(port_kafka, seed), _run_broker(jax_kafka, seed)
    assert got[0] == want[0]
    assert got[1] == want[1]
    # generation fencing and rebalances were reached
    assert any(r[0] == "raise" for _op, r in got[0] if isinstance(r, tuple))
    assert any(op[0] == "join" and r[0] == "tuple" and r[1][1] > 2 for op, r in got[0])


S3_KEYS = ["a.txt", "logs/1", "logs/2", "logs/old/3", "data/x", "data/y/z", "top"]


def _s3_ops(seed: int, n: int = 400):
    rng = np.random.default_rng(seed)
    kinds = ["put", "put", "put", "get", "get_range", "head", "copy", "delete", "delete_many", "list", "list_next",
             "create_mpu", "upload_part", "upload_part", "upload_part", "complete_mpu", "abort_mpu", "lifecycle",
             "get_lifecycle", "apply", "bucket", "delete_bucket"]
    ranges = ["bytes=0-3", "bytes=2-", "bytes=-4", "bytes=9-2", "bytes=100-200", "bits=1-2", "bytes=-0"]
    ops = []
    for _ in range(n):
        kind = kinds[rng.integers(len(kinds))]
        bucket = "nope" if rng.integers(12) == 0 else ["b1", "b2"][rng.integers(2)]
        key = S3_KEYS[rng.integers(len(S3_KEYS))]
        upload = int(rng.integers(-1, 3))  # an index into the open uploads, -1 a bogus id
        if kind == "put":
            meta = {"owner": "t%d" % rng.integers(3)} if rng.integers(2) else None
            ops.append(("put", bucket, key, b"body-%d" % rng.integers(10_000), ["text/plain", None][rng.integers(2)],
                        meta))
        elif kind in ("get", "head", "delete"):
            ops.append((kind, bucket, key))
        elif kind == "get_range":
            ops.append(("get", bucket, key, ranges[rng.integers(len(ranges))]))
        elif kind == "copy":
            ops.append(("copy", bucket, key, ["b1", "b2"][rng.integers(2)], S3_KEYS[rng.integers(len(S3_KEYS))]))
        elif kind == "delete_many":
            ops.append(("delete_many", bucket, tuple(S3_KEYS[i] for i in rng.integers(len(S3_KEYS), size=3))))
        elif kind == "list":
            ops.append(("list", bucket, ["", "logs/", "data/", "x"][rng.integers(4)], int(rng.integers(1, 4)),
                        ["/", None][rng.integers(2)], [None, "logs/1"][rng.integers(2)]))
        elif kind == "list_next":
            ops.append(("list_next", bucket))
        elif kind == "create_mpu":
            ops.append(("create_mpu", bucket, key))
        elif kind == "upload_part":
            ops.append(("upload_part", upload, int(rng.integers(0, 5)), b"part-%d" % rng.integers(100)))
        elif kind in ("complete_mpu", "abort_mpu"):
            ops.append((kind, upload))
        elif kind == "lifecycle":
            ops.append(("lifecycle", bucket, ["logs/", ""][rng.integers(2)], float(rng.integers(2, 12)),
                        [None, 3.0][rng.integers(2)]))
        elif kind in ("get_lifecycle", "bucket", "delete_bucket"):
            ops.append((kind, bucket))
        else:
            ops.append(("apply", int(rng.integers(0, 3))))
    return ops


def _run_s3(mod, seed: int):
    svc = mod.S3Service(_Rng(seed))
    svc.create_bucket("b1")
    svc.create_bucket("b2")
    clock = [0.0]
    tokens = {}

    def upload_id(i):
        live = sorted(svc.uploads)
        return live[i % len(live)] if live and i >= 0 else "f" * 32

    def apply(op):
        kind = op[0]
        clock[0] += 1800.0
        now = clock[0]
        if kind == "put":
            return svc.put_object(op[1], op[2], op[3], now, content_type=op[4], metadata=op[5])
        if kind == "get":
            return svc.get_object(op[1], op[2], range=op[3] if len(op) > 3 else None)
        if kind == "head":
            return svc.head_object(op[1], op[2])
        if kind == "delete":
            return svc.delete_object(op[1], op[2])
        if kind == "copy":
            return svc.copy_object(op[1], op[2], op[3], op[4], now)
        if kind == "delete_many":
            return svc.delete_objects(op[1], list(op[2]))
        if kind in ("list", "list_next"):
            if kind == "list":
                out = svc.list_objects_v2(op[1], prefix=op[2], max_keys=op[3], delimiter=op[4], start_after=op[5])
            else:
                out = svc.list_objects_v2(op[1], continuation=tokens.get(op[1]), max_keys=2)
            tokens[op[1]] = out["next_continuation_token"]
            return out
        if kind == "create_mpu":
            return svc.create_multipart_upload(op[1], op[2], now)
        if kind == "upload_part":
            return svc.upload_part(upload_id(op[1]), op[2], op[3])
        if kind == "complete_mpu":
            return svc.complete_multipart_upload(upload_id(op[1]), now)
        if kind == "abort_mpu":
            return svc.abort_multipart_upload(upload_id(op[1]))
        if kind == "lifecycle":
            rule = {"id": "r", "prefix": op[2], "days": op[3]}
            if op[4] is not None:
                rule["abort_multipart_days"] = op[4]
            return svc.put_bucket_lifecycle_configuration(op[1], {"rules": [rule]})
        if kind == "get_lifecycle":
            return svc.get_bucket_lifecycle_configuration(op[1])
        if kind == "bucket":
            return svc.create_bucket(op[1])
        if kind == "delete_bucket":
            return svc.delete_bucket(op[1])
        clock[0] += op[1] * 86400.0
        return svc.apply_lifecycle(clock[0])

    responses = _drive(_s3_ops(seed), apply)
    state = (norm(svc.buckets), norm(svc.uploads), norm(svc.lifecycle))
    return responses, state


@pytest.mark.parametrize("seed", SEEDS)
def test_s3_service_op_stream_matches_jax(seed):
    got, want = _run_s3(port_s3, seed), _run_s3(jax_s3, seed)
    assert got[0] == want[0]
    assert got[1] == want[1]
    # typed errors, completed uploads and lifecycle expiries were reached
    assert any(r[0] == "raise" for _op, r in got[0] if isinstance(r, tuple))
    assert any(op[0] == "complete_mpu" and r[0] == "dict" for op, r in got[0])
    assert any(op[0] == "apply" and r[1][0][1][1] for op, r in got[0])
