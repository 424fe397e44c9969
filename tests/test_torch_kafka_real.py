"""The port's Kafka wire codec, real client and wire gateway
(`madsim_tpu_torch.services.kafka.wire`, `.real_client`,
`.wire_gateway`), mirroring tests/test_kafka_real.py case for case:
each case runs on the port (the JAX file's source with the package
renamed) and on the JAX package, over the genuine Kafka wire on
127.0.0.1, and every request the wire client sends, with its response,
is equal on both (`torch_mirror_util.run_both`). The genuine-broker
case keeps its skip.

Then the codec itself: records, subscriptions and assignments made with
numpy from a fixed seed encode to the JAX package's bytes, and each
decoder inverts its encoder."""

import numpy as np
import pytest

import madsim_tpu.services.kafka.real_client as jax_real_client
import madsim_tpu.services.kafka.wire as jax_wire
import madsim_tpu_torch.services.kafka.real_client as port_real_client
import madsim_tpu_torch.services.kafka.wire as port_wire
from torch_mirror_util import case_names, load_pair, run_both

PAIR = load_pair("test_kafka_real")
CASES = [
    "test_against_genuine_kafka",
    "test_api_versions_frame_is_genuine_wire",
    "test_gateway_accepts_gzip_record_batches",
    "test_gateway_serves_pre_011_clients_message_set",
    "test_gateway_wire_conformance_edges",
    "test_probe_detects_fake_broker_and_rejects_non_kafka",
    "test_probe_detects_wire_gateway",
    "test_real_mode_public_surface_against_gateway",
    "test_wire_client_core_ops_against_gateway",
    "test_wire_client_group_protocol_against_gateway",
    "test_wire_codec_robust_against_malformed_blobs",
]


def test_cases_are_the_jax_files():
    assert CASES == case_names(PAIR["jax"])


@pytest.mark.parametrize(
    "case", [pytest.param(c, marks=getattr(PAIR["jax"], c).__dict__.get("pytestmark", []), id=c) for c in CASES])
def test_case_matches_jax(case):
    run_both(PAIR, case)


# -- the codec against the JAX package's, byte for byte -----------------------


def _records(rng, n: int, base: int):
    """`n` seeded records at contiguous offsets from `base`: keys and
    values null or of random bytes, headers with null values too."""
    out = []
    for i in range(n):
        key = None if rng.integers(3) == 0 else rng.bytes(int(rng.integers(0, 12)))
        value = None if rng.integers(5) == 0 else rng.bytes(int(rng.integers(0, 300)))
        headers = [(f"h{j}", None if rng.integers(4) == 0 else rng.bytes(int(rng.integers(0, 9))))
                   for j in range(int(rng.integers(0, 3)))]
        out.append((base + i, key, value, int(rng.integers(0, 1 << 41)), headers))
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_wire_codec_matches_jax(seed):
    rng = np.random.default_rng(seed)
    for _ in range(6):
        base = int(rng.integers(0, 1 << 40))
        batch = _records(rng, int(rng.integers(1, 9)), base)
        blob = port_wire.encode_record_batch(batch)
        assert blob == jax_wire.encode_record_batch(batch)
        assert port_wire.decode_record_blob(blob) == batch

        legacy = _records(rng, int(rng.integers(1, 6)), base + len(batch))
        mset = port_wire.encode_message_set(legacy)
        assert mset == jax_wire.encode_message_set(legacy)
        # magic-1 messages carry no headers
        assert port_wire.decode_record_blob(mset) == [(o, k, v, t, []) for o, k, v, t, _h in legacy]

        # concatenated batches and sets, and a fetch-truncated tail
        both_blob = blob + mset + blob[: int(rng.integers(1, len(blob)))]
        assert port_wire.decode_record_blob(both_blob) == jax_wire.decode_record_blob(both_blob)
        assert port_wire.crc32c(both_blob) == jax_wire.crc32c(both_blob)

        topics = [f"t{int(i)}" for i in rng.integers(0, 9, size=int(rng.integers(0, 5)))]
        parts = [(f"t{int(t)}", int(p)) for t, p in zip(rng.integers(0, 4, 6), rng.integers(0, 8, 6))]
        userdata = rng.bytes(int(rng.integers(0, 6)))
        sub = port_wire.encode_subscription(topics, userdata)
        assert sub == jax_wire.encode_subscription(topics, userdata)
        assert port_wire.decode_subscription(sub) == sorted(topics)
        asg = port_wire.encode_assignment(parts, userdata)
        assert asg == jax_wire.encode_assignment(parts, userdata)
        assert port_wire.decode_assignment(asg) == sorted(parts)
        assert port_wire.decode_assignment(asg) == jax_wire.decode_assignment(asg)

    ints = [int(v) for v in rng.integers(-(1 << 62), 1 << 62, size=64)] + [0, -1, 1, 63, -64, 64, -65]
    w_port, w_jax = port_wire.Writer(), jax_wire.Writer()
    for v in ints:
        w_port.varint(v).i32(v & 0x7FFFFFFF).string(str(v))
        w_jax.varint(v).i32(v & 0x7FFFFFFF).string(str(v))
    data = w_port.build()
    assert data == w_jax.build()
    r = port_wire.Reader(data)
    assert [(r.varint(), r.i32(), r.string()) for _ in ints] == [(v, v & 0x7FFFFFFF, str(v)) for v in ints]
    assert r.remaining() == 0
    name = f"client-{seed}"
    assert port_real_client.api_versions_frame(name) == jax_real_client.api_versions_frame(name)
