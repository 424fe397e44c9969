"""The port's etcd real-client passthrough and gateway
(`madsim_tpu_torch.services.etcd.real_client`, `.real_gateway`),
mirroring tests/test_etcd_real.py case for case: each case runs on the
port (the JAX file's source with the package renamed, its subprocess
script importing the port and `examples/etcd_dual_torch.py`) and on the
JAX package, over the genuine etcd v3 gRPC wire on 127.0.0.1, and every
request its client sends, with its response, is equal on both
(`torch_mirror_util.run_both`; the gateways' lease ids are drawn from
one seeded `random`). The JAX file's skips hold: grpcio, protoc, and a
genuine etcd for the last case."""

import pytest

pytest.importorskip("grpc")

from torch_mirror_util import case_names, load_pair, run_both  # noqa: E402

PAIR = load_pair("test_etcd_real", ((r"\bimport etcd_dual\b", "import etcd_dual_torch as etcd_dual"),))
CASES = [
    "test_against_genuine_etcd",
    "test_election_over_real_wire",
    "test_kv_roundtrip_over_real_wire",
    "test_lease_lifecycle_over_real_wire",
    "test_real_mode_connect_prefers_genuine_etcd_and_falls_back",
    "test_txn_and_compares_over_real_wire",
    "test_watch_over_real_wire",
    "test_watch_stream_multiplexes_by_watch_id",
]


def test_cases_are_the_jax_files():
    assert CASES == case_names(PAIR["jax"])


@pytest.mark.parametrize(
    "case", [pytest.param(c, marks=getattr(PAIR["jax"], c).__dict__.get("pytestmark", []), id=c) for c in CASES])
def test_case_matches_jax(case):
    run_both(PAIR, case)
