"""The port's S3 real client and REST gateway
(`madsim_tpu_torch.services.s3.real_client`, `.real_gateway`),
mirroring tests/test_s3_real.py case for case: each case runs on the
port (the JAX file's source with the package renamed) and on the JAX
package, over the genuine S3 REST wire on 127.0.0.1, and every request
the real backend sends, with its response, is equal on both
(`torch_mirror_util.run_both`; `last_modified` is the gateway's wall
clock, so it is masked, and upload ids are drawn from one seeded
`random`). The genuine-store case keeps its skip."""

import pytest

from torch_mirror_util import case_names, load_pair, run_both

PAIR = load_pair("test_s3_real")
CASES = [
    "test_against_genuine_s3",
    "test_awkward_keys_over_real_wire",
    "test_lifecycle_config_over_real_wire",
    "test_listing_and_multipart_over_real_wire",
    "test_object_lifecycle_over_real_wire",
    "test_real_mode_client_probes_http_and_falls_back",
    "test_sigv4_matches_aws_published_vector",
]


def test_cases_are_the_jax_files():
    assert CASES == case_names(PAIR["jax"])


@pytest.mark.parametrize(
    "case", [pytest.param(c, marks=getattr(PAIR["jax"], c).__dict__.get("pytestmark", []), id=c) for c in CASES])
def test_case_matches_jax(case):
    run_both(PAIR, case, wall=("last_modified",))
