"""Lane sharding over torch.distributed, held against the JAX package's
lane-axis mesh (tests/test_mesh.py).

The fixture of tests/test_mesh.py:27-53 (a 3-node Raft with every
harvest surface on: buffered coverage, the flight recorder,
provenance) streams its 32 seeds on the port at 1, 2, 4 and 8 ranks,
CPU processes over gloo (`torch_mesh_util`): the pipelined and the
per-segment executor, each on the counter-based stream (`rng_stream=3`)
and on the split-chain one (`rng_stream=2`, the default), and
`make_runner(mesh)`, all in one job of eight rank processes. At each
rank count every rank's dict (stats included) and coverage map equal
the JAX package's unsharded `run_stream` and its meshed one on the
same number of devices (conftest gives JAX 8 CPU devices).

`make_runner(mesh)` gives the whole BatchResult on every rank, equal
leaf for leaf to the JAX package's unsharded and meshed runners,
`cov.buf` included, on a seed vector whose first lanes all finish
~100-200 events before the last ones: a rank whose lanes all froze
must keep writing their buffer tails while another rank's lanes run,
as the unsharded loop does.

tests/test_mesh.py's `test_aot_export_refuses_mesh` and
`test_cache_subkey_discriminates_devices` have no counterpart: the port
has no AOT export and no compile cache. Its
`test_mesh_refuses_pallas_kernels` has none either: a port rank
launches its CUDA kernels on its own lanes (the kernels are exact), so
a meshed run keeps them on."""

import jax
import numpy as np
import pytest
import torch

from madsim_tpu.parallel import make_mesh as jax_mesh
from madsim_tpu_torch.parallel import CARRY_AXES, Mesh, carry_shardings, shard_seeds

from torch_mesh_util import COUNTS, assert_stream_equal, engines, meshed_runs
from torch_port_util import tree_diff


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return meshed_runs(tmp_path_factory.mktemp("mesh"))


def test_stream_shard_invariance(runs):
    want, got = runs
    assert_stream_equal(want, got, "pipelined_v3")


def test_stream_shard_invariance_per_segment(runs):
    want, got = runs
    assert_stream_equal(want, got, "segment_v3")


def test_stream_shard_invariance_v2(runs):
    want, got = runs
    assert_stream_equal(want, got, "pipelined_v2")


def test_stream_shard_invariance_v2_per_segment(runs):
    want, got = runs
    assert_stream_equal(want, got, "segment_v2")


def test_runner_shard_invariance(runs):
    want, got = runs
    golden = want["runner", 0]
    steps = golden["steps"]
    # the case the test exists for: the first half of the lanes all
    # froze long before the second half's last event
    assert steps[:8].max() < steps[8:].max() - 100
    for k in COUNTS:
        assert not tree_diff(golden, want["runner", k]), f"JAX mesh of {k} diverged"
        for r, res in enumerate(got["runner", k]):
            diff = tree_diff(golden, res)
            assert not diff, (f"BatchResult diverged at {k} ranks (rank {r})", diff[:5])
    assert int(np.count_nonzero(golden["cov"]["buf"])) > 0


def _mesh(world, rank=0):
    return Mesh(group=None, rank=rank, world=world, device=torch.device("cpu"), backend="gloo")


def test_mesh_batch_divisibility():
    """A batch that does not split evenly over the ranks is refused with
    the reference's message, at seed placement and at a stream's start
    (before any collective)."""
    from madsim_tpu.parallel import shard_seeds as jax_shard

    with pytest.raises(ValueError, match="multiple of") as want:
        jax_shard(jax.numpy.arange(12, dtype=jax.numpy.uint32), jax_mesh(jax.devices()[:8]))
    with pytest.raises(ValueError) as got:
        shard_seeds(torch.arange(12), _mesh(8))
    assert str(got.value) == str(want.value)
    _, port = engines(3)
    with pytest.raises(ValueError) as got:
        port.run_stream(12, batch=12, mesh=_mesh(8))
    assert str(got.value) == str(want.value)
    assert shard_seeds(list(range(16)), _mesh(4, rank=2)) == [8, 9, 10, 11]


def test_carry_shardings_follow_the_declared_table():
    """The port's CARRY_AXES is the reference's declared table, and
    `carry_shardings` answers each carry leaf from it."""
    from madsim_tpu.analysis.srules import CARRY_AXES as JAX_AXES

    assert CARRY_AXES == JAX_AXES
    _, port = engines(3)
    carry = port._init_carry(torch.arange(8, dtype=torch.int64), 16)
    axes = carry_shardings(_mesh(1), carry)
    assert axes["seeds"] == "lane" and axes["counters"] == "global" and axes["cov_map"] == "global"
    assert axes["state"]["eq_time"] == "lane" and axes["state"]["cov"]["buf"] == "lane"
    assert set(axes) == set(CARRY_AXES["StreamCarry"])


def test_carry_shardings_refuse_an_undeclared_leaf():
    """A carry leaf with no CARRY_AXES row raises KeyError naming it, in
    both packages."""
    from jax.sharding import Mesh as JaxMesh

    from madsim_tpu.parallel import carry_shardings as jax_shardings

    with pytest.raises(KeyError, match="StreamCarry.bogus") as want:
        jax_shardings(JaxMesh(np.array(jax.devices()[:1]), ("batch",)), {"seeds": np.zeros(4), "bogus": np.zeros(4)})
    with pytest.raises(KeyError, match="StreamCarry.bogus"):
        carry_shardings(_mesh(1), {"seeds": torch.zeros(4), "bogus": torch.zeros(4)})
    with pytest.raises(KeyError, match="LaneState.bogus"):
        carry_shardings(_mesh(1), {"state": {"bogus": torch.zeros(4)}})
    assert "no" in str(want.value)


def test_meshed_calls_refuse_a_non_mesh():
    _, port = engines(3)
    with pytest.raises(TypeError, match="parallel.Mesh"):
        port.run_stream(8, batch=8, mesh=object())
    with pytest.raises(TypeError, match="parallel.Mesh"):
        port.make_runner(100, mesh="batch")
