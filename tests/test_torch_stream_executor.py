"""The port's pipelined stream executor, `run_stream(pipelined=True)`,
the default as in the JAX package. It mirrors the reference's
tests/test_stream_executor.py at its tiny sizes (3-node Raft, 16 lanes):
the pipelined executor runs exactly the per-segment driver's segment
sequence, so every result is identical (completions, the failing ring in
order, seeds consumed), whatever the dispatch knobs, while its blocking
host syncs drop to one a poll cycle plus the drains. Then the port's
pipelined executor against the JAX package's, on both RNG streams with
the flight recorder and coverage on: every result and every executor
statistic equal."""

import numpy as np
import pytest
import torch

from madsim_tpu.models import raft as jax_raft
from madsim_tpu_torch.engine import OVERFLOW, Engine, EngineConfig, FaultPlan
from madsim_tpu_torch.models.raft import RaftMachine

from torch_port_util import engines


class AlwaysFails(RaftMachine):
    """Every processed event breaks the invariant: every lane fails every
    segment, so the failing ring drains again and again."""

    def invariant(self, nodes, now_us):
        lanes = nodes.term.shape[0]
        return (torch.zeros(lanes, dtype=torch.bool, device=nodes.term.device),
                torch.full((lanes,), 99, dtype=torch.int32, device=nodes.term.device))


@pytest.fixture(scope="module")
def raft_engine():
    return Engine(RaftMachine(num_nodes=3, log_capacity=4),
                  EngineConfig(horizon_us=2_000_000, queue_capacity=48,
                               faults=FaultPlan(n_faults=1, t_max_us=1_000_000)), device="cpu")


@pytest.fixture(scope="module")
def failing_engine():
    return Engine(AlwaysFails(3, 4), EngineConfig(horizon_us=1_000_000, queue_capacity=48), device="cpu")


def _strip(out):
    """Everything but the executor's statistics, which differ between
    executors by design."""
    return {k: v for k, v in out.items() if k != "stats"}


def test_pipelined_identical_to_per_segment_executor(failing_engine):
    kw = dict(batch=16, segment_steps=64, seed_start=100)
    new = failing_engine.run_stream(40, **kw)
    old = failing_engine.run_stream(40, pipelined=False, **kw)
    assert _strip(new) == _strip(old)
    assert new["stats"]["device_segments"] == old["stats"]["device_segments"]
    assert new["stats"]["pipelined"] and not old["stats"]["pipelined"]
    # every seed consumed failed, in order: the gapless seed range
    assert sorted(s for s, _ in new["failing"]) == list(range(100, 100 + new["seeds_consumed"]))
    assert new["stats"]["drains"] >= 2  # the drain path ran


def test_donation_is_bit_identical(raft_engine):
    kw = dict(batch=16, segment_steps=64, seed_start=500)
    donated = raft_engine.run_stream(48, donate=True, **kw)
    copied = raft_engine.run_stream(48, donate=False, **kw)
    assert _strip(donated) == _strip(copied)
    assert donated["stats"]["donation"] and not copied["stats"]["donation"]
    assert raft_engine.run_stream(16, batch=16, segment_steps=64)["stats"]["donation"]  # the default


KNOBS_RUN = dict(batch=16, segment_steps=64, seed_start=900)


@pytest.fixture(scope="module")
def per_segment_run(raft_engine):
    return raft_engine.run_stream(48, pipelined=False, **KNOBS_RUN)


@pytest.mark.parametrize("spd,depth", [(1, 1), (4, 2), (8, 4)])
def test_dispatch_knobs_never_change_results(raft_engine, per_segment_run, spd, depth):
    out = raft_engine.run_stream(48, segments_per_dispatch=spd, dispatch_depth=depth, **KNOBS_RUN)
    assert _strip(out) == _strip(per_segment_run)
    assert (out["stats"]["segments_per_dispatch"], out["stats"]["dispatch_depth"]) == (spd, depth)


def test_steady_state_host_syncs_drop(raft_engine):
    kw = dict(batch=16, segment_steps=32, seed_start=2_000, max_steps=4_000)
    new = raft_engine.run_stream(64, segments_per_dispatch=8, dispatch_depth=4, **kw)
    old = raft_engine.run_stream(64, pipelined=False, **kw)
    segs = old["stats"]["device_segments"]
    assert segs > 4 and new["stats"]["device_segments"] == segs
    # per segment: one blocking sync a segment, the final poll and drain
    assert old["stats"]["host_syncs"] == segs + 2
    # pipelined: one a poll cycle (32 segments), the drains and the tail
    assert new["stats"]["host_syncs"] <= -(-segs // 32) + new["stats"]["drains"] + 2
    assert new["stats"]["host_syncs"] < old["stats"]["host_syncs"]


def test_overflow_lands_in_infra_bucket_not_findings():
    eng = Engine(RaftMachine(5, 8), EngineConfig(horizon_us=5_000_000, queue_capacity=16), device="cpu")
    out = eng.run_stream(32, batch=16, segment_steps=64, max_steps=400)
    assert out["failing"] == []
    assert len(out["infra"]) >= 32
    assert all(code == OVERFLOW for _seed, code in out["infra"])


def test_make_stream_runner_threads_executor_config(raft_engine):
    run = raft_engine.make_stream_runner(batch=16, segment_steps=64, segments_per_dispatch=4, dispatch_depth=2)
    out1 = run(32, seed_start=700)
    out2 = run(32, seed_start=700)
    assert out1 == out2
    assert out1["completed"] >= 32
    assert out1["stats"]["pipelined"] and out1["stats"]["segments_per_dispatch"] == 4
    assert out1["stats"]["dispatch_depth"] == 2


def test_knobs_are_validated(raft_engine):
    with pytest.raises(ValueError, match="segments_per_dispatch"):
        raft_engine.run_stream(16, batch=16, segments_per_dispatch=0)
    with pytest.raises(ValueError, match="dispatch_depth"):
        raft_engine.run_stream(16, batch=16, dispatch_depth=0)


@pytest.mark.parametrize("rng_stream", [2, 3], ids=["rng_stream=2", "rng_stream=3"])
def test_pipelined_matches_jax_pipelined(rng_stream):
    """The port's pipelined executor against the JAX package's, recorder
    and coverage on: results, the coverage map and every executor
    statistic (host syncs, drains and dispatches among them) equal."""
    faults = dict(n_faults=1, t_max_us=1_000_000, dur_min_us=200_000, dur_max_us=800_000)
    jax_eng, port = engines(jax_raft.RaftMachine(3, 4), RaftMachine(3, 4), rng_stream=rng_stream,
                            horizon_us=2_000_000, queue_capacity=48, faults=faults)
    kw = dict(batch=16, segment_steps=64, seed_start=300, max_steps=640, segments_per_dispatch=2,
              dispatch_depth=2)
    want, got = jax_eng.run_stream(48, **kw), port.run_stream(48, **kw)
    for key in ("completed", "failing", "infra", "abandoned", "seeds_consumed"):
        assert got[key] == want[key], key
    assert set(got["stats"]) == set(want["stats"])
    for key, value in want["stats"].items():
        assert got["stats"][key] == value, key
    assert np.array_equal(got["coverage_map"], want["coverage_map"])
    assert want["stats"]["pipelined"] and want["stats"]["device_segments"] > 2
    assert want["stats"]["coverage"]["slots_hit"] > 0
