"""The engine's default configuration on the port: `EngineConfig()` as
it comes (the split-chain stream `rng_stream=2`, no faults, the flight
recorder and coverage off) runs and equals the JAX package's
`run_batch`, and the stream executor runs with the recorder and
coverage off. Every comparison is exact."""

import jax
import jax.numpy as jnp
import numpy as np

from madsim_tpu.engine import Engine as JaxEngine
from madsim_tpu.engine import EngineConfig as JaxConfig
from madsim_tpu.engine import FaultPlan as JaxFaultPlan
from madsim_tpu.models import multipaxos as jax_mp
from madsim_tpu.models import raft as jax_raft
from madsim_tpu_torch.engine import Engine, EngineConfig, FaultPlan
from madsim_tpu_torch.interop import tree_to_numpy
from madsim_tpu_torch.models import multipaxos, raft

from torch_port_util import jax_to_numpy, tree_diff


def test_default_engine_config_matches_jax():
    cfg = EngineConfig()
    assert (cfg.rng_stream, cfg.flight_recorder, cfg.coverage) == (2, False, False)
    port = Engine(raft.RaftMachine(5, 8), cfg, device="cpu")
    assert not port.use_megakernel
    seeds = np.arange(32, dtype=np.uint32) + 66500
    want = jax.jit(JaxEngine(jax_raft.RaftMachine(5, 8)).run_batch, static_argnums=1)(jnp.asarray(seeds), 320)
    got = port.run_batch(seeds, 320)
    assert got.fr == {} and got.cov == {}
    diff = tree_diff(jax_to_numpy(want), tree_to_numpy(got))
    assert not diff, diff[:5]


def test_run_stream_matches_jax_with_the_recorder_and_coverage_off():
    faults = dict(n_faults=3, allow_dir_clog=True, allow_group=True, allow_storm=True,
                  t_max_us=3_000_000, dur_min_us=100_000, dur_max_us=800_000)
    cfg = dict(horizon_us=8_000_000, queue_capacity=96)
    jax_eng = JaxEngine(jax_mp.NoPromiseCheckMultiPaxos(5), JaxConfig(faults=JaxFaultPlan(**faults), **cfg))
    port = Engine(multipaxos.NoPromiseCheckMultiPaxos(5), EngineConfig(faults=FaultPlan(**faults), **cfg),
                  device="cpu")
    kw = dict(batch=16, segment_steps=64, seed_start=0, max_steps=384)
    want, got = jax_eng.run_stream(32, pipelined=False, **kw), port.run_stream(32, pipelined=False, **kw)
    for key in ("completed", "failing", "infra", "abandoned", "seeds_consumed"):
        assert got[key] == want[key], key
    for key in ("host_syncs", "drains", "dispatches", "device_segments"):
        assert got["stats"][key] == want["stats"][key], key
    assert "coverage_map" not in got and "flight_recorder" not in got["stats"]
    assert (3, multipaxos.AGREEMENT_MULTI) in got["failing"]
