"""The unpacked clog matrix (`EngineConfig(clog_packed=False)`) in the
port against the JAX package: the bool[L, N, N] matrix gives the packed
rows' results on both streams (tests/test_step_gates.py:71), its lane
state equals the JAX package's matrix leaf for leaf, the directional
poke of tests/test_engine.py:572-598 blocks one way only, the refusal
past 60 packed nodes names the way out (tests/test_step_gates.py:232),
a corpus entry round-trips `clog_packed: false`, and a 64-node gossip
cluster, which only the matrix can hold, runs as the JAX package's."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from madsim_tpu.engine import corpus as jax_corpus
from madsim_tpu.models import gossip as jax_gossip
from madsim_tpu.models import raft as jax_raft
from madsim_tpu_torch.engine import Engine, EngineConfig, FaultPlan, corpus
from madsim_tpu_torch.interop import tree_to_numpy
from madsim_tpu_torch.models import echo, gossip, raft

from torch_port_util import engines, jax_to_numpy, tree_diff

# every kind that touches a link or a node, with loss, on the flagship
FULL_CHAOS = dict(horizon_us=2_000_000, queue_capacity=64, packet_loss_rate=0.01,
                  faults=dict(n_faults=3, t_max_us=1_500_000, dur_min_us=100_000, dur_max_us=600_000,
                              allow_dir_clog=True, allow_group=True, allow_storm=True, allow_delay=True,
                              allow_heal_asym=True))
# the 64-node gossip plan: pair and kill, the v1 derivation. Past 61
# nodes the v2 derivation's high group-mask draw (a modulus of
# 2 ** (N - 30)) leaves uint32, so the JAX package cannot draw a v2
# schedule there, and the port refuses one
GOSSIP64_FAULTS = dict(n_faults=3, t_max_us=3_000_000, dur_min_us=100_000, dur_max_us=800_000)


@pytest.mark.parametrize("rng_stream", [2, 3], ids=["rng-v2", "rng-v3"])
def test_matrix_gives_the_packed_results_and_jax_lanes(rng_stream):
    """Packed against unpacked in the port, whole BatchResult (the
    recorder's clogged-link high-water mark included); then the unpacked
    lane state after 200 steps, matrix and all, equal to the JAX
    package's."""
    kw = dict(FULL_CHAOS, rng_stream=rng_stream)
    jax_eng, port = engines(jax_raft.RaftMachine(5, 8), raft.RaftMachine(5, 8), clog_packed=False, **kw)
    packed = Engine(port.machine, dataclasses.replace(port.config, clog_packed=True), device="cpu")
    seeds = np.arange(16, dtype=np.uint32) + 3
    got = tree_to_numpy(port.run_batch(seeds, 240))
    assert not tree_diff(tree_to_numpy(packed.run_batch(seeds, 240)), got)
    assert got["fr"]["clog_hwm"].max() > 0  # links were clogged
    want = jax.jit(jax_eng.run_segment, static_argnums=1)(jax.jit(jax_eng.init_batch)(jnp.asarray(seeds)), 200)
    state = port.run_segment(port.init_batch(seeds), 200)
    assert str(state.clogged.dtype) == "torch.bool" and tuple(state.clogged.shape) == (16, 5, 5)
    diff = tree_diff(jax_to_numpy(want), tree_to_numpy(state))
    assert not diff, diff[:5]


def test_directional_clog_blocks_one_way_only():
    """clogged[a, b] drops a -> b sends while b -> a still delivers: the
    matrix poked directly, on the echo machine."""
    import torch

    from madsim_tpu_torch.models.echo import CLIENT, SERVER

    eng = Engine(echo.EchoMachine(rounds=3, retry_us=50_000), EngineConfig(queue_capacity=32, clog_packed=False),
                 device="cpu")

    def run_with_clog(src, dst):
        state = eng.init_batch(np.zeros(1, dtype=np.uint32))
        clogged = state.clogged.clone()
        clogged[0, src, dst] = True
        return eng.run_segment(dataclasses.replace(state, clogged=clogged), 40)

    out = run_with_clog(CLIENT, SERVER)
    assert int(out.nodes.served[0, SERVER]) == 0 and int(out.nodes.acked[0, CLIENT]) == 0
    rev = run_with_clog(SERVER, CLIENT)
    assert int(rev.nodes.served[0, SERVER]) > 0 and int(rev.nodes.acked[0, CLIENT]) == 0
    assert isinstance(rev.clogged, torch.Tensor) and bool(rev.clogged[0, SERVER, CLIENT])


def test_packed_rows_refuse_past_60_nodes_naming_the_matrix():
    """Past CLOG_MAX_NODES the packed rows refuse with the reference's
    message, which names `clog_packed=False`; the matrix takes the same
    machine."""
    from madsim_tpu.engine import Engine as JaxEngine
    from madsim_tpu.engine import EngineConfig as JaxConfig
    from madsim_tpu.engine import FaultPlan as JaxFaultPlan

    m, jm = raft.RaftMachine(5, 8), jax_raft.RaftMachine(5, 8)
    m.NUM_NODES = jm.NUM_NODES = 61
    with pytest.raises(ValueError) as want:
        JaxEngine(jm, JaxConfig(queue_capacity=256, faults=JaxFaultPlan(n_faults=0)))
    with pytest.raises(ValueError) as got:
        Engine(m, EngineConfig(queue_capacity=256, faults=FaultPlan(n_faults=0)), device="cpu")
    assert str(got.value) == str(want.value) and "clog_packed=False" in str(got.value)
    Engine(m, EngineConfig(queue_capacity=256, faults=FaultPlan(n_faults=0), clog_packed=False), device="cpu")


def test_corpus_round_trips_the_unpacked_matrix():
    cfg = EngineConfig(rng_stream=3, clog_packed=False, provenance=True, faults=FaultPlan(n_faults=2))
    d = corpus.config_to_dict(cfg)
    assert d["clog_packed"] is False and "provenance" not in d
    assert d == jax_corpus.config_to_dict(jax_corpus.config_from_dict(d))
    back = corpus.config_from_dict(d)
    assert back.clog_packed is False and back.rng_stream == 3
    assert back == dataclasses.replace(cfg, provenance=False)


@pytest.mark.parametrize("rng_stream", [2, 3], ids=["rng-v2", "rng-v3"])
def test_gossip_at_64_nodes_matches_jax(rng_stream):
    """GossipMachine(num_nodes=64) at 8 lanes, which only the matrix can
    hold: every lane leaf after 160 steps under pair and kill faults
    equal to the JAX package's; a v2 plan there is refused, naming the
    v1 kinds."""
    kw = dict(horizon_us=5_000_000, queue_capacity=256, rng_stream=rng_stream, clog_packed=False,
              flight_recorder=True, coverage=False, faults=GOSSIP64_FAULTS)
    jax_eng, port = engines(jax_gossip.GossipMachine(num_nodes=64), gossip.GossipMachine(num_nodes=64), **kw)
    seeds = np.arange(8, dtype=np.uint32) + 11
    want = jax.jit(jax_eng.run_segment, static_argnums=1)(jax.jit(jax_eng.init_batch)(jnp.asarray(seeds)), 160)
    got = port.run_segment(port.init_batch(seeds), 160)
    diff = tree_diff(jax_to_numpy(want), tree_to_numpy(got))
    assert not diff, diff[:5]
    assert tuple(got.clogged.shape) == (8, 64, 64) and not bool(got.failed.any())
    with pytest.raises(ValueError, match="v1 kinds"):
        Engine(port.machine, dataclasses.replace(port.config, faults=FaultPlan(n_faults=3, allow_dir_clog=True)),
               device="cpu")
