"""Unbuffered coverage (`cov_buffer=0`) and message lineage against the
JAX package.

`cov_buffer=0` folds each popped event's slot into the lane's map at
once. Under the whole chaos palette on `rng_stream=3` with duplication
(two slots a step, folded in order) the port's unbuffered `run_batch`
equals the JAX package's leaf for leaf, its coverage state is the map
alone, and its map and every other result equal the buffered port's
(the reference's differential, tests/test_coverage.py:127-180, at a
prime step budget so the last fold is the segment-exit flush).

`replay_with_lineage` gives the reference's trace, `parents`,
`seq_pusher`, watermarks, `message_flows()` and the violation's
`past_cone` on both RNG streams, with the provenance gate off (the
reference's tests/test_provenance.py:142 scenario: the volatile-commit
Raft demo under strict restarts)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from madsim_tpu.engine.provenance import replay_with_lineage as jax_lineage
from madsim_tpu.models import raft as jax_raft
from madsim_tpu.__main__ import build_machine as jax_build
from madsim_tpu_torch.engine.provenance import replay_with_lineage
from madsim_tpu_torch.interop import tree_to_numpy
from madsim_tpu_torch.models import build_machine, raft

from torch_port_util import engines, jax_to_numpy, same, tree_diff

PALETTE = dict(n_faults=3, t_max_us=1_500_000, dur_min_us=100_000, dur_max_us=600_000, allow_dir_clog=True,
               allow_group=True, allow_storm=True, allow_delay=True, allow_pause=True, allow_skew=True,
               allow_dup=True, allow_torn=True, allow_heal_asym=True, strict_restart=True)
STEPS = 257  # prime: never a multiple of the flush cadence
LANES = 16


@pytest.fixture(scope="module")
def unbuffered():
    jax_eng, port = engines(jax_raft.RaftMachine(5, 8), raft.RaftMachine(5, 8), horizon_us=2_000_000,
                            queue_capacity=96, packet_loss_rate=0.01, fr_digest_every=64, fr_digest_ring=4,
                            cov_slots_log2=12, cov_buffer=0, faults=PALETTE)
    seeds = np.arange(LANES, dtype=np.uint32)
    want = jax.jit(jax_eng.run_batch, static_argnums=1)(jnp.asarray(seeds), STEPS)
    return port, seeds, want, port.run_batch(seeds, STEPS)


def test_unbuffered_run_batch_matches_jax(unbuffered):
    port, _, want, got = unbuffered
    assert port._rng_layout.dup_active and not port._cov_buffered and port._cov_flush_every == 0
    same(want, got)
    assert set(got.cov) == {"map"}
    assert bool(got.done.any()) and int(got.fr["dup"].sum()) > 0  # lanes froze mid-run; dups folded


def test_unbuffered_map_equals_the_buffered_fold(unbuffered):
    port, seeds, _, got = unbuffered
    buffered = dataclasses.replace(port.config, cov_buffer=16)
    from madsim_tpu_torch.engine import Engine

    eng = Engine(port.machine, buffered, device="cpu")
    assert eng._cov_buffered and STEPS % eng._cov_flush_every != 0
    ref = tree_to_numpy(eng.run_batch(seeds, STEPS))
    assert int(ref["cov"]["buf_n"].max()) == 0  # the exit flush drained every buffer
    ref["cov"] = {"map": ref["cov"]["map"]}
    assert not tree_diff(ref, tree_to_numpy(got))


def test_cov_buffer_bounds_name_the_unbuffered_fold():
    from madsim_tpu_torch.engine import Engine, EngineConfig, FaultPlan

    for depth in (-1, 1025):
        with pytest.raises(ValueError, match="0 \\(unbuffered"):
            Engine(raft.RaftMachine(5, 8), EngineConfig(cov_buffer=depth), device="cpu")
    with pytest.raises(ValueError, match="use 0 for the unbuffered fold"):
        Engine(raft.RaftMachine(5, 8), EngineConfig(coverage=True, cov_buffer=1, rng_stream=3,
                                                     faults=FaultPlan(allow_dup=True)), device="cpu")


VOLATILE = dict(horizon_us=5_000_000, queue_capacity=96)
VOLATILE_FAULTS = dict(n_faults=2, t_max_us=3_000_000, dur_min_us=100_000, dur_max_us=800_000,
                       strict_restart=True)
SEED = 5
MAX_STEPS = 480  # seed 5 fails 102 at event 451 (v2) and 443 (v3)


@pytest.mark.parametrize("rng_stream", [2, 3], ids=["rng_stream=2", "rng_stream=3"])
def test_lineage_matches_jax(rng_stream):
    from madsim_tpu.engine import Engine as JaxEngine
    from madsim_tpu.engine import EngineConfig as JaxConfig
    from madsim_tpu.engine import FaultPlan as JaxFaultPlan
    from madsim_tpu_torch.engine import Engine, EngineConfig, FaultPlan

    name = "demo-volatilecommit-raft"
    jax_eng = JaxEngine(jax_build(name, 0), JaxConfig(rng_stream=rng_stream, faults=JaxFaultPlan(**VOLATILE_FAULTS),
                                                      **VOLATILE))
    port = Engine(build_machine(name), EngineConfig(rng_stream=rng_stream, faults=FaultPlan(**VOLATILE_FAULTS),
                                                    **VOLATILE), device="cpu")
    want_rp, want = jax_lineage(jax_eng, SEED, max_steps=MAX_STEPS)
    got_rp, got = replay_with_lineage(port, SEED, max_steps=MAX_STEPS)
    assert [dataclasses.astuple(e) for e in got.trace] == [dataclasses.astuple(e) for e in want.trace]
    assert got.parents == want.parents and got.seq_pusher == want.seq_pusher
    assert got.next_seq_after == want.next_seq_after
    assert got.message_flows() == want.message_flows() and got.message_flows()
    viol = len(got.trace) - 1
    cone = got.past_cone(viol)
    assert cone == want.past_cone(viol) and 0 < len(cone) < len(got.trace)  # a real cut
    assert (got_rp.failed, got_rp.fail_code) == (bool(want_rp.failed), int(want_rp.fail_code)) == (True, 102)
    for i, ps in enumerate(got.parents):
        assert all(p < i for p in ps)
    for i, j in got.message_flows():
        send, recv = got.trace[i], got.trace[j]
        assert recv.kind == "msg" and send.node == recv.src and send.time_us <= recv.time_us
    # the replayed lane's node state (the port keeps its lane axis of 1)
    got_nodes = {k: v[0] for k, v in tree_to_numpy(got_rp.state.nodes).items()}
    assert not tree_diff(jax_to_numpy(want_rp.state.nodes), got_nodes)
