"""The port's 33-node gossip machine against the JAX model: the batched
handlers against the vmapped ones on reachable node states (a JAX run
under the full fault vocabulary) for the honest machine and the dup-ack
bug, the invariant, termination, summary and restart hooks, then the
engine: `step_batch` step by step from a carried JAX state, and
`run_batch` at the corpus entry's config (queue 256, every fault kind)
on a batch whose schedule holds group faults with masks past 30 nodes,
for the honest machine and the dup-ack bug (COMMIT_BELOW_QUORUM on seed
45). Every comparison is exact."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from madsim_tpu.engine import Engine as JaxEngine
from madsim_tpu.engine import EngineConfig as JaxConfig
from madsim_tpu.engine import FaultPlan as JaxFaultPlan
from madsim_tpu.models import gossip as jax_gossip
from madsim_tpu_torch.engine import Engine, EngineConfig, FaultPlan
from madsim_tpu_torch.engine.core import F_CLOG_GROUP
from madsim_tpu_torch.interop import lane_state_from_numpy
from madsim_tpu_torch.models import gossip

from torch_port_util import check_handlers, check_hooks, jax_snapshots, same, torch_nodes

LANES, N, R = 16, 33, 6
# the demo-dupack-gossip corpus entry's plan: every kind the port runs
FULL_FAULTS = dict(n_faults=3, allow_dir_clog=True, allow_group=True, allow_storm=True, allow_delay=True,
                   t_max_us=3_000_000, dur_min_us=100_000, dur_max_us=800_000)
CONFIG = dict(horizon_us=5_000_000, queue_capacity=256)
SNAP_STEPS = (0, 60, 150, 300)
SEEDS = np.arange(38, 38 + LANES, dtype=np.uint32)  # 45 is the corpus entry's


def _pair(flag=False):
    flags = {"DUP_ACK_COUNT": True} if flag else {}
    return (type("V", (jax_gossip.GossipMachine,), flags)(N, R), type("V", (gossip.GossipMachine,), flags)(N, R))


def _engines(flag=False, **overrides):
    jax_m, port_m = _pair(flag)
    kw = {**CONFIG, **overrides}
    return (JaxEngine(jax_m, JaxConfig(faults=JaxFaultPlan(**FULL_FAULTS), **kw)),
            Engine(port_m, EngineConfig(faults=FaultPlan(**FULL_FAULTS), **kw), device="cpu"))


@pytest.fixture(scope="module")
def snapshots():
    return jax_snapshots(_engines(True)[0], SEEDS, SNAP_STEPS)


def _inputs(seed, np_nodes, now, n=N):
    """Handler inputs around the state: live, stale and boot timers at
    times past the inject stagger, rumors in and out of range, acks at
    their origins and elsewhere, duplicate ackers, and random words whose
    fan-out salt sum wraps past 2^32."""
    g = np.random.default_rng(seed)
    lanes = len(now)
    node = g.integers(0, n, lanes).astype(np.int32)
    node[::4] = g.integers(0, R, len(node[::4]))  # origins
    epoch = np.asarray(np_nodes.epoch)[np.arange(lanes), node]
    tid = np.where(g.random(lanes) < 0.6, 1 + 2 * epoch, g.integers(0, 9, lanes)).astype(np.int32)
    t_now = (now + g.integers(0, 1_000_000, lanes)).astype(np.int32)
    rand = g.integers(0, 2**32, (lanes, 4), dtype=np.uint32)
    rand[::2, 2] = 2**32 - 1 - g.integers(0, 2**20, len(rand[::2]))
    src = g.integers(0, n, lanes).astype(np.int32)
    payload = np.zeros((lanes, 4), np.int32)
    payload[:, 0] = g.integers(1, 3, lanes)
    payload[:, 1] = g.integers(-1, R + 1, lanes)
    payload[::3, 1] = node[::3] % n  # an ack at its origin
    payload[:, 2] = g.integers(0, 5, lanes)
    return node, tid, t_now, rand, src, payload


@pytest.mark.parametrize("flag", [False, True], ids=["honest", "DUP_ACK_COUNT"])
def test_handlers_match_jax(snapshots, flag):
    check_handlers(*_pair(flag), snapshots, _inputs, reps=2)


def test_handlers_match_jax_at_16_nodes():
    """At 16 nodes the peer draws are mod 15, so a fan-out salt sum left
    unwrapped past 2^32 would pick other peers (at 33 nodes, mod 32, the
    wrap cannot show). Synthetic states: random stores, tallies and
    ackers."""
    n, lanes = 16, 24
    g = np.random.default_rng(16)
    np_nodes = jax_gossip.GossipState(
        holds=g.random((lanes, n, R)) < 0.4, committed=g.random((lanes, n, R)) < 0.2,
        ack_cnt=g.integers(0, n, (lanes, n, R)).astype(np.int32), acked_by=g.random((lanes, n, R, n)) < 0.3,
        epoch=g.integers(0, 4, (lanes, n)).astype(np.int32))
    now = g.integers(0, 1_000_000, lanes).astype(np.int32)
    for flag in (False, True):
        flags = {"DUP_ACK_COUNT": True} if flag else {}
        check_handlers(type("V", (jax_gossip.GossipMachine,), flags)(n, R),
                       type("V", (gossip.GossipMachine,), flags)(n, R), [(np_nodes, now)],
                       functools.partial(_inputs, n=n))


def test_invariant_done_summary_restart_match_jax(snapshots):
    jax_m, port_m = _pair()
    np_nodes, now = snapshots[-1]
    bad = jax.tree.map(np.copy, np_nodes)
    bad.committed[0::3, 1, 1], bad.holds[0::3, :, 1] = True, False  # COMMIT_BELOW_QUORUM
    bad.holds[1::3] = True  # every rumor everywhere ...
    bad.committed[1::3, np.arange(R) % N, np.arange(R)] = True  # ... and committed: done
    _, code = port_m.invariant(torch_nodes(port_m.state_type, bad), torch.from_numpy(now.copy()))
    assert gossip.COMMIT_BELOW_QUORUM in code.tolist()
    check_hooks(jax_m, port_m, [np_nodes, bad], now)


def test_step_batch_matches_jax_from_a_carried_state():
    jax_eng, port = _engines(True, flight_recorder=True, coverage=True)
    step = jax.jit(jax_eng.step_batch)
    state = jax.jit(jax_eng.init_batch)(jnp.asarray(SEEDS[:8]))
    for _ in range(80):
        state = step(state)
    carried = lane_state_from_numpy(jax.tree.map(np.asarray, state), port.machine, device=port.device)
    assert isinstance(carried.nodes, gossip.GossipState)
    for k in range(30):
        state, carried = step(state), port.step_batch(carried)
        same(state, carried, k)


@pytest.mark.parametrize("flag", [False, True], ids=["honest", "dupack"])
def test_run_batch_matches_jax(flag):
    jax_eng, port = _engines(flag, flight_recorder=True)
    want = jax.jit(jax_eng.run_batch, static_argnums=1)(jnp.asarray(SEEDS), 500)
    same(want, port.run_batch(SEEDS, 500))
    # the schedule holds group faults, some with members past node 30
    pay = np.asarray(jax.jit(jax_eng.init_batch)(jnp.asarray(SEEDS)).eq_payload)[:, N : N + 6]
    group = pay[:, :, 0] == F_CLOG_GROUP
    assert group.any() and (pay[:, :, 2][group] != 0).any()
    assert np.asarray(want.fr["inj"])[:, 3].sum() > 0  # a group fault applied
    failed = dict(zip(SEEDS.tolist(), np.where(np.asarray(want.failed), np.asarray(want.fail_code), 0).tolist()))
    if flag:
        assert failed[45] == gossip.COMMIT_BELOW_QUORUM
    else:
        assert not any(failed.values())
