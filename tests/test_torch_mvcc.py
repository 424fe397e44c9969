"""The port's MVCC etcd machine against the JAX model: the batched
handlers against the vmapped ones on reachable node states (a JAX run of
the give-up variant under delay spikes) for the honest machine and each
bug flag, the invariant (every fail code), termination, summary and
restart hooks, then the engine: `step_batch` step by step from a carried
JAX state under the delay-only plan, where spiked sends are seen, and
`run_batch` for the honest machine and the give-up bug (ABANDONED_WRITE).
Every comparison is exact."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from madsim_tpu.engine import Engine as JaxEngine
from madsim_tpu.engine import EngineConfig as JaxConfig
from madsim_tpu.engine import FaultPlan as JaxFaultPlan
from madsim_tpu.models import etcd_mvcc as jax_mvcc
from madsim_tpu_torch.engine import Engine, EngineConfig, FaultPlan
from madsim_tpu_torch.engine.core import DELAY_EXTRA_MIN_US, EV_MSG
from madsim_tpu_torch.interop import lane_state_from_numpy
from madsim_tpu_torch.models import etcd_mvcc

from torch_port_util import check_handlers, check_hooks, jax_snapshots, same, torch_nodes

LANES, N = 32, 4
# the delay-only plan of tests/test_engine_mvcc.py (the give-up bug's)
DELAY_FAULTS = dict(n_faults=3, allow_partition=False, allow_kill=False, allow_delay=True,
                    t_max_us=3_000_000, dur_min_us=200_000, dur_max_us=800_000)
CONFIG = dict(horizon_us=8_000_000, queue_capacity=48)
SNAP_STEPS = (0, 15, 40, 80)
FLAGS = ("NO_DEDUP", "KEEPALIVE_NO_EXTEND", "PREMATURE_GIVEUP")


def _pair(flag=None):
    flags = {flag: True} if flag else {}
    return (type("V", (jax_mvcc.EtcdMvccMachine,), flags)(N),
            type("V", (etcd_mvcc.EtcdMvccMachine,), flags)(N))


def _engines(flag=None, **overrides):
    jax_m, port_m = _pair(flag)
    kw = {**CONFIG, **overrides}
    return (JaxEngine(jax_m, JaxConfig(faults=JaxFaultPlan(**DELAY_FAULTS), **kw)),
            Engine(port_m, EngineConfig(faults=FaultPlan(**DELAY_FAULTS), **kw), device="cpu"))


@pytest.fixture(scope="module")
def snapshots():
    return jax_snapshots(_engines("PREMATURE_GIVEUP")[0], np.arange(LANES) + 700, SNAP_STEPS)


def _inputs(seed, np_nodes, now):
    """Handler inputs around the state: the server and clients, live,
    stale and boot timers, every op kind, seqs at and around each
    client's own (and at the token window's edges: 31, 127, 128)."""
    g = np.random.default_rng(seed)
    lanes = len(now)
    node = g.integers(0, N, lanes).astype(np.int32)
    node[::3] = 0
    epoch = np.asarray(np_nodes.epoch)[np.arange(lanes), node]
    tid = np.where(g.random(lanes) < 0.6, 1 + 2 * epoch, g.integers(0, 9, lanes)).astype(np.int32)
    t_now = (now + g.integers(0, 600_000, lanes)).astype(np.int32)
    rand = g.integers(0, 2**32, (lanes, 4), dtype=np.uint32)
    src = g.integers(1, N, lanes).astype(np.int32)
    src[::7] = 0
    own_seq = np.asarray(np_nodes.seq)[np.arange(lanes), src]
    payload = np.zeros((lanes, 5), np.int32)
    payload[:, 0] = g.integers(1, 3, lanes)
    payload[:, 1] = own_seq + g.integers(-2, 2, lanes)
    edge = g.random(lanes) < 0.2
    payload[edge, 1] = g.choice([31, 32, 63, 127, 128, 200, -1], int(edge.sum()))
    payload[:, 2] = g.integers(0, etcd_mvcc.N_OPS, lanes)
    payload[:, 3] = g.integers(0, 900_000, lanes)
    payload[:, 4] = g.integers(-5, 50, lanes)
    return node, tid, t_now, rand, src, payload


@pytest.mark.parametrize("flag", [None, *FLAGS], ids=["honest", *FLAGS])
def test_handlers_match_jax(snapshots, flag):
    check_handlers(*_pair(flag), snapshots, _inputs)


def test_invariant_done_summary_restart_match_jax(snapshots):
    k = N + 1  # keys: the clients' own and the txn pair
    for flag in (None, "PREMATURE_GIVEUP"):
        jax_m, port_m = _pair(flag)
        np_nodes, now = snapshots[-1]
        bad = jax.tree.map(np.copy, np_nodes)
        bad.rev[0::7, 0] += 1  # REV_SKEW
        bad.val[1::7, 0, k - 2] += 1  # TXN_ATOMICITY
        bad.early_expiry[2::7, 0] = True  # LEASE_EARLY
        bad.puts_applied[3::7, 0, 1] += 9  # DUP_APPLY
        bad.ver[4::7, 0, 0], bad.mod_rev[4::7, 0, 0] = 1, 0  # MVCC_ORDER
        bad.dirty_abandoned[5::7, 0] = True  # ABANDONED_WRITE
        bad.acked[6::7, 1:] = 6  # every client done
        _, code = port_m.invariant(torch_nodes(port_m.state_type, bad), torch.from_numpy(now.copy()))
        assert set(code.tolist()) >= {201, 202, 203, 204, 205, 206}
        late = now.copy()
        late[::2] = etcd_mvcc.GIVEUP_DONE_US
        check_hooks(jax_m, port_m, [np_nodes, bad], now)
        check_hooks(jax_m, port_m, [bad], late, seed=1)


def test_step_batch_matches_jax_from_a_carried_state():
    """Lanes and MvccState carried over from JAX mid-run under the
    delay-only plan, recorder and coverage on, then stepped side by side;
    sends that took a spike (due over 1 s out) are in the queue."""
    jax_eng, port = _engines("PREMATURE_GIVEUP", flight_recorder=True, coverage=True)
    step = jax.jit(jax_eng.step_batch)
    state = jax.jit(jax_eng.init_batch)(jnp.arange(32, dtype=jnp.uint32) + 17)
    for _ in range(25):
        state = step(state)
    carried = lane_state_from_numpy(jax.tree.map(np.asarray, state), port.machine, device=port.device)
    assert isinstance(carried.nodes, etcd_mvcc.MvccState)
    spiked = 0
    for k in range(40):
        state, carried = step(state), port.step_batch(carried)
        same(state, carried, k)
        late = carried.eq_valid & (carried.eq_kind == EV_MSG) & (
            carried.eq_time - carried.now_us[:, None] > DELAY_EXTRA_MIN_US)
        spiked += int(late.sum())
    assert spiked > 0


@pytest.mark.parametrize("flag", [None, "PREMATURE_GIVEUP"], ids=["honest", "giveup"])
def test_run_batch_matches_jax(flag):
    jax_eng, port = _engines(flag)
    seeds = np.arange(48, dtype=np.uint32)
    want = jax.jit(jax_eng.run_batch, static_argnums=1)(jnp.asarray(seeds), 1000)
    same(want, port.run_batch(seeds, 1000))
    codes = np.asarray(want.fail_code)[np.asarray(want.failed)]
    if flag:
        assert (codes == etcd_mvcc.ABANDONED_WRITE).sum() >= 2
    else:
        assert not len(codes) and np.asarray(want.done).all()
