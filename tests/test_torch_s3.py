"""The port's S3 machine against the JAX model: the batched handlers
against the vmapped ones on reachable node states (a JAX run under the
full fault vocabulary, delay spikes included) for the honest machine and
each of the five bug flags, the invariant (every fail code), termination,
summary and restart hooks, then the engine: `step_batch` step by step
from a carried JAX state and `run_batch` for the honest machine and the
abort-leak bug (MPU_ORPHAN). Every comparison is exact."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from madsim_tpu.engine import Engine as JaxEngine
from madsim_tpu.engine import EngineConfig as JaxConfig
from madsim_tpu.engine import FaultPlan as JaxFaultPlan
from madsim_tpu.models import s3 as jax_s3
from madsim_tpu_torch.engine import Engine, EngineConfig, FaultPlan
from madsim_tpu_torch.interop import lane_state_from_numpy
from madsim_tpu_torch.models import s3

from torch_port_util import check_handlers, check_hooks, jax_snapshots, same, torch_nodes

LANES, N = 32, 4
# the full vocabulary of tests/test_engine_s3.py, with delay spikes
FULL_FAULTS = dict(n_faults=3, allow_dir_clog=True, allow_group=True, allow_storm=True, allow_delay=True,
                   t_max_us=3_000_000, dur_min_us=100_000, dur_max_us=800_000)
CONFIG = dict(horizon_us=8_000_000, queue_capacity=48)
SNAP_STEPS = (0, 20, 45, 70)
FLAGS = ("CONCAT_ARRIVAL_ORDER", "ABORT_KEEPS_PARTS", "LC_EARLY_HALF", "LC_TOMBSTONE_LEAK", "NO_DEDUP")


def _pair(flag=None):
    flags = {flag: True} if flag else {}
    return (type("V", (jax_s3.S3Machine,), flags)(N), type("V", (s3.S3Machine,), flags)(N))


def _engines(flag=None, **overrides):
    jax_m, port_m = _pair(flag)
    kw = {**CONFIG, **overrides}
    return (JaxEngine(jax_m, JaxConfig(faults=JaxFaultPlan(**FULL_FAULTS), **kw)),
            Engine(port_m, EngineConfig(faults=FaultPlan(**FULL_FAULTS), **kw), device="cpu"))


@pytest.fixture(scope="module")
def snapshots():
    return jax_snapshots(_engines("ABORT_KEEPS_PARTS")[0], np.arange(LANES) + 50, SNAP_STEPS)


def _inputs(seed, np_nodes, now):
    """Handler inputs around the state: the server (lifecycle ticks) and
    clients, live, stale and boot timers, every op kind at seqs around
    each client's own, part slots in and out of range, and times past the
    lifecycle ages."""
    g = np.random.default_rng(seed)
    lanes = len(now)
    node = g.integers(0, N, lanes).astype(np.int32)
    node[::3] = 0
    epoch = np.asarray(np_nodes.epoch)[np.arange(lanes), node]
    tid = np.where(g.random(lanes) < 0.6, 1 + 2 * epoch, g.integers(0, 9, lanes)).astype(np.int32)
    t_now = (now + g.integers(0, 3_000_000, lanes)).astype(np.int32)
    rand = g.integers(0, 2**32, (lanes, 4), dtype=np.uint32)
    src = g.integers(1, N, lanes).astype(np.int32)
    src[::7] = 0
    own_seq = np.asarray(np_nodes.seq)[np.arange(lanes), src]
    payload = np.zeros((lanes, 5), np.int32)
    payload[:, 0] = g.integers(1, 3, lanes)
    payload[:, 1] = own_seq + g.integers(-2, 2, lanes)
    payload[:, 2] = g.integers(0, s3.N_OPS, lanes)
    payload[:, 3] = g.integers(-1, s3.S3Machine.P + 1, lanes)
    return node, tid, t_now, rand, src, payload


def test_kind_draw_matches_the_reference_table():
    draw = torch.arange(64, dtype=torch.int64)
    m = s3.S3Machine(N)
    nodes = m.init(torch.zeros((64, 2), dtype=torch.int64))
    node = torch.ones(64, dtype=torch.int32)
    rand = torch.stack([draw, torch.zeros_like(draw), torch.zeros_like(draw), torch.zeros_like(draw)], 1)
    _, out = m.on_timer(nodes, node, torch.zeros(64, dtype=torch.int32), torch.zeros(64, dtype=torch.int32), rand)
    assert out.msg_payload[:, 0, 2].tolist() == [s3.KIND_TABLE[d % 8] for d in range(64)]


@pytest.mark.parametrize("flag", [None, *FLAGS], ids=["honest", *FLAGS])
def test_handlers_match_jax(snapshots, flag):
    check_handlers(*_pair(flag), snapshots, _inputs)


def test_invariant_done_summary_restart_match_jax(snapshots):
    jax_m, port_m = _pair()
    np_nodes, now = snapshots[-1]
    bad = jax.tree.map(np.copy, np_nodes)
    bad.obj_ver[0::6, 0, 0], bad.obj_val[0::6, 0, 0] = 1, 77  # MPU_CONCAT
    bad.mpu_active[1::6, 0, 1], bad.mpu_mask[1::6, 0, 1] = 0, 5  # MPU_ORPHAN
    bad.lc_early[2::6, 0] = True  # LC_EARLY
    bad.obj_ver[3::6, 0, 2], bad.obj_val[3::6, 0, 2] = 0, 9  # LC_PARTIAL
    bad.writes_applied[4::6, 0, 0] += 9  # DUP_APPLY
    bad.acked[5::6, 1:] = 6  # every client done
    _, code = port_m.invariant(torch_nodes(port_m.state_type, bad), torch.from_numpy(now.copy()))
    assert set(code.tolist()) >= {211, 212, 213, 214, 215}
    late = now.copy()
    late[::2] = s3.OBSERVE_US
    check_hooks(jax_m, port_m, [np_nodes, bad], now)
    check_hooks(jax_m, port_m, [bad], late, seed=1)


def test_step_batch_matches_jax_from_a_carried_state():
    jax_eng, port = _engines("CONCAT_ARRIVAL_ORDER", flight_recorder=True, coverage=True)
    step = jax.jit(jax_eng.step_batch)
    state = jax.jit(jax_eng.init_batch)(jnp.arange(24, dtype=jnp.uint32) + 9)
    for _ in range(20):
        state = step(state)
    carried = lane_state_from_numpy(jax.tree.map(np.asarray, state), port.machine, device=port.device)
    assert isinstance(carried.nodes, s3.S3State)
    for k in range(40):
        state, carried = step(state), port.step_batch(carried)
        same(state, carried, k)


@pytest.mark.parametrize("flag", [None, "ABORT_KEEPS_PARTS"], ids=["honest", "abortleak"])
def test_run_batch_matches_jax(flag):
    jax_eng, port = _engines(flag)
    seeds = np.arange(48, dtype=np.uint32)
    want = jax.jit(jax_eng.run_batch, static_argnums=1)(jnp.asarray(seeds), 800)
    same(want, port.run_batch(seeds, 800))
    codes = np.asarray(want.fail_code)[np.asarray(want.failed)]
    if flag:
        assert (codes == s3.MPU_ORPHAN).sum() >= 2
    else:
        assert not len(codes) and np.asarray(want.done).all()
        assert int(np.asarray(want.summary["writes_applied"]).sum()) > 48  # real multipart traffic
