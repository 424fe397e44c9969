"""The port's multi-decree Paxos against the JAX model: the batched
handlers against the vmapped ones on reachable node states (from a JAX
run under the v2 fault plan with dir, group and storm faults), the
invariant, termination, summary and restart hooks, then the engine:
`step_batch` step by step from a carried-over JAX state, `run_batch` at
32 lanes, for the honest model and the no-promise-check bug. Every
comparison is exact."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from madsim_tpu.engine import Engine as JaxEngine
from madsim_tpu.engine import EngineConfig as JaxConfig
from madsim_tpu.engine import FaultPlan as JaxFaultPlan
from madsim_tpu.models import multipaxos as jax_mp
from madsim_tpu_torch.engine import Engine, EngineConfig, FaultPlan
from madsim_tpu_torch.interop import lane_state_from_numpy
from madsim_tpu_torch.models import multipaxos

from torch_port_util import check_handlers, check_hooks, jax_snapshots, same, torch_nodes

LANES = 32
N, S = 5, 8
# the v2 fault plan of the corpus's multipaxos hunts, with faults on
V2_FAULTS = dict(n_faults=3, allow_dir_clog=True, allow_group=True, allow_storm=True,
                 t_max_us=3_000_000, dur_min_us=100_000, dur_max_us=800_000)
CONFIG = dict(horizon_us=8_000_000, queue_capacity=96)
SNAP_STEPS = (0, 20, 60, 150)
VARIANTS = {
    "honest": (jax_mp.MultiPaxosMachine, multipaxos.MultiPaxosMachine),
    "nopromise": (jax_mp.NoPromiseCheckMultiPaxos, multipaxos.NoPromiseCheckMultiPaxos),
}


def _engines(variant, **overrides):
    jax_cls, port_cls = VARIANTS[variant]
    kw = {**CONFIG, **overrides}
    return (JaxEngine(jax_cls(N), JaxConfig(faults=JaxFaultPlan(**V2_FAULTS), **kw)),
            Engine(port_cls(N), EngineConfig(faults=FaultPlan(**V2_FAULTS), **kw), device="cpu"))


@pytest.fixture(scope="module")
def snapshots():
    """Node states of a JAX run of the bug variant at SNAP_STEPS."""
    return jax_snapshots(_engines("nopromise")[0], np.arange(LANES) + 900, SNAP_STEPS)


def _inputs(seed, np_nodes, now):
    """Handler inputs around the state: live ballots (own and others'),
    in-range and clamped slots, every message type and timer id."""
    g = np.random.default_rng(seed)
    node = g.integers(0, N, LANES).astype(np.int32)
    node[::3] = g.integers(0, 2, len(node[::3]))  # proposers
    tid = g.integers(0, 4, LANES).astype(np.int32)
    t_now = (now + g.integers(0, 300_000, LANES)).astype(np.int32)
    rand = g.integers(0, 2**32, (LANES, 4), dtype=np.uint32)
    src = ((node + g.integers(1, N, LANES)) % N).astype(np.int32)
    ballots = np.asarray(np_nodes.ballot)[np.arange(LANES), node]
    payload = np.zeros((LANES, 6), np.int32)
    payload[:, 0] = g.integers(1, 7, LANES)
    payload[:, 1] = np.where(g.random(LANES) < 0.7, np.asarray(np_nodes.cur_slot)[np.arange(LANES), node],
                             g.integers(-1, S + 2, LANES))
    payload[:, 2] = np.where(g.random(LANES) < 0.6, ballots, g.integers(-1, 3 * N, LANES))
    payload[:, 3] = g.integers(-1, 3 * N, LANES)
    payload[:, 4] = g.integers(0, 200, LANES)
    learn = payload[:, 0] == multipaxos.M_LEARN
    payload[learn, 2] = g.integers(0, 200, int(learn.sum()))
    return node, tid, t_now, rand, src, payload


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_handlers_match_jax(snapshots, variant):
    jax_cls, port_cls = VARIANTS[variant]
    check_handlers(jax_cls(N), port_cls(N), snapshots, _inputs)


def test_invariant_done_summary_restart_match_jax(snapshots):
    jax_m, port_m = jax_mp.MultiPaxosMachine(N), multipaxos.MultiPaxosMachine(N)
    for k, (np_nodes, now) in enumerate(snapshots):
        bad = jax.tree.map(np.copy, np_nodes)
        bad.bad[::3, 0] = True  # AGREEMENT_MULTI
        bad.chosen_any[1::3, 0, 2] = True  # LEARN_DIVERGED
        bad.chosen_val[1::3, 0, 2] = 5
        bad.learned[1::3, 3, 2] = 6
        bad.learned[2::3, :2] = 1  # both proposers learned every slot
        _, code = port_m.invariant(torch_nodes(multipaxos.MultiPaxosState, bad), torch.from_numpy(now.copy()))
        assert {multipaxos.AGREEMENT_MULTI, multipaxos.LEARN_DIVERGED} <= set(code.tolist())
        check_hooks(jax_m, port_m, [np_nodes, bad], now, seed=k)


def test_step_batch_matches_jax_from_a_carried_state():
    """v2 lanes and MultiPaxosState carried over from JAX mid-run, then
    stepped side by side (the recorder and coverage on, so the digest
    and the buffered slots are compared too)."""
    jax_eng, port = _engines("nopromise", flight_recorder=True, coverage=True)
    step = jax.jit(jax_eng.step_batch)
    state = jax.jit(jax_eng.init_batch)(jnp.arange(16, dtype=jnp.uint32) + 3)
    for _ in range(40):
        state = step(state)
    carried = lane_state_from_numpy(jax.tree.map(np.asarray, state), port.machine, device=port.device)
    assert isinstance(carried.nodes, multipaxos.MultiPaxosState)
    for k in range(30):
        state, carried = step(state), port.step_batch(carried)
        same(state, carried, k)


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_run_batch_matches_jax(variant):
    jax_eng, port = _engines(variant)
    seeds = np.arange(LANES, dtype=np.uint32)
    want = jax.jit(jax_eng.run_batch, static_argnums=1)(jnp.asarray(seeds), 400)
    same(want, port.run_batch(seeds, 400))
    inj = np.asarray(jax.jit(jax_eng.init_batch)(jnp.asarray(seeds)).eq_payload)[:, N : N + 6, 0]
    assert {2, 4, 6, 8} <= set(inj.ravel().tolist())  # dir, group and storm faults scheduled
    if variant == "nopromise":
        assert (np.asarray(want.fail_code) == multipaxos.AGREEMENT_MULTI).sum() >= 4

