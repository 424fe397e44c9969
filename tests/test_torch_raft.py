"""The port's batched Raft handlers against the JAX model's vmapped
ones, on reachable node states: the states come from a JAX run of the
flagship hunt stopped at several step counts and are carried over with
`madsim_tpu_torch.interop`. Handler inputs (node, timer ids, messages,
random words) come from numpy; every comparison is exact, for the
honest model and its four seeded-bug variants."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from madsim_tpu.models import raft as jax_raft
from madsim_tpu_torch.interop import tree_to_numpy
from madsim_tpu_torch.models import raft

from torch_port_util import engines, jax_to_numpy, tree_diff

LANES = 32
SNAP_STEPS = (0, 25, 80, 200, 400)
FLAGS = ("COMMIT_TO_LOG_LEN", "QUORUM_OFF_BY_ONE", "PERSIST_COMMIT_NOT_LOG", "DUP_VOTE_COUNT")


def _variant(base, flag):
    return type(f"{base.__name__}_{flag}", (base,), {flag: True}) if flag else base


@pytest.fixture(scope="module")
def snapshots():
    """Node states of a JAX flagship run at SNAP_STEPS, as numpy trees."""
    jax_eng, _ = engines(jax_raft.RaftMachine(5, 8), raft.RaftMachine(5, 8))
    step = jax.jit(jax_eng.step_batch)
    state = jax.jit(jax_eng.init_batch)(jnp.arange(LANES, dtype=jnp.uint32) + 500)
    snaps = []
    for k in range(max(SNAP_STEPS) + 1):
        if k in SNAP_STEPS:
            snaps.append((jax.tree.map(np.asarray, state.nodes), np.asarray(state.now_us)))
        state = step(state)
    return snaps


def _torch_nodes(np_nodes):
    return raft.RaftState(**{
        f.name: torch.from_numpy(np.asarray(getattr(np_nodes, f.name)).copy())
        for f in dataclasses.fields(raft.RaftState)
    })


def _inputs(seed, np_nodes, now):
    g = np.random.default_rng(seed)
    n, cap = 5, 8
    node = g.integers(0, n, LANES).astype(np.int32)
    epoch = np.asarray(np_nodes.epoch)[np.arange(LANES), node]
    tid = (g.integers(0, 4, LANES) + 4 * (epoch - g.integers(0, 2, LANES))).astype(np.int32)
    tid[::6] = 0  # BOOT
    t_now = (now + g.integers(0, 400_000, LANES)).astype(np.int32)
    rand = g.integers(0, 2**32, (LANES, 4), dtype=np.uint32)
    src = ((node + g.integers(1, n, LANES)) % n).astype(np.int32)
    max_term = int(np.asarray(np_nodes.term).max())
    payload = np.zeros((LANES, 6), np.int32)
    payload[:, 0] = g.integers(1, 5, LANES)
    payload[:, 1] = g.integers(0, max_term + 3, LANES)
    payload[:, 2] = g.integers(-1, cap + 2, LANES)
    payload[:, 3] = g.integers(-1, cap + 2, LANES)
    payload[:, 4] = g.integers(0, max_term + 2, LANES)
    payload[:, 5] = g.integers(0, cap + 1, LANES)
    vote = payload[:, 0] == raft.M_VOTE
    payload[vote, 2] = g.integers(0, 2, int(vote.sum()))
    return node, tid, t_now, rand, src, payload


def _check(want, got, what):
    diff = tree_diff(jax_to_numpy(want), tree_to_numpy(got))
    assert not diff, (what, diff[:5])


@pytest.mark.parametrize("flag", (None,) + FLAGS)
def test_handlers_match_jax(snapshots, flag):
    jax_m = _variant(jax_raft.RaftMachine, flag)(5, 8)
    port_m = _variant(raft.RaftMachine, flag)(5, 8)
    on_timer = jax.jit(jax.vmap(jax_m.on_timer))
    on_message = jax.jit(jax.vmap(jax_m.on_message))
    for k, (np_nodes, now) in enumerate(snapshots):
        node, tid, t_now, rand, src, payload = _inputs(k, np_nodes, now)
        t = torch.from_numpy
        t_nodes, t_rand = _torch_nodes(np_nodes), t(rand.astype(np.int64))
        _check(on_timer(np_nodes, node, tid, t_now, rand),
               port_m.on_timer(t_nodes, t(node), t(tid), t(t_now), t_rand), ("on_timer", k))
        _check(on_message(np_nodes, node, src, payload, t_now, rand),
               port_m.on_message(t_nodes, t(node), t(src), t(payload), t(t_now), t_rand),
               ("on_message", k))


def test_invariant_done_summary_projection_restart_match_jax(snapshots):
    jax_m, port_m = jax_raft.RaftMachine(5, 8), raft.RaftMachine(5, 8)
    invariant = jax.jit(jax.vmap(jax_m.invariant))
    is_done = jax.jit(jax.vmap(jax_m.is_done))
    summary = jax.jit(jax.vmap(jax_m.summary))
    projection = jax.jit(jax.vmap(jax_m.coverage_projection))
    restart = jax.jit(jax.vmap(jax_m.restart_node_if))
    g = np.random.default_rng(7)
    for k, (np_nodes, now) in enumerate(snapshots):
        states = [np_nodes]
        # violations: two leaders of one term; a committed position whose
        # log terms disagree; a full commit (is_done)
        bad = jax.tree.map(np.copy, np_nodes)
        bad.role[::3, :2] = raft.LEADER
        bad.term[::3, 1] = bad.term[::3, 0]
        bad.commit[1::3, :] = 2
        bad.log_term[1::3, 0, 1:3] = 7
        bad.commit[2::3, :] = 8
        states.append(bad)
        ok, code = port_m.invariant(_torch_nodes(bad), torch.from_numpy(now.copy()))
        assert {raft.ELECTION_SAFETY, raft.LOG_MATCHING} <= set(code.tolist())
        assert port_m.is_done(_torch_nodes(bad), torch.from_numpy(now.copy())).any()
        for s in states:
            t_nodes = _torch_nodes(s)
            t_now = torch.from_numpy(now.copy())
            _check(invariant(s, now), port_m.invariant(t_nodes, t_now), ("invariant", k))
            _check(is_done(s, now), port_m.is_done(t_nodes, t_now), ("is_done", k))
            _check(summary(s), port_m.summary(t_nodes), ("summary", k))
            want = np.asarray(projection(s, now))
            assert port_m.coverage_projection(t_nodes, t_now).numpy().tolist() == want.tolist()
            node = g.integers(0, 5, LANES).astype(np.int32)
            cond = g.random(LANES) < 0.5
            keys = g.integers(0, 2**32, (LANES, 2), dtype=np.uint32)
            _check(restart(s, node, cond, keys),
                   port_m.restart_node_if(t_nodes, torch.from_numpy(node), torch.from_numpy(cond),
                                          torch.from_numpy(keys.astype(np.int64))),
                   ("restart", k))
