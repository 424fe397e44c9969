"""The chaos palette's pause, skew, dup and strict-restart gates in the
port, against host oracles and the JAX package (the ports of
tests/test_chaos_palette.py's tests of those gates): the pause and skew
oracles walk the port's replay trace, which equals the JAX package's
event for event on both streams; the dup differential; the two seeded
durable-contract bugs, VolatileCommit (102 under strict restarts) and
the duplicate-vote tally (101 under dup), caught on both engines with
honest Raft clean; and the `durable_spec` refusal. Every comparison with
the JAX package is exact."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from madsim_tpu.engine import Engine as JaxEngine
from madsim_tpu.engine import EngineConfig as JaxConfig
from madsim_tpu.engine import FaultPlan as JaxFaultPlan
from madsim_tpu.engine import core as jax_core
from madsim_tpu.engine.replay import replay as jax_replay
from madsim_tpu.models import raft as jax_raft
from madsim_tpu_torch.engine import Engine, EngineConfig, FaultPlan, core
from madsim_tpu_torch.engine.machine import Machine, make_payload, send_if, set_at, set_timer_if
from madsim_tpu_torch.engine.replay import replay
from madsim_tpu_torch.interop import tree_to_numpy
from madsim_tpu_torch.models import build_machine, raft
from madsim_tpu_torch.utils import take

from test_chaos_palette import HORIZON_US, TICK_US, WINDOW
from test_chaos_palette import DupVoteRaft as JaxDupVoteRaft
from test_chaos_palette import TickMachine as JaxTickMachine
from test_chaos_palette import VolatileCommitRaft as JaxVolatileCommitRaft
from torch_port_util import jax_to_numpy, same, tree_diff

STREAMS = [2, 3]


@dataclasses.dataclass
class TickState:
    ticks: torch.Tensor  # int32[L, 3]
    rx: torch.Tensor  # int32[L, 3]


class TickMachine(Machine):
    """The reference test's three periodic tickers, lane-batched: every
    node counts its own ticks; node 0 reports each tick to node 2."""

    NUM_NODES = 3
    PAYLOAD_WIDTH = 3
    MAX_MSGS = 1
    MAX_TIMERS = 1
    state_type = TickState

    def init(self, rng_key):
        z = torch.zeros((rng_key.shape[0], self.NUM_NODES), dtype=torch.int32, device=rng_key.device)
        return TickState(ticks=z, rx=z.clone())

    def on_timer(self, nodes, node, timer_id, now_us, rand_u32):
        outbox = self.empty_outbox(node.shape[0], node.device)
        is_tick = timer_id == 1
        nodes = dataclasses.replace(nodes, ticks=set_at(nodes.ticks, node, take(nodes.ticks, node) + 1, is_tick))
        outbox = set_timer_if(outbox, 0, torch.ones_like(is_tick), TICK_US, 1)
        pay = make_payload(self.PAYLOAD_WIDTH, 1, take(nodes.ticks, node))
        outbox = send_if(outbox, 0, is_tick & (node == 0), self.NUM_NODES - 1, pay)
        return nodes, outbox

    def on_message(self, nodes, node, src, payload, now_us, rand_u32):
        nodes = dataclasses.replace(nodes, rx=set_at(nodes.rx, node, take(nodes.rx, node) + 1))
        return nodes, self.empty_outbox(node.shape[0], node.device)


def _only_kind(**kind_flags) -> dict:
    return dict(n_faults=1, allow_partition=False, allow_kill=False, **WINDOW, **kind_flags)


def _tick_engines(faults, **cfg):
    return (JaxEngine(JaxTickMachine(), JaxConfig(faults=JaxFaultPlan(**faults), **cfg)),
            Engine(TickMachine(), EngineConfig(faults=FaultPlan(**faults), **cfg), device="cpu"))


def _events(trace):
    return [(e.step, e.time_us, e.kind, e.node, e.src, tuple(e.payload), e.seq) for e in trace]


def _lane(jax_state):
    return jax.tree.map(lambda x: np.asarray(x)[None], jax_to_numpy(jax_state))


def _replay_both(faults, rng_stream, **cfg):
    """The port's replay of seed 0, after checking its trace and final
    state against the JAX package's."""
    jax_eng, port = _tick_engines(faults, horizon_us=HORIZON_US, rng_stream=rng_stream, **cfg)
    want, got = jax_replay(jax_eng, 0, max_steps=400), replay(port, 0, max_steps=400)
    assert _events(got.trace) == _events(want.trace)
    assert not tree_diff(_lane(want.state), tree_to_numpy(got.state))
    return got


def test_constants_match_the_reference():
    for name in ("DUP_PROB_U32", "SKEW_Q10_MIN", "SKEW_Q10_SPAN", "F_PAUSE", "F_RESUME", "F_SKEW",
                 "F_SKEW_END", "K_PAUSE", "K_SKEW"):
        assert getattr(core, name) == getattr(jax_core, name), name


def test_skew_scale_matches_the_reference():
    g = np.random.default_rng(5)
    d = np.concatenate([g.integers(0, 2_000_000, 200), [0, 1, 1023, 1024, 50_000, 300_000]]).astype(np.int32)
    q = g.integers(core.SKEW_Q10_MIN, core.SKEW_Q10_MIN + core.SKEW_Q10_SPAN, d.size).astype(np.int32)
    want = np.asarray(jax_core.skew_scale_us(jnp.asarray(d), jnp.asarray(q)))
    got = core.skew_scale_us(torch.from_numpy(d), torch.from_numpy(q))
    assert got.dtype == torch.int32 and np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("rng_stream", STREAMS)
def test_pause_defers_and_preserves_state(rng_stream):
    """The reference's pause oracle on the port's replay: fault events
    always apply; a handler event whose target is paused at pop time is
    deferred (popped, not processed, re-delivered at the resume time);
    the horizon pop is never processed. The counters it predicts are the
    port's final state."""
    rp = _replay_both(_only_kind(allow_pause=True), rng_stream, queue_capacity=32)
    assert not rp.failed
    paused, expect, deferred, window = {}, {"ticks": [0] * 3, "rx": [0] * 3}, 0, None
    for ev in rp.trace:
        if ev.time_us >= HORIZON_US:
            continue
        if ev.kind == "fault":
            if ev.payload[0] == core.F_PAUSE:
                paused[ev.payload[1]] = ev.payload[2]
                window = (ev.time_us, ev.payload[2], ev.payload[1])
            elif ev.payload[0] == core.F_RESUME:
                paused[ev.payload[1]] = 0
            continue
        if paused.get(ev.node, 0) > ev.time_us:
            deferred += 1
            continue
        if ev.kind == "timer" and ev.payload[0] == 1:
            expect["ticks"][ev.node] += 1
        if ev.kind == "msg":
            expect["rx"][ev.node] += 1
    assert deferred > 0, "pause window deferred nothing: the test is vacuous"
    assert rp.state.nodes.ticks[0].tolist() == expect["ticks"]
    assert rp.state.nodes.rx[0].tolist() == expect["rx"]
    # every deferred event re-delivers at the resume time, keeping its seq
    t0, resume, pn = window
    in_window = [ev for ev in rp.trace if ev.kind != "fault" and ev.node == pn and t0 < ev.time_us < resume]
    redelivered = [ev for ev in rp.trace if ev.kind != "fault" and ev.node == pn and ev.time_us == resume]
    assert in_window and redelivered
    assert {ev.seq for ev in in_window} <= {ev.seq for ev in redelivered}


@pytest.mark.parametrize("rng_stream", STREAMS)
def test_skew_scales_timer_delays_exactly(rng_stream):
    """The reference's skew oracle on the port's replay: while a node's
    skew window is active, each timer it arms lands at t + the exact
    int32 q10 scaling of the tick."""
    rp = _replay_both(_only_kind(allow_skew=True), rng_stream, queue_capacity=32)
    assert not rp.failed
    skew, expected_next, scaled_arms = {}, {}, 0
    for ev in rp.trace:
        if ev.kind == "fault":
            if ev.payload[0] == core.F_SKEW:
                skew[ev.payload[1]] = ev.payload[2]
            elif ev.payload[0] == core.F_SKEW_END:
                skew[ev.payload[1]] = 0
            continue
        if ev.kind != "timer":
            continue
        if ev.node in expected_next:
            assert ev.time_us == expected_next[ev.node], ev
        if ev.time_us >= HORIZON_US:
            continue
        q = skew.get(ev.node, 0)
        d = TICK_US if q == 0 else ((TICK_US >> 10) * q + (((TICK_US & 1023) * q) >> 10))
        scaled_arms += bool(q)
        expected_next[ev.node] = ev.time_us + d
    assert scaled_arms > 0, "skew window scaled nothing: the test is vacuous"


@pytest.mark.parametrize("rng_stream", STREAMS)
def test_dup_duplicates_delivered_messages(rng_stream):
    """Dup on runs the dup-off tick schedule (the dup words ride the
    block's tail) plus duplicates: the msg_count delta is the recorder's
    dup counter, and the receiver sees more deliveries. Both runs equal
    the JAX package's."""
    off = dict(n_faults=0, allow_partition=False, allow_kill=False)
    outs = []
    for faults in (off, {**off, "allow_dup": True}):
        jax_eng, port = _tick_engines(faults, horizon_us=HORIZON_US, queue_capacity=48, flight_recorder=True,
                                      rng_stream=rng_stream)
        got = replay(port, 0, max_steps=400, trace=False).state
        assert not tree_diff(_lane(jax_replay(jax_eng, 0, max_steps=400, trace=False).state), tree_to_numpy(got))
        outs.append(got)
    r_off, r_on = outs
    dups = int(r_on.fr["dup"])
    assert dups > 0 and int(r_on.msg_count) - int(r_off.msg_count) == dups
    assert torch.equal(r_on.nodes.ticks, r_off.nodes.ticks)
    assert int(r_on.nodes.rx[0, 2]) > int(r_off.nodes.rx[0, 2])


def _run_both(jax_machine, port_machine, cfg, seeds, max_steps):
    """run_batch on both engines; asserts the port's equals the JAX
    package's and returns the port's."""
    faults = cfg.pop("faults")
    jax_eng = JaxEngine(jax_machine, JaxConfig(faults=JaxFaultPlan(**faults), **cfg))
    port = Engine(port_machine, EngineConfig(faults=FaultPlan(**faults), **cfg), device="cpu")
    want = jax.jit(jax_eng.run_batch, static_argnums=1)(jnp.asarray(seeds, dtype=jnp.uint32), max_steps)
    got = port.run_batch(np.asarray(seeds, dtype=np.uint32), max_steps)
    same(want, got)
    return got


def _codes(res):
    return {int(c) for c, f in zip(res.fail_code.tolist(), res.failed.tolist()) if f}


# seeds the JAX package fails on under each demo's plan (of 0-63), with
# passing seeds beside them: VolatileCommit fails 0, 3, 6, 8, 9, 11 and
# 12 by step 344; the dup-vote tally fails 24, 91, 140 and 150 by step 55
VOLATILE_SEEDS, VOLATILE_STEPS = list(range(16)), 360
DUPVOTE_SEEDS, DUPVOTE_STEPS = [24, 91, 140, 150] + list(range(8)), 96


def test_strict_restart_catches_volatile_commit_bug():
    """A raft whose durable_spec persists commitIndex but not the log:
    under strict restarts the first restart after a commit leaves commit
    over a wiped log, caught by LogMatching (102) on both engines; the
    honest machine under the same plan stays clean."""
    cfg = dict(horizon_us=3_000_000, queue_capacity=64, flight_recorder=True,
               faults=dict(n_faults=2, t_max_us=1_800_000, dur_min_us=100_000, dur_max_us=600_000,
                           strict_restart=True))
    bug = _run_both(JaxVolatileCommitRaft(5, 8), build_machine("demo-volatilecommit-raft"), dict(cfg),
                    VOLATILE_SEEDS, VOLATILE_STEPS)
    assert _codes(bug) == {raft.LOG_MATCHING} and int(bug.failed.sum()) >= 5
    assert int(bug.fr["amnesia"].sum()) > 0
    honest = _run_both(jax_raft.RaftMachine(5, 8), raft.RaftMachine(5, 8), dict(cfg), VOLATILE_SEEDS, VOLATILE_STEPS)
    assert int(honest.failed.sum()) == 0


def test_strict_restart_requires_durable_spec():
    with pytest.raises(ValueError, match="durable_spec"):
        Engine(TickMachine(), EngineConfig(queue_capacity=32, faults=FaultPlan(n_faults=1, strict_restart=True)),
               device="cpu")
    # no kill, no restart: nothing to wipe, so no contract is needed
    Engine(TickMachine(), EngineConfig(queue_capacity=32, faults=FaultPlan(n_faults=1, allow_kill=False,
                                                                           strict_restart=True)), device="cpu")


def test_dup_chaos_catches_duplicate_vote_tally():
    """The per-message vote tally (DupVoteRaft): a duplicated grant
    elects two leaders in one term (ELECTION_SAFETY, 101) on both
    engines; the voter-bitmask tally is dup-safe."""
    cfg = dict(horizon_us=1_000_000, queue_capacity=96,
               faults=dict(n_faults=2, t_max_us=600_000, dur_min_us=100_000, dur_max_us=800_000, allow_dup=True))
    bug = _run_both(JaxDupVoteRaft(5, 8), build_machine("demo-dupvote-raft"), dict(cfg), DUPVOTE_SEEDS,
                    DUPVOTE_STEPS)
    assert _codes(bug) == {raft.ELECTION_SAFETY} and int(bug.failed.sum()) == 4
    fixed = _run_both(jax_raft.RaftMachine(5, 8), raft.RaftMachine(5, 8), dict(cfg), DUPVOTE_SEEDS, DUPVOTE_STEPS)
    assert int(fixed.failed.sum()) == 0
