"""Causal provenance in the port against the JAX package: the lineage
word layout, the fold in the lane step (every lane leaf with the gate on,
both streams, under one mixed plan of every kind with dup and 2% loss),
the gate changing no other leaf, the pinned violation words
(tests/test_golden_streams.py:560-636), the failure ring's words in
`run_stream`, the host half (`fault_schedule`, `implicated`,
`kind_counts`, `render_why`) and provenance-guided shrink. The tier-1
cases of tests/test_provenance.py are mirrored on the port, on one
replay of the pinned volatile-commit find."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from madsim_tpu.__main__ import build_machine as jax_build
from madsim_tpu.engine import Engine as JaxEngine
from madsim_tpu.engine import EngineConfig as JaxConfig
from madsim_tpu.engine import FaultPlan as JaxFaultPlan
from madsim_tpu.engine import provenance as jax_prov
from madsim_tpu.engine.shrink import shrink as jax_shrink
from madsim_tpu.models import raft as jax_raft
from madsim_tpu_torch.engine import Engine, EngineConfig, FaultPlan
from madsim_tpu_torch.engine.core import (
    F_CLOG_PAIR,
    F_KILL,
    F_RESTART,
    F_UNCLOG_PAIR,
    PROV_BIT_AMNESIA,
    PROV_BIT_DUP,
    PROV_FAULT_BITS,
    prov_fault_bit,
)
from madsim_tpu_torch.engine.provenance import (
    fault_schedule,
    implicated,
    kind_counts,
    render_why,
    replay_with_lineage,
)
from madsim_tpu_torch.engine.replay import replay
from madsim_tpu_torch.engine.shrink import shrink
from madsim_tpu_torch.interop import tree_to_numpy
from madsim_tpu_torch.models import build_machine, raft

from torch_port_util import engines, jax_to_numpy, tree_diff

SEED = 5
MAX_STEPS = 3000
VOLATILE_FAULTS = dict(n_faults=2, t_max_us=3_000_000, dur_min_us=100_000, dur_max_us=800_000, strict_restart=True)
VOLATILE = dict(horizon_us=5_000_000, queue_capacity=96, provenance=True)
# the pinned violation words (tests/test_golden_streams.py:570-573):
# 0x40000002 = fault #1 (the kill) + the amnesia bit, 0x40000001 = fault #0 + it
PROV_PINNED = {2: (5, 102, 0x40000002), 3: (8, 102, 0x40000001)}
# one mixed plan of every kind, with dup, strict restarts and 2% loss
MIXED_FAULTS = dict(n_faults=3, t_max_us=3_000_000, dur_min_us=100_000, dur_max_us=800_000, allow_dir_clog=True,
                    allow_group=True, allow_storm=True, allow_delay=True, allow_pause=True, allow_skew=True,
                    allow_dup=True, allow_heal_asym=True, strict_restart=True)
MIXED = dict(queue_capacity=64, packet_loss_rate=0.02, faults=MIXED_FAULTS)
PROV_LEAVES = ("node_prov", "eq_prov", "fail_prov")


def _volatile(rng_stream=2, **overrides):
    cfg = {**VOLATILE, "rng_stream": rng_stream, **overrides}
    faults = cfg.pop("faults", VOLATILE_FAULTS)
    return (JaxEngine(jax_build("demo-volatilecommit-raft", 0), JaxConfig(faults=JaxFaultPlan(**faults), **cfg)),
            Engine(build_machine("demo-volatilecommit-raft"), EngineConfig(faults=FaultPlan(**faults), **cfg),
                   device="cpu"))


@pytest.fixture(scope="module")
def volatile_find():
    """The pinned find's lineage replay on the port (and the JAX package's
    engine beside it), shared by the cases below."""
    jax_eng, eng = _volatile()
    rp, lineage = replay_with_lineage(eng, SEED, max_steps=MAX_STEPS)
    assert rp.failed and rp.fail_code == 102
    return jax_eng, eng, rp, lineage


def test_word_layout_and_init_planes_match_jax():
    """Fault f owns bit min(f, 29), bits 30 / 31 are the amnesia and dup
    channels, and init's eq_prov plane carries exactly the slot bits
    (boot timers are roots), under both derivations and heal-asym's three
    slots a fault: every init leaf equal to the JAX package's."""
    assert (PROV_FAULT_BITS, PROV_BIT_AMNESIA, PROV_BIT_DUP) == (30, 30, 31)
    assert prov_fault_bit(0) == 1 and prov_fault_bit(29) == prov_fault_bit(40) == 2**29
    seeds = np.arange(4, dtype=np.uint32) + 7
    v1 = dict(n_faults=2, t_max_us=3_000_000)
    v2 = dict(v1, allow_dir_clog=True, allow_storm=True)
    v3 = dict(v1, allow_heal_asym=True, allow_pause=True)
    for faults, slots in ((v1, [1, 1, 2, 2]), (v2, [1, 1, 2, 2]), (v3, [1, 1, 1, 2, 2, 2])):
        jax_eng, port = engines(jax_raft.RaftMachine(5, 8), raft.RaftMachine(5, 8), provenance=True, faults=faults)
        want = jax.jit(jax_eng.init_batch)(jnp.asarray(seeds))
        got = port.init_batch(seeds)
        diff = tree_diff(jax_to_numpy(want), tree_to_numpy(got))
        assert not diff, (faults, diff[:5])
        prov = tree_to_numpy(got)["eq_prov"]
        assert (prov[:, :5] == 0).all() and (prov[:, 5:5 + len(slots)] == slots).all(), faults
        assert not prov[:, 5 + len(slots):].any()
        assert got.node_prov.shape == (4, 5) and got.fail_prov.shape == (4,)


@pytest.mark.parametrize("rng_stream", [2, 3], ids=["rng-v2", "rng-v3"])
def test_pinned_violation_words(rng_stream):
    """The golden words: the pinned seed fails with the pinned code and
    word on the port's replay, as on the JAX package's."""
    seed, code, word = PROV_PINNED[rng_stream]
    rp = replay(_volatile(rng_stream)[1], seed, max_steps=MAX_STEPS, trace=False)
    assert rp.failed and rp.fail_code == code
    assert rp.fail_prov == word, hex(rp.fail_prov)


@pytest.mark.parametrize("rng_stream", [2, 3], ids=["rng-v2", "rng-v3"])
def test_lane_planes_match_jax_under_every_kind(rng_stream):
    """The fold under one plan of every kind, dup and 2% loss, on the
    volatile-commit demo (lanes fail, words reach bits 30 and 31): every
    lane leaf after 240 steps, provenance planes included, equal to the
    JAX package's, and `run_batch`'s whole BatchResult too."""
    jax_eng, port = engines(jax_build("demo-volatilecommit-raft", 0), build_machine("demo-volatilecommit-raft"),
                            rng_stream=rng_stream, provenance=True, **MIXED)
    seeds = np.arange(16, dtype=np.uint32)
    want = jax.jit(jax_eng.run_segment, static_argnums=1)(jax.jit(jax_eng.init_batch)(jnp.asarray(seeds)), 240)
    got = port.run_segment(port.init_batch(seeds), 240)
    diff = tree_diff(jax_to_numpy(want), tree_to_numpy(got))
    assert not diff, diff[:5]
    words = tree_to_numpy(got)["fail_prov"][tree_to_numpy(got)["failed"]]
    assert words.size and (words >> PROV_BIT_AMNESIA & 1).any()
    assert (tree_to_numpy(got)["eq_prov"] >> PROV_BIT_DUP & 1).any()  # duplicate copies in the queues
    want = jax.jit(jax_eng.run_batch, static_argnums=1)(jnp.asarray(seeds[:8]), 160)
    got = port.run_batch(seeds[:8], 160)
    diff = tree_diff(jax_to_numpy(want), tree_to_numpy(got))
    assert not diff, diff[:5]


@pytest.mark.parametrize("rng_stream", [2, 3], ids=["rng-v2", "rng-v3"])
def test_gate_changes_no_other_leaf(rng_stream):
    """Provenance on against off in the port: every leaf but the three
    provenance planes equal, and off they stay [L, 0]."""
    kw = dict(rng_stream=rng_stream, flight_recorder=True, coverage=True, trace_ring=8, **MIXED)
    faults = kw.pop("faults")
    m = build_machine("demo-volatilecommit-raft")
    seeds = np.arange(12, dtype=np.uint32) + 40
    states = {}
    for on in (False, True):
        eng = Engine(m, EngineConfig(faults=FaultPlan(**faults), provenance=on, **kw), device="cpu")
        states[on] = tree_to_numpy(eng.run_segment(eng.init_batch(seeds), 200))
    for name in PROV_LEAVES:
        assert states[False].pop(name).shape[1:] == (0,)
        states[True].pop(name)
    assert not tree_diff(states[False], states[True])


def test_attribution_names_the_seeded_kind(volatile_find):
    """The word decodes to the seeded bug's cause, the kill fault (whose
    strict restart loses the log) and the amnesia channel; the schedule,
    the attribution and the kind counts equal the JAX package's."""
    jax_eng, eng, rp, _lineage = volatile_find
    word = rp.fail_prov
    att = implicated(eng, SEED, word)
    assert att.kinds == ("kill", "strict-restart") and (word >> PROV_BIT_AMNESIA) & 1
    [fault] = att.faults
    assert fault.kind_name == "kill" and fault.target == f"node {fault.arg1}"
    assert 0 < fault.t_apply_us < fault.t_undo_us
    sched = fault_schedule(eng, SEED)
    assert [f.kind_name for f in sched] == ["pair", "kill"]
    assert kind_counts(eng, {SEED: word}) == {"kill": 1, "strict-restart": 1}
    assert [dataclasses.asdict(f) for f in sched] == [dataclasses.asdict(f) for f in
                                                      jax_prov.fault_schedule(jax_eng, SEED)]
    want = jax_prov.implicated(jax_eng, SEED, word)
    assert (att.word, att.kinds, att.aliased, att.describe()) == (want.word, want.kinds, want.aliased,
                                                                  want.describe())
    words = {SEED: word, 8: 0x80000001, 19: 0}
    assert kind_counts(eng, words) == jax_prov.kind_counts(jax_eng, words)


def test_host_oracle_differential(volatile_find):
    """The violation's word recomputed from the trace and the documented
    semantics alone (fault slots own their bit, deliveries OR into the
    handling node, killed nodes consume without folding, pushes inherit
    the sender's word, strict restarts add the amnesia bit) equals the
    port's, and so does every delivered message's word."""
    _jax_eng, eng, rp, lineage = volatile_find
    n = eng.machine.NUM_NODES
    fp = eng.config.faults
    spf = fp.slots_per_fault
    init_seq = n + spf * fp.n_faults
    seq_word, node_w, killed = {}, [0] * n, [False] * n
    prev_mark, final_word = init_seq, None
    for i, ev in enumerate(lineage.trace):
        if ev.time_us >= eng.config.horizon_us:
            break
        if ev.seq < n:
            w = 0
        elif ev.seq < init_seq:
            w = 1 << min((ev.seq - n) // spf, 29)
        else:
            w = seq_word[ev.seq]
        if ev.kind == "fault":
            op, a, b = ev.payload[0], ev.payload[1], ev.payload[2]
            if op == F_RESTART and fp.strict_restart:
                w |= 1 << PROV_BIT_AMNESIA
            if op in (F_CLOG_PAIR, F_UNCLOG_PAIR):
                touched = [a, b]
            else:
                assert op in (F_KILL, F_RESTART), op
                touched = [a]
            if op in (F_KILL, F_RESTART):
                killed[a] = op == F_KILL
            for t in touched:
                node_w[t] |= w
        elif not killed[ev.node]:
            node_w[ev.node] |= w
        sender = node_w[ev.node]
        for q in range(prev_mark, lineage.next_seq_after[i]):
            seq_word[q] = sender
        prev_mark = lineage.next_seq_after[i]
        final_word = w | sender
    assert final_word == rp.fail_prov, (hex(final_word), hex(rp.fail_prov))
    for ev in lineage.trace:
        if ev.kind == "msg" and ev.seq in seq_word:
            assert ev.prov == seq_word[ev.seq], ev


def test_lineage_cone_flows_and_why_text(volatile_find):
    """Parents precede children, every flow's sender is the delivery's
    src, the cone holds the implicated kill's injections and cuts the
    trace; the trace's words and `render_why` equal the JAX package's,
    byte for byte."""
    jax_eng, eng, rp, lineage = volatile_find
    assert all(p < i for i, ps in enumerate(lineage.parents) for p in ps)
    flows = lineage.message_flows()
    assert flows
    for i, j in flows:
        send, recv = lineage.trace[i], lineage.trace[j]
        assert recv.kind == "msg" and send.node == recv.src and send.time_us <= recv.time_us
    cone = lineage.past_cone(len(lineage.trace) - 1)
    assert 0 < len(cone) < len(lineage.trace)
    att = implicated(eng, SEED, rp.fail_prov)
    kills = [i for i, ev in enumerate(lineage.trace)
             if ev.kind == "fault" and ev.payload[0] == F_KILL and ev.payload[1] == att.faults[0].arg1]
    assert kills and all(i in cone for i in kills)
    want_rp, want_lineage = jax_prov.replay_with_lineage(jax_eng, SEED, max_steps=MAX_STEPS)
    assert [(e.seq, e.prov) for e in lineage.trace] == [(e.seq, e.prov) for e in want_lineage.trace]
    want_att = jax_prov.implicated(jax_eng, SEED, int(want_rp.state.fail_prov))
    for tail in (0, 5):
        want = jax_prov.render_why(jax_eng, SEED, want_rp, want_lineage, cone, want_att, max_events=tail)
        assert render_why(eng, SEED, rp, lineage, cone, att, max_events=tail) == want
    assert "implicated kinds: kill,strict-restart" in want


def test_dup_channel_attribution():
    """A dup find carries bit 31: the duplicate copy plants it, delivery
    folds it into the tallying candidate, and the word names `dup`, equal
    to the JAX package's word (its uint32 value, not a negative int)."""
    faults = dict(VOLATILE_FAULTS, strict_restart=False, allow_dup=True)
    jax_eng = JaxEngine(jax_build("demo-dupvote-raft", 0), JaxConfig(faults=JaxFaultPlan(**faults), **VOLATILE))
    eng = Engine(build_machine("demo-dupvote-raft"), EngineConfig(faults=FaultPlan(**faults), **VOLATILE),
                 device="cpu")
    rp = replay(eng, 24, max_steps=MAX_STEPS, trace=False)
    assert rp.failed and rp.fail_code == 101
    from madsim_tpu.engine.replay import replay as jax_replay

    assert rp.fail_prov == int(jax_replay(jax_eng, 24, max_steps=MAX_STEPS, trace=False).state.fail_prov)
    assert (rp.fail_prov >> PROV_BIT_DUP) & 1 and rp.fail_prov > 0
    assert "dup" in implicated(eng, 24, rp.fail_prov).kinds


@pytest.mark.parametrize("pipelined", [False, True], ids=["per-segment", "pipelined"])
def test_stream_harvest_matches_jax_and_replay(pipelined):
    """`run_stream`'s provenance dict (the failure ring's words) equals
    the JAX package's, names every find, and each word equals the port's
    replay of that seed."""
    jax_eng, eng = _volatile(3, horizon_us=3_000_000, queue_capacity=48,
                             faults=dict(VOLATILE_FAULTS, t_max_us=1_800_000, dur_max_us=600_000))
    kw = dict(batch=16, segment_steps=96, max_steps=600)
    want = jax_eng.run_stream(40, **kw)
    got = eng.run_stream(40, pipelined=pipelined, **kw)
    for key in ("completed", "failing", "infra", "abandoned", "provenance"):
        assert got[key] == want[key], key
    assert got["failing"] and set(got["provenance"]) == {s for s, _ in got["failing"] + got["infra"]}
    for seed, _code in got["failing"][:2]:
        assert replay(eng, seed, max_steps=600, trace=False).fail_prov == got["provenance"][seed]


def test_guided_shrink_matches_jax_and_beats_unguided():
    """The guided ShrinkResult of a three-fault double-grant find equals
    the JAX package's and takes fewer replays than the unguided one; a
    word given as `prov_word` to a gate-off engine guides it the same
    way. Guidance orders candidates only: the fault scan keeps the first
    prefix that reproduces, so here it stops at the implicated fault's
    prefix (1 fault) where the unguided scan, trying 0 first, drops all
    three, as the reference's does."""
    from madsim_tpu.engine import corpus as jax_corpus
    from madsim_tpu_torch.engine import corpus

    from test_torch_triage import ETCD_FAULTS, _triage

    faults = dict(ETCD_FAULTS, n_faults=3)
    jax_eng, port = _triage(3, faults=faults, flight_recorder=False, coverage=False, provenance=True)
    seed = 38  # its word implicates fault #0 (a kill) alone
    want = jax_shrink(jax_eng, seed, max_steps=64)
    got = shrink(port, seed, max_steps=64)
    assert jax_corpus.config_to_dict(want.shrunk) == corpus.config_to_dict(got.shrunk)
    for field in ("seed", "fail_code", "steps", "fail_time_us", "attempts", "kinds_removed", "guided",
                  "prov_kinds"):
        assert getattr(got, field) == getattr(want, field), field
    assert got.guided and got.summary() == want.summary()
    off = Engine(port.machine, dataclasses.replace(port.config, provenance=False), device="cpu")
    base = shrink(off, seed, max_steps=64)
    assert not base.guided and got.attempts < base.attempts
    assert (got.shrunk.faults.n_faults, base.shrunk.faults.n_faults) == (1, 0)
    word = replay(port, seed, max_steps=64, trace=False).fail_prov
    given = shrink(off, seed, max_steps=64, prov_word=word)
    assert (given.guided, given.attempts, given.prov_kinds) == (True, got.attempts, got.prov_kinds)
