"""The port's RNG substrate against jax.random and the pinned streams:
`prng_key` / `split` / `bits32` / `bits`, raw Threefry-2x32, the block
layout, the v2 and v3 step words, and the v1 and v2 fault schedules.
Every comparison is exact."""

import dataclasses
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.extend.random import threefry_2x32

import torch_port_util  # noqa: F401  (pins the partitionable lowering)
from madsim_tpu.ops import step_rng as jax_rng
from madsim_tpu_torch.ops import step_rng, threefry

from test_golden_streams import (
    HASYM_ONLY_ROWS_7, PAUSE_ONLY_ROWS_7, SKEW_ONLY_ROWS_7, STORAGE_FAULTS, STORAGE_SCHED, TORN_ONLY_ROWS_7,
    V1_FAULTS, V1_SCHED, V2_DUP_TAIL_7, V2_FAULTS, V2_K_RESTART, V2_SCHED, V2_TORN_TAIL, V2_WORDS, V3_DUP_WORDS,
    V3_TORN_WORDS, V3_WORDS, WINDOW_FAULTS, WINDOW_SCHED,
)

SEEDS = np.array([0, 1, 7, 123, 66531, 2**31 - 1, 2**31, 2**31 + 12345, 2**32 - 1], dtype=np.uint32)


def _t(a):
    return torch.as_tensor(np.asarray(a).astype(np.int64))


def test_prng_key_split_bits_match_jax():
    seeds = np.concatenate([SEEDS, np.random.default_rng(0).integers(0, 2**32, 23, dtype=np.uint32)])
    keys = jax.vmap(jax.random.PRNGKey)(jnp.asarray(seeds))
    port_keys = threefry.prng_key(_t(seeds))
    assert np.array_equal(port_keys.numpy(), np.asarray(keys))
    for n in (2, 3, 6, 7):
        want = jax.vmap(lambda k: jax.random.split(k, n))(keys)
        assert np.array_equal(threefry.split(port_keys, n).numpy(), np.asarray(want)), n
    bits = jax.vmap(lambda k: jax.random.bits(k, (), jnp.uint32))(keys)
    assert np.array_equal(threefry.bits32(port_keys).numpy(), np.asarray(bits))
    for n in (1, 12, 13, 20):
        want = jax.vmap(lambda k: jax.random.bits(k, (n,), jnp.uint32))(keys)
        assert np.array_equal(threefry.bits(port_keys, n).numpy(), np.asarray(want)), n


def test_threefry2x32_matches_jax_primitive():
    g = np.random.default_rng(1)
    for _ in range(4):
        key = g.integers(0, 2**32, 2, dtype=np.uint32)
        count = g.integers(0, 2**32, 64, dtype=np.uint32)
        count[:3] = [0, 2**32 - 1, 2**31]
        want = np.asarray(threefry_2x32(jnp.asarray(key), jnp.asarray(count)))
        y0, y1 = threefry.threefry2x32(
            _t(key[0]), _t(key[1]), _t(count[:32]), _t(count[32:])
        )
        assert np.array_equal(torch.cat([y0, y1]).numpy(), want)


def _flag_grid():
    return list(itertools.product([False, True], repeat=6))


@pytest.mark.parametrize("version", [2, 3])
def test_layout_for_every_flag_combination(version):
    for h, m in ((4, 4), (3, 1), (4, 7)):
        for loss, spike, delay, restart, dup, torn in _flag_grid():
            kw = dict(
                loss_possible=loss, spike_possible=spike, delay_enabled=delay,
                restart_possible=restart, dup_possible=dup, torn_possible=torn,
            )
            want = dataclasses.asdict(jax_rng.layout_for(version, h, m, **kw))
            got = dataclasses.asdict(step_rng.layout_for(version, h, m, **kw))
            assert got == want, (version, h, m, kw)


@pytest.mark.parametrize("total_words", [1, 2, 7, 10, 13])
def test_step_words_v3_matches_jax(total_words):
    g = np.random.default_rng(total_words)
    keys = g.integers(0, 2**32, (16, 2), dtype=np.uint32)
    steps = g.integers(0, 2**31, 16).astype(np.int32)
    steps[:3] = [0, 1, 2**31 - 1]
    layout = step_rng.layout_for(
        3, total_words, 0, loss_possible=False, spike_possible=False,
        delay_enabled=False, restart_possible=False,
    )
    jax_layout = jax_rng.layout_for(
        3, total_words, 0, loss_possible=False, spike_possible=False,
        delay_enabled=False, restart_possible=False,
    )
    want = jax.vmap(lambda k, s: jax_rng.step_words_v3(k, s, jax_layout)[1])(
        jnp.asarray(keys), jnp.asarray(steps)
    )
    got = step_rng.step_words_v3(_t(keys), torch.as_tensor(steps), layout)[1]
    assert np.array_equal(got.numpy(), np.asarray(want))


def test_v3_words_and_v1_schedule_match_pinned_literals():
    """The literals tests/test_golden_streams.py pins: the v3 block of
    the (4, 4, kill) layout, and the v1 fault schedule of RaftMachine(5)
    at queue_capacity=32."""
    layout = step_rng.layout_for(
        3, 4, 4, loss_possible=False, spike_possible=False, delay_enabled=False,
        restart_possible=True,
    )
    assert layout.total_words == 10 and layout.restart_off == 8
    for seed, expect in V3_WORDS.items():
        key = threefry.split(threefry.prng_key(_t([seed])), 3)[:, 0]
        for step in range(2):
            new_key, words, k_restart = step_rng.step_words_v3(key, torch.tensor([step]), layout)
            assert words[0].tolist() == expect[step], (seed, step)
            assert torch.equal(new_key, key) and torch.equal(k_restart, words[:, 8:10])

    from madsim_tpu_torch.engine import Engine, EngineConfig, FaultPlan
    from madsim_tpu_torch.models import RaftMachine

    faults = FaultPlan(**{f.name: getattr(V1_FAULTS, f.name) for f in dataclasses.fields(FaultPlan)})
    eng = Engine(
        RaftMachine(num_nodes=5, log_capacity=8),
        EngineConfig(horizon_us=5_000_000, queue_capacity=32, faults=faults, rng_stream=3,
                     flight_recorder=True, coverage=True),
        device="cpu",
    )
    s = eng.init_batch(np.array(list(V1_SCHED), dtype=np.uint32))
    for lane, expect in enumerate(V1_SCHED.values()):
        rows = slice(5, 9)
        assert s.eq_time[lane, rows].tolist() == expect["time"]
        assert s.eq_seq[lane, rows].tolist() == expect["seq"]
        assert s.eq_node[lane, rows].tolist() == expect["node"]
        assert s.eq_payload[lane, rows].tolist() == expect["pay"]
        assert bool(s.eq_valid[lane, rows].all())


@pytest.mark.parametrize("h,m,loss,delay", [(4, 4, False, False), (4, 4, True, False), (3, 1, True, True),
                                            (4, 7, False, True), (2, 32, True, False)])
def test_step_words_v2_matches_jax(h, m, loss, delay):
    """A chain of v2 draws from random keys: the evolved key, the word
    block and the restart key, step after step."""
    kw = dict(loss_possible=loss, spike_possible=delay, delay_enabled=delay, restart_possible=True)
    layout, jax_layout = step_rng.layout_for(2, h, m, **kw), jax_rng.layout_for(2, h, m, **kw)
    g = np.random.default_rng(h * 100 + m)
    keys = g.integers(0, 2**32, (16, 2), dtype=np.uint32)
    keys[0] = [0, 0]
    draw = jax.vmap(lambda k: jax_rng.step_words(k, jnp.int32(0), jax_layout))
    want_key, got_key = jnp.asarray(keys), _t(keys)
    for _ in range(3):
        want_key, want_words, want_restart = draw(want_key)
        got_key, got_words, got_restart = step_rng.step_words(got_key, torch.zeros(16, dtype=torch.int32), layout)
        assert got_words.shape == (16, layout.total_words)
        for want, got in ((want_key, got_key), (want_words, got_words), (want_restart, got_restart)):
            assert np.array_equal(got.numpy(), np.asarray(want))


def test_v2_words_and_schedules_match_pinned_literals():
    """The v2 word stream and restart keys of the (4, 4) layout, and the
    v2 fault schedule of RaftMachine(5) (dir, group and storm enabled),
    as tests/test_golden_streams.py pins them."""
    layout = step_rng.layout_for(
        2, 4, 4, loss_possible=False, spike_possible=False, delay_enabled=False, restart_possible=True,
    )
    assert layout.total_words == 12
    for seed, expect in V2_WORDS.items():
        key = threefry.split(threefry.prng_key(_t([seed])), 3)[:, 0]
        for step in range(2):
            key, words, k_restart = step_rng.step_words(key, torch.tensor([step]), layout)
            assert words[0].tolist() == expect[step], (seed, step)
            assert k_restart[0].tolist() == V2_K_RESTART[seed][step], (seed, step)

    from madsim_tpu_torch.engine import Engine, EngineConfig, FaultPlan
    from madsim_tpu_torch.models import RaftMachine

    for rng_stream in (2, 3):
        faults = FaultPlan(**{f.name: getattr(V2_FAULTS, f.name) for f in dataclasses.fields(FaultPlan)})
        eng = Engine(RaftMachine(num_nodes=5, log_capacity=8),
                     EngineConfig(horizon_us=5_000_000, queue_capacity=32, faults=faults, rng_stream=rng_stream),
                     device="cpu")
        s = eng.init_batch(np.array(list(V2_SCHED), dtype=np.uint32))
        for lane, expect in enumerate(V2_SCHED.values()):
            rows = slice(5, 9)
            assert s.eq_time[lane, rows].tolist() == expect["time"]
            assert s.eq_seq[lane, rows].tolist() == expect["seq"]
            assert s.eq_node[lane, rows].tolist() == expect["node"]
            assert s.eq_payload[lane, rows].tolist() == expect["pay"]
            assert bool(s.eq_valid[lane, rows].all())


@pytest.mark.parametrize("nodes", [5, 33], ids=["low-mask-word", "high-mask-word"])
def test_v2_fault_derivation_matches_jax(nodes):
    """init_batch under the v2 derivation against the JAX engine's: more
    than 30 nodes take an extra split for the group mask's high word."""
    from madsim_tpu.engine import Engine as JaxEngine, EngineConfig as JaxConfig, FaultPlan as JaxFaultPlan
    from madsim_tpu.models.multipaxos import MultiPaxosMachine as JaxMultiPaxos
    from madsim_tpu_torch.engine import Engine, EngineConfig, FaultPlan
    from madsim_tpu_torch.interop import tree_to_numpy
    from madsim_tpu_torch.models import MultiPaxosMachine

    from torch_port_util import jax_to_numpy, tree_diff

    faults = dict(n_faults=3, allow_dir_clog=True, allow_group=True, allow_storm=True, allow_kill=False,
                  t_max_us=3_000_000)
    cfg = dict(horizon_us=8_000_000, queue_capacity=96)
    jax_eng = JaxEngine(JaxMultiPaxos(nodes), JaxConfig(faults=JaxFaultPlan(**faults), **cfg))
    port = Engine(MultiPaxosMachine(nodes), EngineConfig(faults=FaultPlan(**faults), **cfg), device="cpu")
    seeds = np.arange(24, dtype=np.uint32) * 7919
    want = jax_to_numpy(jax.jit(jax_eng.init_batch)(jnp.asarray(seeds)))
    got = tree_to_numpy(port.init_batch(seeds))
    assert not tree_diff(want, got)
    ops = want["eq_payload"][:, nodes : nodes + 6, 0]
    assert {6, 7} <= set(ops.ravel().tolist())  # group faults drawn
    if nodes > 30:
        assert (want["eq_payload"][:, nodes : nodes + 6, 2][ops == 6] != 0).any()  # high mask bits


def _dup_layout(version):
    return step_rng.layout_for(
        version, 4, 4, loss_possible=False, spike_possible=False, delay_enabled=False, restart_possible=True,
        dup_possible=True,
    )


def _lane_key(seed):
    return threefry.split(threefry.prng_key(_t([seed])), 3)[:, 0]


def test_dup_words_match_pinned_literals():
    """The dup section rides the block's tail on both streams, as
    tests/test_golden_streams.py pins it: the v3 (4, 4, kill, dup) block
    of 18 words, whose restart key still reads words 8-9; and v2's step
    0 of seed 7, whose first 12 words are the legacy block."""
    layout = _dup_layout(3)
    assert (layout.total_words, layout.dup_off, layout.restart_off) == (18, 10, 8)
    for seed, expect in V3_DUP_WORDS.items():
        for step in range(2):
            _, words, k_restart = step_rng.step_words_v3(_lane_key(seed), torch.tensor([step]), layout)
            assert words[0].tolist() == expect[step], (seed, step)
            assert torch.equal(k_restart, words[:, 8:10])
    layout = _dup_layout(2)
    assert (layout.total_words, layout.dup_off) == (20, 12)
    _, words, k_restart = step_rng.step_words(_lane_key(7), torch.tensor([0]), layout)
    assert words[0, :12].tolist() == V2_WORDS[7][0]
    assert words[0, 12:].tolist() == V2_DUP_TAIL_7
    assert k_restart[0].tolist() == V2_K_RESTART[7][0]


def _window_engine(faults, rng_stream, horizon_us):
    from madsim_tpu_torch.engine import Engine, EngineConfig, FaultPlan
    from madsim_tpu_torch.models import RaftMachine

    if not isinstance(faults, dict):  # the JAX package's FaultPlan
        faults = {f.name: getattr(faults, f.name) for f in dataclasses.fields(FaultPlan)}
    return Engine(RaftMachine(num_nodes=5, log_capacity=8),
                  EngineConfig(horizon_us=horizon_us, queue_capacity=32, faults=FaultPlan(**faults),
                               rng_stream=rng_stream),
                  device="cpu")


@pytest.mark.parametrize("rng_stream", [2, 3])
def test_window_schedules_match_pinned_literals(rng_stream):
    """The pause / skew derivation (one more split a fault, for the skew
    factor) as tests/test_golden_streams.py pins it: the mixed schedule,
    and pause-only rows (arg2 the resume time) and skew-only rows (arg2
    the q10 factor) of seed 7. The schedule does not depend on the
    stream."""
    eng = _window_engine(WINDOW_FAULTS, rng_stream, 5_000_000)
    s = eng.init_batch(np.array(list(WINDOW_SCHED), dtype=np.uint32))
    for lane, expect in enumerate(WINDOW_SCHED.values()):
        rows = slice(5, 9)
        assert s.eq_time[lane, rows].tolist() == expect["time"]
        assert s.eq_seq[lane, rows].tolist() == expect["seq"]
        assert s.eq_node[lane, rows].tolist() == expect["node"]
        assert s.eq_payload[lane, rows].tolist() == expect["pay"]
    window = dict(n_faults=1, allow_partition=False, allow_kill=False, t_min_us=200_000, t_max_us=600_000,
                  dur_min_us=200_000, dur_max_us=400_000)
    for kind_flags, expect in ((dict(allow_pause=True), PAUSE_ONLY_ROWS_7), (dict(allow_skew=True), SKEW_ONLY_ROWS_7)):
        s = _window_engine({**window, **kind_flags}, rng_stream, 2_000_000).init_batch(np.array([7], np.uint32))
        assert s.eq_time[0, 5:7].tolist() == expect["time"], kind_flags
        assert s.eq_node[0, 5:7].tolist() == expect["node"], kind_flags
        assert s.eq_payload[0, 5:7].tolist() == expect["pay"], kind_flags
        assert s.paused_until.shape == (1, 5 if "allow_pause" in kind_flags else 0)
        assert s.skew_q10.shape == (1, 5 if "allow_skew" in kind_flags else 0)


def test_torn_words_match_pinned_literals():
    """The torn salt word rides the block's tail on both streams, as
    tests/test_golden_streams.py pins it: the v3 (4, 4, kill, torn)
    block of 11 words, whose restart key still reads words 8-9; and v2's
    steps 0-1, whose first 12 words are the legacy block and whose
    thirteenth is the pinned tail word, the restart key untouched."""
    kw = dict(loss_possible=False, spike_possible=False, delay_enabled=False, restart_possible=True,
              torn_possible=True)
    layout = step_rng.layout_for(3, 4, 4, **kw)
    assert (layout.total_words, layout.torn_off, layout.restart_off) == (11, 10, 8)
    for seed, expect in V3_TORN_WORDS.items():
        for step in range(2):
            _, words, k_restart = step_rng.step_words_v3(_lane_key(seed), torch.tensor([step]), layout)
            assert words[0].tolist() == expect[step], (seed, step)
            assert torch.equal(k_restart, words[:, 8:10])
    layout = step_rng.layout_for(2, 4, 4, **kw)
    assert (layout.total_words, layout.torn_off) == (13, 12)
    for seed, tails in V2_TORN_TAIL.items():
        key = _lane_key(seed)
        for step in range(2):
            key, words, k_restart = step_rng.step_words(key, torch.tensor([step]), layout)
            assert words[0, :12].tolist() == V2_WORDS[seed][step], (seed, step)
            assert int(words[0, 12]) == tails[step], (seed, step)
            assert k_restart[0].tolist() == V2_K_RESTART[seed][step], (seed, step)


@pytest.mark.parametrize("rng_stream", [2, 3])
def test_storage_schedules_match_pinned_literals(rng_stream):
    """The torn / heal-asym derivation (one more split a fault, after the
    window kinds', and a third slot a fault under heal-asym, valid only
    for heal-asym faults) as tests/test_golden_streams.py pins it: the
    mixed schedule, torn-only rows (arg2 the damage mask) and heal-asym
    rows (the both-way clog, then two one-way heals). The window and
    older schedules above pass unchanged: the draw is taken only with a
    storage kind on."""
    eng = _window_engine(STORAGE_FAULTS, rng_stream, 5_000_000)
    s = eng.init_batch(np.array(list(STORAGE_SCHED), dtype=np.uint32))
    rows = slice(5, 5 + 3 * STORAGE_FAULTS.n_faults)
    for lane, expect in enumerate(STORAGE_SCHED.values()):
        assert s.eq_time[lane, rows].tolist() == expect["time"]
        assert s.eq_seq[lane, rows].tolist() == expect["seq"]
        assert s.eq_node[lane, rows].tolist() == expect["node"]
        assert s.eq_valid[lane, rows].tolist() == expect["valid"]
        assert s.eq_payload[lane, rows].tolist() == expect["pay"]
    single = dict(n_faults=1, allow_partition=False, allow_kill=False, t_min_us=200_000, t_max_us=600_000,
                  dur_min_us=200_000, dur_max_us=400_000)
    for kind_flags, nrows, expect in ((dict(allow_torn=True), 2, TORN_ONLY_ROWS_7),
                                      (dict(allow_heal_asym=True), 3, HASYM_ONLY_ROWS_7)):
        s = _window_engine({**single, **kind_flags}, rng_stream, 2_000_000).init_batch(np.array([7], np.uint32))
        rows = slice(5, 5 + nrows)
        assert s.eq_time[0, rows].tolist() == expect["time"], kind_flags
        assert s.eq_node[0, rows].tolist() == expect["node"], kind_flags
        assert s.eq_valid[0, rows].tolist() == expect["valid"], kind_flags
        assert s.eq_payload[0, rows].tolist() == expect["pay"], kind_flags


def _flagship_engine(rng_stream=2, **flags):
    from madsim_tpu_torch.engine import Engine, EngineConfig, FaultPlan
    from madsim_tpu_torch.models import RaftMachine

    faults = {f.name: getattr(V1_FAULTS, f.name) for f in dataclasses.fields(FaultPlan)}
    return Engine(RaftMachine(num_nodes=5, log_capacity=8),
                  EngineConfig(horizon_us=5_000_000, queue_capacity=32,
                               faults=FaultPlan(**{**faults, **flags}), rng_stream=rng_stream),
                  device="cpu")


def test_engine_v2_block_matches_module():
    """The engine's own layout for the bench config agrees with the
    module-level layouts the golden words pin (guards against the engine
    silently re-sizing the legacy block), on both streams, as the JAX
    package's pin of the same name."""
    kw = dict(loss_possible=False, spike_possible=False, delay_enabled=False, restart_possible=True)
    assert _flagship_engine(2)._rng_layout == step_rng.layout_for(2, 4, 4, **kw)
    assert _flagship_engine(3)._rng_layout == step_rng.layout_for(3, 4, 4, **kw)


# the engine's layout under each chaos flag that draws words or must not:
# (total_words, spike_off, restart_off, dup_off) per stream
_FLAG_LAYOUTS = {
    "allow_delay": {2: (20, 12, None, None), 3: (18, 8, 16, None)},
    "allow_dup": {2: (20, None, None, 12), 3: (18, None, 8, 10)},
    "strict_restart": {2: (12, None, None, None), 3: (10, None, 8, None)},
}


@pytest.mark.parametrize("flag", sorted(_FLAG_LAYOUTS))
@pytest.mark.parametrize("rng_stream", [2, 3])
def test_engine_chaos_flag_block_pinned(flag, rng_stream):
    """Each chaos flag's word block held to the pinned literals through
    the engine that builds it (the flagship Raft, V1 plan plus the flag):
    allow_delay's spike section and allow_dup's dup section keep the
    legacy words as v2's prefix and, on v3, the restart key at its
    pinned words; strict_restart draws no word, so its blocks are the
    pinned kill blocks word for word, as are the restart keys."""
    eng = _flagship_engine(rng_stream, **{flag: True})
    layout = eng._rng_layout
    got = (layout.total_words, layout.spike_off, layout.restart_off, layout.dup_off)
    assert got == _FLAG_LAYOUTS[flag][rng_stream]
    if rng_stream == 2:
        _, words, k_restart = step_rng.step_words(_lane_key(7), torch.tensor([0]), layout)
        assert words[0, :12].tolist() == V2_WORDS[7][0]
        assert k_restart[0].tolist() == V2_K_RESTART[7][0]
        if flag == "allow_dup":
            assert words[0, 12:].tolist() == V2_DUP_TAIL_7
        return
    _, words, k_restart = step_rng.step_words_v3(_lane_key(7), torch.tensor([0]), layout)
    if flag in ("allow_dup", "strict_restart"):
        pinned = V3_DUP_WORDS if flag == "allow_dup" else V3_WORDS
        assert words[0].tolist() == pinned[7][0]
    assert torch.equal(k_restart, words[:, layout.restart_off:layout.restart_off + 2])
