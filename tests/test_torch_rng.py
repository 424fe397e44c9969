"""The port's RNG substrate against jax.random and the pinned streams:
`prng_key` / `split` / `bits32`, raw Threefry-2x32, the block layout
and the v3 step words. Every comparison is exact."""

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

from test_golden_streams import V1_FAULTS, V1_SCHED, V3_WORDS

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
