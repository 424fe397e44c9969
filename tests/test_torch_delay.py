"""The delay-spike fault kind (`FaultPlan.allow_delay`) against the JAX
package, on both RNG streams: the engine's word layout and its block
with the spike words, `run_batch` of the flagship Raft with delay faults
in the plan, and `step_batch` step by step from a JAX state carried over
inside a spike window, where sends that took the spike (latency over
1 s) are seen in the queue. Every comparison is exact."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from madsim_tpu.engine import core as jax_core
from madsim_tpu.models import raft as jax_raft
from madsim_tpu.ops.step_rng import step_words as jax_step_words
from madsim_tpu_torch.engine import core
from madsim_tpu_torch.interop import lane_state_from_numpy
from madsim_tpu_torch.models import raft
from madsim_tpu_torch.ops.step_rng import step_words

from torch_port_util import FLAGSHIP_FAULTS, engines, same

DELAY_FAULTS = {**FLAGSHIP_FAULTS, "allow_delay": True}
STREAMS = [2, 3]


@pytest.fixture(scope="module", params=STREAMS, ids=[f"rng_stream={v}" for v in STREAMS])
def delay_engines(request):
    return engines(jax_raft.RaftMachine(5, 8), raft.RaftMachine(5, 8), rng_stream=request.param,
                   faults=DELAY_FAULTS)


def test_constants_match_the_reference():
    for name in ("DELAY_PROB_U32", "DELAY_EXTRA_MIN_US", "DELAY_EXTRA_SPAN_US", "F_DELAY_SPIKE", "F_DELAY_END",
                 "K_DELAY"):
        assert getattr(core, name) == getattr(jax_core, name), name


def test_layout_and_word_block_with_spike_words(delay_engines):
    """The layout carries the spike gate and magnitude words (v3: W = 18
    for the flagship Raft, handler 4 | latency 4 | spike 8 | restart 2),
    and the step's words equal the reference's."""
    jax_eng, port = delay_engines
    layout = port._rng_layout
    assert dataclasses.asdict(layout) == dataclasses.asdict(jax_eng._rng_layout)
    assert layout.spike_active and layout.spike_off is not None
    if layout.version == 3:
        assert layout.total_words == 18 and port.use_megakernel
    g = np.random.default_rng(layout.version)
    keys = g.integers(0, 2**32, (24, 2), dtype=np.uint32)
    steps = g.integers(0, 2**31, 24).astype(np.int32)
    want = jax.vmap(lambda k, s: jax_step_words(k, s, jax_eng._rng_layout))(jnp.asarray(keys), jnp.asarray(steps))
    got = step_words(torch.as_tensor(keys.astype(np.int64)), torch.as_tensor(steps), layout)
    for w, t in zip(want, got):
        assert np.array_equal(np.asarray(w).astype(np.int64), t.numpy())


def test_run_batch_matches_jax(delay_engines):
    jax_eng, port = delay_engines
    seeds = np.arange(32, dtype=np.uint32) + 300
    want = jax.jit(jax_eng.run_batch, static_argnums=1)(jnp.asarray(seeds), 256)
    same(want, port.run_batch(seeds, 256))
    assert np.asarray(want.fr["inj"])[:, core.K_DELAY].sum() > 0  # delay windows opened


def test_step_batch_matches_jax_inside_a_spike_window(delay_engines):
    """Lanes carried over from JAX once some are inside a spike window,
    then stepped side by side; spiked sends (a message due more than 1 s
    out, where the latency is otherwise 1-10 ms) appear in the queue."""
    jax_eng, port = delay_engines
    step = jax.jit(jax_eng.step_batch)
    state = jax.jit(jax_eng.init_batch)(jnp.arange(32, dtype=jnp.uint32) + 40)
    for _ in range(400):
        state = step(state)
        if int(np.asarray(state.delay_spike).sum()) >= 2:
            break
    assert int(np.asarray(state.delay_spike).sum()) >= 2
    carried = lane_state_from_numpy(jax.tree.map(np.asarray, state), port.machine, device=port.device)
    spiked = 0
    for k in range(40):
        state, carried = step(state), port.step_batch(carried)
        same(state, carried, k)
        late = carried.eq_valid & (carried.eq_kind == core.EV_MSG) & (
            carried.eq_time - carried.now_us[:, None] > core.DELAY_EXTRA_MIN_US)
        spiked += int(late.sum())
    assert spiked > 0
