"""The port's single-lane replay against the JAX package's: the event
trace, the final lane state and the traceless `replay_outcome`, for
seed 66531 of the overcommit regression (tests/test_engine.py), which
must fail with LOG_MATCHING on `OvercommitRaft` and pass on
`RaftMachine` under the default stream. Every comparison is exact."""

import jax
import numpy as np
import pytest

from madsim_tpu.engine import Engine as JaxEngine
from madsim_tpu.engine import EngineConfig as JaxConfig
from madsim_tpu.engine import FaultPlan as JaxFaultPlan
from madsim_tpu.engine.replay import replay as jax_replay
from madsim_tpu.models import raft as jax_raft
from madsim_tpu_torch.engine import Engine, EngineConfig, FaultPlan
from madsim_tpu_torch.engine.replay import replay, replay_diff, replay_outcome
from madsim_tpu_torch.interop import tree_to_numpy
from madsim_tpu_torch.models import build_machine, raft
from madsim_tpu_torch.ops import kernels

from torch_port_util import jax_to_numpy, tree_diff

SEED = 66531
# the regression's config: the default stream (v2), recorder and coverage off
CONFIG = dict(horizon_us=5_000_000, queue_capacity=32)
FAULTS = dict(n_faults=2, t_max_us=3_000_000, dur_min_us=200_000, dur_max_us=800_000)


class JaxOvercommitRaft(jax_raft.RaftMachine):
    COMMIT_TO_LOG_LEN = True


def _events(trace):
    return [(e.step, e.time_us, e.kind, e.node, e.src, e.payload, e.seq) for e in trace]


def _lane(jax_state):
    return jax.tree.map(lambda x: np.asarray(x)[None], jax_to_numpy(jax_state))


@pytest.mark.parametrize("name,jax_machine,fails", [
    ("demo-overcommit-raft", JaxOvercommitRaft(5, 8), True),
    ("raft", jax_raft.RaftMachine(5, 8), False),
], ids=["overcommit-fails", "raft-passes"])
def test_replay_of_seed_66531_matches_jax(name, jax_machine, fails):
    jax_eng = JaxEngine(jax_machine, JaxConfig(faults=JaxFaultPlan(**FAULTS), **CONFIG))
    port = Engine(build_machine(name), EngineConfig(faults=FaultPlan(**FAULTS), **CONFIG), device="cpu")
    want = jax_replay(jax_eng, SEED, max_steps=2000)
    kernels.reset_launches()
    got = replay(port, SEED, max_steps=2000)
    assert set(kernels.launches.values()) == {0}  # CPU: the twins ran
    assert (got.failed, got.fail_code) == ((True, raft.LOG_MATCHING) if fails else (False, 0))
    assert (got.failed, got.fail_code) == (bool(want.failed), int(want.fail_code))
    assert len(got.trace) > 300 and _events(got.trace) == _events(want.trace)
    assert not tree_diff(_lane(want.state), tree_to_numpy(got.state))
    outcome = replay_outcome(port, SEED, max_steps=2000)
    assert outcome.trace == [] and not tree_diff(_lane(want.state), tree_to_numpy(outcome.state))


def test_replay_hook_and_diff():
    """The on_step hook sees every event and the state after it; two
    seeds' traces diverge at the first differing event."""
    port = Engine(raft.RaftMachine(5, 8), EngineConfig(faults=FaultPlan(**FAULTS), **CONFIG), device="cpu")
    seen = []
    rp = replay(port, 7, max_steps=40, on_step=lambda ev, st: seen.append((ev.step, int(st.step[0]))))
    assert seen == [(e.step, e.step + 1) for e in rp.trace] and len(seen) == 40
    assert replay(port, 7, max_steps=40, trace=False).trace == []
    assert replay_diff(port, 7, 7, max_steps=30) is None
    assert replay_diff(port, 7, 8, max_steps=200) > 0
