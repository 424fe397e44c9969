"""The port's engine against the JAX package on the flagship config:
`init_batch` leaf for leaf, `step_batch` step by step from one carried-
over state, the whole `run_batch` result (digest trail, checkpoint ring
and coverage maps included), `run_stream`'s result dict, and the
failing seeds of the overcommit bug. Then the gates still closed, the
device rule and the import boundary. Every comparison is exact."""

import ast
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import madsim_tpu_torch
from madsim_tpu import kinds as jax_kinds
from madsim_tpu.models import raft as jax_raft
from madsim_tpu_torch import kinds
from madsim_tpu_torch.engine import Engine, EngineConfig, FaultPlan
from madsim_tpu_torch.interop import lane_state_from_numpy, tree_to_numpy
from madsim_tpu_torch.models import raft

from torch_port_util import FLAGSHIP, FLAGSHIP_FAULTS, engines, jax_to_numpy, tree_diff

REPO = pathlib.Path(__file__).resolve().parents[1]
# OvercommitRaft (COMMIT_TO_LOG_LEN) fails this seed with LOG_MATCHING
# under the flagship config at step 364 (found by a JAX sweep of seeds
# 0..237k, which also found 134519 and 143336)
OVERCOMMIT_SEED = 232949


class JaxOvercommitRaft(jax_raft.RaftMachine):
    COMMIT_TO_LOG_LEN = True


class OvercommitRaft(raft.RaftMachine):
    COMMIT_TO_LOG_LEN = True


def _same(want, got, what=""):
    diff = tree_diff(jax_to_numpy(want), tree_to_numpy(got))
    assert not diff, (what, diff[:5])


@pytest.fixture(scope="module")
def flagship():
    return engines(jax_raft.RaftMachine(5, 8), raft.RaftMachine(5, 8))


def test_kinds_tables_match_the_reference():
    for name in ("FAULT_KIND_NAMES", "FR_EXTRA_NAMES", "COV_BAND_NAMES", "COV_BAND_NAMES_V2", "KIND_TO_FLAG",
                 "EXTRA_FLAGS", "FLAG_BY_KIND", "KIND_BY_FLAG"):
        assert getattr(kinds, name) == getattr(jax_kinds, name), name


def test_init_batch_matches_jax(flagship):
    jax_eng, port = flagship
    seeds = np.array([0, 1, 7, 123, 66531, 2**31 - 1, 2**31, 2**32 - 1] + list(range(900, 916)), np.uint32)
    _same(jax.jit(jax_eng.init_batch)(jnp.asarray(seeds)), port.init_batch(seeds))


def test_interop_round_trip_is_lossless(flagship):
    jax_eng, port = flagship
    state = jax.tree.map(np.asarray, jax.jit(jax_eng.init_batch)(jnp.arange(2**32 - 6, 2**32, dtype=jnp.uint32)))
    carried = lane_state_from_numpy(state, port.machine, device=port.device)
    assert carried.rng_key.dtype == torch.int32  # uint32 leaves ride as bit patterns
    _same(state, carried)


@pytest.mark.parametrize("queue_capacity", [32, 16], ids=["flagship", "overflowing-queue"])
def test_step_batch_matches_jax_step_by_step(queue_capacity):
    """K step_batch calls from one carried-over JAX state; the 16-slot
    queue drives lanes into OVERFLOW."""
    jax_eng, port = engines(jax_raft.RaftMachine(5, 8), raft.RaftMachine(5, 8), queue_capacity=queue_capacity)
    step = jax.jit(jax_eng.step_batch)
    state = jax.jit(jax_eng.init_batch)(jnp.arange(24, dtype=jnp.uint32) + 4000)
    for _ in range(30):
        state = step(state)
    carried = lane_state_from_numpy(jax.tree.map(np.asarray, state), port.machine, device=port.device)
    for k in range(40):
        state, carried = step(state), port.step_batch(carried)
        _same(state, carried, k)
    if queue_capacity == 16:
        assert (np.asarray(state.fail_code) == 1).any()


def test_run_batch_matches_jax(flagship):
    """The whole BatchResult of 64 flagship lanes: digest trail,
    checkpoint ring, metrics, coverage maps and slot buffers."""
    jax_eng, port = flagship
    seeds = np.arange(64, dtype=np.uint32) + 1000
    want = jax.jit(jax_eng.run_batch, static_argnums=1)(jnp.asarray(seeds), 512)
    got = port.run_batch(seeds, 512)
    _same(want, got)
    assert np.asarray(want.done).sum() > 32 and (np.asarray(want.fr["ck_step"]) > 0).any()


def test_run_segment_leaves_its_input_state_alone(flagship):
    """The coverage flush writes its map in place; a segment owns the map
    it writes, so two runs from one kept state are equal and the kept
    state is unchanged."""
    _, port = flagship
    kept = port.run_segment(port.init_batch(np.arange(8, dtype=np.uint32) + 500), 24)
    before = tree_to_numpy(kept)
    first = tree_to_numpy(port.run_segment(kept, 40))
    assert not tree_diff(before, tree_to_numpy(kept))
    assert not tree_diff(first, tree_to_numpy(port.run_segment(kept, 40)))
    assert not np.array_equal(first["cov"]["map"], before["cov"]["map"])


@pytest.fixture(scope="module")
def overcommit_streams():
    jax_eng, port = engines(JaxOvercommitRaft(5, 8), OvercommitRaft(5, 8))
    kw = dict(batch=32, segment_steps=64, seed_start=OVERCOMMIT_SEED - 40, max_steps=384)
    return jax_eng.run_stream(64, pipelined=False, **kw), port.run_stream(64, **kw)


def test_run_stream_matches_jax(overcommit_streams):
    want, got = overcommit_streams
    for key in ("completed", "failing", "infra", "abandoned", "seeds_consumed"):
        assert got[key] == want[key], key
    for key in ("coverage", "flight_recorder", "host_syncs", "drains", "dispatches", "device_segments"):
        assert got["stats"][key] == want["stats"][key], key
    assert np.array_equal(got["coverage_map"], want["coverage_map"])
    assert want["abandoned"] and want["stats"]["coverage"]["slots_hit"] > 0


def test_overcommit_bug_found_on_the_same_seeds(overcommit_streams):
    want, got = overcommit_streams
    assert (OVERCOMMIT_SEED, raft.LOG_MATCHING) in want["failing"]
    assert got["failing"] == want["failing"]


# the gates still closed; those lifted since (every FaultPlan kind among
# them) run in test_torch_gates.py
GATES = [
    ("clog_packed=False", dict(clog_packed=False)),
    ("provenance", dict(provenance=True)),
    ("cov_buffer=0", dict(cov_buffer=0)),
    ("compile_cache_dir", dict(compile_cache_dir="cache")),
]


@pytest.mark.parametrize("gate,overrides", GATES, ids=[g for g, _ in GATES])
def test_unported_gates_raise(gate, overrides):
    cfg = EngineConfig(**{**FLAGSHIP, "faults": FaultPlan(**FLAGSHIP_FAULTS), **overrides})
    with pytest.raises(NotImplementedError, match=gate.replace("(", r"\(").split(" ")[0].replace("[", r"\[")):
        Engine(raft.RaftMachine(5, 8), cfg, device="cpu")


def test_stream_gates_raise(flagship):
    _, port = flagship
    with pytest.raises(NotImplementedError, match="pipelined"):
        port.run_stream(8, batch=8, pipelined=True)
    with pytest.raises(NotImplementedError, match="mesh"):
        port.run_stream(8, batch=8, mesh=object())


def test_engine_runs_on_the_card_unless_asked_for_the_cpu(monkeypatch):
    cfg = EngineConfig(**FLAGSHIP, faults=FaultPlan(**FLAGSHIP_FAULTS))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Engine(raft.RaftMachine(5, 8), cfg)
    assert Engine(raft.RaftMachine(5, 8), cfg, device="cpu").device == torch.device("cpu")


def test_interop_runs_on_the_card_unless_asked_for_the_cpu(flagship, monkeypatch):
    jax_eng, port = flagship
    state = jax.tree.map(np.asarray, jax.jit(jax_eng.init_batch)(jnp.arange(2, dtype=jnp.uint32)))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        lane_state_from_numpy(state, port.machine)
    assert lane_state_from_numpy(state, port.machine, device="cpu").step.device == torch.device("cpu")


def test_port_imports_nothing_of_jax():
    banned = {"jax", "jaxlib", "flax", "madsim_tpu"}
    root = pathlib.Path(madsim_tpu_torch.__file__).parent
    files = sorted(root.rglob("*.py"))
    assert len(files) > 10
    for path in files:
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            for name in names:
                assert name.split(".")[0] not in banned, (path, name)


def test_port_runs_with_jax_blocked():
    code = (
        "import sys\n"
        "for m in ('jax', 'jaxlib', 'flax', 'madsim_tpu'): sys.modules[m] = None\n"
        "import numpy as np\n"
        "from madsim_tpu_torch.engine import Engine, EngineConfig, FaultPlan\n"
        "from madsim_tpu_torch.models import RaftMachine\n"
        f"cfg = EngineConfig(faults=FaultPlan(**{FLAGSHIP_FAULTS!r}), **{FLAGSHIP!r})\n"
        "res = Engine(RaftMachine(5, 8), cfg, device='cpu').run_batch(np.arange(8, dtype=np.uint32), 64)\n"
        "assert res.steps.tolist() == [64] * 8, res.steps\n"
        "print('ran', int(res.msg_count.sum()))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.startswith("ran ")
