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
                 "EXTRA_FLAGS", "FLAG_BY_KIND", "KIND_BY_FLAG", "CLI_KIND_TO_FLAG"):
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
    return jax_eng.run_stream(64, pipelined=False, **kw), port.run_stream(64, pipelined=False, **kw)


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


# the gate still closed; those lifted since (every FaultPlan kind among
# them) run in test_torch_gates.py, cov_buffer=0 and the pipelined
# executor below, provenance in test_torch_provenance.py and
# clog_packed=False in test_torch_clog.py
GATES = [
    ("compile_cache_dir", dict(compile_cache_dir="cache")),
]


@pytest.mark.parametrize("gate,overrides", GATES, ids=[g for g, _ in GATES])
def test_unported_gates_raise(gate, overrides):
    cfg = EngineConfig(**{**FLAGSHIP, "faults": FaultPlan(**FLAGSHIP_FAULTS), **overrides})
    with pytest.raises(NotImplementedError, match=gate.replace("(", r"\(").split(" ")[0].replace("[", r"\[")):
        Engine(raft.RaftMachine(5, 8), cfg, device="cpu")


def test_cov_buffer_zero_matches_jax():
    """The lifted `cov_buffer=0` gate: the unbuffered per-event fold's
    whole BatchResult equals the JAX package's on the flagship."""
    jax_eng, port = engines(jax_raft.RaftMachine(5, 8), raft.RaftMachine(5, 8), cov_buffer=0)
    seeds = np.arange(32, dtype=np.uint32) + 1000
    want = jax.jit(jax_eng.run_batch, static_argnums=1)(jnp.asarray(seeds), 160)
    got = port.run_batch(seeds, 160)
    _same(want, got)
    assert set(got.cov) == {"map"} and int(got.cov["map"].ne(0).sum()) > 0


def test_stream_gates_raise(flagship):
    """The stream's mesh gate: a `mesh` that is not a `parallel.Mesh`
    is refused before any lane runs (meshed streams themselves are
    held against the JAX package in tests/test_torch_mesh*.py)."""
    _, port = flagship
    with pytest.raises(TypeError, match="mesh"):
        port.run_stream(8, batch=8, mesh=object())


def test_pipelined_stream_matches_jax():
    """The lifted `pipelined=True` gate (now the default): the overcommit
    stream's results and executor statistics equal the JAX package's
    pipelined executor's."""
    jax_eng, port = engines(JaxOvercommitRaft(5, 8), OvercommitRaft(5, 8))
    kw = dict(batch=32, segment_steps=64, seed_start=OVERCOMMIT_SEED - 40, max_steps=384)
    want, got = jax_eng.run_stream(64, **kw), port.run_stream(64, **kw)
    for key in ("completed", "failing", "infra", "abandoned", "seeds_consumed"):
        assert got[key] == want[key], key
    assert got["stats"] == {k: v for k, v in want["stats"].items()}
    assert np.array_equal(got["coverage_map"], want["coverage_map"])
    assert (OVERCOMMIT_SEED, raft.LOG_MATCHING) in got["failing"] and got["stats"]["pipelined"]


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


def test_port_scripts_import_nothing_of_jax():
    """The port's scripts beside the package (the smoke and every
    `examples/*_torch.py`) import nothing of JAX either."""
    banned = {"jax", "jaxlib", "flax", "madsim_tpu"}
    examples = sorted((REPO / "examples").glob("*_torch.py"))
    assert len(examples) >= 6
    for path in (REPO / "chip_smoke.py", *examples):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            for name in names:
                assert name.split(".")[0] not in banned, (path, name)


def test_port_services_import_without_grpc_or_protobuf():
    """`import madsim_tpu_torch.services` needs neither grpcio nor
    protobuf (only the real-mode gRPC half does, lazily), nor JAX: the
    services run a sim workload with all of them blocked."""
    code = (
        "import sys\n"
        "for m in ('jax', 'jaxlib', 'flax', 'madsim_tpu', 'grpc', 'google.protobuf'): sys.modules[m] = None\n"
        "import madsim_tpu_torch, madsim_tpu_torch.services\n"
        "from madsim_tpu_torch.services import etcd, kafka, s3\n"
        "import madsim_tpu_torch.services.kafka.wire, madsim_tpu_torch.services.kafka.real_client\n"
        "import madsim_tpu_torch.services.s3.real_client\n"
        "from madsim_tpu_torch.services.etcd.service import EtcdService\n"
        "from madsim_tpu_torch.services.kafka.wire import decode_record_blob, encode_record_batch\n"
        "assert 'services' in dir(madsim_tpu_torch)\n"
        "svc = EtcdService(None)\n"
        "svc.put(b'k', b'v')\n"
        "recs = [(0, b'k', b'v', 5, [('h', b'x')])]\n"
        "assert decode_record_blob(encode_record_batch(recs)) == recs\n"
        "print('services', svc.revision)\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip() == "services 2"


def test_port_differential_runs_with_jax_blocked():
    """The whole Raft differential, its device side and its own host
    runtime, runs with JAX and the JAX package unimportable."""
    code = (
        "import sys\n"
        "for m in ('jax', 'jaxlib', 'flax', 'madsim_tpu'): sys.modules[m] = None\n"
        "from madsim_tpu_torch.differential import differential_raft\n"
        "from madsim_tpu_torch.engine import Engine, EngineConfig, FaultPlan\n"
        "from madsim_tpu_torch.models import RaftMachine\n"
        "cfg = EngineConfig(horizon_us=5_000_000, queue_capacity=96, faults=FaultPlan(n_faults=2,"
        " t_max_us=3_000_000, dur_min_us=200_000, dur_max_us=800_000))\n"
        "rep = differential_raft(Engine(RaftMachine(5, 8), cfg, device='cpu'), range(4))\n"
        "assert rep['schedule_mismatches'] == 0 and rep['safety_disagreements'] == 0, rep\n"
        "assert all(r['host']['chaos_applied'] for r in rep['rows']), rep\n"
        "print('differential', rep['device_elected'], rep['host_elected'])\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.startswith("differential ")
