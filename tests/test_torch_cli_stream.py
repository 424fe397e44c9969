"""The port's command line against the JAX package's on the streaming
path: `explore --stream` with the default pipelined executor and with
`--no-pipeline`, `hunt --stream` with `--coverage-out` and
`--checkpoint`, the `coverage` report of what the hunt wrote; then the
checkpoint on its own (round trip, fingerprint, a resume equal to the
uninterrupted run, a refused mismatch), the resume run on the port
alone at echo's size. The sizes are the reference's own CLI tests'
(tests/test_coverage.py:229-320, tests/test_chaos_palette.py:592-690),
at most 64 lanes. Stdout is equal
apart from the program name and the wall-clock figures; the written
files are byte for byte the reference's (the corpus apart from the
`meta` fields that name the framework, the coverage doc apart from its
wall-clock stamp)."""

import json
import re
from types import SimpleNamespace

import pytest

from torch_port_util import corpus_without_env, run_pair

STREAM = ["--machine", "raft", "--seeds", "64", "--batch", "32", "--stream", "--max-steps", "300",
          "--horizon", "2.0", "--queue", "48", "--coverage", "--flight-recorder"]


@pytest.mark.parametrize("executor", [[], ["--no-pipeline"]], ids=["pipelined", "per-segment"])
def test_explore_stream_matches_jax(executor):
    want, got = run_pair(["explore", *STREAM, *executor])
    assert got == want
    assert "executor: " in got[1] and "flight recorder: " in got[1] and "coverage: " in got[1]
    assert f"pipelined={not executor}" in got[1]


HUNT = ["--machine", "demo-doublegrant-etcd", "--seeds", "64", "--batch", "32", "--stream", "--max-steps", "300",
        "--horizon", "8.0", "--queue", "96", "--loss", "0.05", "--rng-stream", "3", "--coverage",
        "--flight-recorder", "--limit", "2"]


def _ts_free(path):
    """A coverage doc's bytes with its wall-clock stamp masked."""
    return re.sub(r'"ts": [0-9.]+', '"ts": 0', open(path).read())


@pytest.fixture(scope="module")
def hunted(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("cli_stream")
    files = {who: {kind: str(tmp / f"{who}.{kind}.json") for kind in ("corpus", "ckpt", "cov")}
             for who in ("jax", "port")}

    def argv(who):
        f = files[who]
        return ["hunt", *HUNT, "--corpus", f["corpus"], "--checkpoint", f["ckpt"], "--coverage-out", f["cov"]]

    want, got = run_pair(argv("jax"), argv("port"))
    return files, want, got


def test_hunt_stream_matches_jax(hunted):
    files, (rc_j, out_j), (rc_p, out_p) = hunted
    for kind, path in files["port"].items():
        out_p = out_p.replace(path, files["jax"][kind])
    assert rc_p == rc_j == 1 and out_p == out_j
    assert "+ corpus: seed" in out_p and "coverage map: " in out_p
    assert corpus_without_env(files["port"]["corpus"]) == corpus_without_env(files["jax"]["corpus"])
    assert open(files["port"]["ckpt"], "rb").read() == open(files["jax"]["ckpt"], "rb").read()
    assert _ts_free(files["port"]["cov"]) == _ts_free(files["jax"]["cov"])
    assert json.load(open(files["port"]["ckpt"]))["done"] is True


@pytest.mark.parametrize("flags", [[], ["--json", "--top", "4"]], ids=["report", "json"])
def test_coverage_report_matches_jax(hunted, tmp_path, flags):
    from madsim_tpu_torch.runtime.coverage import doc_maps, load_coverage_doc, make_coverage_doc, save_coverage_doc

    files, _, _ = hunted
    doc = load_coverage_doc(files["port"]["cov"])
    base = str(tmp_path / "base.json")
    # a baseline: the hunt's map with its first half cleared
    maps = {name: m.copy() for name, m in doc_maps(doc).items()}
    for m in maps.values():
        m[: m.size // 2] = False
    save_coverage_doc(base, make_coverage_doc(maps, doc["slots_log2"], band_bits=doc.get("band_bits", 3)))
    want, got = run_pair(["coverage", files["jax"]["cov"], "--diff", base, *flags], port_extra=())
    assert got == want and got[0] == 0
    assert "demo-doublegrant-etcd" in got[1]


# -- the checkpoint ------------------------------------------------------------


def _args(**over):
    d = dict(machine="echo", nodes=0, seed=0, seeds=96, batch=32, max_steps=300, horizon=1.0, loss=0.0,
             faults=0, fault_tmax=0, fault_kinds="pair,kill", rng_stream=2, strict_restart=False,
             coverage=False, stop_on_plateau=0)
    d.update(over)
    return SimpleNamespace(**d)


def test_checkpoint_roundtrip_and_fingerprint_match_jax(tmp_path):
    from madsim_tpu.runtime import checkpoint as jax_ck
    from madsim_tpu_torch.runtime import checkpoint as ck

    args = _args()
    state = {"fingerprint": ck.fingerprint_from_args(args), "batch": 1, "planned": 3, "cursor": 32,
             "completed": 32, "seeds_consumed": 32, "failing": [], "infra": [], "abandoned": [],
             "cov_b64": None, "detector": None, "plateau": False, "done": False}
    path, theirs = str(tmp_path / "ck.json"), str(tmp_path / "jax.json")
    assert ck.load_checkpoint(path) is None
    ck.save_checkpoint(path, state)
    jax_ck.save_checkpoint(theirs, state)
    assert open(path, "rb").read() == open(theirs, "rb").read()
    loaded = ck.load_checkpoint(path)
    assert loaded["batch"] == 1 and loaded["version"] == ck.CKPT_VERSION
    assert ck.check_fingerprint(loaded, args) is None
    assert "seeds" in ck.check_fingerprint(loaded, _args(seeds=128))
    assert ck.fingerprint_from_args(args) == jax_ck.fingerprint_from_args(args)


def _stream_args(tmp_path, **over):
    return _args(**{"stats": None, "stream": True, "checkpoint": str(tmp_path / "hunt_ck.json"),
                    "stop_after_batches": 0, **over})


@pytest.fixture(scope="module")
def echo_engine():
    from madsim_tpu_torch.engine import Engine, EngineConfig, FaultPlan
    from madsim_tpu_torch.models import EchoMachine

    return Engine(EchoMachine(rounds=10), EngineConfig(horizon_us=1_000_000, queue_capacity=32,
                                                       faults=FaultPlan(n_faults=0)), device="cpu")


def test_checkpoint_resume_matches_uninterrupted(tmp_path, monkeypatch, capsys, echo_engine):
    monkeypatch.delenv("MADSIM_TPU_STATS", raising=False)
    from madsim_tpu_torch.__main__ import _stream_batches

    full = _stream_batches(echo_engine, _stream_args(tmp_path, checkpoint=None))
    assert full["batches_run"] >= 2 and full["completed"] >= 96
    part = _stream_batches(echo_engine, _stream_args(tmp_path, stop_after_batches=1))
    assert part["batches_run"] == 1
    ckpt = json.load(open(str(tmp_path / "hunt_ck.json")))
    assert ckpt["batch"] == 1 and ckpt["done"] is False
    capsys.readouterr()
    resumed = _stream_batches(echo_engine, _stream_args(tmp_path))
    assert "resumed at batch 2/3" in capsys.readouterr().out
    for key in ("completed", "seeds_consumed", "batches_run", "batches_planned", "failing", "abandoned"):
        assert resumed[key] == full[key], key
    assert json.load(open(str(tmp_path / "hunt_ck.json")))["done"] is True
    # a different command line is refused, naming what differs
    with pytest.raises(SystemExit, match="seeds"):
        _stream_batches(echo_engine, _stream_args(tmp_path, seeds=128))
