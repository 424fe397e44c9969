"""The port's command line over several ranks, against the JAX package's
over several devices.

`explore --stream --devices 2` and `hunt --stream --devices 2` with
`--device cpu` (rank 0 in this process, rank 1 a follower process over
gloo) print what `python -m madsim_tpu ... --devices 2` prints on a
2-device mesh (conftest's CPU devices), apart from the program name and
the wall-clock figures, `--devices 2` in the repro line included.
(`explore --multihost` is held in tests/test_torch_multihost.py.)
`--devices 2` on a machine with one card exits with one line and starts
no rank; a rank that dies fails the run."""


import pytest
import torch

from torch_port_util import corpus_without_env, run_pair

STREAM = ["--machine", "raft", "--seeds", "16", "--batch", "16", "--stream", "--max-steps", "200",
          "--horizon", "2.0", "--queue", "48", "--coverage", "--flight-recorder", "--devices", "2"]
HUNT = ["--machine", "demo-doublegrant-etcd", "--seeds", "16", "--batch", "16", "--stream", "--max-steps", "120",
        "--horizon", "8.0", "--queue", "96", "--loss", "0.05", "--rng-stream", "3", "--coverage",
        "--flight-recorder", "--devices", "2"]


def test_explore_stream_over_two_ranks_matches_jax():
    want, got = run_pair(["explore", *STREAM])
    assert got == want
    assert "executor: " in got[1] and "flight recorder: " in got[1] and "coverage: " in got[1]


def test_explore_stream_finds_over_two_ranks_match_jax():
    """Failing seeds found over two ranks, and the repro line that
    records the ranks (`--devices 2`), are the JAX package's."""
    want, got = run_pair(["explore", *HUNT])
    assert got == want and got[0] == 1
    assert "--devices 2 --max-steps 120" in got[1]


def test_hunt_stream_over_two_ranks_matches_jax(tmp_path):
    """The hunt's report and its shrunk corpus entry are the JAX
    package's."""
    (tmp_path / "jax").mkdir()
    (tmp_path / "port").mkdir()
    corpus = {who: str(tmp_path / who / "corpus.json") for who in ("jax", "port")}
    want, got = run_pair(["hunt", *HUNT, "--limit", "1", "--corpus", corpus["jax"]],
                         ["hunt", *HUNT, "--limit", "1", "--corpus", corpus["port"]])
    assert got[0] == want[0] == 1
    assert got[1].replace(corpus["port"], "C") == want[1].replace(corpus["jax"], "C")
    assert corpus_without_env(corpus["port"]) == corpus_without_env(corpus["jax"])


def test_devices_past_the_visible_cards_exit_with_one_line(monkeypatch, capsys):
    """On a machine with one card, `--devices 2` exits non-zero with one
    line and starts no rank process."""
    from madsim_tpu_torch.parallel import ranks

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)

    def no_rank(*args, **kwargs):
        raise AssertionError("a refused --devices started a rank")

    monkeypatch.setattr(ranks.subprocess, "Popen", no_rank)
    with pytest.raises(SystemExit) as exc:
        with ranks.spawn_mesh(2, cpu=False):
            pass
    assert str(exc.value) == ("--devices 2: only 1 devices visible (on the CPU, pass --device cpu to run 2 "
                              "ranks over gloo)")


def test_a_dead_rank_fails_the_run():
    """A follower killed in the middle of a meshed stream fails rank 0's
    next collective; the run raises and the rank is reaped."""
    import threading

    from madsim_tpu_torch.engine import Engine, EngineConfig, FaultPlan
    from madsim_tpu_torch.models.echo import EchoMachine
    from madsim_tpu_torch.parallel.ranks import spawn_mesh

    eng = Engine(EchoMachine(rounds=4), EngineConfig(horizon_us=3_000_000, queue_capacity=16,
                                                     faults=FaultPlan(n_faults=0), coverage=True), device="cpu")
    with pytest.raises(RuntimeError):
        with spawn_mesh(2, cpu=True) as ranks:
            follower = ranks.followers.procs[0]
            threading.Timer(1.0, follower.kill).start()
            ranks.call(eng, "run_stream", n_seeds=100_000, batch=16, segment_steps=64, max_steps=400)
    assert follower.poll() is not None
    import torch.distributed as dist

    assert not dist.is_initialized()
