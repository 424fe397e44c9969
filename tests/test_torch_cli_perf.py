"""The port's perf command line held against the JAX package's on the
same arguments: `perf`, and `--perf-timeline` on `explore --stream`
(per-segment, with the recorder and coverage on: the harvest spans) and
on `hunt --stream` (with a checkpoint and a stats feed: the persistence
spans). Their stdout is equal line for line with the wall times, rates,
the share of the wall the spans cover, the verdict's figures and the
files' paths masked (`torch_port_util.perf_text`), and every span name
is written as often as in the JAX package's timeline. Then
`--xla-profile` on the CPU (the port's capture of its device phases),
and the perf commands without a card."""

import json

import pytest
import torch

from madsim_tpu_torch.__main__ import main
from madsim_tpu_torch.perf import xprof

from torch_port_util import perf_text, run_pair

ECHO = ["--machine", "echo", "--seeds", "64", "--batch", "32", "--faults", "0", "--horizon", "1.0", "--max-steps",
        "400", "--queue", "16"]


def span_counts(path):
    """Each span name's count in a timeline, `compile`, `init` and
    `dispatch` counted as one `runs`: the JAX package compiles its
    stream functions again at a new batch size, while the port's first
    call of each on an engine is its only `compile`."""
    counts = {k: v["count"] for k, v in json.load(open(path))["madsim_perf_summary"]["spans"].items()}
    counts["runs"] = sum(counts.pop(k, 0) for k in ("compile", "init", "dispatch"))
    return counts


def run_with_files(tmp_path, argv, files):
    """run_pair of `argv` with each `{name}` of `files` given a path of
    its own per package; ((rc, text), (rc, text)) with those paths
    masked, and {name: (JAX's path, port's path)}."""
    paths = {name: (str(tmp_path / f"jax.{name}"), str(tmp_path / f"port.{name}")) for name in files}

    def fill(i):
        return [a.format(**{n: p[i] for n, p in paths.items()}) for a in argv]

    want, got = run_pair(fill(0), fill(1))
    texts = []
    for i, (rc, text) in enumerate((want, got)):
        for name, p in paths.items():
            text = text.replace(p[i], f"<{name}>")
        texts.append((rc, perf_text(text)))
    return texts[0], texts[1], paths


def test_perf_matches_jax(tmp_path):
    want, got, paths = run_with_files(tmp_path, ["perf", "{timeline}", *ECHO], ["timeline"])
    assert got == want and got[0] == 0
    assert "host timeline: 31 spans" in got[1] and "device memory" not in got[1]
    assert span_counts(paths["timeline"][1]) == span_counts(paths["timeline"][0])


def test_perf_timeline_explore_per_segment_matches_jax(tmp_path):
    argv = ["explore", "--stream", "--no-pipeline", "--flight-recorder", "--coverage", *ECHO,
            "--perf-timeline", "{timeline}"]
    want, got, paths = run_with_files(tmp_path, argv, ["timeline"])
    assert got == want and got[0] == 0 and "coverage: " in got[1]
    counts = span_counts(paths["timeline"][1])
    assert counts == span_counts(paths["timeline"][0])
    assert counts["harvest"] == 2 * counts["run_stream"]


def test_perf_timeline_hunt_matches_jax(tmp_path):
    argv = ["hunt", "--stream", "--machine", "demo-doublegrant-etcd", "--seeds", "64", "--batch", "32",
            "--horizon", "8.0", "--faults", "2", "--max-steps", "300", "--corpus", "{corpus}", "--limit", "1",
            "--checkpoint", "{ckpt}", "--stats", "{stats}", "--perf-timeline", "{timeline}"]
    want, got, paths = run_with_files(tmp_path, argv, ["corpus", "ckpt", "stats", "timeline"])
    assert got == want and got[0] == 1 and "1 new entries in <corpus>" in got[1]
    counts = span_counts(paths["timeline"][1])
    assert counts == span_counts(paths["timeline"][0])
    assert counts["checkpoint_write"] >= 2 and counts["stats_emit"] >= 2


def test_xla_profile_captures_the_device_phases(tmp_path, capsys, monkeypatch):
    """`--xla-profile DIR` keeps the reference's spelling; the port's is
    a torch.profiler capture with the stream's phases named."""
    monkeypatch.setenv(xprof.ENV_GATE, "0")
    logdir = tmp_path / "prof"
    assert main(["explore", "--stream", "--flight-recorder", "--coverage", *ECHO, "--xla-profile", str(logdir),
                 "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    path = xprof.find_device_trace(str(logdir))
    assert f"device profile -> {path} " in out
    names = {e["name"] for e in xprof.load_device_events(path) if e.get("ph") == "X"}
    for phase in ("step", "refill", "harvest", "fr_fold", "cov_fold", "counters", "ring_append", "cov_flush",
                  "dispatch", "counters_poll", "ring_drain"):
        assert xprof.PHASE_PREFIX + phase in names, phase
    assert any(n.startswith(xprof.SYNC_NAME + ":") for n in names)


@pytest.mark.parametrize("argv", [["perf", "t.json", *ECHO], ["prof", *ECHO],
                                  ["bench-ab", "--gate", "coverage", "--machine", "echo"]],
                         ids=["perf", "prof", "bench-ab"])
def test_perf_commands_without_a_card_exit_without_falling_back(argv, capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert main(argv) != 0
    assert "no CUDA device" in capsys.readouterr().err
