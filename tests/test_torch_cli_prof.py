"""The port's `prof` and `bench-ab` held against the JAX package's on
the same arguments: stdout equal line for line with the wall times,
rates, the profilers' event and sync-point counts and the artifacts'
paths masked (`torch_port_util.perf_text`: the two packages' captures
come from different profilers), and the merged plane's virtual track
equal to the JAX package's. Each command sets MADSIM_TPU_XPROF in the
process, so each test restores it."""

import json

import pytest

from madsim_tpu_torch.perf import xprof

from torch_port_util import perf_text, run_pair, virtual_track

ECHO = ["--machine", "echo", "--seeds", "32", "--batch", "32", "--faults", "0", "--horizon", "1.0", "--max-steps",
        "300", "--queue", "16"]


@pytest.fixture(autouse=True)
def gate_restored(monkeypatch):
    monkeypatch.setenv(xprof.ENV_GATE, "0")


def _pair(tmp_path, argv):
    """run_pair of `argv`, `{out}` and `{dir}` a path of each package's
    own; the texts masked, and the port's output path."""
    paths = [(str(tmp_path / f"{who}.json"), str(tmp_path / who)) for who in ("jax", "port")]
    runs = [[a.format(out=o, dir=d) for a in argv] for o, d in paths]
    want, got = run_pair(*runs)
    return (want[0], perf_text(want[1])), (got[0], perf_text(got[1])), paths


def test_prof_matches_jax(tmp_path):
    want, got, paths = _pair(tmp_path, ["prof", *ECHO, "--out", "{out}", "--profile-dir", "{dir}"])
    assert got == want and got[0] == 0
    assert "(pass --merge for the three-clock plane)" in got[1]
    doc = json.load(open(paths[1][0]))
    marks = [e for e in doc["traceEvents"] if e["name"] == xprof.SYNC_NAME]
    assert len(marks) >= 2 and doc["madsim_perf_meta"]["cmd"] == "prof"


def test_prof_merge_matches_jax(tmp_path):
    want, got, paths = _pair(tmp_path, ["prof", "--merge", *ECHO, "--trace-seed", "5", "--out", "{out}",
                                        "--profile-dir", "{dir}"])
    assert got == want and got[0] == 0 and "(host+device+virtual)" in got[1]
    assert virtual_track(paths[1][0]) == virtual_track(paths[0][0]) != []
    doc = json.load(open(paths[1][0]))
    s = doc["madsim_xprof_summary"]
    assert s["tracks"] == {"host": True, "device": True, "virtual": True}
    # every marker the host stamped inside the recorder matched one in
    # the capture
    host_marks = [e for e in doc["traceEvents"] if e["name"] == xprof.SYNC_NAME]
    assert s["sync_points"] == len(host_marks) >= 2
    assert doc["madsim_xprof_meta"] == {"machine": "echo", "virtual_seed": 5}
    phases = {e["name"] for e in doc["traceEvents"] if e.get("ph") == "X" and e["name"].startswith("madsim.")}
    assert {"madsim.step", "madsim.refill", "madsim.harvest", "madsim.counters"} <= phases


def test_bench_ab_coverage_matches_jax(tmp_path):
    argv = ["bench-ab", "--gate", "coverage", "--machine", "echo", "--lanes", "16", "--seeds", "16", "--reps", "1",
            "--faults", "0", "--horizon", "1.0", "--max-steps", "200", "--queue", "16"]
    want, got = run_pair(argv)
    assert perf_text(got[1]) == perf_text(want[1]) and got[0] == want[0] == 0
    doc = json.loads(got[1].splitlines()[0])
    assert (doc["metric"], doc["platform"], doc["a"], doc["b"], doc["pairs"]) == (
        "coverage_ab_delta_pct", "cpu", "coverage=on", "coverage=off", 1)
