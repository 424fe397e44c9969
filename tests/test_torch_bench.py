"""The port's `bench` command (`madsim_tpu_torch/__main__.py` cmd_bench,
`madsim_tpu_torch/perf/flagship.py`) against the JAX package's
(`madsim_tpu/__main__.py:1982-2061`) and the repo-root bench.py: the
flagship's configuration under every knob, the command line's mapping of
--lanes / --reps onto the flagship, the usage message, `bench --machine`
on both packages, a flagship run on the CPU with its history row and an
enforced budget violation (and the same budget on `bench --machine`),
`bench report` without torch, and `bench-ab --gate pallas-megakernel`,
which costs the gate bench.py's step-cost menu had as `pallas_pop_off`.
The flagship on the card is marked `cuda` and skips without one."""

import contextlib
import dataclasses
import io
import json
import os
import subprocess
import sys
import types

import pytest
import torch

from madsim_tpu_torch.__main__ import main
from madsim_tpu_torch.perf import flagship, history

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

KNOBS = ("MADSIM_TPU_RNG_STREAM", "MADSIM_TPU_CLOG_PACKED", "MADSIM_TPU_FLIGHT_RECORDER", "MADSIM_TPU_COVERAGE",
         "MADSIM_TPU_PROVENANCE", "MADSIM_TPU_COV_BUFFER")

# bench.py:519-616's line, less what reports JAX's compiler or a TPU,
# plus the card
BENCH_PY_KEYS = {"metric", "value", "unit", "vs_baseline", "history", "platform", "backend", "compile_s",
                 "compile_s_cold", "compile_s_warm", "trace_s", "lower_s", "backend_s", "flops_per_seed_step",
                 "bytes_per_seed_step", "compile_autopsy", "steady_seeds_per_sec", "gates", "diagnostics"}
NOT_PORTED = {"vs_baseline", "backend", "trace_s", "lower_s", "backend_s", "compile_autopsy", "flops_per_seed_step",
              "bytes_per_seed_step"}
FLAGSHIP_KEYS = (BENCH_PY_KEYS - NOT_PORTED) | {"card"}


def bench_py_config(env):
    """The JAX EngineConfig bench.py:180-222 builds under `env`."""
    from madsim_tpu.engine import EngineConfig, FaultPlan

    rng_stream = int(env.get("MADSIM_TPU_RNG_STREAM", "3"))
    clog_packed = env.get("MADSIM_TPU_CLOG_PACKED", "1") not in ("", "0")
    flight_recorder = env.get("MADSIM_TPU_FLIGHT_RECORDER", "1") not in ("", "0")
    coverage = env.get("MADSIM_TPU_COVERAGE", "1") not in ("", "0")
    provenance = env.get("MADSIM_TPU_PROVENANCE", "0") not in ("", "0")
    cov_buffer_env = env.get("MADSIM_TPU_COV_BUFFER", "")
    cov_buffer_kw = {} if cov_buffer_env == "" else {"cov_buffer": int(cov_buffer_env)}
    return EngineConfig(
        horizon_us=5_000_000,
        queue_capacity=32,
        faults=FaultPlan(n_faults=2, t_max_us=3_000_000, dur_min_us=200_000, dur_max_us=800_000),
        rng_stream=rng_stream,
        clog_packed=clog_packed,
        flight_recorder=flight_recorder,
        coverage=coverage,
        provenance=provenance,
        **cov_buffer_kw,
    )


@pytest.mark.parametrize("env", [{}, {"MADSIM_TPU_RNG_STREAM": "2"}, {"MADSIM_TPU_CLOG_PACKED": "0"},
                                 {"MADSIM_TPU_FLIGHT_RECORDER": "0"}, {"MADSIM_TPU_COVERAGE": "0"},
                                 {"MADSIM_TPU_PROVENANCE": "1"}, {"MADSIM_TPU_COV_BUFFER": "0"},
                                 {"MADSIM_TPU_COV_BUFFER": "32"}, {"MADSIM_TPU_CLOG_PACKED": ""}],
                         ids=lambda env: ",".join(f"{k[11:]}={v}" for k, v in env.items()) or "default")
def test_flagship_config_equals_bench_py(env, monkeypatch):
    """Field for field, the fault plan's included, under the default
    environment and each knob flipped; from os.environ as from a mapping."""
    for knob in KNOBS:
        monkeypatch.delenv(knob, raising=False)
    want = dataclasses.asdict(bench_py_config(env))
    assert dataclasses.asdict(flagship.flagship_config(env)) == want
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    assert dataclasses.asdict(flagship.flagship_config()) == want


def test_flagship_machine_is_bench_py_raft():
    from madsim_tpu.models.raft import RaftMachine

    want, got = RaftMachine(num_nodes=5, log_capacity=8), flagship.flagship_machine()
    assert (got.NUM_NODES, got.log_capacity, type(got).__name__) == (want.NUM_NODES, want.log_capacity,
                                                                    type(want).__name__)


def bench_py_lanes_reps(argv):
    """The (lanes, reps) bench.py:169-170 reads from its argv."""
    return (int(argv[0]) if argv else 8192, int(argv[1]) if len(argv) > 1 else 5)


@pytest.mark.parametrize("argv", [["bench"], ["bench", "--lanes", "64"], ["bench", "--reps", "2"],
                                  ["bench", "--reps", "3"], ["bench", "--lanes", "64", "--reps", "7"]],
                         ids=["default", "lanes", "reps2", "reps3", "both"])
def test_flagship_argument_mapping_equals_jax(argv, monkeypatch):
    """The (lanes, reps) each package hands its flagship, the reference's
    quirk included: the default --reps 3 passes no reps, so bench.py runs
    its own default of 5."""
    from madsim_tpu.__main__ import main as jax_main

    seen = {}
    monkeypatch.setattr(sys, "argv", list(sys.argv))
    monkeypatch.setitem(sys.modules, "bench",
                        types.SimpleNamespace(main=lambda: seen.__setitem__("jax",
                                                                            bench_py_lanes_reps(sys.argv[1:]))))
    assert jax_main(list(argv)) == 0

    def port_flagship(lanes, reps, device=None, history_file=None):
        seen["port"] = (lanes, reps)
        return 0

    monkeypatch.setattr(flagship, "run", port_flagship)
    assert main([*argv, "--device", "cpu"]) == 0
    assert seen["port"] == seen["jax"]
    assert (flagship.DEFAULT_LANES, flagship.DEFAULT_REPS) == bench_py_lanes_reps([])


def test_usage_message_equals_jax():
    from madsim_tpu.__main__ import main as jax_main

    with pytest.raises(SystemExit) as want:
        jax_main(["bench", "--lanes", "-1"])
    with pytest.raises(SystemExit) as got:
        main(["bench", "--lanes", "-1", "--device", "cpu"])
    assert str(got.value) == str(want.value) and "--lanes >= 1" in str(got.value)


def _run(fn, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = fn(list(argv))
    return rc, out.getvalue()


def test_bench_machine_equals_jax(tmp_path):
    """`bench --machine echo` on both packages: the same keys apart from
    the port's `card` and `history`, the same counts, and one history row
    naming the machine."""
    from madsim_tpu.__main__ import main as jax_main

    argv = ["bench", "--machine", "echo", "--lanes", "8", "--seeds", "16", "--reps", "1"]
    path = str(tmp_path / "h.jsonl")
    rc_j, out_j = _run(jax_main, argv)
    rc_p, out_p = _run(main, [*argv, "--device", "cpu", "--history", path])
    assert rc_j == rc_p == 0
    [want] = [json.loads(ln) for ln in out_j.splitlines() if ln.startswith("{")]
    [got] = [json.loads(ln) for ln in out_p.splitlines() if ln.startswith("{")]
    assert set(got) == set(want) | {"card", "history"} and got["card"] is None
    assert set(got["diagnostics"]) == set(want["diagnostics"])
    for key in ("failing_total", "lanes", "queue_capacity", "fault_kinds"):
        assert got["diagnostics"][key] == want["diagnostics"][key], key
    assert (got["metric"], got["platform"]) == (want["metric"], "cpu") == ("echo_seeds_per_sec", "cpu")
    [row] = history.load(path)
    assert row["value"] == got["value"] and row["source"] == "bench --machine"
    assert row["fingerprint"]["machine"] == "echo" and row["fingerprint"]["lanes"] == 8


def test_flagship_on_the_cpu_line_row_and_budget(tmp_path, monkeypatch, capsys):
    """A flagship at 16 lanes on the CPU prints one JSON line with the
    stated keys and appends one row; with that row's value made 10x and
    the budget enforced, the next run exits 1 naming the violation."""
    for knob in (*KNOBS, "MADSIM_TPU_BENCH_HISTORY", "MADSIM_TPU_BENCH_TAG", "MADSIM_TPU_BENCH_ENFORCE_BUDGET"):
        monkeypatch.delenv(knob, raising=False)
    path = tmp_path / "h.jsonl"
    argv = ["bench", "--lanes", "16", "--reps", "1", "--device", "cpu", "--history", str(path)]
    assert main(argv) == 0
    out = capsys.readouterr().out.splitlines()
    assert len(out) == 1
    line = json.loads(out[0])
    assert set(line) == FLAGSHIP_KEYS
    assert (line["platform"], line["card"], line["history"]) == ("cpu", None, {"tag": "r01", "path": "h.jsonl"})
    assert line["gates"] == {"rng_stream": 3, "clog_packed": True, "pallas_megakernel": True,
                             "flight_recorder": True, "coverage": True, "cov_buffer": 16, "provenance": False}
    diag = line["diagnostics"]
    assert (diag["lanes"], diag["segment_steps"], diag["queue_capacity"], len(diag["reps"])) == (16, 384, 32, 1)
    assert line["value"] > 0 and line["compile_s"] == line["compile_s_cold"] > 0 and line["compile_s_warm"] > 0
    [row] = history.load(str(path))
    assert (row["tag"], row["value"], row["source"], row["compile_s"]) == ("r01", line["value"], "bench",
                                                                          line["compile_s"])
    assert row["fingerprint"]["platform"] == "cpu" and row["fingerprint"]["machine"] is None

    path.write_text(json.dumps({**row, "value": row["value"] * 10}) + "\n")
    monkeypatch.setenv("MADSIM_TPU_BENCH_ENFORCE_BUDGET", "1")
    assert main(argv) == 1
    cap = capsys.readouterr()
    line = json.loads(cap.out.splitlines()[-1])
    assert set(line) == FLAGSHIP_KEYS | {"budget"} and line["budget"]["within_5pct"] is False
    assert line["budget"]["neighbor"] == "r01" and line["history"]["tag"] == "r02"
    assert "bench: BUDGET VIOLATION" in cap.err and "the r01 capture" in cap.err
    assert len(history.load(str(path))) == 2


def _fp(**over):
    base = dict(host="boxA", platform="cuda", python="3.12", torch="2.11.0", cuda="12.8",
                device="NVIDIA H100 80GB HBM3", power_limit="700.00 W", kernels="0123456789abcdef", lanes=8192,
                reps=5, segment_steps=384, gates={"rng_stream": 3, "clog_packed": True, "pallas_megakernel": True,
                                                  "flight_recorder": True, "coverage": True,
                                                  "provenance": False},
                device_count=1, machine=None)
    base.update(over)
    return base


def test_bench_report_renders_without_torch(tmp_path):
    """`bench report` in a process of its own renders a fixture history
    (the flagship's rows, a `--machine` row apart from them) and imports
    neither torch nor JAX; an empty history gives its line."""
    path = tmp_path / "h.jsonl"
    for tag, value, fp in (("r01", 1000.0, _fp()), ("r02", 1100.0, _fp()),
                           ("r03", 600.0, _fp(machine="raft", gates={**_fp()["gates"], "rng_stream": 2,
                                                                     "pallas_megakernel": False}))):
        history.append(str(path), history.make_record(tag, value, fp, compile_s=12.5, ts=1.0))
    code = ("import sys\n"
            "from madsim_tpu_torch.__main__ import main\n"
            "rc = main(sys.argv[1:])\n"
            "print(rc, sorted(m for m in ('torch', 'jax', 'madsim_tpu') if m in sys.modules))\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    outs = []
    for p in (path, tmp_path / "missing.jsonl"):
        proc = subprocess.run([sys.executable, "-c", code, "bench", "report", "--history", str(p)], cwd=tmp_path,
                              env=env, capture_output=True, text=True, timeout=120)
        assert proc.returncode == 0, proc.stderr[-2000:]
        outs.append(proc.stdout.splitlines())
    text = outs[0]
    assert text[-1] == "0 []" and outs[1] == ["bench history is empty: a bench appends every capture", "0 []"]
    rows = {ln.split()[0]: ln for ln in text if ln[:1] == "r"}
    assert "+10.0%" in rows["r02"] and "new cfg" in rows["r01"] and "new cfg" in rows["r03"]
    assert "raft: rng2+packed+fr+cov" in rows["r03"] and "12.5s" in rows["r01"]
    assert text[:-1] == history.render_report(history.load(str(path))).splitlines()


def test_flagship_without_a_card_exits_2(tmp_path, monkeypatch, capsys):
    """The flagship without a card (and without `--device cpu`) exits 2
    with the "no CUDA device" line and writes no history: it never falls
    back to the CPU (the command line's refusal is in
    tests/test_torch_cli_gates.py)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.chdir(tmp_path)
    monkeypatch.delenv("MADSIM_TPU_BENCH_HISTORY", raising=False)
    assert flagship.run(64, 1) == 2
    assert "no CUDA device" in capsys.readouterr().err
    assert not list(tmp_path.iterdir())


def test_bench_machine_shares_the_budget(tmp_path, monkeypatch, capsys):
    """`bench --machine` runs the flagship's timed protocol: against a
    comparable row 10x its rate it prints the violation, carries the
    budget in its line and, with the budget enforced, exits 1."""
    monkeypatch.delenv("MADSIM_TPU_BENCH_TAG", raising=False)
    path = tmp_path / "h.jsonl"
    argv = ["bench", "--machine", "echo", "--lanes", "8", "--seeds", "16", "--reps", "1", "--device", "cpu",
            "--history", str(path)]
    assert main(argv) == 0
    [row] = history.load(str(path))
    path.write_text(json.dumps({**row, "value": row["value"] * 10}) + "\n")
    monkeypatch.setenv("MADSIM_TPU_BENCH_ENFORCE_BUDGET", "1")
    capsys.readouterr()
    assert main(argv) == 1
    cap = capsys.readouterr()
    line = json.loads(cap.out.splitlines()[-1])
    assert line["budget"]["neighbor"] == "r01" and line["budget"]["within_5pct"] is False
    assert line["history"]["tag"] == "r02" and "bench: BUDGET VIOLATION" in cap.err
    assert [r["source"] for r in history.load(str(path))] == ["bench --machine"] * 2


def test_bench_ab_pallas_megakernel_on_the_cpu():
    """`bench-ab --gate pallas-megakernel`: the megakernel's engine
    against its plain twin's, both on the v3 stream, in one JSON line."""
    argv = ["bench-ab", "--gate", "pallas-megakernel", "--machine", "echo", "--lanes", "16", "--seeds", "16",
            "--reps", "1", "--faults", "0", "--horizon", "1.0", "--max-steps", "200", "--queue", "16",
            "--device", "cpu"]
    rc, out = _run(main, argv)
    doc = json.loads(out.splitlines()[0])
    assert rc == 0 and (doc["metric"], doc["platform"], doc["a"], doc["b"], doc["pairs"]) == (
        "pallas-megakernel_ab_delta_pct", "cpu", "pallas_megakernel=on", "pallas_megakernel=off", 1)


@pytest.mark.cuda
def test_flagship_on_the_card(tmp_path):
    """The flagship on the card at 256 lanes, one rep, in a process of its
    own as a user runs it: its line names the card and the megakernel
    gate, and its row is appended."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the flagship runs on the card by default")
    path = tmp_path / "h.jsonl"
    proc = subprocess.run([sys.executable, "-m", "madsim_tpu_torch", "bench", "--lanes", "256", "--reps", "1",
                           "--history", str(path)], cwd=tmp_path, env=dict(os.environ, PYTHONPATH=REPO),
                          capture_output=True, text=True, timeout=900)
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = json.loads(proc.stdout.splitlines()[-1])
    assert set(line) == FLAGSHIP_KEYS and line["platform"] == "cuda" and line["card"]["name"]
    assert line["gates"]["pallas_megakernel"] is True and line["value"] > 0
    assert len(history.load(str(path))) == 1
