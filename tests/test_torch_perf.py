"""The port's perf package (`madsim_tpu_torch/perf`) against the JAX
package's (`madsim_tpu/perf`), mirroring tests/test_perf.py: the host
recorder's spans, summary, verdict and Perfetto export fed through the
same fake clock in both packages; the interleaved A/B statistics on the
same deltas and reps; the bench history with the port's fingerprint
(torch, CUDA, the card, the kernel sources' hash) and gate keys; and
`explore --stream --perf-timeline` end to end, whose spans name the same
set as the JAX package's run of the same arguments.

Left out of tests/test_perf.py, each for its reason:
  * :324 and :343 (the legacy BENCH_r*.json import and the seeded
    BENCH_HISTORY.jsonl report): those rows are TPU numbers, which the
    port's history never imports (perf/history.py's docstring);
  * :356 (`bench report` past the backend watchdog): the port has no
    watchdog, and its `bench report` is held in tests/test_torch_bench.py
    (a process of its own that imports no torch);
  * :467-603 (the JAX compile cache, the compile split and the AOT
    artifacts): eager PyTorch has no compile to cache, split or export.
"""

import json
import math

import pytest

from madsim_tpu.perf import ab as jax_ab
from madsim_tpu.perf import history as jax_history
from madsim_tpu.perf import recorder as jax_recorder
from madsim_tpu_torch.perf import ab, history, recorder
from madsim_tpu_torch.perf.recorder import PerfRecorder, current_recorder, maybe_count, maybe_span

from torch_port_util import run_pair


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t

    def tick(self, s):
        self.t += s


def both(scenario):
    """Run `scenario(recorder_module, clock) -> PerfRecorder` through the
    JAX package's recorder and the port's, each on its own fake clock;
    returns (JAX's, port's), asserting their summary, verdict, Chrome
    trace and counters equal."""
    out = []
    for mod in (jax_recorder, recorder):
        clk = FakeClock()
        out.append(scenario(mod, clk))
    want, got = out
    assert got.summary() == want.summary()
    assert got.verdict() == want.verdict()
    assert got.chrome_trace() == want.chrome_trace()
    assert got.counters == want.counters
    return want, got


# -- PerfRecorder ------------------------------------------------------------


def test_recorder_span_nesting_and_totals():
    def scenario(mod, clk):
        rec = mod.PerfRecorder(clock=clk)
        with rec:
            with rec.span("outer"):
                clk.tick(1.0)
                with rec.span("inner"):
                    clk.tick(0.25)
                clk.tick(0.5)
            clk.tick(0.1)  # gap between top-level spans
            with rec.span("outer"):
                clk.tick(0.4)
        return rec

    _, rec = both(scenario)
    s = rec.summary()
    assert s["wall_s"] == pytest.approx(2.25)
    assert s["spans"]["outer"]["total_s"] == pytest.approx(2.15)
    assert s["spans"]["outer"]["count"] == 2
    assert s["spans"]["inner"]["total_s"] == pytest.approx(0.25)
    assert s["dispatch_gap_s"] == pytest.approx(0.1)
    assert s["span_coverage"] == pytest.approx(2.15 / 2.25, abs=1e-4)


def test_recorder_device_wait_scoped_to_run_stream():
    """Uncovered interior of a run_stream span is device_wait; that of
    any other span is that span's own host work."""
    def scenario(mod, clk):
        rec = mod.PerfRecorder(clock=clk)
        with rec:
            with rec.span("engine_build"):
                clk.tick(0.4)
            with rec.span("run_stream"):
                with rec.span("compile"):
                    clk.tick(2.0)
                clk.tick(0.7)
                with rec.span("counters_poll"):
                    clk.tick(0.05)
        return rec

    _, rec = both(scenario)
    s = rec.summary()
    assert s["device_wait_s"] == pytest.approx(0.7)
    assert s["spans"]["run_stream"]["total_s"] == pytest.approx(2.75)
    assert "compile-bound" in rec.verdict()


def test_recorder_contextvar_scoping():
    assert current_recorder() is None
    with maybe_span("anything"):
        maybe_count("x")
    rec = PerfRecorder(clock=FakeClock())
    with rec:
        assert current_recorder() is rec
        # the JAX package's recorder lives in its own contextvar
        assert jax_recorder.current_recorder() is None
        maybe_count("x", 3)
        with maybe_span("spanned"):
            pass
    assert current_recorder() is None
    assert rec.counters == {"x": 3}
    assert [s["name"] for s in rec.spans] == ["spanned"]


def test_recorder_open_spans_crash_flush_view():
    views = []
    for mod in (jax_recorder, recorder):
        clk = FakeClock()
        rec = mod.PerfRecorder(clock=clk)
        assert rec.open_spans() == []
        with rec:
            with rec.span("unit", batch=32):
                clk.tick(1.0)
                with rec.span("dispatch"):
                    clk.tick(0.25)
                    got = rec.open_spans()
        assert rec.open_spans() == []
        views.append((got, rec.spans))
    assert views[1] == views[0]
    got, spans = views[1]
    assert [s["name"] for s in got] == ["unit", "dispatch"]
    assert [s["depth"] for s in got] == [0, 1]
    assert got[0]["dur"] == pytest.approx(1.25e6)
    assert got[0]["args"] == {"batch": 32, "partial": True}
    assert [s["name"] for s in spans] == ["dispatch", "unit"]


def test_recorder_absorb_matches_jax():
    def scenario(mod, clk):
        inner = mod.PerfRecorder(clock=clk)
        with inner:
            with inner.span("dispatch"):
                clk.tick(0.3)
            inner.count("units", 2)
        rec = mod.PerfRecorder(clock=clk)
        with rec:
            clk.tick(0.1)
            assert rec.absorb(inner, ts_offset_us=50.0) == 1
        return rec

    both(scenario)


def test_recorder_not_reenterable():
    rec = PerfRecorder(clock=FakeClock())
    with rec:
        pass
    with pytest.raises(RuntimeError):
        rec.__enter__()


def test_chrome_trace_schema_pin(tmp_path):
    def scenario(mod, clk):
        rec = mod.PerfRecorder(meta={"cmd": "test"}, clock=clk)
        with rec:
            with rec.span("dispatch", batch=8):
                clk.tick(0.002)
            rec.instant("marker", note="hi")
        return rec

    want, rec = both(scenario)
    paths = [tmp_path / "jax.json", tmp_path / "port.json"]
    counts = [r.write(str(p)) for r, p in zip((want, rec), paths)]
    assert counts[0] == counts[1] and paths[0].read_bytes() == paths[1].read_bytes()
    doc = json.loads(paths[1].read_text())
    assert sorted(doc.keys()) == ["displayTimeUnit", "madsim_perf_meta", "madsim_perf_summary", "traceEvents"]
    evs = doc["traceEvents"]
    assert counts[1] == len(evs) - 2
    assert [e["ph"] for e in evs[:2]] == ["M", "M"]
    assert evs[0]["args"]["name"] == "madsim_tpu host"
    [slice_ev] = [e for e in evs if e["ph"] == "X"]
    assert slice_ev["name"] == "dispatch" and slice_ev["dur"] == pytest.approx(2000.0)
    [inst] = [e for e in evs if e["ph"] == "i"]
    assert inst["name"] == "marker" and inst["s"] == "t"


# -- paired A/B statistics ---------------------------------------------------


@pytest.mark.parametrize("deltas", [[1, 2, 3, -1, 5], [0.5] * 8, [0, 0, 1, -1], [], [1, -1]])
def test_sign_test_matches_jax(deltas):
    assert ab.sign_test_p(deltas) == jax_ab.sign_test_p(deltas)


def test_sign_test_hand_computed():
    assert ab.sign_test_p([1, 2, 3, -1, 5]) == pytest.approx(0.375)
    assert ab.sign_test_p([0.5] * 8) == pytest.approx(2 / 256)
    assert ab.sign_test_p([]) == 1.0


@pytest.mark.parametrize("deltas", [[1, 2, 3, -1, 5], [4.2], [0.31, -0.12, 0.55, 0.08]])
def test_paired_stats_and_bootstrap_match_jax(deltas):
    st = ab.paired_stats(deltas)
    assert st == jax_ab.paired_stats(deltas)
    lo, hi = st["ci95"]
    assert lo <= st["median"] <= hi
    for seed in (0, 7):
        assert ab.bootstrap_ci(deltas, seed=seed) == jax_ab.bootstrap_ci(deltas, seed=seed)
    with pytest.raises(ValueError):
        ab.bootstrap_ci([])


def _interleaved(mod, drift):
    """`interleaved_ab` of `mod` on a fake clock: A at 100 units/s, B at
    80; with `drift`, every rep runs 2% slower than the one before."""
    calls, clk, state = [], FakeClock(), {"i": 0}

    def rep(label, rate):
        def f(seed_start):
            calls.append((label, seed_start))
            slow = 1.0 - 0.02 * state["i"] if drift else 1.0
            state["i"] += 1
            clk.tick(100.0 / (rate * slow))
            return 100

        return f

    res = mod.interleaved_ab(rep("A", 100.0), rep("B", 80.0), pairs=5 if drift else 3, seed_start=1000,
                             seeds_per_rep=50, label_a="on", label_b="off", clock=clk)
    return res, calls


@pytest.mark.parametrize("drift", [False, True], ids=["alternation", "drift"])
def test_interleaved_ab_matches_jax(drift):
    want, want_calls = _interleaved(jax_ab, drift)
    got, calls = _interleaved(ab, drift)
    assert calls == want_calls
    assert got.to_dict() == want.to_dict() and got.summary() == want.summary() and got.order == want.order
    assert [c[0] for c in calls[:6]] == ["A", "B"] * 3
    if not drift:
        assert [c[1] for c in calls] == [1000, 1000, 1050, 1050, 1100, 1100]
        assert got.median_delta_pct == pytest.approx(20.0)
        assert "median paired delta +20.00%" in got.summary()
    else:
        assert 19.0 < got.median_delta_pct < 25.0 and got.sign_p == pytest.approx(2 / 32)


def test_bench_ab_pairs_default_pinned():
    assert ab.DEFAULT_BENCH_AB_PAIRS == jax_ab.DEFAULT_BENCH_AB_PAIRS == 5


# -- bench history -------------------------------------------------------------

_GATES = {"rng_stream": 3, "clog_packed": True, "flight_recorder": True, "coverage": True, "provenance": False}


def _fp(mod, **kw):
    """A fingerprint of `mod`'s history with its own kernel-gate key."""
    gate = "pallas_megakernel" if mod is history else "pallas_pop"
    base = dict(host="boxA", platform="cuda" if mod is history else "cpu", python="3.12", lanes=8192, reps=5,
                segment_steps=384, gates={**_GATES, gate: False}, device="NVIDIA H100 80GB HBM3",
                kernels="0123456789abcdef")
    if mod is jax_history:
        base.pop("device"), base.pop("kernels")
    base.update(kw)
    return base


def test_history_append_load_roundtrip(tmp_path):
    tags = []
    for mod in (jax_history, history):
        path = str(tmp_path / f"{mod.__name__}.jsonl")
        mod.append(path, mod.make_record("r01", 100.0, _fp(mod), reps=[99.0, 101.0], ts=123.0))
        mod.append(path, mod.make_record("r02", 105.0, _fp(mod), ts=124.0))
        rows = mod.load(path)
        assert rows[0]["reps"] == [99.0, 101.0] and rows[0]["fingerprint"]["gates"]["coverage"] is True
        tags.append(([r["tag"] for r in rows], mod.next_tag(rows)))
    assert tags[1] == tags[0] == (["r01", "r02"], "r03")
    assert history.DEFAULT_BASENAME != jax_history.DEFAULT_BASENAME


def test_history_neighbor_selection():
    picks = []
    for mod in (jax_history, history):
        rows = [
            mod.make_record("r01", 100.0, _fp(mod), ts=1.0),
            mod.make_record("r02", 200.0, _fp(mod, lanes=512), ts=2.0),
            mod.make_record("r03", 110.0, _fp(mod), ts=3.0),
            mod.make_record("r04", 150.0, _fp(mod, gates={**_fp(mod)["gates"], "coverage": False}), ts=4.0),
            mod.make_record("r05", 120.0, _fp(mod, host="boxB"), ts=5.0),
        ]
        b = mod.neighbor_budget(rows, 104.0, _fp(mod))
        picks.append((mod.select_neighbor(rows, _fp(mod))["tag"], mod.select_neighbor(rows, _fp(mod, host=None))["tag"],
                      b, mod.neighbor_budget(rows, 104.0, _fp(mod, platform="tpu"))))
    assert picks[1] == picks[0]
    assert picks[1][:2] == ("r03", "r05") and picks[1][2]["within_5pct"] is False and picks[1][3] is None


def test_history_card_and_kernels_keep_rows_apart():
    """Rows from another card (an H100 SXM against a PCIe card) or from
    other kernel sources never compare; rows off the card (no name on
    either) do."""
    fp = _fp(history)
    assert history.comparable(fp, dict(fp))
    assert not history.comparable(fp, _fp(history, device="NVIDIA H100 PCIe"))
    assert not history.comparable(fp, _fp(history, kernels="fedcba9876543210"))
    assert history.comparable(_fp(history, device=None, platform="cpu"), _fp(history, device=None, platform="cpu"))
    rows = [history.make_record("r01", 100.0, _fp(history, device="NVIDIA H100 PCIe"), ts=1.0)]
    assert history.select_neighbor(rows, fp) is None
    text = history.render_report(rows + [history.make_record("r02", 90.0, fp, ts=2.0)])
    assert "new cfg" in text and "mega" not in text and "rng3+packed+fr+cov" in text


def test_history_fingerprint_gate_normalization(monkeypatch):
    import torch

    gates = {"rng_stream": 3, "clog_packed": True, "pallas_megakernel": True, "flight_recorder": True,
             "coverage": True, "compile_cache_dir": "/x"}
    fp = history.env_fingerprint(backend_platform="cpu", lanes=64, reps=1, segment_steps=384, gates=gates)
    assert fp["gates"] == {"rng_stream": 3, "clog_packed": True, "pallas_megakernel": True,
                           "flight_recorder": True, "coverage": True, "provenance": False}
    jax_fp = jax_history.env_fingerprint(backend_platform="cpu", lanes=64, reps=1, segment_steps=384,
                                         gates={**gates, "pallas_pop": True})
    for key in ("host", "platform", "python", "lanes", "reps", "segment_steps", "device_count"):
        assert fp[key] == jax_fp[key], key
    # the port's own fields: torch and CUDA versions, the kernels' hash,
    # and no card off the card
    from madsim_tpu_torch.ops import build

    assert fp["torch"] == torch.__version__ and fp["cuda"] == torch.version.cuda
    assert fp["kernels"] == build._sources_hash(build.CSRC) and len(fp["kernels"]) == 16
    assert fp["device"] is None and fp["power_limit"] is None
    assert "jax" not in fp and "compile_cache" not in fp
    # on the card the name and limit come from nvidia-smi, as it prints them
    monkeypatch.setattr(history, "card", lambda: {"name": "NVIDIA H100 80GB HBM3", "power_limit": "700.00 W"})
    fp = history.env_fingerprint(backend_platform="cuda", lanes=64, gates=gates)
    assert fp["device"] == "NVIDIA H100 80GB HBM3" and fp["power_limit"] == "700.00 W"


def test_history_card_parses_nvidia_smi(monkeypatch):
    import subprocess
    import types

    def smi(*args, **kwargs):
        return types.SimpleNamespace(returncode=0, stdout="NVIDIA H100 80GB HBM3, 700.00 W\n")

    monkeypatch.setattr(subprocess, "run", smi)
    assert history.card() == {"name": "NVIDIA H100 80GB HBM3", "power_limit": "700.00 W"}

    def missing(*args, **kwargs):
        raise FileNotFoundError("nvidia-smi")

    monkeypatch.setattr(subprocess, "run", missing)
    assert history.card() is None


# -- end to end: --perf-timeline over a real streaming run ---------------------

EXPLORE = ["explore", "--machine", "echo", "--seeds", "64", "--batch", "32", "--stream", "--faults", "0",
           "--horizon", "1.0", "--max-steps", "400", "--queue", "16"]


def test_perf_timeline_e2e_explore_stream(tmp_path):
    """The reference's explore arguments with `--perf-timeline`: the
    port's timeline names the same spans, as often, as the JAX
    package's; its spans cover >= 90% of the wall."""
    out = {who: tmp_path / f"{who}.json" for who in ("jax", "port")}
    want, got = run_pair([*EXPLORE, "--perf-timeline", str(out["jax"])],
                         [*EXPLORE, "--perf-timeline", str(out["port"])])
    assert want[0] == got[0] == 0
    docs = {who: json.loads(p.read_text()) for who, p in out.items()}
    counts = {who: {k: v["count"] for k, v in d["madsim_perf_summary"]["spans"].items()} for who, d in docs.items()}
    assert counts["port"] == counts["jax"]
    names = [[e["name"] for e in d["traceEvents"] if e["ph"] == "X"] for d in (docs["jax"], docs["port"])]
    assert names[1] == names[0]
    s = docs["port"]["madsim_perf_summary"]
    assert {"compile", "dispatch", "counters_poll", "ring_drain", "run_stream", "engine_build"} <= set(s["spans"])
    assert s["span_coverage"] >= 0.9, s
    accounted = sum(v["total_s"] for k, v in s["spans"].items() if k != "run_stream") + s["device_wait_s"]
    assert accounted >= 0.9 * s["wall_s"], s
    xs = [e for e in docs["port"]["traceEvents"] if e["ph"] == "X"]
    assert xs == sorted(xs, key=lambda e: e["ts"])
    assert math.isfinite(sum(e["dur"] for e in xs))
    # on the CPU the engine reports no device memory, as the JAX package's
    assert "device_peak_bytes" not in s["counters"]


def test_perf_timeline_written_on_failure(tmp_path):
    from madsim_tpu_torch.__main__ import _perf_session

    class A:
        perf_timeline = str(tmp_path / "fail.json")
        xla_profile = None
        cmd = "explore"

    with pytest.raises(RuntimeError):
        with _perf_session(A()) as rec:
            with rec.span("doomed"):
                raise RuntimeError("boom")
    doc = json.loads((tmp_path / "fail.json").read_text())
    assert any(e.get("name") == "doomed" for e in doc["traceEvents"])
