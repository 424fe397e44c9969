"""The port's three-clock profiler (`madsim_tpu_torch/perf/xprof.py`)
against the JAX package's, mirroring tests/test_xprof.py: the gate off
by default inserting nothing; device-trace parsing and finding;
`merge_plane` on the same hand-built documents giving the JAX package's
documents (apart from the label of the device's process, which names
torch.profiler); plus a hand-written fixture in kineto's layout (string
`tid`s, `kernel` and `gpu_user_annotation` events, Python frames); the
capture on the CPU, and its refusal of a card capture with no kernel;
and `run_stream` equal with the gate and a recorder on and off, in
place of :38 (a JAX stream-function cache the port does not have).

Left out of tests/test_xprof.py: :227 (the compile autopsy: eager
PyTorch has no trace, lowering or backend stage). The fleet's /profile
endpoint (:249) runs on the port's fleet, and a CPU worker's unit under
the gate leaves its capture and span dump in the store.
"""

import copy
import gzip
import json
import os

import numpy as np
import pytest
import torch

from madsim_tpu.perf import xprof as jax_xprof
from madsim_tpu_torch.perf import xprof
from madsim_tpu_torch.perf.recorder import PerfRecorder

# -- gate discipline ---------------------------------------------------------


def test_gate_off_inserts_nothing(monkeypatch):
    monkeypatch.delenv(xprof.ENV_GATE, raising=False)
    assert not xprof.enabled()
    assert xprof.annotation("step") is xprof._NULL_CTX
    assert xprof.scope("step") is xprof._NULL_CTX
    assert xprof.collective_scope("cov-map-or") is xprof._NULL_CTX
    assert xprof.sync_marker("anywhere") is None
    monkeypatch.setenv(xprof.ENV_GATE, "0")
    assert not xprof.enabled()
    monkeypatch.setenv(xprof.ENV_GATE, "1")
    assert xprof.enabled()
    assert isinstance(xprof.scope("step"), torch.profiler.record_function)
    assert (xprof.ENV_GATE, xprof.PHASE_PREFIX, xprof.SYNC_NAME, xprof.DEVICE_PHASES) == (
        jax_xprof.ENV_GATE, jax_xprof.PHASE_PREFIX, jax_xprof.SYNC_NAME, jax_xprof.DEVICE_PHASES)


def test_sync_marker_stamps_the_recorder(monkeypatch):
    monkeypatch.setenv(xprof.ENV_GATE, "1")
    with PerfRecorder() as rec:
        a = xprof.sync_marker("dispatch", batch=4)
        b = xprof.sync_marker("counters_poll")
    assert b == a + 1
    marks = [s for s in rec.spans if s["name"] == xprof.SYNC_NAME]
    assert [(m["dur"], m["args"]["seq"], m["args"]["point"]) for m in marks] == [
        (None, a, "dispatch"), (None, b, "counters_poll")]
    assert marks[0]["args"]["batch"] == 4 and marks[0]["args"]["wall_epoch_us"] > 0


# -- device-trace parsing ----------------------------------------------------


def test_load_device_events_parses_and_filters(tmp_path):
    events = [
        {"ph": "X", "name": "madsim.step", "ts": 10, "dur": 5, "pid": 7},
        {"ph": "X", "name": "$profiler.py:120", "ts": 0, "dur": 99},
        {"ph": "M", "name": "process_name", "pid": 7, "args": {"name": "dev"}},
        "not-a-dict",
    ]
    gz = tmp_path / "t.trace.json.gz"
    with gzip.open(gz, "wt") as f:
        json.dump({"traceEvents": events}, f)
    for mod in (jax_xprof, xprof):
        got = mod.load_device_events(str(gz))
        assert [e.get("name") for e in got] == ["madsim.step", "process_name"]
        assert len(mod.load_device_events(str(gz), keep_python=True)) == 3
        assert mod.load_device_events(str(tmp_path / "nope.json")) == []
    torn = tmp_path / "torn.json"
    torn.write_text('{"traceEvents": [')
    scalar = tmp_path / "scalar.json"
    scalar.write_text('{"traceEvents": 42}')
    assert xprof.load_device_events(str(torn)) == [] and xprof.load_device_events(str(scalar)) == []


def test_find_device_trace_prefers_perfetto(tmp_path):
    assert xprof.find_device_trace(str(tmp_path)) is None
    run = tmp_path / "plugins" / "profile" / "run1"
    run.mkdir(parents=True)
    (run / "host.trace.json.gz").write_bytes(b"x")
    for mod in (jax_xprof, xprof):
        assert mod.find_device_trace(str(tmp_path)).endswith("host.trace.json.gz")
    (run / "perfetto_trace.json.gz").write_bytes(b"x")
    for mod in (jax_xprof, xprof):
        assert mod.find_device_trace(str(tmp_path)).endswith("perfetto_trace.json.gz")


# -- the golden clock-alignment fixture --------------------------------------


def _host_doc():
    """Two executor spans (dispatch 1000-1500, counters_poll 2000-2300
    host us) and two sync instants, seqs 0/1 (tests/test_xprof.py)."""
    return {
        "traceEvents": [
            {"ph": "M", "pid": 0, "name": "process_name", "args": {"name": "madsim_tpu host"}},
            {"ph": "X", "pid": 0, "tid": 0, "name": "dispatch", "ts": 1000.0, "dur": 500.0, "args": {}},
            {"ph": "X", "pid": 0, "tid": 0, "name": "counters_poll", "ts": 2000.0, "dur": 300.0, "args": {}},
            {"ph": "i", "s": "t", "pid": 0, "tid": 0, "name": "madsim.sync", "ts": 1000.0,
             "args": {"point": "a", "seq": 0}},
            {"ph": "i", "s": "t", "pid": 0, "tid": 0, "name": "madsim.sync", "ts": 2300.0,
             "args": {"point": "b", "seq": 1}},
        ],
    }


def _device_events():
    """The same run on a device clock 900 us behind."""
    return [
        {"ph": "X", "pid": 3, "tid": 0, "name": "madsim.sync:0", "ts": 100.0, "dur": 0.0},
        {"ph": "X", "pid": 3, "tid": 0, "name": "madsim.sync:1", "ts": 1400.0, "dur": 0.0},
        {"ph": "X", "pid": 3, "tid": 0, "name": "madsim.step", "ts": 150.0, "dur": 200.0},
        {"ph": "X", "pid": 3, "tid": 0, "name": "madsim.counters", "ts": 1150.0, "dur": 100.0},
        {"ph": "X", "pid": 3, "tid": 0, "name": "fusion.42", "ts": 500.0, "dur": 50.0},
    ]


def _virtual_doc():
    return {
        "traceEvents": [
            {"ph": "M", "pid": 0, "name": "process_name", "args": {"name": "node timelines"}},
            {"ph": "X", "pid": 0, "tid": 2, "name": "elect", "ts": 123456.0, "dur": 10.0, "args": {}},
        ],
    }


def _merged_pair(*args, **kwargs):
    """merge_plane of both packages on deep copies of the same inputs;
    the JAX package's document with its device process label replaced
    by the port's."""
    want = jax_xprof.merge_plane(*copy.deepcopy(args), **copy.deepcopy(kwargs))
    got = xprof.merge_plane(*copy.deepcopy(args), **copy.deepcopy(kwargs))
    for e in want["traceEvents"]:
        if e.get("ph") == "M" and (e.get("args") or {}).get("name") == "device (jax profiler, host-aligned)":
            e["args"] = {"name": xprof.DEVICE_PROCESS_LABEL}
    assert got == want
    return got


def test_merge_plane_golden_clock_alignment():
    doc = _merged_pair(_host_doc(), _device_events(), _virtual_doc(), meta={"trace_id": "golden"})
    s = doc["madsim_xprof_summary"]
    assert s["clock_offset_us"] == pytest.approx(900.0)
    assert s["sync_points"] == 2
    assert s["tracks"] == {"host": True, "device": True, "virtual": True}
    by_name = {}
    for e in doc["traceEvents"]:
        by_name.setdefault(e.get("name"), []).append(e)
    [step] = by_name["madsim.step"]
    [dispatch] = by_name["dispatch"]
    assert step["ts"] == pytest.approx(1050.0)
    assert dispatch["ts"] <= step["ts"] and step["ts"] + step["dur"] <= dispatch["ts"] + dispatch["dur"]
    [velect] = by_name["elect"]
    assert velect["ts"] == 123456.0
    vmeta = [e for e in by_name["process_name"] if "VIRTUAL" in (e.get("args") or {}).get("name", "")]
    assert len(vmeta) == 1 and "simulated" in vmeta[0]["args"]["name"]
    assert s["host_wall_us"] == pytest.approx(1300.0)
    assert s["attribution"] == pytest.approx(800.0 / 1300.0, abs=1e-3)


def test_merge_plane_without_sync_markers_anchors_at_host_start():
    devs = [e for e in _device_events() if not e["name"].startswith("madsim.sync")]
    doc = _merged_pair(_host_doc(), devs, None)
    s = doc["madsim_xprof_summary"]
    assert s["sync_points"] == 0 and s["tracks"]["virtual"] is False
    assert s["clock_offset_us"] == pytest.approx(1000.0 - 150.0)


def test_merge_plane_degrades_to_host_only(tmp_path):
    doc = _merged_pair(_host_doc(), None, None)
    s = doc["madsim_xprof_summary"]
    assert s["tracks"] == {"host": True, "device": False, "virtual": False}
    assert s["sync_points"] == 0 and s["clock_offset_us"] == 0.0
    for name in ("m.json", "m.json.gz"):
        path = str(tmp_path / name)
        n = xprof.write_doc(doc, path)
        assert n == jax_xprof.write_doc(doc, str(tmp_path / f"jax.{name}"))
        with (gzip.open if name.endswith(".gz") else open)(path, "rt") as f:
            back = json.load(f)
        assert len(back["traceEvents"]) == n and back["madsim_xprof_summary"] == s


# -- kineto's layout -----------------------------------------------------------


def _kineto_events():
    """A hand-written capture in the layout torch.profiler exports: the
    CPU process (an int pid and tid) holds the user annotations (the
    phases and the sync markers), the runtime's launch calls and a
    Python frame; the card's process (pid 0, `tid` a string naming the
    stream) holds the kernels and kineto's projection of the phases
    onto the stream; the profiler's own span has string pid and tid.
    The device clock is kineto's, 5,000 us behind the host's."""
    cpu, tid = 4242, 4242
    return [
        {"ph": "M", "name": "process_name", "pid": cpu, "tid": 0, "args": {"name": "python"}},
        {"ph": "M", "name": "process_name", "pid": 0, "tid": 0, "args": {"name": "GPU 0"}},
        {"ph": "M", "name": "thread_name", "pid": 0, "tid": "stream 7", "args": {"name": "stream 7"}},
        {"ph": "X", "cat": "user_annotation", "name": "madsim.sync:0", "pid": cpu, "tid": tid,
         "ts": -4000.0, "dur": 1.0},
        {"ph": "X", "cat": "user_annotation", "name": "madsim.step", "pid": cpu, "tid": tid,
         "ts": -3990.0, "dur": 400.0},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "pid": cpu, "tid": tid,
         "ts": -3980.0, "dur": 5.0, "args": {"correlation": 11}},
        {"ph": "X", "cat": "python_function", "name": "core.py(1257): run_segment", "pid": cpu, "tid": tid,
         "ts": -3995.0, "dur": 420.0},
        {"ph": "X", "cat": "kernel", "name": "step_megakernel_kernel", "pid": 0, "tid": "stream 7",
         "ts": -3970.0, "dur": 4.5, "args": {"correlation": 11}},
        {"ph": "X", "cat": "gpu_user_annotation", "name": "madsim.step", "pid": 0, "tid": "stream 7",
         "ts": -3970.0, "dur": 300.0},
        {"ph": "X", "cat": "user_annotation", "name": "madsim.sync:1", "pid": cpu, "tid": tid,
         "ts": -3500.0, "dur": 1.0},
        {"ph": "X", "cat": "Trace", "name": "PyTorch Profiler (0)", "pid": "Spans", "tid": "PyTorch Profiler",
         "ts": -4100.0, "dur": 700.0},
    ]


def test_merge_plane_kineto_layout(tmp_path):
    gz = tmp_path / "vm.1.pt.trace.json.gz"
    with gzip.open(gz, "wt") as f:
        json.dump({"schemaVersion": 1, "traceEvents": _kineto_events(), "baseTimeNanoseconds": 1}, f)
    dev = xprof.load_device_events(str(gz))
    assert not any(e.get("cat") == "python_function" for e in dev) and len(dev) == len(_kineto_events()) - 1
    assert xprof.has_kernel_events(str(gz))
    host = {"traceEvents": [
        {"ph": "X", "pid": 0, "tid": 0, "name": "dispatch", "ts": 1000.0, "dur": 500.0, "args": {}},
        {"ph": "i", "s": "t", "pid": 0, "tid": 0, "name": "madsim.sync", "ts": 1000.0, "args": {"seq": 0}},
        {"ph": "i", "s": "t", "pid": 0, "tid": 0, "name": "madsim.sync", "ts": 1500.0, "args": {"seq": 1}},
    ]}
    doc = _merged_pair(host, dev, None)
    s = doc["madsim_xprof_summary"]
    assert s["sync_points"] == 2 and s["clock_offset_us"] == pytest.approx(5000.0)
    by_name = {e.get("name"): e for e in doc["traceEvents"] if e.get("ph") == "X"}
    kern, band = by_name["step_megakernel_kernel"], by_name["madsim.step"]
    assert kern["ts"] == pytest.approx(1030.0) and kern["tid"] == "stream 7"
    assert band["ts"] <= kern["ts"] and kern["ts"] + kern["dur"] <= band["ts"] + band["dur"]
    # three capture processes (the CPU's, the card's, the profiler's
    # "Spans"), each on its own merged pid, labelled as the port's
    labels = [e for e in doc["traceEvents"] if e.get("ph") == "M"
              and (e.get("args") or {}).get("name") == xprof.DEVICE_PROCESS_LABEL]
    assert len({e["pid"] for e in labels}) == 3 and 0 not in {e["pid"] for e in labels}


def test_has_kernel_events_and_capture_on_the_cpu(tmp_path, monkeypatch):
    """On the CPU a capture holds the madsim.* ranges and the sync
    markers (no aten op); asked for the card where the profiler sees
    none, it raises instead of leaving an empty profile."""
    plain = tmp_path / "plain.json"
    plain.write_text(json.dumps({"traceEvents": [{"ph": "X", "cat": "cpu_op", "name": "aten::add"}]}))
    assert not xprof.has_kernel_events(str(plain))
    monkeypatch.setenv(xprof.ENV_GATE, "1")
    with PerfRecorder() as rec:
        with xprof.device_trace(str(tmp_path / "cpu"), cuda=False) as logdir:
            with xprof.scope("step"):
                torch.ones(4) + 1
            xprof.sync_marker("dispatch")
    path = xprof.find_device_trace(logdir)
    events = xprof.load_device_events(path)
    names = {e.get("name") for e in events if e.get("ph") == "X"}
    assert "madsim.step" in names and not any(str(n).startswith("aten::") for n in names)
    # the capture's start and stop markers and the one stamped inside
    marks = [s["args"] for s in rec.spans if s["name"] == xprof.SYNC_NAME]
    assert [m["point"] for m in marks] == ["device_trace_start", "dispatch", "device_trace_stop"]
    assert all(f"madsim.sync:{m['seq']}" in names for m in marks)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    with pytest.raises(RuntimeError, match="no kernel event"):
        with pytest.warns(UserWarning):
            with xprof.device_trace(str(tmp_path / "card"), cuda=True):
                torch.ones(4) + 1
    assert xprof.find_device_trace(str(tmp_path / "card")) is not None
    monkeypatch.delenv(xprof.ENV_GATE)
    with xprof.device_trace(str(tmp_path / "off")) as off:
        assert off is None
    assert not os.path.exists(tmp_path / "off")


# -- run_stream with the gate and a recorder on --------------------------------


def _flagship_engine():
    from madsim_tpu_torch.engine import Engine, EngineConfig, FaultPlan
    from madsim_tpu_torch.models import RaftMachine

    cfg = EngineConfig(horizon_us=5_000_000, queue_capacity=32, rng_stream=3, flight_recorder=True, coverage=True,
                       faults=FaultPlan(n_faults=2, t_max_us=3_000_000, dur_min_us=200_000, dur_max_us=800_000))
    return Engine(RaftMachine(num_nodes=5, log_capacity=8), cfg, device="cpu")


@pytest.mark.parametrize("pipelined", [True, False], ids=["pipelined", "per-segment"])
def test_run_stream_equal_with_gate_and_recorder(pipelined, monkeypatch):
    """The flagship stream (recorder and buffered coverage on, v3) with
    MADSIM_TPU_XPROF and a PerfRecorder on gives the results of a run
    with both off: failing seeds, rings, coverage map and curve, every
    stat. The recorder holds the executor's spans and a sync marker at
    each dispatch and poll."""
    kw = dict(batch=16, segment_steps=64, seed_start=3, max_steps=160, pipelined=pipelined,
              segments_per_dispatch=2, dispatch_depth=2)
    monkeypatch.delenv(xprof.ENV_GATE, raising=False)
    off = _flagship_engine().run_stream(40, **kw)
    monkeypatch.setenv(xprof.ENV_GATE, "1")
    eng = _flagship_engine()
    with PerfRecorder() as rec:
        on = eng.run_stream(40, **kw)
    assert on.keys() == off.keys() and np.array_equal(on.pop("coverage_map"), off.pop("coverage_map"))
    assert on == off
    names = [s["name"] for s in rec.spans]
    for name in ("run_stream", "compile", "counters_poll", "ring_drain", "harvest"):
        assert name in names, name
    assert names.count("harvest") == 2 and names.count("compile") >= 2
    st = on["stats"]
    marks = names.count(xprof.SYNC_NAME)
    assert marks == st["dispatches"] + st["host_syncs"] - st["drains"]


# -- the fleet /profile endpoint ---------------------------------------------


def test_fleet_profile_endpoint_degraded_and_full(tmp_path):
    """/jobs/{id}/profile merges whatever planes exist: with no xprof
    artifacts it degrades to the host plane (the cross-process
    timeline); once the worker's device capture and failing-lane
    virtual trace are on disk they merge in. Torch-free throughout."""
    from madsim_tpu_torch.fleet.api import FleetAPI
    from madsim_tpu_torch.fleet.chaos import synthetic_driver
    from madsim_tpu_torch.fleet.store import JobStore
    from madsim_tpu_torch.fleet.worker import FleetWorker

    root = str(tmp_path)
    st = JobStore(root)
    job = st.submit({"machine": "chaos-echo", "seeds": 96, "batch": 32, "faults": 0})
    FleetWorker(root, worker_id="w1", driver=synthetic_driver, poll_s=0.01).run(drain=True)
    api = FleetAPI(st)

    status, _, body = api.handle("GET", "/jobs/nope/profile")
    assert status == 404

    status, _, body = api.handle("GET", f"/jobs/{job.id}/profile")
    doc = json.loads(body)
    assert status == 200
    assert doc["madsim_xprof_summary"]["tracks"] == {"host": True, "device": False, "virtual": False}
    assert doc["madsim_xprof_meta"]["trace_id"] == job.id

    # the worker's xprof artifacts appear -> the planes merge in
    with gzip.open(st.device_trace_path(job.id), "wt") as f:
        json.dump({"traceEvents": [{"ph": "X", "pid": 0, "tid": 0, "name": "madsim.step", "ts": 5.0,
                                    "dur": 2.0}]}, f)
    with open(st.vtrace_path(job.id), "w") as f:
        json.dump(_virtual_doc(), f)
    status, _, body = api.handle("GET", f"/jobs/{job.id}/profile")
    doc = json.loads(body)
    assert status == 200
    assert doc["madsim_xprof_summary"]["tracks"] == {"host": True, "device": True, "virtual": True}
    names = {e.get("name") for e in doc["traceEvents"]}
    assert "madsim.step" in names and "elect" in names
    # a torn vtrace degrades (no virtual track), never 500s
    with open(st.vtrace_path(job.id), "w") as f:
        f.write('{"traceEvents": [')
    status, _, body = api.handle("GET", f"/jobs/{job.id}/profile")
    assert status == 200
    assert json.loads(body)["madsim_xprof_summary"]["tracks"]["virtual"] is False


def test_fleet_worker_unit_leaves_its_capture_on_the_cpu(tmp_path, monkeypatch):
    """A `--device cpu` worker's unit under MADSIM_TPU_XPROF=1 leaves a
    kineto capture of CPU activity (the stream's `madsim.*` ranges and
    its sync markers) and the unit's span dump in the store, and the
    /profile merge aligns them on the sync markers."""
    from madsim_tpu_torch.fleet.api import FleetAPI
    from madsim_tpu_torch.fleet.store import JobStore
    from madsim_tpu_torch.fleet.worker import FleetWorker

    monkeypatch.setenv(xprof.ENV_GATE, "1")
    root = str(tmp_path)
    st = JobStore(root)
    job = st.submit({"machine": "echo", "seeds": 16, "batch": 16, "faults": 0, "horizon": 1.0, "max_steps": 64})
    FleetWorker(root, worker_id="w1", poll_s=0.01, device="cpu").run(max_units=1)
    trace = st.device_trace_path(job.id)
    events = xprof.load_device_events(trace)
    names = {e.get("name") for e in events}
    assert "madsim.step" in names and any(str(n).startswith(xprof.SYNC_NAME + ":") for n in names)
    assert not xprof.has_kernel_events(trace)  # CPU activity only
    assert os.path.getsize(st.spans_path(job.id)) > 0
    doc = json.loads(FleetAPI(st).handle("GET", f"/jobs/{job.id}/profile")[2])
    summary = doc["madsim_xprof_summary"]
    assert summary["tracks"]["host"] and summary["tracks"]["device"] and summary["sync_points"] >= 2
