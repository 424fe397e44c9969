"""The port's fleet observatory, held to the cases of
tests/test_fleet_events.py: the append-only job-lifecycle event log, SSE
push streaming, torn-append durability, cross-process trace correlation,
scrape-time SLO histograms with the parsed-textfile cache, and the
pinned heartbeat formats.

Tier budget: everything here is torch-free — the event log, the API
handlers and the synthetic-driver worker runs build no engine (the
control plane's torch-free contract is pinned by a subprocess test in
test_torch_fleet.py that includes fleet.events).
"""

import io
import json
import os
import threading
import time

import pytest

from madsim_tpu_torch.fleet import client as fleet_client
from madsim_tpu_torch.fleet import events as fleet_events
from madsim_tpu_torch.fleet import fsck as fsck_mod
from madsim_tpu_torch.fleet.api import FleetAPI
from madsim_tpu_torch.fleet.chaos import derive_schedule, synthetic_driver
from madsim_tpu_torch.fleet.store import (
    COMPILING,
    EXHAUSTED,
    RUNNING,
    JobStore,
)
from madsim_tpu_torch.fleet.worker import FleetWorker
from madsim_tpu_torch.runtime.atomicio import append_text

ECHO = {"machine": "chaos-echo", "seeds": 48, "batch": 16, "faults": 0}
FIND = {"machine": "chaos-find", "seeds": 48, "batch": 16, "faults": 0}


# -- the event log ------------------------------------------------------------


def test_store_emits_ordered_lifecycle_events(tmp_path):
    """Every store mutation site appends its typed event under the
    per-job lock: the log is the ordered, seq-monotonic history of the
    job, from submit to terminal state."""
    st = JobStore(str(tmp_path))
    job = st.submit(dict(ECHO))
    assert st.try_lease(job.id, "w1", ttl_s=30.0) is not None
    # a same-worker lease renewal is silent (no event spam)
    st.try_lease(job.id, "w1", ttl_s=30.0)
    st.transition(job.id, COMPILING)
    st.transition(job.id, RUNNING)
    st.note_progress(job.id, "w1", {"batches_run": 1},
                     event_fields={"elapsed_s": 0.5, "device_count": 4})
    st.emit_job_event(job.id, "find", worker="w1", failing=1, batch=1)
    st.transition(job.id, EXHAUSTED,
                  result={"report": {"completed": 48}, "finds": []})
    evs = st.read_events(job.id)
    assert [e["type"] for e in evs] == [
        "submitted", "queued", "leased", "compiling", "running",
        "batch_done", "find", "exhausted",
    ]
    assert [e["seq"] for e in evs] == list(range(1, len(evs) + 1))
    assert all(isinstance(e["ts"], float) for e in evs)
    assert all(e["job"] == job.id for e in evs)
    # payloads: the spec snapshot on submitted, the worker thereafter
    assert evs[0]["machine"] == ECHO["machine"]
    assert evs[2]["worker"] == "w1" and evs[2]["ttl_s"] == 30.0
    assert evs[5]["device_count"] == 4 and evs[5]["elapsed_s"] == 0.5
    # ?since=SEQ filters strictly-after
    assert [e["type"] for e in st.read_events(job.id, since=evs[4]["seq"])] \
        == ["batch_done", "find", "exhausted"]


def test_events_kill_switch_disables_emission(tmp_path, monkeypatch):
    monkeypatch.setenv("MADSIM_TPU_FLEET_EVENTS", "0")
    st = JobStore(str(tmp_path))
    job = st.submit(dict(ECHO))
    st.emit_job_event(job.id, "find", worker="w1")
    assert not os.path.exists(st.events_path(job.id))
    assert st.read_events(job.id) == []


def test_append_text_heals_torn_tail_and_seq_survives(tmp_path):
    """A crash mid-append leaves a torn line in the REAL file (appends
    are deliberately not atomic). The next append's healing newline
    confines the damage to one line; readers skip it and the sequence
    re-anchors past it — monotonic across any number of deaths."""
    path = str(tmp_path / "x.events.jsonl")
    fleet_events.emit_event(path, "submitted", job="j1")
    fleet_events.emit_event(path, "queued", job="j1")
    # tear: half of the next record reaches the file, no newline
    with open(path, "a") as f:
        f.write('{"seq":3,"ts":17.0,"ty')
    assert fleet_events.last_seq(path) == 2  # torn record skipped
    rec = fleet_events.emit_event(path, "leased", job="j1", worker="w1")
    assert rec["seq"] == 3  # re-anchored, not reset
    evs = fleet_events.read_events(path)
    assert [e["type"] for e in evs] == ["submitted", "queued", "leased"]
    # the torn prefix is still there, on its own line, exactly once
    lines = open(path).read().splitlines()
    assert lines[2] == '{"seq":3,"ts":17.0,"ty'
    assert len(lines) == 4
    # append_text on a pristine file does NOT inject a leading newline
    p2 = str(tmp_path / "clean.jsonl")
    append_text(p2, '{"a":1}\n')
    append_text(p2, '{"a":2}\n')
    assert open(p2).read() == '{"a":1}\n{"a":2}\n'


def test_fsck_reports_torn_events_without_quarantine(tmp_path):
    """Event/span logs are append-mode observability streams: a torn
    record ANYWHERE (not just the tail) is reported as torn-tail and
    never quarantined — readers skip it, the job is untouched."""
    st = JobStore(str(tmp_path))
    job = st.submit(dict(ECHO))
    path = st.events_path(job.id)
    # torn record in the MIDDLE (a healed mid-append death), plus a
    # torn tail
    with open(path, "a") as f:
        f.write('{"seq":3,"ts":1.0,"torn')
    fleet_events.emit_event(path, "leased", job=job.id, worker="w1")
    with open(path, "a") as f:
        f.write('{"seq":9,"ts"')
    rep = fsck_mod.scan(st)
    [finding] = [x for x in rep["findings"] if x["path"] == path]
    assert finding["verdict"] == "torn-tail"
    assert rep["corrupt"] == 0
    rep2 = fsck_mod.fsck(str(tmp_path), fix=True)
    assert os.path.exists(path)  # never quarantined
    assert not os.path.exists(path + ".corrupt")
    assert rep2["corrupt"] == 0
    # readers skip both torn records
    assert [e["type"] for e in st.read_events(job.id)] == [
        "submitted", "queued", "leased"]


# -- the API: one-shot JSON, ?wait park, SSE stream ---------------------------


def test_api_events_one_shot_since_and_wait(tmp_path):
    st = JobStore(str(tmp_path))
    api = FleetAPI(st)
    api.WAIT_TICK_S = 0.05
    job = st.submit(dict(ECHO))
    status, _, body = api.handle("GET", f"/jobs/{job.id}/events")
    doc = json.loads(body)
    assert status == 200
    assert [e["type"] for e in doc["events"]] == ["submitted", "queued"]
    assert doc["last_seq"] == 2 and doc["terminal"] is False
    # since filters strictly-after
    doc = json.loads(api.handle(
        "GET", f"/jobs/{job.id}/events?since=1")[2])
    assert [e["type"] for e in doc["events"]] == ["queued"]
    # ?wait parks until a NEW event lands, then answers promptly
    timer = threading.Timer(
        0.15, lambda: st.emit_job_event(job.id, "find", worker="w1"))
    timer.start()
    t0 = time.monotonic()
    doc = json.loads(api.handle(
        "GET", f"/jobs/{job.id}/events?since=2&wait=10")[2])
    timer.join()
    assert time.monotonic() - t0 < 5
    assert [e["type"] for e in doc["events"]] == ["find"]
    assert api.handle("GET", "/jobs/nope/events")[0] == 404


def test_sse_stream_pushes_find_then_end(tmp_path):
    """The push-not-poll acceptance: a tailing stream sees `find` at
    find-time (while the job is still running), and an `end` frame —
    with the terminal state — closes the stream."""
    st = JobStore(str(tmp_path))
    api = FleetAPI(st)
    api.WAIT_TICK_S = 0.02
    job = st.submit(dict(ECHO))
    st.try_lease(job.id, "w1", ttl_s=30.0)

    def drive():
        st.emit_job_event(job.id, "find", worker="w1", failing=1)
        time.sleep(0.1)
        st.transition(job.id, COMPILING)
        st.transition(job.id, RUNNING)
        st.transition(job.id, EXHAUSTED,
                      result={"report": {}, "finds": []})

    timer = threading.Timer(0.1, drive)
    timer.start()
    frames = list(fleet_client.parse_sse(io.BytesIO(
        b"".join(api.events_stream(job.id, since=0, wait_s=30.0)))))
    timer.join()
    types = [f.get("event") for f in frames]
    # the find frame arrives BEFORE the terminal lifecycle frames
    assert types.index("find") < types.index("exhausted")
    assert types[-1] == "end"
    end = frames[-1]["data"]
    assert end["state"] == EXHAUSTED and end["job"] == job.id
    # frame ids carry the seq cursor a reconnect would resume from
    assert int(frames[0]["id"]) == 1
    # unknown job: a typed error frame, not an exception
    err = list(fleet_client.parse_sse(io.BytesIO(
        b"".join(api.events_stream("nope", since=0, wait_s=0.1)))))
    assert err[-1]["event"] == "error"


def test_parse_sse_frames(tmp_path):
    raw = (b"retry: 1000\n\n"
           b"id: 1\nevent: submitted\ndata: {\"seq\": 1}\n\n"
           b": keepalive comment\n"
           b"data: {\"a\":\ndata:  1}\n\n"
           b"event: end\ndata: not-json\n\n")
    frames = list(fleet_client.parse_sse(io.BytesIO(raw)))
    assert frames[0] == {"id": "1", "event": "submitted",
                         "data": {"seq": 1}}
    assert frames[1]["data"] == {"a": 1}  # multi-line data joined
    assert frames[2] == {"event": "end", "data": "not-json"}


# -- SLO metrics + the parsed-textfile cache ----------------------------------


def test_slo_observations_from_event_deltas():
    evs = [
        {"type": "submitted", "ts": 100.0, "seq": 1},
        {"type": "queued", "ts": 100.0, "seq": 2},
        {"type": "leased", "ts": 102.5, "seq": 3},
        {"type": "batch_done", "ts": 103.0, "seq": 4,
         "elapsed_s": 0.5, "device_count": 8},
        {"type": "batch_done", "ts": 104.0, "seq": 5,
         "elapsed_s": 1.0, "device_count": 8},
        {"type": "find", "ts": 104.0, "seq": 6},
        {"type": "requeued", "ts": 110.0, "seq": 7},
        {"type": "leased", "ts": 111.0, "seq": 8},
    ]
    obs = fleet_events.slo_observations(evs)
    assert obs["queue_wait_s"] == pytest.approx(2.5)
    assert obs["time_to_first_find_s"] == pytest.approx(4.0)
    assert obs["lane_seconds_per_find"] == pytest.approx(12.0)  # 8*1.5
    assert obs["batches_per_find"] == 2.0
    # a job with no finds contributes nothing to the find histograms
    obs2 = fleet_events.slo_observations(evs[:4])
    assert "time_to_first_find_s" not in obs2
    assert obs2["queue_wait_s"] == pytest.approx(2.5)
    assert fleet_events.slo_observations([]) == {}


def test_metrics_slo_histograms_and_zero_reparse_cache(tmp_path):
    """/metrics renders the four SLO histograms from event deltas at
    scrape time, and a second scrape of an unchanged
    store performs ZERO re-parses of the per-job textfiles and event
    logs (the cache is keyed on (mtime, size))."""
    st = JobStore(str(tmp_path))
    api = FleetAPI(st)
    job = st.submit(dict(ECHO))
    st.try_lease(job.id, "w1", ttl_s=30.0)
    st.emit_job_event(job.id, "find", worker="w1", failing=1)
    with open(st.stats_base(job.id) + ".prom", "w") as f:
        f.write("# TYPE madsim_tpu_completed gauge\n"
                f'madsim_tpu_completed{{job="{job.id}"}} 16\n')
    _, _, body = api.handle("GET", "/metrics")
    text = body.decode()
    for name, _key in api.SLO_METRICS:
        assert f"# TYPE {name} histogram" in text
        assert f'{name}_bucket{{le="+Inf"}}' in text
        assert f"{name}_count" in text
    # the SLO metric names are substrings of the namespaced ones
    for stem in ("fleet_time_to_first_find_seconds",
                 "fleet_queue_wait_seconds",
                 "fleet_lane_seconds_per_find",
                 "fleet_batches_per_find"):
        assert stem in text
    # this farm has one lease + one find observation
    assert "madsim_tpu_fleet_queue_wait_seconds_count 1" in text
    assert "madsim_tpu_fleet_batches_per_find_count 1" in text
    assert f'madsim_tpu_completed{{job="{job.id}"}} 16' in text

    parses = (api._prom_cache.parses, api._events_cache.parses)
    assert parses[0] >= 1 and parses[1] >= 1
    _, _, body2 = api.handle("GET", "/metrics")
    assert (api._prom_cache.parses, api._events_cache.parses) == parses
    assert body2 == body
    # a real change invalidates exactly the touched file
    st.emit_job_event(job.id, "batch_done", worker="w1", batch=1)
    api.handle("GET", "/metrics")
    assert api._events_cache.parses == parses[1] + 1
    assert api._prom_cache.parses == parses[0]


def test_queue_summaries_carry_last_event_and_momentum(tmp_path):
    st = JobStore(str(tmp_path))
    api = FleetAPI(st)
    job = st.submit(dict(ECHO))
    st.try_lease(job.id, "w1", ttl_s=30.0)
    _, _, body = api.handle("GET", "/queue")
    [s] = [j for j in json.loads(body)["jobs"] if j["id"] == job.id]
    assert s["last_event"]["type"] == "leased"
    assert s["last_event"]["seq"] == 3
    assert s["worker"] == "w1"
    assert "active" in s["momentum"]


# -- determinism: events are observability-class ------------------------------


def _run_farm(root, monkeypatch, events_on: bool):
    if events_on:
        monkeypatch.delenv("MADSIM_TPU_FLEET_EVENTS", raising=False)
    else:
        monkeypatch.setenv("MADSIM_TPU_FLEET_EVENTS", "0")
    st = JobStore(root)
    job = st.submit(dict(FIND))
    FleetWorker(root, worker_id="w1", driver=synthetic_driver,
                poll_s=0.01).run(drain=True)
    out = st.get(job.id)
    assert out.state not in ("failed", "quarantined"), out.error
    return st, job.id, json.dumps(out.result["report"], sort_keys=True)


def test_events_on_off_reports_byte_identical(tmp_path, monkeypatch):
    """The acceptance bar: the event log feeds nothing — a run with
    events disabled produces a byte-identical job report, and disables
    every artifact of the observatory."""
    st_on, jid_on, rep_on = _run_farm(
        str(tmp_path / "on"), monkeypatch, events_on=True)
    st_off, jid_off, rep_off = _run_farm(
        str(tmp_path / "off"), monkeypatch, events_on=False)
    assert rep_on == rep_off
    evs = st_on.read_events(jid_on)
    assert [e["type"] for e in evs[:5]] == [
        "submitted", "queued", "leased", "compiling", "running"]
    types = [e["type"] for e in evs]
    # find-at-find-time: the find event lands BEFORE the terminal state
    assert "find" in types and "shrink_started" in types
    assert types.index("find") < types.index("found")
    assert types[-1] == "filed"
    assert not os.path.exists(st_off.events_path(jid_off))
    assert not os.path.exists(st_off.spans_path(jid_off))


# -- cross-process timeline merge ---------------------------------------------


def test_timeline_doc_merges_and_attributes(tmp_path):
    evs = [
        {"type": "submitted", "ts": 1000.0, "seq": 1, "job": "j1"},
        {"type": "queued", "ts": 1000.0, "seq": 2, "job": "j1"},
        {"type": "leased", "ts": 1004.0, "seq": 3, "worker": "w1"},
        {"type": "running", "ts": 1004.2, "seq": 4, "worker": "w1"},
        {"type": "batch_done", "ts": 1006.0, "seq": 5, "batch": 1,
         "elapsed_s": 1.8, "device_count": 2},
        {"type": "find", "ts": 1006.0, "seq": 6, "worker": "w1"},
        {"type": "shrink_started", "ts": 1006.5, "seq": 7},
        {"type": "shrink_done", "ts": 1007.5, "seq": 8, "finds": 1},
        {"type": "filed", "ts": 1008.0, "seq": 9, "worker": "w1"},
    ]
    spans = [{"worker": "w1", "job": "j1", "trace_id": "j1",
              "wall_t0": 1004.1,
              "spans": [{"name": "fleet_unit", "ts": 0.0,
                         "dur": 1.9e6, "depth": 0,
                         "args": {"trace_id": "j1"}}]}]
    doc = fleet_events.timeline_doc(
        {"id": "j1", "state": "filed"}, evs, spans)
    summary = doc["madsim_fleet_timeline_summary"]
    # the acceptance bar: >= 90% of job wall clock in named slices
    assert summary["attribution"] >= 0.9
    assert summary["wall_s"] == pytest.approx(8.0)
    assert summary["trace_id"] == "j1"
    assert summary["worker_spans"] == 1
    names = {e["name"] for e in doc["traceEvents"] if e["ph"] == "X"}
    assert "queue_wait" in names          # submitted -> leased
    assert "batch 1" in names             # reconstructed from elapsed_s
    assert "shrink" in names              # bracketed by its events
    assert "fleet_unit" in names          # the worker's span, merged in
    # queue_wait covers exactly the submit->lease gap
    [qw] = [e for e in doc["traceEvents"]
            if e["ph"] == "X" and e["name"] == "queue_wait"]
    assert qw["dur"] == pytest.approx(4.0e6)
    # the worker pid is a separate named process, re-anchored onto the
    # shared wall clock
    [unit] = [e for e in doc["traceEvents"] if e["name"] == "fleet_unit"]
    assert unit["pid"] != 0
    assert unit["ts"] == pytest.approx(4.1e6)
    assert unit["args"]["trace_id"] == "j1"
    # empty log: a well-formed empty doc, attribution 0
    empty = fleet_events.timeline_doc({"id": "j1"}, [], [])
    assert empty["traceEvents"] == []
    assert empty["madsim_fleet_timeline_summary"]["attribution"] == 0.0


def test_worker_dumps_correlated_spans(tmp_path):
    st = JobStore(str(tmp_path))
    job = st.submit(dict(ECHO))
    FleetWorker(str(tmp_path), worker_id="w1", driver=synthetic_driver,
                poll_s=0.01).run(drain=True)
    recs = list(fleet_events.iter_jsonl(st.spans_path(job.id)))
    assert recs, "worker must dump one span record per unit"
    for rec in recs:
        assert rec["trace_id"] == job.id and rec["worker"] == "w1"
        assert isinstance(rec["wall_t0"], float)
        assert any(sp["name"] == "fleet_unit" for sp in rec["spans"])
    # and the API's /timeline merges them
    api = FleetAPI(st)
    status, _, body = api.handle("GET", f"/jobs/{job.id}/timeline")
    doc = json.loads(body)
    assert status == 200
    assert doc["madsim_fleet_timeline_summary"]["worker_spans"] >= len(recs)
    assert doc["madsim_fleet_timeline_summary"]["attribution"] >= 0.9


# -- chaos schedule: the new event-log faults ---------------------------------


def test_derive_schedule_event_faults_pure():
    a = derive_schedule(4, profile="torn")
    b = derive_schedule(4, profile="torn")
    assert a == b  # replayable from the seed alone
    acts = {e["action"] for e in a["events"]}
    assert {"kill_event_append", "torn_events"} <= acts
    for ev in a["events"]:
        if ev["action"] == "kill_event_append":
            assert 1 <= ev["at_write"] <= 6 and 0 <= ev["at_byte"] <= 80
        elif ev["action"] == "torn_events":
            assert 2 <= ev["cut"] <= 25 and ev["job_index"] >= 0


# -- pinned log formats -------------------------------------------------------


def test_heartbeat_formats_pinned():
    """The per-batch heartbeat lines carry the device count
    and (guided) the escalation rung. Pinned verbatim — operators grep
    these."""
    from madsim_tpu_torch.__main__ import _batch_heartbeat
    from madsim_tpu_torch.search.guided import _guided_heartbeat

    # the unguided line has no escalation argument: only the guided
    # search escalates, and it has a line of its own
    assert _batch_heartbeat(
        2, 6, 256, 2.0, 1, 0, 3, device_count=8,
        cov_txt=", coverage 91 slots (+7)",
    ) == ("batch 2/6: 256 seeds in 2.0s (128 seeds/s) on 8 device(s), "
          "1 failing so far, 0 infra, 3 abandoned, coverage 91 slots (+7)")
    assert _batch_heartbeat(1, 3, 64, 0.5, 0, 0, 0) == (
        "batch 1/3: 64 seeds in 0.5s (128 seeds/s) on 1 device(s), "
        "0 failing so far, 0 infra, 0 abandoned")
    assert _guided_heartbeat(
        3, 8, 128, 96, 4.0, 210, 5, 2, 1, ["pair", "kill"],
        device_count=4, escalated_to=2,
    ) == ("guided batch 3/8: 128 seeds (96 mutants) in 4.0s "
          "(32 seeds/s) on 4 device(s), coverage 210 slots (+5), "
          "2 failing so far, escalation 1 [pair,kill] "
          "-> escalated to step 2")


def test_fleet_top_renders_one_screen():
    from madsim_tpu_torch.__main__ import _fleet_top_render

    doc = {
        "counts": {"running": 1, "queued": 2},
        "jobs": [{
            "id": "j0001-abc", "state": "running", "machine": "etcd",
            "batches_run": 3, "batches_planned": 6, "failing": 1,
            "coverage_slots": 88, "escalation": 2, "worker": "w7",
            "momentum": {"active": True},
            "last_event": {"type": "batch_done", "seq": 9},
        }],
    }
    text = _fleet_top_render(doc)
    head, cols, row = text.splitlines()
    assert "queued:2" in head and "running:1" in head
    assert cols.startswith("JOB")
    assert "j0001-abc" in row and "3/6" in row and "batch_done" in row
    assert "w7" in row and "*" in row
    assert _fleet_top_render({}) == "fleet top — queue empty"
