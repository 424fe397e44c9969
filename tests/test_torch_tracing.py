"""The port's tracing (`madsim_tpu_torch.tracing`), mirroring
tests/test_tracing.py case for case: the @instrument span decorator
(sync and async, exit and exception paths), the JSONL log sink, the
command line's --log-level wiring and the StatsEmitter. The decorator's
messages and the log records' simulation context are held equal on both
packages (`torch_host_util.both`)."""

import asyncio
import json
import logging

import pytest

import madsim_tpu.tracing  # noqa: F401  (binds `madsim_tpu.tracing`)
import madsim_tpu_torch.tracing  # noqa: F401
from madsim_tpu_torch.tracing import JsonlHandler, SimContextFilter, StatsEmitter, init_tracing, instrument
from torch_host_util import both


class _Capture(logging.Handler):
    def __init__(self):
        super().__init__(logging.DEBUG)
        self.records = []

    def emit(self, record):
        self.records.append(record)


def _messages(m, body):
    """The messages `body(instrument)` logs at INFO and above, with `m`'s
    `instrument`, and its outcome."""
    cap = _Capture()
    root = logging.getLogger()
    level = root.level
    root.addHandler(cap)
    root.setLevel(logging.INFO)
    try:
        out = body(m.tracing.instrument)
    finally:
        root.removeHandler(cap)
        root.setLevel(level)
    return out, [r.getMessage() for r in cap.records]


def test_instrument_async_entry_exit():
    def work(m):
        def body(instrument):
            @instrument(level=logging.INFO)
            async def work(x):
                return x + 1

            return asyncio.run(work(1))

        return _messages(m, body)

    out, msgs = both(work)
    assert out == 2
    assert any(m.startswith("enter ") and "work" in m for m in msgs)
    assert any(m.startswith("exit ") and "work" in m for m in msgs)


def test_instrument_async_exception_logged_and_propagates():
    def work(m):
        def body(instrument):
            @instrument(level=logging.INFO)
            async def boom():
                raise ValueError("kapow")

            with pytest.raises(ValueError, match="kapow"):
                asyncio.run(boom())
            return True

        return _messages(m, body)

    _, msgs = both(work)
    assert any("exit" in m and "raised ValueError: kapow" in m for m in msgs)


def test_instrument_sync_fn():
    def work(m):
        def body(instrument):
            @instrument(name="span-name", level=logging.INFO)
            def add(a, b):
                return a + b

            @instrument(level=logging.INFO)
            def bad():
                raise KeyError("nope")

            out = add(2, 3)
            with pytest.raises(KeyError):
                bad()
            # functools.wraps preserved the wrapped function's identity
            return out, add.__name__

        return _messages(m, body)

    (out, name), msgs = both(work)
    assert out == 5 and name == "add"
    assert "enter span-name" in msgs and "exit span-name" in msgs
    assert any("raised KeyError" in m for m in msgs)


def test_jsonl_handler_writes_structured_lines(tmp_path):
    path = str(tmp_path / "log.jsonl")
    logger = logging.getLogger("test.torch.jsonl.sink")
    logger.setLevel(logging.DEBUG)
    h = JsonlHandler(path)
    h.addFilter(SimContextFilter())
    logger.addHandler(h)
    try:
        logger.info("hello %s", "world")
        logger.warning("watch out")
    finally:
        logger.removeHandler(h)
        h.close()
    lines = [json.loads(l) for l in open(path)]
    assert len(lines) == 2
    assert lines[0]["msg"] == "hello world" and lines[0]["level"] == "INFO"
    assert lines[1]["level"] == "WARNING"
    # outside a simulation the sim span context is "-"
    assert lines[0]["sim"] == "-"
    assert {"ts", "level", "logger", "sim", "msg"} <= set(lines[0])


def test_init_tracing_installs_jsonl_sink(tmp_path):
    path = str(tmp_path / "root.jsonl")
    root = logging.getLogger()
    before = list(root.handlers)
    try:
        init_tracing("INFO", jsonl_path=path)
        logging.getLogger("some.module").info("ping")
    finally:
        for h in root.handlers[len(before):]:
            h.close()
        root.handlers[:] = before
    lines = [json.loads(l) for l in open(path)]
    assert any(l["msg"] == "ping" for l in lines)


def test_cli_log_level_wiring(tmp_path, capsys):
    """--log-jsonl on any subcommand installs the sink via main()."""
    from madsim_tpu_torch.__main__ import main

    path = str(tmp_path / "cli.jsonl")
    root = logging.getLogger()
    before = list(root.handlers)
    try:
        rc = main([
            "replay", "--machine", "echo", "--seed", "0", "--faults", "0",
            "--max-steps", "50", "--tail", "1",
            "--log-level", "INFO", "--log-jsonl", path, "--device", "cpu",
        ])
        logging.getLogger("cli.test").info("wired")
    finally:
        for h in root.handlers[len(before):]:
            h.close()
        root.handlers[:] = before
    assert rc == 0
    assert any(json.loads(l)["msg"] == "wired" for l in open(path))


def test_log_records_carry_the_sim_context(tmp_path):
    """The records of a simulation carry its virtual time, node and task
    in `sim`, the JAX package's strings: a node `a` that sleeps 1.5 s
    and logs, then the main task."""

    def work(m):
        path = tmp_path / f"{m.__name__}.jsonl"
        root = logging.getLogger()
        before, level = list(root.handlers), root.level
        log = logging.getLogger("test.torch.sim.context")

        async def main():
            node = m.Handle.current().create_node().name("a").build()

            async def task():
                await m.time.sleep(1.5)
                log.info("from a")

            await node.spawn(task())
            log.info("from main")

        try:
            m.tracing.init_tracing("INFO", jsonl_path=str(path))
            m.Runtime(seed=3).block_on(main())
        finally:
            for h in root.handlers[len(before):]:
                h.close()
            root.handlers[:] = before
            root.setLevel(level)
        return [(r["msg"], r["sim"]) for r in map(json.loads, open(path)) if r["logger"] == log.name]

    assert both(work) == [("from a", "t=1.500000s node=a/2 task=2"),
                          ("from main", "t=1.500000s node=madsim-main/1 task=1")]


def test_stats_emitter_jsonl_roundtrip(tmp_path):
    """Every emitted record lands in BASE.jsonl and round-trips exactly
    (modulo the stamped ts/seq); the BASE.json snapshot always holds the
    LAST record; the BASE.prom textfile holds every numeric leaf (nested
    dicts flattened) as a gauge."""
    base = str(tmp_path / "run")
    em = StatsEmitter(base)
    recs = [
        {"kind": "hunt_batch", "batch": 1, "seeds_per_sec": 512.5,
         "coverage": {"slots_hit": 10, "new_slots": 10}, "note": "warm"},
        {"kind": "hunt_batch", "batch": 2, "seeds_per_sec": 640.0,
         "coverage": {"slots_hit": 12, "new_slots": 2}, "plateau": False},
    ]
    for r in recs:
        em.emit(r)
    em.close()

    lines = [json.loads(l) for l in open(base + ".jsonl")]
    assert len(lines) == len(recs)
    for row, rec in zip(lines, recs):
        assert {k: row[k] for k in rec} == rec  # payload round-trips
        assert row["seq"] >= 1 and row["ts"] > 0
    assert [l["seq"] for l in lines] == [1, 2]

    snap = json.loads(open(base + ".json").read())
    assert {k: snap[k] for k in recs[-1]} == recs[-1]

    prom = open(base + ".prom").read()
    assert "madsim_tpu_coverage_slots_hit 12" in prom
    assert "madsim_tpu_seeds_per_sec 640.0" in prom
    assert "madsim_tpu_plateau 0" in prom  # bools emit as 0/1 gauges
    assert "note" not in prom  # strings are JSONL-only
    # append mode: a reopened emitter extends history, replaces snapshots
    em2 = StatsEmitter(base)
    em2.emit({"kind": "summary", "completed": 128})
    em2.close()
    lines = [json.loads(l) for l in open(base + ".jsonl")]
    assert len(lines) == 3 and lines[-1]["kind"] == "summary"
    assert json.loads(open(base + ".json").read())["completed"] == 128


def test_stats_snapshot_and_prom_writes_are_atomic(tmp_path, monkeypatch):
    """The latest-snapshot JSON and the Prometheus textfile are
    tmp+rename: an error mid-update leaves the previous complete snapshot
    in place, never a truncated file, and no .tmp litter survives a
    successful emit."""
    import os as _os

    base = str(tmp_path / "run")
    em = StatsEmitter(base)
    em.emit({"kind": "batch", "completed": 32})
    assert not _os.path.exists(base + ".json.tmp")
    assert not _os.path.exists(base + ".prom.tmp")
    before_snap = open(base + ".json").read()
    before_prom = open(base + ".prom").read()

    real_replace = _os.replace

    def exploding_replace(src, dst):
        if dst.endswith((".json", ".prom")):
            raise OSError("simulated crash between write and publish")
        return real_replace(src, dst)

    monkeypatch.setattr("os.replace", exploding_replace)
    em.emit({"kind": "batch", "completed": 64})  # swallowed (telemetry)
    monkeypatch.undo()
    assert open(base + ".json").read() == before_snap
    assert open(base + ".prom").read() == before_prom
    assert json.loads(open(base + ".json").read())["completed"] == 32
    em.emit({"kind": "batch", "completed": 96})  # recovers after the blip
    assert json.loads(open(base + ".json").read())["completed"] == 96
    em.close()


def test_stats_emitter_label_namespacing(tmp_path):
    """`labels={"job": id}` renders every Prometheus gauge as
    name{job="id"} value; the JSONL history and JSON snapshot stay
    label-free."""
    base = str(tmp_path / "job")
    em = StatsEmitter(base, labels={"job": "j0007-deadbeef"})
    em.emit({"kind": "fleet_batch", "completed": 32,
             "coverage": {"slots_hit": 4}})
    em.close()
    prom = open(base + ".prom").read()
    assert 'madsim_tpu_completed{job="j0007-deadbeef"} 32' in prom
    assert 'madsim_tpu_coverage_slots_hit{job="j0007-deadbeef"} 4' in prom
    snap = json.loads(open(base + ".json").read())
    assert snap["completed"] == 32 and "labels" not in snap
    row = json.loads(open(base + ".jsonl").read().splitlines()[-1])
    assert "labels" not in row
