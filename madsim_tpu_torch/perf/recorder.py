"""Host-timeline tracing: where does the *wall clock* go?

The port of `madsim_tpu/perf/recorder.py`, host code copied as it is.
`engine/trace_export.py` renders a seed's VIRTUAL-time schedule; this
module renders the complementary view: what the HOST was doing, in real
microseconds, while the engine streamed: launching a segment's kernels,
blocked on a counters poll, draining result rings, writing
checkpoints/stats. `stats["host_syncs"]` says *how many* blocking syncs
happened; the timeline says *how long each one took and what sat
between them*.

A `PerfRecorder` is a context manager that publishes itself through a
contextvar; instrumented code calls the module-level `maybe_span(name)`
which is a no-op (a shared null context) when no recorder is active:
the engine's host loop pays one contextvar read per instrumented call,
nothing else. Spans nest (the recorder keeps a stack) and the export is
Chrome `trace_event` JSON: one process, one "host" thread row, `ph: "X"`
slices whose nesting the Perfetto UI draws by containment.

Span taxonomy (what the instrumented engine emits; the names are the
reference's, so its readers sort the port's time the same way):

=================  =========================================================
``compile``        first call of a stream function on an engine: in eager
                   PyTorch the first launch of its kernels, which on the
                   card also builds and loads the CUDA kernels at first use
``dispatch``       one dispatch of segments; in eager PyTorch the host
                   launching every kernel of those segments (~1,000 a step),
                   so it is long, unlike an async XLA enqueue
``init``           the carry's first segment state on a warm engine
``counters_poll``  the blocking device->host counters read
``ring_drain``     failing/abandoned ring harvest
``harvest``        final flight-recorder / coverage-map transfer
``checkpoint_write`` / ``stats_emit`` / ``engine_build`` — host work
                   riding a hunt
=================  =========================================================

The summary classifies a run: mostly ``compile`` => compile-bound; mostly
``counters_poll``/``ring_drain`` => device-bound (the host is waiting);
large ``dispatch_gap`` (wall time between instrumented operations: the
host-side Python loop) and ``dispatch`` => dispatch-gap-bound (the host
is the bottleneck).
"""

from __future__ import annotations

# madsim: allow-file(D001) — this module's *contract* is reading the
# host wall clock: it measures real elapsed time of host operations
# (compile, dispatch, poll). Nothing here can reach simulation state;
# virtual time stays in the engine.
import contextlib
import contextvars
import json
import time
from typing import Any, Callable, Dict, List, Optional

_CURRENT: contextvars.ContextVar[Optional["PerfRecorder"]] = contextvars.ContextVar(
    "madsim_tpu_perf_recorder", default=None
)

# one shared, re-entered null context for the recorder-off path: no
# allocation per call in the engine hot loop
_NULL_CTX = contextlib.nullcontext()


def current_recorder() -> Optional["PerfRecorder"]:
    """The PerfRecorder active in this context, or None."""
    return _CURRENT.get()


def maybe_span(name: str, **args: Any):
    """`with maybe_span("dispatch"): ...` — a real span when a recorder
    is active, a shared no-op context otherwise (one contextvar read)."""
    rec = _CURRENT.get()
    if rec is None:
        return _NULL_CTX
    return rec.span(name, **args)


def maybe_count(name: str, n: int = 1) -> None:
    """Bump a recorder counter when one is active; no-op otherwise."""
    rec = _CURRENT.get()
    if rec is not None:
        rec.count(name, n)


class PerfRecorder:
    """Collects host spans + counters; exports a Chrome-trace timeline.

    `clock` is injectable for tests (defaults to `time.perf_counter`).
    All recorded times are MICROSECONDS since recorder entry (Chrome
    trace_event's native unit). Not thread-safe by design — the engine
    host loop is single-threaded on purpose.
    """

    def __init__(
        self,
        meta: Optional[Dict[str, Any]] = None,
        clock: Callable[[], float] = time.perf_counter,
    ):
        self.meta = dict(meta or {})
        self._clock = clock
        self.spans: List[dict] = []  # {"name", "ts", "dur", "depth", "args"}
        self._open: List[dict] = []  # in-flight spans (crash-flush path)
        self.counters: Dict[str, int] = {}
        self._t0: Optional[float] = None
        self._t_end: Optional[float] = None
        self._depth = 0
        self._token = None

    # -- lifecycle ----------------------------------------------------------

    def __enter__(self) -> "PerfRecorder":
        if self._t0 is not None:
            raise RuntimeError("PerfRecorder is not re-enterable")
        self._t0 = self._clock()
        self._token = _CURRENT.set(self)
        return self

    def __exit__(self, *exc) -> None:
        self._t_end = self._clock()
        _CURRENT.reset(self._token)
        self._token = None

    def _now_us(self) -> float:
        if self._t0 is None:
            raise RuntimeError("PerfRecorder used outside its context")
        return (self._clock() - self._t0) * 1e6

    # -- recording ----------------------------------------------------------

    @contextlib.contextmanager
    def span(self, name: str, **args: Any):
        """Record one host span; spans nest (`depth` is recorded so the
        summary can attribute wall time to OUTERMOST spans only)."""
        start = self._now_us()
        self._depth += 1
        self._open.append(
            {"name": name, "ts": start, "depth": self._depth - 1,
             "args": args})
        try:
            yield self
        finally:
            self._depth -= 1
            self._open.pop()  # spans unwind LIFO, exceptions included
            self.spans.append(
                {
                    "name": name,
                    "ts": start,
                    "dur": max(self._now_us() - start, 0.0),
                    "depth": self._depth,
                    "args": args,
                }
            )

    def instant(self, name: str, **args: Any) -> None:
        self.spans.append(
            {"name": name, "ts": self._now_us(), "dur": None,
             "depth": self._depth, "args": args}
        )

    def count(self, name: str, n: int = 1) -> None:
        self.counters[name] = self.counters.get(name, 0) + n

    def open_spans(self) -> List[dict]:
        """Still-open spans materialized as of NOW (dur = elapsed so
        far, args tagged ``partial``) — the crash/SIGTERM flush path:
        a worker killed mid-unit dumps these so its `fleet timeline`
        shows the span it died inside instead of nothing. Does not
        mutate recorder state; the spans keep accruing if the process
        survives."""
        if self._t0 is None or not self._open:
            return []
        now = (self._t_end - self._t0) * 1e6 if self._t_end is not None \
            else self._now_us()
        return [
            {"name": s["name"], "ts": s["ts"],
             "dur": max(now - s["ts"], 0.0), "depth": s["depth"],
             "args": dict(s["args"], partial=True)}
            for s in self._open
        ]

    def absorb(self, other: "PerfRecorder", ts_offset_us: float = 0.0) -> int:
        """Replay another recorder's spans/counters into this one,
        shifted by `ts_offset_us` (this recorder's clock at the moment
        the other one started). The fleet worker uses this to nest a
        per-unit recorder — whose spans also go to the store's span
        dump for cross-process correlation — under an outer
        `--perf-timeline` recorder without double-instrumenting.
        Returns the number of spans absorbed."""
        for s in other.spans:
            self.spans.append({
                "name": s["name"],
                "ts": s["ts"] + ts_offset_us,
                "dur": s["dur"],
                "depth": s["depth"],
                "args": dict(s["args"]),
            })
        for name, n in other.counters.items():
            self.count(name, n)
        return len(other.spans)

    # -- analysis -----------------------------------------------------------

    @property
    def wall_us(self) -> float:
        """Recorder-entry to recorder-exit (or to now while active)."""
        if self._t0 is None:
            return 0.0
        end = self._t_end if self._t_end is not None else self._clock()
        return (end - self._t0) * 1e6

    def _level(self, depth_zero: bool) -> List[dict]:
        return sorted(
            (
                s for s in self.spans
                if (s["depth"] == 0) == depth_zero and s["dur"] is not None
            ),
            key=lambda s: s["ts"],
        )

    @staticmethod
    def _union_us(spans: List[dict]) -> float:
        """Merged-interval length (spans pre-sorted by ts)."""
        covered = 0.0
        prev_end = None
        for s in spans:
            start, end = s["ts"], s["ts"] + s["dur"]
            if prev_end is None:
                covered += end - start
            else:
                covered += max(end - max(start, prev_end), 0.0)
            prev_end = end if prev_end is None else max(prev_end, end)
        return covered

    def summary(self) -> dict:
        """Where the wall went, at two grains.

        `spans` — per-name totals over ALL spans, any nesting depth
        (the taxonomy names never nest within themselves, so each
        name's total is honest; a parent like `run_stream` naturally
        contains its children's time — percentages are per-name, not a
        partition). `span_coverage` — merged union of outermost spans
        over the recorder wall ("how much wall is explained at all").
        `dispatch_gap_s` — wall BETWEEN outermost spans: uninstrumented
        host Python. `device_wait_s` — time INSIDE outermost spans not
        covered by any inner span: for a streaming run this is the
        device executing (on a host that shares cores with the compute
        threads, that time starves the host thread between inner spans
        rather than accruing to the blocking poll)."""
        top = self._level(True)
        inner = self._level(False)
        by_name: Dict[str, dict] = {}
        for s in sorted(self.spans, key=lambda s: s["ts"]):
            if s["dur"] is None:
                continue
            d = by_name.setdefault(s["name"], {"total_us": 0.0, "count": 0})
            d["total_us"] += s["dur"]
            d["count"] += 1
        top_union = self._union_us(top)
        # device_wait is scoped to the streaming spans: uncovered
        # interior of a `run_stream` span is the device executing (or
        # starving the host thread on a shared-core box); uncovered
        # interior of anything else is just that span's own host work
        rs = [s for s in top if s["name"] == "run_stream"]
        inner_in_rs = [
            s for s in inner
            if any(
                r["ts"] <= s["ts"] < r["ts"] + r["dur"] for r in rs
            )
        ]
        device_wait = max(self._union_us(rs) - self._union_us(inner_in_rs), 0.0)
        gap_us = 0.0
        prev_end = None
        for s in top:
            if prev_end is not None and s["ts"] > prev_end:
                gap_us += s["ts"] - prev_end
            prev_end = s["ts"] + s["dur"] if prev_end is None else max(
                prev_end, s["ts"] + s["dur"]
            )
        wall = self.wall_us
        spans_out = {
            name: {
                "total_s": round(d["total_us"] / 1e6, 6),
                "count": d["count"],
                "pct_of_wall": round(100.0 * d["total_us"] / wall, 2) if wall else 0.0,
            }
            for name, d in sorted(by_name.items())
        }
        return {
            "wall_s": round(wall / 1e6, 6),
            "spans": spans_out,
            "span_coverage": round(top_union / wall, 4) if wall else 0.0,
            "dispatch_gap_s": round(gap_us / 1e6, 6),
            "dispatch_gap_pct": round(100.0 * gap_us / wall, 2) if wall else 0.0,
            "device_wait_s": round(device_wait / 1e6, 6),
            "device_wait_pct": (
                round(100.0 * device_wait / wall, 2) if wall else 0.0
            ),
            "counters": dict(sorted(self.counters.items())),
        }

    def verdict(self) -> str:
        """One-line answer to "what is this run bound on?": compile vs
        device (blocked polls/drains/harvest + device_wait) vs
        dispatch-gap (everything else: host-side Python — the loop,
        engine build, emitter/checkpoint writes, uninstrumented gaps)."""
        s = self.summary()
        compile_s = s["spans"].get("compile", {}).get("total_s", 0.0)
        device_s = (
            s["spans"].get("counters_poll", {}).get("total_s", 0.0)
            + s["spans"].get("ring_drain", {}).get("total_s", 0.0)
            + s["spans"].get("harvest", {}).get("total_s", 0.0)
            + s["device_wait_s"]
        )
        buckets = {
            "compile-bound": compile_s,
            "device-bound": device_s,
            "dispatch-gap-bound": max(s["wall_s"] - compile_s - device_s, 0.0),
        }
        bound = max(buckets, key=lambda k: buckets[k])
        parts = ", ".join(f"{k.split('-bound')[0]} {v:.2f}s" for k, v in buckets.items())
        return f"{bound} ({parts} of {s['wall_s']:.2f}s wall)"

    # -- export -------------------------------------------------------------

    def chrome_trace(self) -> dict:
        """Chrome/Perfetto trace_event JSON (dict): pid 0, one "host"
        thread (tid 0), `ph: "X"` slices (nesting drawn by containment)
        + `ph: "i"` instants; `madsim_perf_summary` rides as a top-level
        key (trace_event readers ignore unknown top-level keys)."""
        events: List[dict] = [
            {
                "ph": "M", "pid": 0, "name": "process_name",
                "args": {"name": "madsim_tpu host"},
            },
            {
                "ph": "M", "pid": 0, "tid": 0, "name": "thread_name",
                "args": {"name": "host"},
            },
        ]
        for s in sorted(self.spans, key=lambda s: (s["ts"], -(s["dur"] or 0))):
            if s["dur"] is None:
                events.append(
                    {
                        "ph": "i", "s": "t", "pid": 0, "tid": 0,
                        "ts": round(s["ts"], 3), "name": s["name"],
                        "args": dict(s["args"]),
                    }
                )
            else:
                events.append(
                    {
                        "ph": "X", "pid": 0, "tid": 0,
                        "ts": round(s["ts"], 3),
                        "dur": round(max(s["dur"], 0.01), 3),
                        "name": s["name"],
                        "args": dict(s["args"]),
                    }
                )
        return {
            "traceEvents": events,
            "displayTimeUnit": "ms",
            "madsim_perf_summary": self.summary(),
            "madsim_perf_meta": dict(self.meta),
        }

    def write(self, path: str) -> int:
        """Write the Perfetto/Chrome timeline; returns span+instant
        count (excluding metadata records)."""
        doc = self.chrome_trace()
        with open(path, "w") as f:
            json.dump(doc, f)
            f.write("\n")
        return len(doc["traceEvents"]) - 2
