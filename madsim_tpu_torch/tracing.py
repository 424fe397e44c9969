"""Tracing spans — structured logging context per node/task.

Reference parity (§5.1): every node gets an `error_span!("node")` and
every task a child span entered on each poll (madsim/src/sim/task/
mod.rs:116-131, runtime/context.rs:59-66), so log lines carry which
simulated process emitted them. Here a logging.Filter injects
`%(sim)s` = "t=<virtual time> node=<name>/<id> task=<id>" into every
record emitted inside a simulation, plus an `@instrument` decorator for
span-like entry/exit logs.
"""

from __future__ import annotations

import functools
import inspect
import json
import logging
import time
from typing import Any, Callable, Optional

from . import _context


class SimContextFilter(logging.Filter):
    """Injects the current simulation context into log records."""

    def filter(self, record: logging.LogRecord) -> bool:
        ctx = _context.try_current()
        if ctx is None:
            record.sim = "-"
            return True
        t_ns = ctx.executor.time.now_ns()
        task = ctx.current_task
        if task is not None:
            node = task.node
            record.sim = f"t={t_ns / 1e9:.6f}s node={node.name}/{node.id} task={task.id}"
        else:
            record.sim = f"t={t_ns / 1e9:.6f}s node=main"
        return True


class JsonlHandler(logging.Handler):
    """Structured JSONL log sink: one JSON object per record —
    {"ts", "level", "logger", "sim", "msg"} — append-mode, grep/jq-able.
    The machine-readable counterpart of the human StreamHandler format
    (engine traces have their own serializer, engine/trace_export.py)."""

    def __init__(self, path: str):
        super().__init__()
        self._f = open(path, "a")

    def emit(self, record: logging.LogRecord) -> None:
        try:
            self._f.write(
                json.dumps(
                    {
                        # madsim: allow(D001) — log-record wall stamp
                        "ts": round(time.time(), 6),
                        "level": record.levelname,
                        "logger": record.name,
                        "sim": getattr(record, "sim", "-"),
                        "msg": record.getMessage(),
                    }
                )
            )
            self._f.write("\n")
            self._f.flush()
        except Exception:  # never let logging take down the sim
            self.handleError(record)

    def close(self) -> None:
        try:
            self._f.close()
        finally:
            super().close()


def init_tracing(level: str = "INFO", jsonl_path: Optional[str] = None) -> None:
    """Install a handler whose format includes the sim span context
    (reference: init_logger, sim/runtime/mod.rs:445-449). With
    `jsonl_path`, a structured JSONL sink (JsonlHandler) is installed
    alongside the human-readable stream handler."""
    root = logging.getLogger()
    root.setLevel(getattr(logging, level.upper()))
    handler = logging.StreamHandler()
    handler.setFormatter(logging.Formatter("%(levelname)s [%(sim)s] %(name)s: %(message)s"))
    handler.addFilter(SimContextFilter())
    root.addHandler(handler)
    if jsonl_path:
        jh = JsonlHandler(jsonl_path)
        jh.addFilter(SimContextFilter())
        root.addHandler(jh)


class StatsEmitter:
    """Time-series run telemetry for long hunts/benches — observable
    from OUTSIDE the process, which a log stream is not:

      * `<base>.jsonl` — one JSON object per emitted record (append;
        the whole history, replotting-friendly);
      * `<base>.prom` — a Prometheus textfile-collector snapshot of the
        LATEST record's numeric leaves (node_exporter's textfile
        directory, or curl via `serve --service stats` /metrics);
      * `<base>.json` — the latest record verbatim (the `/stats`
        endpoint's payload; dashboards read one file, not a log).

    Snapshots are written atomically (tmp + rename) so a scraper never
    reads a torn file — the latest-snapshot JSON included, which is what
    lets the fleet control plane serve `/jobs/{id}` live feeds without
    ever observing a torn record. Records are plain dicts; nested dicts
    flatten to `a_b_c` gauge names, non-numeric leaves are JSONL-only.
    Emission must never take down a hunt: I/O errors are swallowed
    after the constructor proves the base path writable.

    `labels` namespaces the Prometheus textfile: every gauge renders as
    ``name{k="v",...} value``, so many emitters (one per fleet job) can
    be concatenated into one exposition — the fleet `/metrics` endpoint
    does exactly that with ``labels={"job": <id>}``."""

    def __init__(self, base: str, prefix: str = "madsim_tpu",
                 labels: Optional[dict] = None):
        self.base = base
        self.prefix = prefix
        self.labels = dict(labels) if labels else None
        self.seq = 0
        self._jsonl = open(base + ".jsonl", "a")

    @property
    def jsonl_path(self) -> str:
        return self.base + ".jsonl"

    @property
    def prom_path(self) -> str:
        return self.base + ".prom"

    @property
    def snapshot_path(self) -> str:
        return self.base + ".json"

    @staticmethod
    def _flatten(record: dict, prefix: str = "") -> dict:
        out: dict = {}
        for k, v in record.items():
            key = f"{prefix}_{k}" if prefix else str(k)
            if isinstance(v, dict):
                out.update(StatsEmitter._flatten(v, key))
            elif isinstance(v, bool):
                out[key] = int(v)
            elif isinstance(v, (int, float)):
                out[key] = v
        return out

    def _atomic_write(self, path: str, text: str) -> None:
        # the shared rename discipline, WITHOUT the fsync half: these
        # snapshots are rewritten every batch and are throwaway on
        # crash — a scraper must never see a torn file, but losing the
        # latest one to a power cut costs one poll interval
        from .runtime.atomicio import atomic_write_text

        atomic_write_text(path, text, fsync=False)

    def emit(self, record: dict) -> dict:
        """Emit one record (a plain dict of stats). Returns the record
        as written (with `ts`/`seq` stamped). The write rides the host
        timeline as a `stats_emit` span when a PerfRecorder is active
        (`perf/recorder.py`) — emitter I/O is part of the observability
        tax the timeline exists to expose."""
        from .perf.recorder import maybe_span

        self.seq += 1
        # madsim: allow(D001) — JSONL sink stamps host wall time
        row = {"ts": round(time.time(), 6), "seq": self.seq, **record}
        with maybe_span("stats_emit"):
            return self._emit_row(row)

    def _label_suffix(self) -> str:
        if not self.labels:
            return ""
        rendered = ",".join(
            '{}="{}"'.format(
                k, str(v).replace("\\", "\\\\").replace('"', '\\"')
            )
            for k, v in sorted(self.labels.items())
        )
        return "{" + rendered + "}"

    def _emit_row(self, row: dict) -> dict:
        try:
            self._jsonl.write(json.dumps(row, sort_keys=True) + "\n")
            self._jsonl.flush()
            lines = [f"# emitted by madsim_tpu StatsEmitter (seq {self.seq})"]
            suffix = self._label_suffix()
            for k, v in sorted(self._flatten(row).items()):
                name = f"{self.prefix}_{k}".replace("-", "_").replace(".", "_")
                lines.append(f"# TYPE {name} gauge")
                lines.append(f"{name}{suffix} {v}")
            self._atomic_write(self.prom_path, "\n".join(lines) + "\n")
            self._atomic_write(
                self.snapshot_path, json.dumps(row, sort_keys=True) + "\n"
            )
        except OSError:  # telemetry must never kill the run
            pass
        return row

    def close(self) -> None:
        try:
            self._jsonl.close()
        except OSError:
            pass


def instrument(fn: Callable[..., Any] = None, *, name: str = "", level: int = logging.DEBUG):
    """Span-style decorator: logs entry/exit of a sync or async fn with
    the sim context (reference: `#[instrument]` on net ops). An
    exception exits the span as `exit <span> raised <Type>: <msg>` (at
    the same level — spans are tracing, the exception itself still
    propagates to whoever handles it)."""

    def deco(f):
        span = name or f.__qualname__
        logger = logging.getLogger(f.__module__)

        def _exit_ok():
            logger.log(level, "exit %s", span)

        def _exit_exc(exc: BaseException):
            logger.log(
                level, "exit %s raised %s: %s", span, type(exc).__name__, exc
            )

        if inspect.iscoroutinefunction(f):

            @functools.wraps(f)
            async def wrapper(*args, **kwargs):
                logger.log(level, "enter %s", span)
                try:
                    result = await f(*args, **kwargs)
                except BaseException as exc:
                    _exit_exc(exc)
                    raise
                _exit_ok()
                return result

        else:

            @functools.wraps(f)
            def wrapper(*args, **kwargs):
                logger.log(level, "enter %s", span)
                try:
                    result = f(*args, **kwargs)
                except BaseException as exc:
                    _exit_exc(exc)
                    raise
                _exit_ok()
                return result

        return wrapper

    if fn is not None:
        return deco(fn)
    return deco
