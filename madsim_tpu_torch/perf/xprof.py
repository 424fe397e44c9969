"""The third clock: the card's execution time, and the plane that unifies
all three.

The port of `madsim_tpu/perf/xprof.py` on `torch.profiler`. The repo
renders two clocks already: `engine/trace_export.py` draws a seed's
VIRTUAL-time schedule, `perf/recorder.py` draws the HOST wall-clock
timeline. This module names the device's work and merges the three:

* **Device-phase attribution**: `annotation(name)` and `scope(name)`
  wrap the stream executor's phases in a
  `torch.profiler.record_function("madsim.<name>")`. Eager PyTorch has
  no trace time, so the reference's two kinds (a host annotation and a
  trace-time scope) are the same thing here. Kineto projects each range
  onto the card's timeline as a `gpu_user_annotation` over the kernels
  launched inside it, so a capture names simulation phases
  (``madsim.step``, ``madsim.harvest``, ...) over the kernels. Gated OFF
  by default (``MADSIM_TPU_XPROF``): when off, every helper returns one
  shared `nullcontext` and `sync_marker` returns None, so nothing is
  inserted into the host loop.

* **The device capture**: `device_trace(logdir)` runs torch's kineto
  profiler (the engine of `torch.profiler.profile`) with CPU activity,
  plus CUDA activity on the card, shapes, stacks and memory off, and
  exports a gzipped Chrome trace under `logdir`. The CPU side records
  the ``madsim.*`` ranges only (`RecordScope.USER_SCOPE`), not every
  aten op: a full-width step runs ~1,000 ops, and a capture of every
  one of them buries the phases, as the reference's Python tracer
  buried its annotations until it was turned off. On the card a capture
  that holds no `kernel` event raises: it never degrades to "no
  artifact".

* **The merged plane**: `merge_plane(host_doc, device_events,
  virtual_doc)` aligns the host timeline, the device capture and a
  failing lane's virtual-time trace into ONE Perfetto session.
  Alignment is by explicit clock-sync markers: `sync_marker(point)`
  stamps the SAME monotonically-numbered marker into both planes (a
  recorder instant named ``madsim.sync`` with the seq in its args, and
  a zero-width ``madsim.sync:<seq>`` range in the capture); the merge
  matches seqs and shifts device time by the median host-device delta.
  Virtual-time tracks are NEVER shifted: they stay in virtual
  microseconds and are labelled as such.

The reference's compile autopsy (trace / lower / backend stages of a
jitted function) has no counterpart in eager PyTorch and is not ported.

Three clock domains, stated once:

=============  ==========================================================
host           us since PerfRecorder entry (`time.perf_counter` based)
device         us on the profiler's clock (kineto's timestamps)
virtual        simulated us from the seed's event schedule, NOT wall time
=============  ==========================================================
"""

from __future__ import annotations

# madsim: allow-file(D001) — this module's *contract* is wall-clock
# profiling: it stamps wall-epoch clock-sync markers and drives
# torch.profiler captures. Nothing here can reach simulation state; the
# gate is off by default and gate-off inserts nothing (one shared
# nullcontext).
import contextlib
import glob
import gzip
import itertools
import json
import logging
import os
import re
import shutil
import socket
import tempfile
import time
from typing import Any, Dict, List, Optional, Tuple

from .recorder import current_recorder

ENV_GATE = "MADSIM_TPU_XPROF"

#: every device-phase name the executor emits carries this prefix so
#: the merge can tell simulation phases from the profiler's own events.
PHASE_PREFIX = "madsim."

#: clock-sync marker name: recorder instants are named exactly this
#: (seq in args); capture ranges are named "madsim.sync:<seq>".
SYNC_NAME = "madsim.sync"

#: the stream executor's phases, as named in the device capture
#: (annotation targets in engine/core.py)
DEVICE_PHASES = (
    "step",            # per-event advance (run_segment interior)
    "refill",          # harvested-lane refill (ranks + seed counter)
    "harvest",         # completion count + ring appends
    "fr_fold",         # flight-recorder totals fold
    "cov_fold",        # coverage-map OR fold
    "counters",        # the small counters vector rebuild
    "ring_append",     # failing/abandoned ring append
    "dispatch",        # host: one dispatch of segments
    "counters_poll",   # host: the blocking device->host counters read
    "ring_drain",      # host: ring harvest + reset
)

#: the merged plane's label of each process of the device capture
DEVICE_PROCESS_LABEL = "device (torch.profiler, host-aligned)"

# one shared, re-entered null context for the gate-off path: no
# allocation, no insertion
_NULL_CTX = contextlib.nullcontext()

_SYNC_SEQ = itertools.count()

# a kernel event of kineto's Chrome export
_KERNEL_EVENT = re.compile(r'"cat":\s*"kernel"')


def enabled() -> bool:
    """The MADSIM_TPU_XPROF gate, read at every call site."""
    return os.environ.get(ENV_GATE, "") not in ("", "0")


def annotation(name: str):
    """A capture range named ``madsim.<name>`` when the gate is on (a
    `torch.profiler.record_function`), the shared no-op context
    otherwise. Host-side executor operations (dispatch, poll, drain)
    are wrapped in it."""
    if not enabled():
        return _NULL_CTX
    from torch.profiler import record_function

    return record_function(PHASE_PREFIX + name)


def scope(name: str):
    """A device phase: in eager PyTorch the same range as `annotation`
    (the reference's trace-time scope has no counterpart: there is no
    trace); kineto draws it on the card's timeline over the kernels
    launched inside it. The shared no-op context when the gate is off."""
    return annotation(name)


def collective_scope(name: str):
    """`scope` for a named collective: ``madsim.collective.<name>``."""
    return scope("collective." + name)


def sync_marker(point: str, **args: Any) -> Optional[int]:
    """Stamp one clock-sync marker into BOTH planes: a zero-width
    ``madsim.sync:<seq>`` range into the device capture and a
    ``madsim.sync`` instant (seq + wall-epoch us in args) onto the
    active PerfRecorder. The executor calls this at dispatch and poll
    boundaries; `merge_plane` matches seqs across the two planes and
    aligns the device clock by the median host-device delta. Returns
    the seq, or None when the gate is off."""
    if not enabled():
        return None
    seq = next(_SYNC_SEQ)
    from torch.profiler import record_function

    with record_function(f"{SYNC_NAME}:{seq}"):
        pass
    rec = current_recorder()
    if rec is not None:
        rec.instant(
            SYNC_NAME, point=point, seq=seq,
            wall_epoch_us=time.time() * 1e6, **args,
        )
    return seq


# -- device capture ----------------------------------------------------------


@contextlib.contextmanager
def device_trace(logdir: str, cuda: Optional[bool] = None):
    """Capture a device profile around a block, a sync marker stamped at
    each boundary. Yields the logdir when capturing, None when the gate
    is off (zero side effects).

    `cuda` (default: whether torch sees a card) adds CUDA activity to
    the CPU activity: kernels, memcpys and the runtime calls that
    launched them; the CPU activity records the ``madsim.*`` ranges
    (record_function's user scope) and no aten op. The capture is
    exported, gzipped, to
    ``<logdir>/plugins/profile/<time>/<host>.<pid>.pt.trace.json.gz``
    (`find_device_trace` finds it). With CUDA activity, a capture that
    holds no `kernel` event raises RuntimeError once the block has
    ended without error: a capture that cannot see the card is a
    failure, not an empty profile."""
    if not enabled():
        yield None
        return
    import torch
    from torch._C._autograd import _disable_profiler, _enable_profiler, _prepare_profiler
    from torch._C._profiler import RecordScope
    from torch.autograd.profiler import profile as _profile
    from torch.profiler import ProfilerActivity

    if cuda is None:
        cuda = torch.cuda.is_available()
    activities = {ProfilerActivity.CPU} | ({ProfilerActivity.CUDA} if cuda else set())
    # torch.profiler.profile's own config (kineto, no shapes, stacks,
    # memory, flops or modules), enabled for the user scope alone
    config = _profile(use_kineto=True, use_device="cuda" if cuda else None, record_shapes=False,
                      profile_memory=False, with_stack=False, with_flops=False, with_modules=False).config()
    os.makedirs(logdir, exist_ok=True)
    run_dir = os.path.join(logdir, "plugins", "profile", time.strftime("%Y_%m_%d_%H_%M_%S"))
    _prepare_profiler(config, activities)
    _enable_profiler(config, activities, {RecordScope.USER_SCOPE})
    sync_marker("device_trace_start")
    ok = False
    try:
        yield logdir
        ok = True
    finally:
        sync_marker("device_trace_stop")
        if cuda:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        result = _disable_profiler()
        os.makedirs(run_dir, exist_ok=True)
        path = os.path.join(run_dir, f"{socket.gethostname()}.{os.getpid()}.pt.trace.json.gz")
        with tempfile.NamedTemporaryFile(suffix=".json", dir=run_dir) as raw:
            result.save(raw.name)
            raw_bytes = os.path.getsize(raw.name)
            with open(raw.name, "rb") as src, gzip.open(path, "wb", compresslevel=1) as dst:
                shutil.copyfileobj(src, dst, 1 << 22)
        logging.getLogger("madsim_tpu.xprof").info(
            "device capture: %d bytes of trace (%d gzipped) exported in %.3fs -> %s",
            raw_bytes, os.path.getsize(path), time.perf_counter() - t0, path)
        if ok and cuda and not has_kernel_events(path):
            raise RuntimeError(
                f"device capture {path} holds no kernel event: the profiler "
                "did not see the card"
            )


def has_kernel_events(path: str) -> bool:
    """Whether a Chrome trace (gzipped or plain) holds a `kernel` event."""
    opener = gzip.open if path.endswith(".gz") else open
    tail = ""
    with opener(path, "rt") as f:
        while True:
            chunk = f.read(1 << 22)
            if not chunk:
                return False
            if _KERNEL_EVENT.search(tail + chunk):
                return True
            tail = chunk[-64:]


def find_device_trace(logdir: str) -> Optional[str]:
    """Newest trace artifact under a profiler logdir (the
    ``plugins/profile/<run>/`` layout): ``perfetto_trace.json.gz`` when
    present, else the newest ``*.trace.json.gz``. None when the capture
    left nothing."""
    for pattern in ("perfetto_trace.json.gz", "*.trace.json.gz"):
        hits = sorted(
            glob.glob(os.path.join(logdir, "**", pattern), recursive=True)
        )
        if hits:
            return hits[-1]
    return None


def load_device_events(path: str, keep_python: bool = False) -> List[dict]:
    """Parse a device-profile trace (gzipped or plain Chrome JSON) into
    its event list. Python-frame events (kineto's `python_function`
    category, and names starting with ``$``) are dropped unless
    `keep_python`: they dominate the count without adding attribution.
    Returns [] on a missing or unparseable artifact."""
    try:
        if path.endswith(".gz"):
            with gzip.open(path, "rt") as f:
                doc = json.load(f)
        else:
            with open(path) as f:
                doc = json.load(f)
    except (OSError, ValueError):
        return []
    events = doc.get("traceEvents", []) if isinstance(doc, dict) else doc
    if not isinstance(events, list):
        return []
    out = []
    for e in events:
        if not isinstance(e, dict):
            continue
        name = e.get("name") or ""
        if not keep_python and (name.startswith("$") or e.get("cat") == "python_function"):
            continue
        out.append(e)
    return out


# -- the merged plane --------------------------------------------------------


def _union_us(ivals: List[Tuple[float, float]]) -> float:
    """Merged length of (start, end) intervals."""
    covered = 0.0
    prev_end = None
    for start, end in sorted(ivals):
        if end <= start:
            continue
        if prev_end is None:
            covered += end - start
            prev_end = end
        else:
            covered += max(end - max(start, prev_end), 0.0)
            prev_end = max(prev_end, end)
    return covered


def _host_sync_points(events: List[dict]) -> Dict[int, float]:
    """seq -> host ts for every ``madsim.sync`` instant in a host doc."""
    out: Dict[int, float] = {}
    for e in events:
        if e.get("name") == SYNC_NAME and "seq" in (e.get("args") or {}):
            out[int(e["args"]["seq"])] = float(e.get("ts", 0.0))
    return out


def _device_sync_points(events: List[dict]) -> Dict[int, float]:
    """seq -> device ts for every ``madsim.sync:<seq>`` slice."""
    out: Dict[int, float] = {}
    prefix = SYNC_NAME + ":"
    for e in events:
        name = e.get("name") or ""
        if name.startswith(prefix):
            try:
                out[int(name[len(prefix):])] = float(e.get("ts", 0.0))
            except ValueError:
                continue
    return out


def _median(xs: List[float]) -> float:
    s = sorted(xs)
    n = len(s)
    return s[n // 2] if n % 2 else (s[n // 2 - 1] + s[n // 2]) / 2.0


def merge_plane(
    host_doc: dict,
    device_events: Optional[List[dict]] = None,
    virtual_doc: Optional[dict] = None,
    meta: Optional[Dict[str, Any]] = None,
) -> dict:
    """One Perfetto session from up to three clock planes.

    `host_doc`: a PerfRecorder `chrome_trace()` (pids 0..N, host us),
    kept verbatim. `device_events`: raw events from `load_device_events`
    (kineto's layout: a process a CPU pid and one for the card, `tid`s
    that may be strings such as ``"stream 7"``). Shifted onto the host
    clock by the median host-device delta over matched ``madsim.sync``
    seqs; with no matched markers, anchored so the earliest device
    slice lands at the earliest host slice (flagged in the summary as
    ``sync_points: 0``). `virtual_doc`: a `trace_export.trace_event_dict`
    document; its tracks are moved onto their own pid and its
    timestamps are NOT touched: virtual microseconds are simulated time.

    The ``madsim_xprof_summary`` key carries the attribution fraction:
    union(host slices and shifted device ``madsim.*`` phase slices,
    clipped to the host window) / host wall.
    """
    host_events = [e for e in host_doc.get("traceEvents", [])]
    events: List[dict] = list(host_events)
    host_pids = {e.get("pid", 0) for e in host_events}
    next_pid = (max(host_pids) + 1) if host_pids else 1

    host_slices = [
        (float(e["ts"]), float(e["ts"]) + float(e["dur"]))
        for e in host_events
        if e.get("ph") == "X" and e.get("dur") is not None
    ]
    if host_slices:
        host_lo = min(s for s, _ in host_slices)
        host_hi = max(e for _, e in host_slices)
    else:
        host_lo, host_hi = 0.0, 0.0
    summary = host_doc.get("madsim_perf_summary") or {}
    wall_us = float(summary.get("wall_s", 0.0)) * 1e6
    if wall_us <= 0.0:
        wall_us = max(host_hi - host_lo, 0.0)

    offset_us = 0.0
    sync_points = 0
    phase_ivals: List[Tuple[float, float]] = []
    device_present = False
    if device_events:
        device_present = True
        h_sync = _host_sync_points(host_events)
        d_sync = _device_sync_points(device_events)
        matched = sorted(set(h_sync) & set(d_sync))
        sync_points = len(matched)
        if matched:
            offset_us = _median([h_sync[s] - d_sync[s] for s in matched])
        else:
            d_ts = [
                float(e["ts"]) for e in device_events
                if e.get("ph") == "X" and "ts" in e
            ]
            offset_us = (host_lo - min(d_ts)) if d_ts else 0.0
        pid_map: Dict[Any, int] = {}
        for e in device_events:
            e = dict(e)
            pid = e.get("pid", 0)
            if pid not in pid_map:
                pid_map[pid] = next_pid
                next_pid += 1
                events.append({
                    "ph": "M", "pid": pid_map[pid], "name": "process_name",
                    "args": {"name": DEVICE_PROCESS_LABEL},
                })
            e["pid"] = pid_map[pid]
            if "ts" in e and e.get("ph") != "M":
                e["ts"] = round(float(e["ts"]) + offset_us, 3)
            events.append(e)
            name = e.get("name") or ""
            if (
                e.get("ph") == "X"
                and e.get("dur") is not None
                and name.startswith(PHASE_PREFIX)
            ):
                s = float(e["ts"])
                phase_ivals.append(
                    (max(s, host_lo), min(s + float(e["dur"]), host_hi))
                )

    virtual_present = False
    if virtual_doc:
        v_events = virtual_doc.get("traceEvents", [])
        if v_events:
            virtual_present = True
            v_pid_map: Dict[Any, int] = {}
            for e in v_events:
                e = dict(e)
                pid = e.get("pid", 0)
                if pid not in v_pid_map:
                    v_pid_map[pid] = next_pid
                    next_pid += 1
                e["pid"] = v_pid_map[pid]
                if e.get("ph") == "M" and e.get("name") == "process_name":
                    base = (e.get("args") or {}).get("name", "virtual")
                    e["args"] = {
                        "name": f"{base} [VIRTUAL µs — simulated time]"
                    }
                # ts untouched: virtual microseconds stay virtual
                events.append(e)

    attributed = _union_us(
        [(max(s, host_lo), min(e, host_hi)) for s, e in host_slices]
        + phase_ivals
    )
    xprof_summary = {
        "attribution": round(attributed / wall_us, 4) if wall_us else 0.0,
        "host_wall_us": round(wall_us, 1),
        "clock_offset_us": round(offset_us, 3),
        "sync_points": sync_points,
        "tracks": {
            "host": bool(host_events),
            "device": device_present,
            "virtual": virtual_present,
        },
    }
    out = {
        "traceEvents": events,
        "displayTimeUnit": "ms",
        "madsim_xprof_summary": xprof_summary,
    }
    for k in ("madsim_perf_summary", "madsim_perf_meta",
              "madsim_fleet_timeline_summary"):
        if k in host_doc:
            out[k] = host_doc[k]
    if meta:
        out["madsim_xprof_meta"] = dict(meta)
    return out


def write_doc(doc: dict, path: str) -> int:
    """Write a merged plane (gzipped when the path says so); returns
    the event count."""
    data = json.dumps(doc)
    if path.endswith(".gz"):
        with gzip.open(path, "wt") as f:
            f.write(data + "\n")
    else:
        with open(path, "w") as f:
            f.write(data + "\n")
    return len(doc.get("traceEvents", []))
