"""Drift-aware bench history for the port: one JSONL row a capture.

The port of `madsim_tpu/perf/history.py`. Every bench run APPENDS one
row: value, per-rep rates, the first run's seconds, and an ENVIRONMENT
FINGERPRINT, the fields that decide whether two rows are comparable at
all. The budget check is a NEIGHBOR comparison: the newest prior row
whose platform, card, kernel sources, lanes and gates (and host, when
both recorded) match. `render_report` draws the trend.

What differs from the reference:

* the fingerprint records torch and its CUDA version, the card's name
  and power limit as `nvidia-smi --query-gpu=name,power.limit
  --format=csv,noheader` gives them (None off the card), and `kernels`,
  the hash of `ops/csrc` that `ops/build.py` keys its libraries on, so
  two rows from different kernel designs never compare;
* the gate keys are the port's (`pallas_megakernel` where the reference
  has `pallas_pop`), and rows whose card names differ never compare;
* `machine` names what a `bench --machine NAME` row streamed (None for
  the flagship), and rows of different machines never compare; a row
  also keeps `compile_s_warm`, a second fresh engine's first run;
* there is no legacy import: the reference seeds its history from its
  `BENCH_r*.json` series, which are TPU numbers, and the port's history
  holds the card's numbers only. `DEFAULT_BASENAME` is the port's own
  file for the same reason.

Nothing here writes a row by itself: a bench calls `append`. Pure
stdlib apart from the fingerprint, which reads torch's versions.
"""

from __future__ import annotations

# madsim: allow-file(D001) — history rows are stamped with host wall
# time (when a capture was taken) by design; nothing here feeds
# simulation state.
import json
import os
import platform as _platform
import re
import subprocess
import time
from typing import List, Optional

DEFAULT_BASENAME = "TORCH_BENCH_HISTORY.jsonl"

# gate keys that make two runs comparable: a differing gate means the
# step does different work, so a throughput delta is expected
GATE_KEYS = (
    "rng_stream",
    "clog_packed",
    "pallas_megakernel",
    "flight_recorder",
    "coverage",
    "provenance",
)


def card() -> Optional[dict]:
    """The card's name and power limit as nvidia-smi gives them
    ({"name", "power_limit"}), or None where nvidia-smi is missing or
    lists no card."""
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60,
        )
    except (OSError, subprocess.TimeoutExpired):
        return None
    lines = smi.stdout.strip().splitlines() if smi.returncode == 0 else []
    if not lines:
        return None
    name, _, limit = lines[0].rpartition(",")
    return {"name": name.strip(), "power_limit": limit.strip()}


def kernels_hash() -> Optional[str]:
    """The hash of the kernel sources (and nvcc flags) the libraries are
    built from: `ops/build.py`'s key, or None where torch is absent
    (importing `ops` imports torch; a report never needs it)."""
    try:
        from ..ops import build
    except ImportError:
        return None
    return build._sources_hash(build.CSRC)


def env_fingerprint(
    *,
    backend_platform: Optional[str] = None,
    lanes: Optional[int] = None,
    reps: Optional[int] = None,
    segment_steps: Optional[int] = None,
    gates: Optional[dict] = None,
    device_count: Optional[int] = None,
    machine: Optional[str] = None,
) -> dict:
    """The comparability fingerprint for one bench capture.
    `backend_platform` is the engine's device type ("cuda" / "cpu");
    on "cuda" the card's name and power limit are read from nvidia-smi.
    `device_count` is the number of cards the stream spanned (None/1 =
    one) and is part of the comparability key, as is `machine` (the
    registry name a `bench --machine` row streamed; None: the flagship)."""
    try:
        import torch

        torch_v, cuda_v = torch.__version__, torch.version.cuda
    except Exception:  # a report never needs torch installed
        torch_v = cuda_v = None
    gpu = card() if backend_platform == "cuda" else None
    return {
        "host": _platform.node() or None,
        "platform": backend_platform,
        "python": _platform.python_version(),
        "torch": torch_v,
        "cuda": cuda_v,
        "device": gpu["name"] if gpu else None,
        "power_limit": gpu["power_limit"] if gpu else None,
        "kernels": kernels_hash(),
        "lanes": lanes,
        "reps": reps,
        "segment_steps": segment_steps,
        "gates": _norm_gates(gates),
        "device_count": device_count,
        "machine": machine,
    }


def _norm_gates(gates: Optional[dict]) -> Optional[dict]:
    """Project a bench `gates` dict onto the comparability keys with
    plain JSON-stable values (any other key dropped)."""
    if gates is None:
        return None
    out = {}
    for k in GATE_KEYS:
        v = gates.get(k)
        if isinstance(v, bool) or v is None:
            out[k] = bool(v) if v is not None else False
        else:
            out[k] = v
    return out


def make_record(
    tag: str,
    value: float,
    fingerprint: dict,
    *,
    reps: Optional[List[float]] = None,
    compile_s: Optional[float] = None,
    compile_s_warm: Optional[float] = None,
    spread_pct: Optional[float] = None,
    host_load1: Optional[float] = None,
    step_cost: Optional[dict] = None,
    source: str = "bench",
    ts: Optional[float] = None,
) -> dict:
    """One history row. `compile_s` is the first run's seconds (in
    eager PyTorch: the kernels' build and load at first use and the
    first run of every op); `compile_s_warm` is the first run of a second
    fresh engine in the same process."""
    # madsim: allow(D001) — capture timestamp (host metadata, not sim)
    return {
        "tag": tag,
        "ts": round(time.time(), 3) if ts is None else ts,
        "value": value,
        "reps": reps,
        "compile_s": compile_s,
        "compile_s_warm": compile_s_warm,
        "spread_pct": spread_pct,
        "host_load1": host_load1,
        "step_cost": step_cost,
        "source": source,
        "fingerprint": fingerprint,
    }


def load(path: str) -> List[dict]:
    """All history rows, in file (append, so time) order."""
    if not os.path.exists(path):
        return []
    rows = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                rows.append(json.loads(line))
    return rows


def append(path: str, record: dict) -> None:
    with open(path, "a") as f:
        f.write(json.dumps(record, sort_keys=True) + "\n")


def next_tag(rows: List[dict]) -> str:
    """The next rNN tag after the highest in the history."""
    best = 0
    for row in rows:
        m = re.fullmatch(r"r(\d+)", str(row.get("tag", "")))
        if m:
            best = max(best, int(m.group(1)))
    return f"r{best + 1:02d}"


# -- neighbor comparison ----------------------------------------------------


def comparable(fp_a: Optional[dict], fp_b: Optional[dict]) -> bool:
    """Two fingerprints describe the same measurement: platform, lanes
    and the gate tuple must be recorded and equal, and so must the card
    (its name; None on both off the card), the kernel sources' hash and
    the machine (None on both for the flagship);
    the host must match when both rows recorded one."""
    if not fp_a or not fp_b:
        return False
    for key in ("platform", "lanes"):
        if fp_a.get(key) is None or fp_a.get(key) != fp_b.get(key):
            return False
    if fp_a.get("gates") is None or fp_a.get("gates") != fp_b.get("gates"):
        return False
    for key in ("device", "kernels", "machine"):
        if fp_a.get(key) != fp_b.get(key):
            return False
    if (fp_a.get("device_count") or 1) != (fp_b.get("device_count") or 1):
        return False
    host_a, host_b = fp_a.get("host"), fp_b.get("host")
    if host_a is not None and host_b is not None and host_a != host_b:
        return False
    return True


def select_neighbor(rows: List[dict], fingerprint: dict) -> Optional[dict]:
    """The newest prior row comparable to `fingerprint`: the drift-aware
    baseline (same box, card, kernels and config, closest in time)."""
    for row in reversed(rows):
        if comparable(row.get("fingerprint"), fingerprint):
            return row
    return None


def neighbor_budget(
    rows: List[dict], value: float, fingerprint: dict, threshold: float = 0.95
) -> Optional[dict]:
    """The budget receipt for a fresh capture: ratio vs its neighbor,
    or None when no comparable row exists (first capture of a config:
    nothing honest to compare against)."""
    nb = select_neighbor(rows, fingerprint)
    if nb is None or not nb.get("value"):
        return None
    ratio = value / nb["value"]
    return {
        "vs_neighbor": round(ratio, 3),
        "neighbor": nb.get("tag"),
        "neighbor_value": nb["value"],
        "within_5pct": ratio >= threshold,
    }


# -- trend report -----------------------------------------------------------


def _gates_str(fp: Optional[dict]) -> str:
    gates = (fp or {}).get("gates")
    if not gates:
        return "-"
    short = {
        "rng_stream": "rng", "clog_packed": "packed", "pallas_megakernel": "mega",
        "flight_recorder": "fr", "coverage": "cov", "provenance": "prov",
    }
    parts = []
    for k in GATE_KEYS:
        v = gates.get(k)
        if isinstance(v, bool):
            if v:
                parts.append(short[k])
        elif v is not None:
            parts.append(f"{short[k]}{v}")
    text = "+".join(parts) or "none"
    # a `bench --machine` row names its machine before its gates
    return f"{fp['machine']}: {text}" if fp.get("machine") else text


def render_report(rows: List[dict]) -> str:
    """The bench trajectory as text: one line per capture with its
    delta vs its OWN comparable neighbor (so config changes never
    masquerade as regressions)."""
    if not rows:
        return "bench history is empty: a bench appends every capture"
    lines = [
        f"{'tag':<8} {'seeds/s':>9} {'vs prev':>8} {'plat':<5} "
        f"{'lanes':>6} {'compile':>8}  gates",
        "-" * 72,
    ]
    for i, row in enumerate(rows):
        fp = row.get("fingerprint") or {}
        nb = select_neighbor(rows[:i], fp) if fp else None
        if nb and nb.get("value"):
            delta = 100.0 * (row["value"] / nb["value"] - 1.0)
            vs = f"{delta:+.1f}%"
        else:
            vs = "new cfg"
        compile_s = row.get("compile_s")
        lines.append(
            f"{str(row.get('tag', '?')):<8} {row['value']:>9.1f} {vs:>8} "
            f"{str(fp.get('platform') or '?'):<5} "
            f"{str(fp.get('lanes') if fp.get('lanes') is not None else '?'):>6} "
            f"{(f'{compile_s:.1f}s' if compile_s is not None else '?'):>8}  "
            f"{_gates_str(fp)}"
        )
    lines.append("-" * 72)
    lines.append(
        "`vs prev` compares each row against its newest COMPARABLE "
        "neighbor (same platform/card/kernels/lanes/gates/machine, same host when "
        "recorded): drift and config changes are separated by construction."
    )
    return "\n".join(lines)
