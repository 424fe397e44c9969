"""The flagship benchmark of the port: seeds/s of MadRaft 5-node log
replication under partition and kill faults, on the card.

    python -m madsim_tpu_torch bench [--lanes N] [--reps R] [--history PATH]

The port of the repo-root `bench.py:120-616` (`main`, `_main_impl`),
run through the command line's `bench` (`cmd_bench` calls `run`).
Each simulation is one seed run to its end: boot 5 nodes, elect,
replicate an 8-entry log under 2 random partition / kill faults, check
election safety and log matching on every event, 5 virtual seconds.
After a warm run of `2 * lanes` seeds, `reps` runs of `2 * lanes` seeds
each over disjoint seed ranges are timed and the MEDIAN rate reported,
with the per-rep rates, min, max, spread and host load under
`diagnostics` (the reference's criterion benches never single-shot
either). One JSON line on stdout; every capture appends a row to the
port's bench history (`history.py`), and the newest comparable row is
the budget's neighbour ("BUDGET VIOLATION" on stderr below 95% of it;
`MADSIM_TPU_BENCH_ENFORCE_BUDGET=1` makes that exit 1). `capture` is
that timed protocol, shared with `bench --machine NAME`.

The knobs are bench.py's: `MADSIM_TPU_RNG_STREAM` (3),
`MADSIM_TPU_CLOG_PACKED` (1), `MADSIM_TPU_FLIGHT_RECORDER` (1),
`MADSIM_TPU_COVERAGE` (1), `MADSIM_TPU_PROVENANCE` (0),
`MADSIM_TPU_COV_BUFFER` (the engine's default) and
`MADSIM_TPU_STREAM_PIPELINE` (1); `MADSIM_TPU_BENCH_TAG` names the row.

What differs from bench.py, and why:

* no `_acquire_backend` (bench.py:41-118): it re-runs the process on
  the CPU when the accelerator is missing, and the port never falls
  back. Without a card (and without the command line's `--device cpu`)
  `run` exits 2 with the "no CUDA device" line its other commands print;
* one entry point, the command line's: no `python -m` of this module,
  no `MADSIM_TPU_PERF_TIMELINE` (the command line's `--perf-timeline`
  records the host timeline) and no `MADSIM_TPU_BENCH_STEP_COST` menu
  (`bench-ab --gate G` costs each of its gates, `pallas-megakernel`
  where the reference's menu has `pallas_pop_off`);
* no compile cache (bench.py:224-242), no compile autopsy and no
  `MADSIM_TPU_BENCH_COLD_TRACE` (bench.py:253-321): eager PyTorch
  compiles no graph to cache, trace, lower or split. `compile_s` (and
  `compile_s_cold`, kept as bench.py's key: no cache makes a warmer
  first run) is the first `run(1)` of a fresh engine: the kernels' build
  and load at first use and the first run of every op, the meaning
  `history.make_record` gives it; `compile_s_warm` is the first
  `run(1)` of a second fresh engine in the same process;
* the JSON line drops the keys that report JAX's compiler or a TPU:
  `vs_baseline` (a share of a v5e-8 target), `backend`, `trace_s`,
  `lower_s`, `backend_s`, `compile_autopsy`, `flops_per_seed_step` and
  `bytes_per_seed_step`; it adds `card` (`history.card()`: the name and
  power limit nvidia-smi gives, null off the card); `platform` is the
  engine's device type (`cuda` / `cpu`); `gates` holds the port's
  gates (`pallas_megakernel` where the reference has `pallas_pop`);
* the history is the port's (`TORCH_BENCH_HISTORY.jsonl` in the working
  directory unless `MADSIM_TPU_BENCH_HISTORY` or the command line's
  `--history` names another), loaded with `history.load`: the port
  never imports the reference's TPU rows.
"""

from __future__ import annotations

# madsim: allow-file(D001) — every wall-clock read here times host
# throughput (seeds/s, the first run's seconds) or stamps the history
# row; nothing feeds simulation state.
import json
import os
import statistics
import sys
import time
from typing import Mapping, Optional

DEFAULT_LANES = 8192  # the real-chip sweep's maximum (benches/tpu_sweep.py)
DEFAULT_REPS = 5
SEGMENT_STEPS = 384


def _on(env: Mapping[str, str], name: str, default: str) -> bool:
    return env.get(name, default) not in ("", "0")


def flagship_config(environ: Optional[Mapping[str, str]] = None):
    """The flagship's EngineConfig under `environ` (default os.environ):
    bench.py:207-222's values and knobs."""
    from ..engine import EngineConfig, FaultPlan

    env = os.environ if environ is None else environ
    cov_buffer = env.get("MADSIM_TPU_COV_BUFFER", "")
    return EngineConfig(
        horizon_us=5_000_000,
        # 32 slots run this workload with no overflow (PROFILE_r2.md);
        # an overflow would show as a failing lane with code 1
        queue_capacity=32,
        faults=FaultPlan(n_faults=2, t_max_us=3_000_000, dur_min_us=200_000, dur_max_us=800_000),
        rng_stream=int(env.get("MADSIM_TPU_RNG_STREAM", "3")),
        clog_packed=_on(env, "MADSIM_TPU_CLOG_PACKED", "1"),
        flight_recorder=_on(env, "MADSIM_TPU_FLIGHT_RECORDER", "1"),
        coverage=_on(env, "MADSIM_TPU_COVERAGE", "1"),
        provenance=_on(env, "MADSIM_TPU_PROVENANCE", "0"),
        **({} if cov_buffer == "" else {"cov_buffer": int(cov_buffer)}),
    )


def flagship_machine():
    """The flagship's machine: `RaftMachine(num_nodes=5, log_capacity=8)`."""
    from ..models.raft import RaftMachine

    return RaftMachine(num_nodes=5, log_capacity=8)


def gates_of(eng) -> dict:
    """The gates a bench line and its history row carry."""
    cfg = eng.config
    return {
        "rng_stream": cfg.rng_stream,
        "clog_packed": cfg.clog_packed,
        "pallas_megakernel": eng.use_megakernel,
        "flight_recorder": cfg.flight_recorder,
        "coverage": cfg.coverage,
        "cov_buffer": cfg.cov_buffer,
        "provenance": cfg.provenance,
    }


def history_path(explicit: Optional[str] = None) -> str:
    """Where a capture's row goes: `explicit` (the command line's
    --history), else $MADSIM_TPU_BENCH_HISTORY, else the port's file in
    the working directory."""
    from . import history

    return explicit or os.environ.get("MADSIM_TPU_BENCH_HISTORY") or history.DEFAULT_BASENAME


def host_load1() -> Optional[float]:
    try:
        return round(os.getloadavg()[0], 2)
    except OSError:
        return None




def capture(eng, run, *, n: int, reps: int, seed_start: int, stride: int, fingerprint: dict,
            history_file: Optional[str], source: str, compile_s: float,
            compile_s_warm: Optional[float] = None) -> dict:
    """The timed protocol both bench forms share: `reps` runs of `n`
    seeds, the r-th from `seed_start + r * stride`, each rate completed
    seeds over its wall; their median, spread and host load; the budget
    against the newest row of the history comparable with `fingerprint`
    ("BUDGET VIOLATION" on stderr below 95% of it); the row appended
    under $MADSIM_TPU_BENCH_TAG or the next tag. Returns the rates, the
    runs' outputs and the line's shared fields (`fields`); `violated` is
    true when the budget failed and MADSIM_TPU_BENCH_ENFORCE_BUDGET=1."""
    from . import history

    rates, outs = [], []
    for r in range(reps):
        t0 = time.perf_counter()
        outs.append(run(n, seed_start=seed_start + r * stride))
        rates.append(outs[-1]["completed"] / (time.perf_counter() - t0))
    median = statistics.median(rates)
    spread_pct = round(100 * (max(rates) - min(rates)) / max(rates), 1)
    load1 = host_load1()
    hist_path = history_path(history_file)
    rows = history.load(hist_path)
    budget = history.neighbor_budget(rows, median, fingerprint)
    if budget is not None and not budget["within_5pct"]:
        print(f"bench: BUDGET VIOLATION — {median:.1f} seeds/s is "
              f"{100 * (1 - budget['vs_neighbor']):.1f}% below the {budget['neighbor']} capture "
              f"({budget['neighbor_value']}), the newest same-box/same-config neighbor",
              file=sys.stderr, flush=True)
    tag = os.environ.get("MADSIM_TPU_BENCH_TAG") or history.next_tag(rows)
    history.append(hist_path, history.make_record(
        tag, round(median, 1), fingerprint, reps=[round(x, 1) for x in rates], compile_s=round(compile_s, 2),
        compile_s_warm=None if compile_s_warm is None else round(compile_s_warm, 2), spread_pct=spread_pct,
        host_load1=load1, source=source))
    return {
        "rates": rates,
        "outs": outs,
        "spread_pct": spread_pct,
        "host_load1": load1,
        "violated": budget is not None and not budget["within_5pct"]
        and _on(os.environ, "MADSIM_TPU_BENCH_ENFORCE_BUDGET", ""),
        "fields": {
            "value": round(median, 1),
            "unit": "seeds/sec",
            **({"budget": budget} if budget else {}),
            "history": {"tag": tag, "path": os.path.basename(hist_path)},
            "platform": eng.device.type,
            "card": history.card() if eng.device.type == "cuda" else None,
        },
    }


def run(lanes: int, reps: int, device=None, history_file: Optional[str] = None) -> int:
    """The flagship bench at `lanes` lanes, `reps` timed runs; `device`
    None is the card. Prints the one JSON line and returns the exit code:
    0, 1 on an enforced budget violation, 2 without a card."""
    from ..engine.core import resolve_device

    try:
        resolve_device(device)
    except RuntimeError as exc:
        print(f"madsim_tpu_torch: {exc}", file=sys.stderr)
        return 2
    from .recorder import maybe_span

    with maybe_span("engine_build"):
        from ..engine import Engine
        from . import history

    cfg = flagship_config()
    with maybe_span("engine_build"):
        eng = Engine(flagship_machine(), cfg, device=device)
    pipelined = _on(os.environ, "MADSIM_TPU_STREAM_PIPELINE", "1")
    stream = eng.make_stream_runner(batch=lanes, segment_steps=SEGMENT_STEPS, pipelined=pipelined)

    # the first run of a fresh engine: eager PyTorch's whole start cost
    t0 = time.perf_counter()
    stream(1)
    compile_s = time.perf_counter() - t0
    # the same on a second fresh engine: what a later engine of this
    # process pays (the kernels are loaded, the ops have run once)
    with maybe_span("compile_warm"):
        fresh = Engine(flagship_machine(), cfg, device=device)
        t0 = time.perf_counter()
        fresh.make_stream_runner(batch=lanes, segment_steps=SEGMENT_STEPS, pipelined=pipelined)(1)
        compile_s_warm = time.perf_counter() - t0
    del fresh
    stream(2 * lanes, seed_start=500_000)

    # `reps` repetitions over disjoint seed ranges; streaming refills
    # finished lanes, so stragglers never idle the batch
    gates = gates_of(eng)
    fingerprint = history.env_fingerprint(backend_platform=eng.device.type, lanes=lanes, reps=reps,
                                          segment_steps=SEGMENT_STEPS, gates=gates, device_count=1)
    cap = capture(eng, stream, n=2 * lanes, reps=reps, seed_start=1_000_000, stride=4 * lanes,
                  fingerprint=fingerprint, history_file=history_file, source="bench", compile_s=compile_s,
                  compile_s_warm=compile_s_warm)
    rates, stats = cap["rates"], cap["outs"][-1]["stats"]
    print(json.dumps({
        "metric": "madraft5_seeds_per_sec_per_chip",
        **cap["fields"],
        "compile_s": round(compile_s, 2),
        "compile_s_cold": round(compile_s, 2),
        "compile_s_warm": round(compile_s_warm, 2),
        "steady_seeds_per_sec": cap["fields"]["value"],
        "gates": gates,
        "diagnostics": {
            "reps": [round(x, 1) for x in rates],
            "min": round(min(rates), 1),
            "max": round(max(rates), 1),
            "spread_pct": cap["spread_pct"],
            "host_load1": cap["host_load1"],
            "lanes": lanes,
            "segment_steps": SEGMENT_STEPS,
            "queue_capacity": cfg.queue_capacity,
            # the executor's evidence (last rep): blocking syncs against
            # the segments the card ran
            **{k: stats[k] for k in ("host_syncs", "device_segments", "dispatch_depth", "segments_per_dispatch",
                                     "donation", "pipelined")},
            **({"flight_recorder": stats["flight_recorder"]} if "flight_recorder" in stats else {}),
            # the coverage summary (last rep), its curve left out
            **({"coverage": {k: v for k, v in stats["coverage"].items() if k != "curve"}}
               if "coverage" in stats else {}),
        },
    }), flush=True)
    return 1 if cap["violated"] else 0
