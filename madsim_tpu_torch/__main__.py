"""The command line of the port: seed exploration, hunting (guided or
not), replay, trace export, shrinking, the corpus, audits, coverage
reports and the stats endpoint.

    python -m madsim_tpu_torch explore --machine raft --seeds 4096 [--stream]
    python -m madsim_tpu_torch explore --machine raft --seeds 16384 --stream --devices 4
    python -m madsim_tpu_torch hunt    --machine demo-overcommit-raft --stream --corpus c.json
    python -m madsim_tpu_torch hunt    --machine raft --stream --coverage --guided --checkpoint ck.json
    python -m madsim_tpu_torch replay  --machine raft --seed 1234 [--tail 30]
    python -m madsim_tpu_torch why     1234 --machine demo-volatilecommit-raft --strict-restart
    python -m madsim_tpu_torch regress --corpus corpus.json
    python -m madsim_tpu_torch check   --machine kv --seeds 64
    python -m madsim_tpu_torch serve   --service stats --stats BASE --addr 127.0.0.1:0
    MADSIM_TPU_MODE=real python -m madsim_tpu_torch serve --service etcd --addr 127.0.0.1:0 [--grpc]
    python -m madsim_tpu_torch perf    host.json --machine raft --seeds 16384 --batch 8192
    python -m madsim_tpu_torch prof    --merge --out m.json --machine raft --seeds 8192 --batch 8192
    python -m madsim_tpu_torch bench-ab --gate coverage --lanes 1024 --reps 4
    python -m madsim_tpu_torch bench   [--lanes 8192] [--reps 3] [--history TORCH_BENCH_HISTORY.jsonl]
    python -m madsim_tpu_torch bench   --machine raft --seeds 16384
    python -m madsim_tpu_torch bench   report [--history TORCH_BENCH_HISTORY.jsonl]
    python -m madsim_tpu_torch fleet serve --root farm --port-file farm.port
    python -m madsim_tpu_torch fleet submit --port-file farm.port --machine raft --seeds 16384 --batch 8192
    python -m madsim_tpu_torch fleet worker --root farm --drain [--device cpu]

The port of `madsim_tpu/__main__.py`: the same subcommands, flags,
defaults, printed lines and exit codes for explore, hunt (with
`--guided`), replay, trace, why, shrink, regress, audit, check, coverage,
`serve` (the stats endpoint and the host services etcd, kafka and s3),
the perf tooling (`perf`, `prof`,
`bench-ab`, `--perf-timeline`, `--xla-profile`), `bench` (the flagship,
`--machine NAME` and `report`; `perf/flagship.py`) and the hunt farm
(`fleet serve|worker|submit|status|result|cancel|queue|watch|timeline|
profile|top|fsck|chaos`), `--provenance` among
the flags, and the same files (corpus, checkpoint with its guided trail,
coverage doc, exports, attribution JSON, host timeline, merged plane).
`--xla-profile DIR` keeps the reference's spelling; here it is a
`torch.profiler` capture of the card (`perf/xprof.py`). Every command
runs on the CUDA card unless given `--device cpu`; without a card it
exits non-zero and never falls back to the CPU.

`--devices N` shards each stream's lanes over N ranks: the command's
process is rank 0 and starts the other N - 1 (`parallel/ranks.py`), one
card each, or all on the CPU over gloo with `--device cpu`; the results
are those of the unsharded run. `explore --multihost` joins a job of
processes started from the MADSIM_TPU_* env (`parallel/multihost.py`).
Only rank 0 prints or writes a file. `lint` is the static analyzer
(`analysis/`) pointed at this package; it imports no torch unless its C
import half runs (`--no-import-check` turns that off), and neither does
`bench report`. What the port does not run (the compile cache and its
autopsy `prof compile`) exits with status 2 and one line naming the
gate, before any engine is built.
"""

from __future__ import annotations

# madsim: allow-file(D001) — every wall-clock read in this module goes
# through the deliberately named `import time as wall` alias and only
# measures host throughput (seeds/s, elapsed_s) or stamps report
# metadata; nothing feeds simulation state. Virtual time lives in the
# engine.

import argparse
import contextlib
import dataclasses
import functools
import json
import logging
import os
import sys

PROG = "madsim_tpu_torch"

# what the port refuses, and why
_GATED_FLAGS = (
    ("compile_cache", "--compile-cache (a JAX compile cache)", "no port item: the port compiles no graph"),
)


def _gate_line(attr: str) -> str:
    """The refusal line of the flag gate on `attr` (a fleet worker
    refuses a leased job that needs it with the same line)."""
    what, item = next((what, item) for a, what, item in _GATED_FLAGS if a == attr)
    return f"{PROG}: {what} is not ported yet ({item})"


def _gate(args) -> str:
    """The line naming the first gate this command line hits, or ''."""
    if args.cmd == "prof" and args.action == "compile":
        # the reference's compile autopsy splits a jitted function's
        # compile into its trace, lowering and backend stages
        return (f"{PROG}: `prof compile` is not ported: it reads the JAX compile autopsy, and eager "
                f"PyTorch has no trace, lowering or backend stage (no port item)")
    hits = [attr for attr, _what, _item in _GATED_FLAGS if getattr(args, attr, None)]
    return _gate_line(hits[0]) if hits else ""


def _device(args):
    """The engines' device: None (the card) unless `--device cpu`."""
    return "cpu" if getattr(args, "device", "cuda") == "cpu" else None


def _machine(name: str, nodes: int = 0):
    """The registry's machine; an unknown name exits with its message, as
    the reference's registry does."""
    from .models import build_machine

    try:
        return build_machine(name, nodes)
    except ValueError as exc:
        sys.exit(str(exc))


def _build_engine(args):
    # engine construction (model init, device constants, the card's
    # first touch) lands on the host timeline: it is real wall time a
    # --perf-timeline run would otherwise report as unattributed
    from .perf.recorder import maybe_span

    with maybe_span("engine_build"):
        return _build_engine_inner(args)


def _build_engine_inner(args):
    from .engine import Engine, EngineConfig, FaultPlan

    machine = _machine(args.machine, args.nodes)
    cfg = EngineConfig(
        # guided hunts pin the 4-bit coverage band layout so the slot
        # space stays identical across fault-vocabulary escalations; 0
        # keeps the derived layout for every unguided run
        cov_band_bits_min=4 if getattr(args, "guided", False) else 0,
        # round, not truncate: a shrunk repro prints horizon_us/1e6 and
        # float truncation would shave the failing event off the horizon
        horizon_us=round(args.horizon * 1e6),
        queue_capacity=args.queue,
        packet_loss_rate=args.loss,
        rng_stream=getattr(args, "rng_stream", 2),
        flight_recorder=bool(getattr(args, "flight_recorder", False)),
        coverage=bool(getattr(args, "coverage", False)),
        provenance=bool(getattr(args, "provenance", False)),
        # None keeps the engine default (buffered); 0 is the unbuffered
        # per-event fold; the maps are equal either way
        **({} if getattr(args, "cov_buffer", None) is None
           else {"cov_buffer": int(args.cov_buffer)}),
        faults=FaultPlan(
            n_faults=args.faults,
            # an explicit --fault-tmax keeps fault draws stable when a
            # shrunk repro command passes a smaller --horizon
            t_max_us=args.fault_tmax or int(args.horizon * 0.6e6) or 1,
            dur_min_us=100_000,
            dur_max_us=800_000,
            strict_restart=bool(getattr(args, "strict_restart", False)),
            **_fault_kind_flags(args),
        ),
    )
    return Engine(machine, cfg, device=_device(args))


def _fault_kind_flags(args) -> dict:
    from .kinds import CLI_KIND_TO_FLAG

    raw = getattr(args, "fault_kinds", "pair,kill")
    kinds = {k.strip() for k in raw.split(",") if k.strip()}
    known = {name for name, _field in CLI_KIND_TO_FLAG}
    if not kinds <= known:
        sys.exit(f"unknown fault kinds {sorted(kinds - known)}; choose from {sorted(known)}")
    if kinds == {"dup"} and args.faults > 0:
        sys.exit(
            "dup is per-delivery chaos, not a scheduled fault: with "
            "--faults > 0 pick at least one scheduled kind too "
            "(e.g. --fault-kinds pair,kill,dup), or pass --faults 0"
        )
    return {field: name in kinds for name, field in CLI_KIND_TO_FLAG}


def fault_kinds_str(fp) -> str:
    """The --fault-kinds value that reproduces a FaultPlan's vocabulary
    (shrink prints it after kind ablation, so the repro line matches the
    minimized plan)."""
    from .kinds import CLI_KIND_TO_FLAG

    return ",".join(name for name, field in CLI_KIND_TO_FLAG if getattr(fp, field)) or "pair"


def _repro_line(args, seed) -> str:
    """A replay command that reproduces `seed` exactly, including the
    resolved --fault-tmax: without it a replay with another --horizon
    would draw another fault schedule."""
    tmax = args.fault_tmax or int(args.horizon * 0.6e6) or 1
    return (
        f"reproduce: python -m {PROG} replay --machine {args.machine} "
        f"--seed {seed} --nodes {args.nodes} --horizon {args.horizon} "
        f"--queue {args.queue} --faults {args.faults} --loss {args.loss} "
        f"--fault-tmax {tmax} "
        f"--fault-kinds {getattr(args, 'fault_kinds', 'pair,kill')} "
        f"--rng-stream {getattr(args, 'rng_stream', 2)} "
        + ("--strict-restart " if getattr(args, "strict_restart", False) else "")
        + (f"--devices {args.devices} " if getattr(args, "devices", 0) else "")
        + f"--max-steps {args.max_steps}"
    )


@contextlib.contextmanager
def _perf_session(args):
    """`--perf-timeline PATH` / `--xla-profile DIR` around a whole
    subcommand: a PerfRecorder publishes itself for the engine's spans
    (`perf/recorder.py`), and the Chrome/Perfetto host timeline and its
    verdict land AFTER the command's own output. `--xla-profile` turns
    the device-phase gate on and wraps the run in `xprof.device_trace`
    (a `torch.profiler` capture; `perf/xprof.py`), then names the trace
    file it wrote. The timeline is written even when the command fails:
    a failing run's wall-clock profile is exactly what one wants."""
    path = getattr(args, "perf_timeline", None)
    xla_dir = getattr(args, "xla_profile", None)
    if not path and not xla_dir:
        yield None
        return
    from .perf import xprof

    rec = None
    try:
        with contextlib.ExitStack() as stack:
            if xla_dir:
                # before the engine is built: its phases are named from
                # the first segment on
                os.environ[xprof.ENV_GATE] = "1"
                stack.enter_context(xprof.device_trace(xla_dir, cuda=_device(args) != "cpu"))
            if path:
                from .perf.recorder import PerfRecorder

                rec = stack.enter_context(PerfRecorder(meta={"cmd": getattr(args, "cmd", None)}))
            yield rec
    finally:
        if rec is not None and rec.wall_us:
            n = rec.write(path)
            s = rec.summary()
            print(
                f"host timeline: {n} spans, "
                f"{100 * s['span_coverage']:.0f}% of {s['wall_s']:.1f}s "
                f"wall attributed -> {path} (open in https://ui.perfetto.dev)"
            )
            print(f"host verdict: {rec.verdict()}")
        if xla_dir:
            print(f"device profile -> {xprof.find_device_trace(xla_dir)} (open in https://ui.perfetto.dev)")


@contextlib.contextmanager
def _streaming(args):
    """The streaming commands' `stream(eng, n_seeds, **kw)`: the engine's
    `run_stream` with the executor knobs bound (default: pipelined and
    donated; --no-pipeline runs the per-segment driver), and with
    `--devices N` run on every rank of a mesh of N, alive for the block
    (`parallel/ranks.py`)."""
    knobs = {
        "pipelined": not getattr(args, "no_pipeline", False),
        "segments_per_dispatch": getattr(args, "segments_per_dispatch", 8),
        "dispatch_depth": getattr(args, "dispatch_depth", 4),
        "donate": not getattr(args, "no_donate", False),
    }
    n = int(getattr(args, "devices", 0) or 0)
    if not n:
        yield lambda eng, n_seeds, **kw: eng.run_stream(n_seeds, **knobs, **kw)
        return
    from .parallel.ranks import spawn_mesh

    with spawn_mesh(n, cpu=_device(args) == "cpu") as ranks:
        yield lambda eng, n_seeds, **kw: ranks.call(eng, "run_stream", n_seeds=n_seeds, **knobs, **kw)


def _device_count(args) -> int:
    """Ranks a streaming unit spans: `--devices N` shards over N, 0 means
    the unsharded single-device path."""
    return int(getattr(args, "devices", 0) or 0) or 1


def _print_fr_stats(stats) -> None:
    """One metrics line when the flight recorder rode the stream."""
    fr = stats.get("flight_recorder")
    if not fr:
        return
    inj = ", ".join(f"{k}={v}" for k, v in fr["faults_injected"].items() if v)
    extra = "".join(
        f", {label} {fr[key]}"
        for key, label in (("dup_injected", "dups"), ("amnesia_restarts", "amnesia restarts"))
        if fr.get(key)
    )
    print(
        f"flight recorder: faults injected [{inj or 'none'}]{extra}, "
        f"queue hwm {fr['queue_hwm']}, clogged-links hwm {fr['clog_links_hwm']}, "
        f"killed hwm {fr['killed_hwm']}"
    )


def _print_attribution(stats) -> None:
    """One fault-attribution line when provenance rode the run: how many
    failures causally implicate each chaos kind."""
    att = stats.get("fault_attribution")
    if att is None:
        return
    kinds = ", ".join(f"{k}={v}" for k, v in att.items())
    print(f"fault attribution: [{kinds or 'no failures'}]")


def _make_emitter(args):
    """StatsEmitter bound to --stats BASE (also $MADSIM_TPU_STATS).
    `args.stats_labels` (set by the fleet worker, not a flag) namespaces
    the Prometheus gauges per job."""
    base = getattr(args, "stats", None) or os.environ.get("MADSIM_TPU_STATS")
    if not base:
        return None
    from .tracing import StatsEmitter

    return StatsEmitter(base, labels=getattr(args, "stats_labels", None))


def _print_cov_stats(stats) -> None:
    """One coverage line when the map rode the stream."""
    cov = stats.get("coverage")
    if not cov:
        return
    bands = ", ".join(f"{k}={v}" for k, v in cov["by_band"].items() if v)
    print(
        f"coverage: {cov['slots_hit']}/{cov['slots_total']} slots "
        f"({100 * cov['fraction']:.2f}%) [{bands or 'none'}]"
    )


def _batch_heartbeat(bi, planned, completed, el, failing, infra, abandoned, device_count=1, cov_txt=""):
    """The per-batch heartbeat line: batch index, throughput, the devices
    (ranks) the stream spans, failure tallies and the coverage delta."""
    return (
        f"batch {bi}/{planned}: {completed} seeds in {el:.1f}s "
        f"({completed / el:.0f} seeds/s) on {device_count} device(s), "
        f"{failing} failing so far, {infra} infra, {abandoned} abandoned"
        f"{cov_txt}"
    )


def _stream_batches(eng, args, purpose="explore"):
    """The chunked streaming driver of explore and hunt: the seed budget
    as batches of `--batch` seeds (one run_stream call each), with a
    heartbeat log line and a StatsEmitter record per batch, a cumulative
    coverage map, the `--stop-on-plateau N` early exit and the
    `--checkpoint` resume. Returns an aggregate shaped like run_stream's
    result, plus "batches_run", "batches_planned", "plateau" and
    "elapsed_s" (and "coverage_map" with coverage on)."""
    if getattr(args, "guided", False):
        # coverage-feedback search: the same aggregate, checkpoint file
        # and stats feed, but every batch's seed vector is chosen
        from .search.guided import run_guided

        return run_guided(eng, args, purpose=purpose)
    with _streaming(args) as stream:
        return _stream_chunks(eng, args, purpose, stream)


def _stream_chunks(eng, args, purpose, stream):
    """`_stream_batches` past the guided branch, each batch run through
    `stream` (`_streaming`)."""
    import time as wall

    import numpy as np

    log = logging.getLogger(f"madsim_tpu.{purpose}")
    emitter = _make_emitter(args)
    plateau_n = int(getattr(args, "stop_on_plateau", 0) or 0)
    detector = None
    if plateau_n:
        if not getattr(args, "coverage", False):
            sys.exit("--stop-on-plateau needs --coverage: the plateau signal IS the coverage curve")
        from .runtime.coverage import PlateauDetector

        detector = PlateauDetector(plateau_n)

    batch = min(args.seeds, args.batch)
    planned = -(-args.seeds // batch)  # ceil

    agg = {"completed": 0, "failing": [], "infra": [], "abandoned": [], "seeds_consumed": 0, "stats": {},
           # seed -> violation provenance word (--provenance; empty otherwise)
           "provenance": {}}
    cov_map = None
    cursor = args.seed
    plateaued = False
    start_bi = 0

    # --checkpoint PATH: batch i always consumes the same seed range, so
    # the cursor and the aggregates are the whole resumable state
    ckpt_path = getattr(args, "checkpoint", None)
    stop_after = int(getattr(args, "stop_after_batches", 0) or 0)
    if ckpt_path:
        from .runtime.checkpoint import check_fingerprint, load_checkpoint

        ck = load_checkpoint(ckpt_path)
        if ck is not None:
            err = check_fingerprint(ck, args)
            if err:
                sys.exit(f"--checkpoint {ckpt_path}: {err}")
            agg["completed"] = int(ck["completed"])
            agg["seeds_consumed"] = int(ck["seeds_consumed"])
            agg["failing"] = [tuple(x) for x in ck["failing"]]
            agg["infra"] = [tuple(x) for x in ck["infra"]]
            agg["abandoned"] = list(ck["abandoned"])
            agg["provenance"] = {int(k): int(v) for k, v in (ck.get("prov") or {}).items()}
            cursor = int(ck["cursor"])
            start_bi = int(ck["batch"])
            plateaued = bool(ck.get("plateau", False))
            if ck.get("cov_b64"):
                from .runtime.coverage import decode_map

                cov_map = decode_map(ck["cov_b64"], eng.config.cov_slots_log2)
            if detector is not None and ck.get("detector"):
                d = ck["detector"]
                detector.best = int(d["best"])
                detector.streak = int(d["streak"])
                detector.batches = int(d["batches"])
            if ck.get("done"):
                print(
                    f"checkpoint {ckpt_path}: run already complete "
                    f"({start_bi}/{planned} batches, "
                    f"{agg['completed']} seeds) — nothing to resume"
                )
            else:
                print(f"resumed at batch {start_bi + 1}/{planned} "
                      f"({agg['completed']} seeds already completed)")
                log.info("checkpoint %s: resumed at batch %d/%d", ckpt_path, start_bi + 1, planned)

    def _save_ckpt(bi_done: int, done_flag: bool) -> None:
        if not ckpt_path:
            return
        from .runtime.checkpoint import fingerprint_from_args, save_checkpoint
        from .runtime.coverage import encode_map

        save_checkpoint(
            ckpt_path,
            {
                "fingerprint": fingerprint_from_args(args),
                "batch": bi_done,
                "planned": planned,
                "cursor": cursor,
                "completed": agg["completed"],
                "seeds_consumed": agg["seeds_consumed"],
                "failing": [list(x) for x in agg["failing"]],
                "infra": [list(x) for x in agg["infra"]],
                "abandoned": list(agg["abandoned"]),
                "prov": {str(k): v for k, v in agg["provenance"].items()},
                "cov_b64": encode_map(cov_map) if cov_map is not None else None,
                "detector": (
                    {"best": detector.best, "streak": detector.streak, "batches": detector.batches}
                    if detector is not None else None
                ),
                "plateau": plateaued,
                "done": done_flag,
            },
        )

    # warm outside the timed loop, as the reference does
    t_warm = wall.perf_counter()
    stream(eng, 1, batch=batch, segment_steps=384, max_steps=args.max_steps)
    log.info("warm-up run_stream(1, batch=%d): %.1fs", batch, wall.perf_counter() - t_warm)

    t_start = wall.perf_counter()
    bi = start_bi - 1
    for bi in range(start_bi, planned):
        chunk = min(batch, args.seeds - agg["completed"])
        if chunk <= 0:
            _save_ckpt(bi, True)  # seed budget already consumed: complete
            break
        t0 = wall.perf_counter()
        out = stream(
            eng, chunk, batch=min(batch, chunk), segment_steps=384,
            seed_start=cursor, max_steps=args.max_steps,
        )
        el = max(wall.perf_counter() - t0, 1e-9)
        cursor += out["seeds_consumed"]
        agg["completed"] += out["completed"]
        agg["seeds_consumed"] += out["seeds_consumed"]
        agg["failing"].extend(out["failing"])
        agg["infra"].extend(out["infra"])
        agg["abandoned"].extend(out["abandoned"])
        agg["provenance"].update(out.get("provenance", {}))
        agg["stats"] = out["stats"]
        new_slots = 0
        slots_hit = 0
        if "coverage_map" in out:
            m = np.asarray(out["coverage_map"])
            prev = 0 if cov_map is None else int(cov_map.sum())
            cov_map = m if cov_map is None else (cov_map | m)
            slots_hit = int(cov_map.sum())
            new_slots = slots_hit - prev
        cov_txt = f", coverage {slots_hit} slots (+{new_slots})" if cov_map is not None else ""
        log.info("%s", _batch_heartbeat(
            bi + 1, planned, out["completed"], el,
            len(agg["failing"]), len(agg["infra"]), len(agg["abandoned"]),
            device_count=_device_count(args), cov_txt=cov_txt,
        ))
        if emitter is not None:
            rec = {
                "kind": f"{purpose}_batch",
                "machine": args.machine,
                "batch": bi + 1,
                "batches": planned,
                "completed": agg["completed"],
                "batch_completed": out["completed"],
                "seeds_per_sec": round(out["completed"] / el, 1),
                "failing": len(agg["failing"]),
                "infra": len(agg["infra"]),
                "abandoned": len(agg["abandoned"]),
            }
            if cov_map is not None:
                rec["coverage"] = {"slots_hit": slots_hit, "new_slots": new_slots}
            if "flight_recorder" in out["stats"]:
                rec["flight_recorder"] = out["stats"]["flight_recorder"]
            emitter.emit(rec)
        if detector is not None and detector.update(slots_hit):
            plateaued = True
        _save_ckpt(bi + 1, plateaued)
        if plateaued:
            log.info(
                "coverage plateau: no new slots for %d consecutive "
                "batches — stopping after batch %d/%d",
                plateau_n, bi + 1, planned,
            )
            break
        if stop_after and bi + 1 >= stop_after:
            # a deliberate early stop: the checkpoint above has
            # done=False, so the next --checkpoint run resumes
            log.info(
                "stopping after batch %d/%d (--stop-after-batches %d; "
                "resumable via --checkpoint)", bi + 1, planned, stop_after,
            )
            break
    else:
        _save_ckpt(planned, True)

    agg["elapsed_s"] = wall.perf_counter() - t_start
    agg["batches_run"] = bi + 1
    agg["batches_planned"] = planned
    agg["plateau"] = plateaued
    if cov_map is not None:
        agg["coverage_map"] = cov_map
        from .runtime.coverage import coverage_dict

        agg["stats"] = dict(agg["stats"])
        agg["stats"]["coverage"] = {
            **coverage_dict(cov_map, eng.config.cov_slots_log2, band_bits=eng.cov_band_bits),
            "plateau": plateaued,
            "plateau_patience": plateau_n,
        }
    if agg["provenance"]:
        # per-kind fault attribution over the finds: how many failures
        # causally implicate each chaos kind
        from .engine.provenance import kind_counts

        agg["stats"] = dict(agg["stats"])
        agg["stats"]["fault_attribution"] = kind_counts(eng, agg["provenance"])
    if emitter is not None:
        emitter.emit(
            {
                "kind": f"{purpose}_summary",
                "machine": args.machine,
                "completed": agg["completed"],
                "failing": len(agg["failing"]),
                "infra": len(agg["infra"]),
                "abandoned": len(agg["abandoned"]),
                "batches_run": agg["batches_run"],
                "batches_planned": planned,
                "plateau": plateaued,
                "elapsed_s": round(agg["elapsed_s"], 2),
                **({"coverage": agg["stats"]["coverage"]} if cov_map is not None else {}),
                **({"fault_attribution": agg["stats"]["fault_attribution"]}
                   if "fault_attribution" in agg["stats"] else {}),
            }
        )
        emitter.close()
    return agg


def _write_coverage_out(eng, args, agg) -> None:
    """`hunt --coverage-out PATH`: persist the cumulative map for
    cross-run diffing (`coverage PATH --diff OLD`)."""
    path = getattr(args, "coverage_out", None)
    if not path:
        return
    if "coverage_map" not in agg:
        sys.exit("--coverage-out needs --coverage and --stream")
    import time as wall

    from .runtime.coverage import make_coverage_doc, save_coverage_doc

    doc = make_coverage_doc(
        {args.machine: agg["coverage_map"]},
        eng.config.cov_slots_log2,
        band_bits=eng.cov_band_bits,
        meta={
            "seeds": args.seeds,
            "seed_start": args.seed,
            "completed": agg["completed"],
            "fault_kinds": getattr(args, "fault_kinds", "pair,kill"),
            "ts": round(wall.time(), 3),
        },
    )
    save_coverage_doc(path, doc)
    cov = agg["stats"]["coverage"]
    print(f"coverage map: {cov['slots_hit']}/{cov['slots_total']} slots -> {path}")


def _split_infra(failing):
    """(findings, infra) of (seed, code) pairs: OVERFLOW is a fixed-shape
    capacity abort ("rerun with a bigger --queue"), never a finding."""
    from .engine import OVERFLOW

    pairs = list(failing)
    return [(s, c) for s, c in pairs if c != OVERFLOW], [(s, c) for s, c in pairs if c == OVERFLOW]


def _find_failing(eng, args, purpose="hunt"):
    """Run the seeds (streaming or one batch): (failing, infra,
    abandoned count, aggregate), the aggregate being _stream_batches'
    result (nearly empty for the batch path)."""
    import numpy as np

    if args.stream:
        agg = _stream_batches(eng, args, purpose=purpose)
        return agg["failing"], agg["infra"], len(agg["abandoned"]), agg
    seeds = np.arange(args.seed, args.seed + args.seeds, dtype=np.uint32)
    res = eng.make_runner(max_steps=args.max_steps)(seeds)
    failing, infra = _split_infra(
        (int(s), int(c))
        for s, c in zip(eng.failing_seeds(res).tolist(), res.fail_code[res.failed].tolist())
    )
    agg = {"stats": {}, "provenance": {}}
    if eng.config.provenance:
        from .engine.provenance import kind_counts

        agg["provenance"] = {
            int(s): int(p) & 0xFFFFFFFF
            for s, p in zip(eng.failing_seeds(res).tolist(), res.fail_prov[res.failed].tolist())
        }
        agg["stats"]["fault_attribution"] = kind_counts(eng, agg["provenance"])
    return failing, infra, 0, agg


def cmd_explore(args) -> int:
    import numpy as np

    if getattr(args, "multihost", False):
        # the job was joined in main(); the batch shards over every rank
        from .parallel import multihost, pad_to_multiple

        eng = _build_engine(args)
        mesh = multihost.global_mesh()
        n = pad_to_multiple(args.seeds, mesh.size)
        out = multihost.run_batch_global(eng, n, seed_start=args.seed, max_steps=args.max_steps, mesh=mesh)
        # the summary is the same on every process: only process 0 reports
        if mesh.rank == 0:
            print(
                f"explored {n} seeds over {out['processes']} processes / "
                f"{out['global_devices']} devices ({out['completed']} completed), "
                f"{out['failed']} failing"
            )
            if out["failing"]:
                print(f"failing seeds: {out['failing'][:20]}{' ...' if out['truncated'] else ''}")
        return 1 if out["failing"] else 0

    eng = _build_engine(args)
    if args.stream:
        out = _stream_batches(eng, args, purpose="explore")
        el = out["elapsed_s"]
        failing = out["failing"]
        st = out["stats"]
        plateau_txt = (
            f" [stopped early: coverage plateau after batch "
            f"{out['batches_run']}/{out['batches_planned']}]"
            if out["plateau"] else ""
        )
        print(
            f"streamed {out['completed']} seeds in {el:.1f}s "
            f"({out['completed']/max(el, 1e-9):.0f} seeds/s), {len(failing)} failing, "
            f"{len(out['abandoned'])} abandoned"
            + (f", {len(out['infra'])} infra (queue overflow)" if out["infra"] else "")
            + plateau_txt
        )
        print(
            f"executor: {st['device_segments']} segments, "
            f"{st['host_syncs']} host syncs, {st['drains']} drains "
            f"(pipelined={st['pipelined']}, donation={st['donation']}, "
            f"depth={st['dispatch_depth']}x{st['segments_per_dispatch']})"
        )
        _print_fr_stats(st)
        _print_cov_stats(st)
        _print_attribution(st)
        if failing:
            codes = sorted({c for _s, c in failing})
            print(f"failure codes: {codes}")
            print(f"failing seeds: {[s for s, _ in failing[:20]]}{' ...' if len(failing) > 20 else ''}")
            print(_repro_line(args, failing[0][0]))
            return 1
        return 0

    seeds = np.arange(args.seed, args.seed + args.seeds, dtype=np.uint32)
    res = eng.make_runner(max_steps=args.max_steps)(seeds)
    failing = eng.failing_seeds(res).tolist()
    n_done = int(res.done.sum())
    print(f"explored {len(seeds.tolist())} seeds ({n_done} completed), {len(failing)} failing")
    if getattr(args, "coverage", False):
        from .runtime.coverage import coverage_dict, unpack_map

        m = unpack_map(np.bitwise_or.reduce(res.cov["map"].cpu().numpy(), axis=0), eng.config.cov_slots_log2)
        _print_cov_stats({"coverage": coverage_dict(m, eng.config.cov_slots_log2, band_bits=eng.cov_band_bits)})
    if failing:
        codes = sorted({int(c) for c in res.fail_code.tolist() if c != 0})
        print(f"failure codes: {codes}")
        print(f"failing seeds: {failing[:20]}{' ...' if len(failing) > 20 else ''}")
        print(_repro_line(args, failing[0]))
        return 1
    return 0


def cmd_hunt(args) -> int:
    """explore -> shrink -> corpus: every found failing seed becomes a
    durable "open" regression entry with its minimized config."""
    from .engine import audit, corpus, shrink
    from .models import build_machine

    if getattr(args, "guided", False):
        if not args.stream:
            sys.exit("--guided needs --stream (the chunked batch loop "
                     "is where the feedback lives)")
        if not getattr(args, "coverage", False):
            sys.exit("--guided needs --coverage: the bias signal IS the "
                     "live coverage map")
    eng = _build_engine(args)
    failing, infra, abandoned, agg = _find_failing(eng, args, purpose="hunt")
    stream_stats = agg.get("stats", {})
    hunted = agg.get("completed", args.seeds)
    plateau_txt = ""
    if agg.get("plateau"):
        # a plateaued hunt ran FEWER seeds than asked
        plateau_txt = (
            f" [coverage plateau: stopped after batch "
            f"{agg['batches_run']}/{agg['batches_planned']} — "
            f"{max(0, args.seeds - hunted)} budgeted seeds not run]"
        )
    print(
        f"hunted {hunted} seeds: {len(failing)} failing"
        + (f", {abandoned} abandoned (over --max-steps)" if abandoned else "")
        + (
            f", {len(infra)} infra artifacts (queue overflow — rerun "
            f"with a bigger --queue; not recorded as findings)"
            if infra else ""
        )
        + plateau_txt
    )
    _print_fr_stats(stream_stats)
    _print_cov_stats(stream_stats)
    _print_attribution(stream_stats)
    guided_rec = agg.get("guided") or {}
    if guided_rec:
        g = stream_stats.get("guided", {})
        print(
            f"guided: escalation step {g.get('escalation', 0)}, "
            f"{g.get('parents', 0)} corpus parents, "
            f"{g.get('mutants', 0)} mutants over {g.get('batches', 0)} "
            f"batches (trail recorded"
            + (" in checkpoint)" if getattr(args, "checkpoint", None) else ")")
        )
    _write_coverage_out(eng, args, agg)
    entries = corpus.load(args.corpus)
    known = {e.key for e in entries}
    added = 0
    # one representative per distinct fail code (--all-seeds: the first
    # --limit seeds, whatever their codes)
    if getattr(args, "all_seeds", False):
        to_shrink = failing[: args.limit]
    else:
        by_code: dict = {}
        for seed, code in failing:
            by_code.setdefault(code, []).append(seed)
        to_shrink = [(s[0], c) for c, s in sorted(by_code.items())][: args.limit]
        shrinking = {c for _s, c in to_shrink}
        for code, seeds_of in sorted(by_code.items()):
            verb = f"shrinking seed {seeds_of[0]}" if code in shrinking else "beyond --limit, not shrunk"
            print(f"  code {code}: {len(seeds_of)} seeds ({verb})")
    esc_by_seed = {int(k): int(v) for k, v in (guided_rec.get("failing_escalation") or {}).items()}
    for seed, code in to_shrink:
        # a guided find made under an escalated vocabulary reproduces only
        # under that vocabulary: shrink (and the entry's config) start from
        # the escalation step's engine, and kind ablation minimizes it
        shrink_eng = eng
        if esc_by_seed.get(seed):
            from .search.guided import engine_for_escalation

            shrink_eng = engine_for_escalation(eng, esc_by_seed[seed])
        try:
            # the device-harvested provenance word (when the gate rode the
            # hunt) orders the candidates; each is still verified by replay
            sr = shrink(shrink_eng, seed, max_steps=args.max_steps, prov_word=agg.get("provenance", {}).get(seed))
        except ValueError as exc:
            # flagged by the batch but not reproducing in the replay:
            # report it (that drift is itself a finding) and go on
            print(f"  ! seed {seed} code {code}: {exc}")
            continue
        entry = corpus.CorpusEntry(
            machine=args.machine,
            nodes=args.nodes,
            seed=seed,
            fail_code=code,
            status=corpus.STATUS_OPEN,
            config=sr.shrunk,
            max_steps=sr.steps + 1,
            note=sr.summary(),
        )
        if entry.key in known:
            print(f"  = corpus: seed {seed} code {code} already recorded")
            continue
        # every new entry carries its digest trail and environment from birth
        entry, _trail = audit.record_entry(entry, build_machine, device=_device(args))
        known.add(entry.key)
        entries.append(entry)
        added += 1
        print(f"  + corpus: {sr.summary()}")
    if added:
        corpus.save(args.corpus, entries)
    if len(to_shrink) < (len(failing) if getattr(args, "all_seeds", False) else len({c for _s, c in failing})):
        print("  (further failing codes/seeds not shrunk; raise --limit)")
    print(f"{added} new entries in {args.corpus}")
    return 1 if failing else 0


def cmd_regress(args) -> int:
    """Re-verify every corpus entry against its status contract: open
    entries must still reproduce their exact failure; fixed entries must
    keep passing. `--promote` flips open entries that no longer fail."""
    from .engine import corpus
    from .models import build_machine

    entries = corpus.load(args.corpus)
    if not entries:
        print(f"corpus {args.corpus} is empty")
        return 0
    bad = 0
    changed = False
    for i, e in enumerate(entries):
        try:
            out = corpus.check(e, build_machine, device=_device(args))
        except ValueError:
            # an unknown machine name must not end the run: later entries
            # are still checked and --promote updates still saved
            print(f"[FAIL] {e.machine} seed {e.seed}: unknown machine in registry")
            bad += 1
            continue
        tag = "ok " if out.ok else "FAIL"
        print(f"[{tag}] {e.machine} seed {e.seed} code {e.fail_code} ({e.status}): {out.verdict}")
        if not out.ok:
            if args.promote and e.status == corpus.STATUS_OPEN and not out.failed:
                entries[i] = dataclasses.replace(e, status=corpus.STATUS_FIXED)
                changed = True
                print(f"       promoted to {corpus.STATUS_FIXED}")
            else:
                bad += 1
    if changed:
        corpus.save(args.corpus, entries)
        print(f"corpus updated: {args.corpus}")
    print(f"{len(entries) - bad}/{len(entries)} entries satisfied")
    return 1 if bad else 0


def cmd_replay(args) -> int:
    from .engine import replay

    eng = _build_engine(args)
    if getattr(args, "diff_seed", None) is not None:
        # the schedule-fork debugger: the first diverging step of two seeds
        from .engine.replay import replay_diff

        replay_diff(eng, args.seed, args.diff_seed, max_steps=args.max_steps, context=args.diff_context)
        return 0
    rp = replay(eng, args.seed, max_steps=args.max_steps)
    events = rp.trace[-args.tail :] if args.tail else rp.trace
    for ev in events:
        print(ev)
    status = f"FAILED (code {rp.fail_code})" if rp.failed else "ok"
    print(f"seed {args.seed}: {status}, {len(rp.trace)} events, t={int(rp.state.now_us)}us")
    return 1 if rp.failed else 0


def cmd_trace(args) -> int:
    """Replay one seed and export its virtual-time event timeline:
    Perfetto trace_event JSON (--perfetto, with the send -> delivery
    flow arrows) and/or JSONL (--jsonl, one object per event)."""
    from .engine import replay
    from .engine.trace_export import write_jsonl, write_perfetto

    if not args.perfetto and not args.jsonl:
        sys.exit("trace needs at least one of --perfetto PATH / --jsonl PATH")
    eng = _build_engine(args)
    n_nodes = eng.machine.NUM_NODES
    if args.perfetto:
        from .engine.provenance import replay_with_lineage

        rp, lineage = replay_with_lineage(eng, args.seed, max_steps=args.max_steps)
        flows = [(lineage.trace[i], lineage.trace[j]) for i, j in lineage.message_flows()]
        n = write_perfetto(args.perfetto, rp.trace, machine=args.machine, seed=args.seed, num_nodes=n_nodes,
                           flows=flows)
        print(f"wrote {n} events ({len(flows)} message flows) to "
              f"{args.perfetto} (perfetto trace_event; "
              f"open in https://ui.perfetto.dev)")
    else:
        rp = replay(eng, args.seed, max_steps=args.max_steps)
    if args.jsonl:
        n = write_jsonl(args.jsonl, rp.trace, machine=args.machine, seed=args.seed)
        print(f"wrote {n} events to {args.jsonl} (JSONL)")
    status = f"FAILED (code {rp.fail_code})" if rp.failed else "ok"
    print(f"seed {args.seed}: {status}, {len(rp.trace)} events, t={int(rp.state.now_us)}us")
    return 1 if rp.failed else 0


def cmd_why(args) -> int:
    """Answer "why did this seed fail?": replay with causal provenance and
    lineage, decode the violation's provenance word to the implicated
    scheduled faults (kind, virtual time, target), cut the trace to the
    violation's past cone, and render the causal chain as text (stdout,
    --out), JSON (--json) and a Perfetto timeline with the cone's flow
    arrows and the cone highlighted (--perfetto)."""
    from .engine.provenance import implicated, render_why, replay_with_lineage
    from .engine.trace_export import write_perfetto

    args.provenance = True  # the whole point of `why`
    if getattr(args, "seed_pos", None) is not None:
        args.seed = args.seed_pos
    eng = _build_engine(args)
    rp, lineage = replay_with_lineage(eng, args.seed, max_steps=args.max_steps)
    if not rp.failed:
        print(
            f"seed {args.seed} does not fail under this config (within "
            f"{args.max_steps} steps) — nothing to explain; pass the "
            f"repro line's exact flags"
        )
        return 2
    word = rp.fail_prov
    att = implicated(eng, args.seed, word)
    cone = lineage.past_cone(len(lineage.trace) - 1)
    text = render_why(eng, args.seed, rp, lineage, cone, att, max_events=args.tail)
    print(text)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text + "\n")
        print(f"causal chain -> {args.out}")
    if args.json:
        doc = {
            "machine": args.machine,
            "seed": args.seed,
            "fail_code": rp.fail_code,
            "fail_time_us": int(rp.state.now_us),
            "prov_word": word,
            "implicated_kinds": list(att.kinds),
            "implicated_faults": [
                {"index": f.index, "kind": f.kind_name, "t_apply_us": f.t_apply_us, "t_undo_us": f.t_undo_us,
                 "target": f.target}
                for f in att.faults
            ],
            "cone_events": len(cone),
            "trace_events": len(lineage.trace),
        }
        with open(args.json, "w") as f:
            json.dump(doc, f, indent=2)
            f.write("\n")
        print(f"attribution JSON -> {args.json}")
    if args.perfetto:
        cone_idx = set(cone)
        cone_steps = {lineage.trace[i].step for i in cone}
        flows = [(lineage.trace[i], lineage.trace[j]) for i, j in lineage.message_flows() if j in cone_idx]
        n = write_perfetto(args.perfetto, rp.trace, machine=args.machine, seed=args.seed,
                           num_nodes=eng.machine.NUM_NODES, flows=flows, highlight=cone_steps)
        print(
            f"wrote {n} events ({len(flows)} causal flows, cone "
            f"highlighted) to {args.perfetto} (open in "
            f"https://ui.perfetto.dev)"
        )
    return 0


def cmd_audit(args) -> int:
    """Replay every corpus entry and bisect its recorded digest trail to
    the first divergent checkpoint. With --record, record trails and
    environment metadata again instead, refusing entries whose outcome
    no longer matches their status contract."""
    from .engine import audit, corpus
    from .models import build_machine

    entries = corpus.load(args.corpus)
    if not entries:
        print(f"corpus {args.corpus} is empty")
        return 0
    bad = 0
    changed = False
    for i, e in enumerate(entries):
        try:
            if args.record:
                new, trail = audit.record_entry(e, build_machine, every=args.digest_every, device=_device(args))
                if e.status == corpus.STATUS_OPEN:
                    contract_ok = trail.failed and trail.fail_code == e.fail_code
                else:  # STATUS_FIXED must pass
                    contract_ok = not trail.failed
                if not contract_ok:
                    got = f"fails with code {trail.fail_code}" if trail.failed else "passes"
                    print(f"[FAIL] {e.machine} seed {e.seed}: replay {got}, "
                          f"which breaks its {e.status!r} contract — NOT "
                          f"recording (fix or re-hunt the entry first)")
                    bad += 1
                    continue
                entries[i] = new
                changed = True
                print(f"[rec ] {e.machine} seed {e.seed} code {e.fail_code}: "
                      f"{len(new.digests)} checkpoints every {new.digest_every} "
                      f"steps, final step {new.digest_final[0]}")
                continue
            out = audit.audit_entry(e, build_machine, device=_device(args))
        except ValueError:
            print(f"[FAIL] {e.machine} seed {e.seed}: unknown machine in registry")
            bad += 1
            continue
        tag = {"match": "ok  ", "no-digests": "??  ", "diverged": "DIVG"}[out.status]
        print(f"[{tag}] {e.machine} seed {e.seed} code {e.fail_code}: {out.verdict}")
        if not out.ok:
            bad += 1
    if changed:
        corpus.save(args.corpus, entries)
        print(f"corpus updated: {args.corpus}")
    print(f"{len(entries) - bad}/{len(entries)} entries satisfied")
    return 1 if bad else 0


def cmd_shrink(args) -> int:
    from .engine import shrink

    eng = _build_engine(args)
    try:
        sr = shrink(eng, args.seed, max_steps=args.max_steps)
    except ValueError as exc:
        print(exc)
        return 2
    print(sr.summary())
    f = sr.shrunk.faults
    print(
        f"minimal repro: python -m {PROG} replay --machine {args.machine} "
        f"--seed {args.seed} --nodes {args.nodes} "
        f"--horizon {sr.shrunk.horizon_us / 1e6} --queue {sr.shrunk.queue_capacity} "
        f"--faults {f.n_faults} --fault-tmax {f.t_max_us} "
        f"--loss {sr.shrunk.packet_loss_rate} --max-steps {sr.steps} "
        # kinds from the SHRUNK plan: ablation may have dropped some
        f"--fault-kinds {fault_kinds_str(f)} "
        + ("--strict-restart " if f.strict_restart else "")
        + f"--rng-stream {sr.shrunk.rng_stream}"
    )
    return 0


def cmd_check(args) -> int:
    import numpy as np

    from .errors import NonDeterminism

    eng = _build_engine(args)
    seeds = np.arange(args.seed, args.seed + args.seeds, dtype=np.uint32)
    try:
        eng.check_determinism(seeds, max_steps=args.max_steps)
    except NonDeterminism as exc:
        print(f"FAIL: {exc}")
        return 1
    print(f"determinism check passed for {args.seeds} seeds")
    return 0


def _serve_stats(args) -> int:
    """`serve --service stats`: a small HTTP endpoint over the
    StatsEmitter's files — GET /stats returns the latest run snapshot
    (BASE.json), GET /metrics the Prometheus textfile (BASE.prom), GET
    /healthz "ok" — so dashboards poll an endpoint instead of parsing
    logs. Plain stdlib http.server; read-only; builds no engine."""
    import http.server

    base = args.stats or os.environ.get("MADSIM_TPU_STATS") or "madsim_stats"
    routes = {
        "/stats": (base + ".json", "application/json"),
        "/metrics": (base + ".prom", "text/plain; version=0.0.4"),
    }

    class Handler(http.server.BaseHTTPRequestHandler):
        def do_GET(self):  # noqa: N802 (stdlib API name)
            path = self.path.split("?", 1)[0].rstrip("/") or "/stats"
            if path == "/healthz":
                body, ctype = b"ok\n", "text/plain"
            elif path in routes:
                fname, ctype = routes[path]
                try:
                    with open(fname, "rb") as f:
                        body = f.read()
                except OSError:
                    self.send_error(404, f"no stats recorded yet ({fname} missing)")
                    return
            else:
                self.send_error(404, "routes: /stats /metrics /healthz")
                return
            self.send_response(200)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, fmt, *a):  # route access logs to logging
            logging.getLogger("madsim_tpu.serve").debug(fmt, *a)

    # --port-file writes the realized port atomically, so a supervisor
    # discovers a host:0 bind without racing stdout; SIGTERM closes the
    # server as Ctrl-C does
    from .fleet import httpd

    srv, host, port = httpd.bind(args.addr, Handler)
    print(f"stats serving on {host}:{port} (GET /stats /metrics /healthz; files {base}.json/.prom)", flush=True)
    return httpd.run_http_server(srv, port_file=args.port_file)


def cmd_lint(args) -> int:
    """Static determinism & contract analysis of the port
    (madsim_tpu_torch/analysis/). Runs torch-free except the C-rule
    import half (--no-import-check disables it)."""
    from .analysis.cli import main as lint_main

    return lint_main(args)


def cmd_serve(args) -> int:
    """Run a host service's server over real TCP (production mode):
    apps written against the `services.*` clients connect unmodified.
    `--grpc` (etcd), `--http` (s3) and `--wire` (kafka) serve the
    genuine wire protocol instead of the sim protocol. Builds no engine
    and needs no card.

    SECURITY: the sim protocol's wire format is pickle, which can
    execute code on load: bind only on trusted networks / localhost."""
    if args.service == "stats":
        # observability endpoint over StatsEmitter files: no sim
        # networking involved, so no real-mode requirement
        return _serve_stats(args)
    from . import dual

    if dual.MODE != "real":
        sys.exit(
            "serve needs production networking: re-run as\n"
            f"  MADSIM_TPU_MODE=real python -m {PROG} serve "
            f"--service {args.service} --addr {args.addr}"
        )
    import asyncio

    async def run_server() -> None:
        if args.grpc:
            if args.service != "etcd":
                sys.exit("--grpc is only available for --service etcd")
            from .services.etcd.real_gateway import EtcdGrpcGateway

            gw = EtcdGrpcGateway()
            port = await gw.start(args.addr)
            host = args.addr.rsplit(":", 1)[0]
            print(f"etcd serving on {host}:{port} (genuine gRPC wire)", flush=True)
            await gw.wait()
            return
        if args.http:
            if args.service != "s3":
                sys.exit("--http is only available for --service s3")
            from .services.s3.real_gateway import S3HttpGateway

            gw = S3HttpGateway()
            port = await gw.start(args.addr)
            host = args.addr.rsplit(":", 1)[0]
            print(f"s3 serving on {host}:{port} (genuine S3 REST wire)", flush=True)
            await gw.wait()
            return
        if args.wire:
            if args.service != "kafka":
                sys.exit("--wire is only available for --service kafka")
            from .services.kafka.wire_gateway import KafkaWireGateway

            host = args.addr.rsplit(":", 1)[0]
            # Metadata/FindCoordinator responses must name an address
            # clients can CONNECT to, which a 0.0.0.0 bind is not (real
            # brokers split listeners from advertised.listeners too)
            advertise = args.advertise or (host if host and host != "0.0.0.0" else "127.0.0.1")
            gw = KafkaWireGateway(advertised_host=advertise)
            port = await gw.start(args.addr)
            gw.advertised_port = port
            print(
                f"kafka serving on {host or '127.0.0.1'}:{port} "
                f"(genuine Kafka wire, advertising {advertise}:{port})",
                flush=True,
            )
            await gw.wait()
            return
        if args.service == "etcd":
            from .services.etcd import SimServer

            server = SimServer()
        elif args.service == "kafka":
            from .services.kafka import SimBroker

            server = SimBroker()
        else:
            from .services.s3 import SimServer as S3Server

            server = S3Server()

        def on_bound(ep) -> None:
            # the ready line prints the ACTUAL bound address (supports
            # --addr host:0) and only after the socket exists
            host, port = ep.local_addr
            print(f"{args.service} serving on {host}:{port} (real TCP)", flush=True)

        await server.serve(args.addr, on_bound=on_bound)

    try:
        asyncio.run(run_server())
    except KeyboardInterrupt:
        pass
    return 0


def cmd_coverage(args) -> int:
    """Render a persisted coverage map (`hunt --coverage-out`): slots
    hit, per-band marginals, the thinnest (band x phase) cells and, with
    --diff, what a second run added over the first; `--json` gives the
    same tables machine-readably. Host-side numpy only: no engine."""
    from .runtime.coverage import load_coverage_doc, render_report

    try:
        doc = load_coverage_doc(args.doc)
        diff_doc = load_coverage_doc(args.diff) if args.diff else None
    except (OSError, ValueError, KeyError) as exc:
        sys.exit(f"coverage: {exc}")
    if getattr(args, "json", False):
        from .runtime.coverage import coverage_dict, diff_maps, doc_band_bits, doc_maps, top_uncovered

        slots_log2 = doc["slots_log2"]
        bb = doc_band_bits(doc)
        other = doc_maps(diff_doc) if diff_doc is not None else {}
        out = {"slots_log2": slots_log2, "band_bits": bb, "maps": {}}
        for name, m in doc_maps(doc).items():
            entry = {
                **coverage_dict(m, slots_log2, band_bits=bb),
                "thinnest": top_uncovered(m, slots_log2, top=args.top, band_bits=bb),
            }
            if name in other:
                dd = diff_maps(other[name], m)
                entry["diff"] = {"new": dd["only_b"], "lost": dd["only_a"], "shared": dd["both"]}
            out["maps"][name] = entry
        print(json.dumps(out, indent=1, sort_keys=True))
        return 0
    print(render_report(doc, top=args.top, diff_doc=diff_doc))
    return 0


def cmd_perf(args) -> int:
    """Host wall-clock observatory: run a streaming workload with the
    PerfRecorder active (main() sets `args.perf_timeline = args.out`
    before the command runs) and report what the wall clock went to:
    the first run of each stream function, blocked on the card
    (counters_poll / ring_drain / harvest), or the host launching kernels
    and running Python between them. The Perfetto timeline and verdict
    print through the shared --perf-timeline epilogue."""
    eng = _build_engine(args)
    agg = _stream_batches(eng, args, purpose="perf")
    st = agg["stats"]
    el = agg["elapsed_s"]
    print(
        f"streamed {agg['completed']} seeds in {el:.1f}s "
        f"({agg['completed'] / max(el, 1e-9):.0f} seeds/s), "
        f"{len(agg['failing'])} failing"
    )
    print(
        f"executor: {st['device_segments']} segments, "
        f"{st['host_syncs']} host syncs, {st['drains']} drains "
        f"(pipelined={st['pipelined']}, donation={st['donation']})"
    )
    if "device_memory" in st:
        mem = st["device_memory"]
        print("device memory: " + ", ".join(f"{k}={v}" for k, v in sorted(mem.items())))
    return 0


def cmd_prof(args) -> int:
    """The three-clock profiler (`perf/xprof.py`): stream a hunt batch
    with MADSIM_TPU_XPROF on (device-phase ranges, clock-sync markers at
    dispatch and poll boundaries, a torch.profiler capture of the card)
    and, with --merge, align host wall-clock spans, the device capture
    and a failing lane's virtual-time trace into ONE Perfetto session.
    (`prof compile` is refused before this runs.)"""
    import tempfile

    from .perf import xprof
    from .perf.recorder import PerfRecorder

    # the gate must be on before the engine runs a segment
    os.environ[xprof.ENV_GATE] = "1"
    eng = _build_engine(args)
    logdir = args.profile_dir or tempfile.mkdtemp(prefix="madsim-xprof-")
    rec = PerfRecorder(meta={
        "cmd": "prof", "machine": args.machine, "seeds": args.seeds,
        "batch": args.batch,
    })
    # recorder INSIDE the capture: the profiler's stop and export stay
    # off the hunt's wall clock, so the attribution fraction measures
    # the hunt, not the profiler
    with _streaming(args) as stream, xprof.device_trace(logdir, cuda=eng.device.type == "cuda"):
        with rec:
            out = stream(
                eng, args.seeds, batch=args.batch, seed_start=args.seed,
                max_steps=args.max_steps,
            )
    wall_s = rec.wall_us / 1e6
    print(
        f"streamed {out['completed']} seeds in {wall_s:.1f}s "
        f"({out['completed'] / max(wall_s, 1e-9):.0f} seeds/s), "
        f"{len(out['failing'])} failing"
    )
    artifact = xprof.find_device_trace(logdir)
    dev = xprof.load_device_events(artifact) if artifact else []
    if dev:
        print(f"device profile: {len(dev)} events ({artifact})")
    else:
        print("device profile: no artifact (backend without profiler export)")

    if not args.merge:
        n = rec.write(args.out)
        print(
            f"host timeline: {n} spans -> {args.out} "
            f"(pass --merge for the three-clock plane)"
        )
        print(f"host verdict: {rec.verdict()}")
        return 0

    # virtual-time track: the failing lane when the hunt surfaced one,
    # else the batch's first seed; timestamps stay in VIRTUAL us
    vseed = args.trace_seed
    if vseed is None:
        vseed = out["failing"][0][0] if out["failing"] else args.seed
    from .engine import replay
    from .engine.trace_export import trace_event_dict

    rp = replay(eng, int(vseed), max_steps=args.max_steps)
    vdoc = trace_event_dict(
        rp.trace, machine=args.machine, seed=int(vseed),
        num_nodes=eng.machine.NUM_NODES,
    )
    doc = xprof.merge_plane(
        rec.chrome_trace(), dev, vdoc,
        meta={"machine": args.machine, "virtual_seed": int(vseed)},
    )
    n = xprof.write_doc(doc, args.out)
    s = doc["madsim_xprof_summary"]
    print(json.dumps({"metric": "prof_merge", **s}))
    tracks = "+".join(k for k, v in s["tracks"].items() if v)
    print(
        f"merged plane: {n} events ({tracks}), "
        f"{100 * s['attribution']:.0f}% of {s['host_wall_us'] / 1e6:.1f}s "
        f"wall attributed across {s['sync_points']} sync points "
        f"-> {args.out} (open in https://ui.perfetto.dev)"
    )
    return 0


_AB_GATES = ("flight_recorder", "coverage", "provenance", "clog-packed",
             "rng-stream", "coverage-unbuffered", "pallas-megakernel")


def cmd_bench_ab(args) -> int:
    """Interleaved A/B cost of ONE engine gate: ABAB... alternating reps
    in one process over identical seed ranges, median of PAIRED deltas
    with a seeded-bootstrap 95% CI and an exact sign test
    (`perf/ab.py`). Both engines run on the command's device and are
    warmed (one run plus one untimed rep) first. Prints one JSON line
    and a summary."""
    from .engine import Engine
    from .perf.ab import interleaved_ab
    from .perf.recorder import current_recorder

    eng = _build_engine(args)
    base = eng.config
    if args.gate == "rng-stream":
        cfg_a = dataclasses.replace(base, rng_stream=3)
        cfg_b = dataclasses.replace(base, rng_stream=2)
        label_a, label_b = "rng_stream=3", "rng_stream=2"
    elif args.gate == "coverage-unbuffered":
        # the buffered fold (the cov_buffer default) against the
        # per-event fold (cov_buffer=0), coverage on in both: the maps
        # are equal, so the delta is the fold's mechanics
        cfg_a = dataclasses.replace(base, coverage=True)
        cfg_b = dataclasses.replace(base, coverage=True, cov_buffer=0)
        label_a, label_b = "cov_buffer=on", "cov_buffer=0"
    elif args.gate == "pallas-megakernel":
        # the step-prefix kernel against its plain PyTorch twin, both on
        # the v3 stream the kernel serves
        cfg_a = dataclasses.replace(base, rng_stream=3, pallas_megakernel=True)
        cfg_b = dataclasses.replace(base, rng_stream=3, pallas_megakernel=False)
        label_a, label_b = "pallas_megakernel=on", "pallas_megakernel=off"
    else:
        field = args.gate.replace("-", "_")
        cfg_a = dataclasses.replace(base, **{field: True})
        cfg_b = dataclasses.replace(base, **{field: False})
        label_a, label_b = f"{field}=on", f"{field}=off"
    lanes = args.lanes or 1024
    n_rep = args.seeds or 2 * lanes
    runs = {}
    with _streaming(args) as stream:
        for tag, cfg in (("a", cfg_a), ("b", cfg_b)):
            run = functools.partial(stream, Engine(eng.machine, cfg, device=eng.device),
                                    batch=lanes, segment_steps=384, max_steps=args.max_steps)
            # the first run and one full untimed rep: the harness measures
            # steady state, never the first run or a cold first rep
            run(1)
            run(n_rep, seed_start=500_000)
            runs[tag] = run

        res = interleaved_ab(
            lambda s: runs["a"](n_rep, seed_start=s)["completed"],
            lambda s: runs["b"](n_rep, seed_start=s)["completed"],
            pairs=args.reps,
            seed_start=args.seed,
            seeds_per_rep=4 * n_rep,
            label_a=label_a,
            label_b=label_b,
            recorder=current_recorder(),
        )
    print(json.dumps({
        "metric": f"{args.gate}_ab_delta_pct",
        "gate": args.gate,
        "machine": args.machine,
        "platform": eng.device.type,
        "lanes": lanes,
        "seeds_per_rep": n_rep,
        **res.to_dict(),
    }))
    print(res.summary())
    return 0


def _cmd_bench_report(args) -> int:
    """`bench report`: render the port's bench history trend, read where
    the bench forms write it. It builds no engine and imports no torch,
    so it runs where there is no card."""
    from .perf import flagship, history

    print(history.render_report(history.load(flagship.history_path(args.history))))
    return 0


def cmd_bench(args) -> int:
    """`bench`: with no --machine the flagship (`perf/flagship.py`, the
    port of the repo-root bench.py); with `--machine NAME` a streaming
    throughput bench of any registered machine under the usual engine
    flags: `run(64)` and one untimed rep, then `--reps` timed reps of
    max(--seeds, lanes) seeds, the median rate in one JSON line with the
    reference's keys and the card's name and power limit (`card`). Both
    run the flagship's timed protocol (`flagship.capture`): each appends
    a row to the history (--history, else $MADSIM_TPU_BENCH_HISTORY, else
    TORCH_BENCH_HISTORY.jsonl here) and checks the budget against its
    newest comparable row."""
    if getattr(args, "action", None) == "report":
        return _cmd_bench_report(args)
    if args.lanes < 0 or args.reps < 1 or args.seeds < 1:
        sys.exit("bench needs --lanes >= 1 (or 0 = default), --reps >= 1, --seeds >= 1")
    from .perf import flagship

    if not getattr(args, "machine", None):
        # the reference's mapping, kept as it is: the default --reps 3
        # passes no reps, so the flagship runs its own default of 5
        return flagship.run(args.lanes or flagship.DEFAULT_LANES,
                            args.reps if args.reps != 3 else flagship.DEFAULT_REPS,
                            device=_device(args), history_file=args.history)

    import time as wall

    from .perf import history

    eng = _build_engine(args)
    lanes = args.lanes or flagship.DEFAULT_LANES
    n = max(args.seeds, lanes)
    fingerprint = history.env_fingerprint(
        backend_platform=eng.device.type, lanes=lanes, reps=args.reps, segment_steps=flagship.SEGMENT_STEPS,
        gates=flagship.gates_of(eng), device_count=_device_count(args), machine=args.machine)
    with _streaming(args) as stream:
        run = functools.partial(stream, eng, batch=lanes, segment_steps=flagship.SEGMENT_STEPS,
                                max_steps=args.max_steps)
        t0 = wall.perf_counter()
        run(64)
        first_s = wall.perf_counter() - t0
        run(n, seed_start=500_000)
        cap = flagship.capture(eng, run, n=n, reps=args.reps, seed_start=args.seed, stride=4 * n,
                               fingerprint=fingerprint, history_file=args.history, source="bench --machine",
                               compile_s=first_s)
    st = cap["outs"][-1]["stats"]
    print(json.dumps({
        "metric": f"{args.machine}_seeds_per_sec",
        **cap["fields"],
        "diagnostics": {
            "reps": [round(x, 1) for x in cap["rates"]],
            "failing_total": sum(len(out["failing"]) + len(out["infra"]) for out in cap["outs"]),
            "lanes": lanes,
            "queue_capacity": args.queue,
            "fault_kinds": getattr(args, "fault_kinds", "pair,kill"),
            **{k: st[k] for k in ("host_syncs", "device_segments", "dispatch_depth", "segments_per_dispatch",
                                  "donation", "pipelined")},
        },
    }))
    return 1 if cap["violated"] else 0


def _format_fleet_event(ev: dict, t0: float) -> str:
    """One `fleet watch` line per event: relative seconds (wall deltas
    between recorded timestamps — no clock is read here), the event
    type, and the payload fields that aren't already in the prefix."""
    ts = float(ev.get("ts") or t0)
    skip = {"seq", "ts", "type", "job"}
    detail = " ".join(
        f"{k}={ev[k]}" for k in sorted(ev) if k not in skip
        and ev[k] is not None
    )
    return f"+{ts - t0:9.2f}s  {ev.get('type', '?'):<16} {detail}".rstrip()


def _fleet_watch(client, addr: str, args) -> int:
    """`fleet watch JOB`: tail the job's SSE event stream and print one
    line per event, exiting 0 once the stream's `end` frame reports a
    terminal state. Push, not poll — the server parks between events."""
    t0 = None
    for frame in client.iter_events(addr, args.job, since=args.since):
        data = frame.get("data")
        if frame.get("event") == "end":
            state = (data or {}).get("state") if isinstance(data, dict) else "?"
            print(f"-- job {args.job} reached terminal state "
                  f"{state!r} --")
            return 0
        if not isinstance(data, dict):
            continue
        if t0 is None:
            t0 = float(data.get("ts") or 0.0)
        print(_format_fleet_event(data, t0), flush=True)
    # stream generator returned without an end frame (server gone mid-
    # tail after retries) — surface it
    print(f"fleet watch: stream for {args.job} closed before a "
          f"terminal state", file=sys.stderr)
    return 1


def _fleet_timeline(client, addr: str, args, retries: int) -> int:
    """`fleet timeline JOB`: fetch the merged control-plane + worker
    Perfetto timeline and write it next to the invoker."""
    doc = client.timeline(addr, args.job, retries=retries)
    out_path = args.out or f"{args.job}.timeline.perfetto.json"
    with open(out_path, "w") as f:
        json.dump(doc, f, indent=1, sort_keys=True)
    summary = doc.get("madsim_fleet_timeline_summary", {})
    n_ev = len(doc.get("traceEvents", []))
    frac = float(summary.get("attribution") or 0.0)
    print(f"timeline: {n_ev} trace events "
          f"({summary.get('events', 0)} lifecycle events, "
          f"{summary.get('worker_spans', 0)} worker spans), "
          f"{frac * 100.0:.0f}% of job wall clock attributed "
          f"-> {out_path} (open in https://ui.perfetto.dev)")
    return 0


def _fleet_profile(client, addr: str, args, retries: int) -> int:
    """`fleet profile JOB`: fetch the three-clock merge — the
    timeline's host plane joined with the worker's device-profile
    capture and failing-lane virtual trace (whichever the store has;
    the worker records them when run under MADSIM_TPU_XPROF=1)."""
    doc = client.profile(addr, args.job, retries=retries)
    out_path = args.out or f"{args.job}.profile.perfetto.json"
    with open(out_path, "w") as f:
        json.dump(doc, f, indent=1, sort_keys=True)
    summary = doc.get("madsim_xprof_summary", {})
    tracks = summary.get("tracks", {})
    present = ", ".join(k for k in ("host", "device", "virtual")
                        if tracks.get(k)) or "none"
    print(f"profile: {len(doc.get('traceEvents', []))} trace events, "
          f"tracks present: {present}, "
          f"{summary.get('sync_points', 0)} sync points, "
          f"{float(summary.get('attribution') or 0.0) * 100.0:.0f}% "
          f"attributed -> {out_path} (open in https://ui.perfetto.dev)")
    if not (tracks.get("device") or tracks.get("virtual")):
        print("hint: run the worker with MADSIM_TPU_XPROF=1 to record "
              "the device profile and the failing lane's virtual trace")
    return 0


def _fleet_top_render(doc: dict) -> str:
    """One screenful of farm state from a /queue document. Pure
    formatting — torch-free, storeless, testable."""
    counts = doc.get("counts", {})
    head = "fleet top — " + " ".join(
        f"{k}:{counts[k]}" for k in sorted(counts) if counts[k]
    ) if counts else "fleet top — queue empty"
    if doc.get("degraded"):
        head += "  [DEGRADED: index-served while load-shedding]"
    cols = (f"{'JOB':<14} {'STATE':<11} {'MACHINE':<18} {'BATCH':>7} "
            f"{'FAIL':>4} {'SLOTS':>6} {'RUNG':>4} {'MOM':>3} "
            f"{'WORKER':<10} LAST EVENT")
    jobs = doc.get("jobs", [])
    lines = [head]
    farm = doc.get("farm")
    if farm:
        # the contention plane: shed state, index honesty, and each
        # worker's lost claim races / refused zombie writes
        bits = [f"shed:{'YES' if farm.get('shed') else 'no'}"]
        if farm.get("queue_log_lag") is not None:
            bits.append(f"lag:{farm['queue_log_lag']}")
        for wid, ws in sorted((farm.get("workers") or {}).items()):
            bits.append(
                f"{wid}[units:{ws.get('units_done', 0)} "
                f"conflicts:{ws.get('claim_conflicts', 0)} "
                f"fenced:{ws.get('fenced_writes', 0)}]"
            )
        lines.append("farm — " + " ".join(bits))
    lines += [cols] if jobs else []
    for s in jobs:
        mom = s.get("momentum") or {}
        last = s.get("last_event") or {}
        planned = s.get("batches_planned")
        batch = (f"{s.get('batches_run', 0)}/{planned}" if planned
                 else str(s.get("batches_run", 0)))
        lines.append(
            f"{s.get('id', '?'):<14} {s.get('state', '?'):<11} "
            f"{str(s.get('machine', '?'))[:18]:<18} "
            f"{batch:>7} "
            f"{s.get('failing') or 0:>4} "
            f"{s.get('coverage_slots') or 0:>6} "
            f"{s.get('escalation') or 0:>4} "
            f"{'*' if mom.get('active') else '.':>3} "
            f"{str(s.get('worker') or '-')[:10]:<10} "
            f"{last.get('type', '-')}"
        )
    return "\n".join(lines)


def _fleet_top(client, addr: str, args, retries: int) -> int:
    """`fleet top`: a one-screen live farm view rendered purely from
    /queue (momentum and last-event are attached server-side, so this
    verb needs no store access and stays torch-free). `--once` prints a
    single frame for scripts/CI; otherwise redraws every --interval."""
    import time as wall

    while True:
        print(_fleet_top_render(client.queue(addr, retries=retries)),
              flush=True)
        if args.once:
            return 0
        wall.sleep(max(0.2, args.interval))
        print()


def cmd_fleet(args) -> int:
    """The hunt-farm service (`fleet/`): a durable job store + queue, a
    lease-based worker that slices jobs into checkpointed batch units,
    and a torch-free HTTP control plane + client verbs. Only `fleet
    worker` with the real driver builds engines (on the card, or the
    CPU with `--device cpu`); serve/submit/status/result/cancel/queue/
    watch/timeline/profile/top/fsck and a synthetic-driver worker run
    on boxes with no card."""
    sub = args.fleet_cmd
    if sub == "serve":
        from .fleet import api

        return api.serve(args.root, args.addr, port_file=args.port_file,
                         sweep_interval_s=args.sweep_interval)
    if sub == "worker":
        from .fleet.worker import FleetWorker

        driver = None
        if args.driver == "synthetic":
            from .fleet.chaos import synthetic_driver as driver
        worker = FleetWorker(
            args.root,
            worker_id=args.worker_id or f"w{os.getpid()}",
            lease_ttl_s=args.lease_ttl,
            poll_s=args.poll,
            max_attempts=args.max_attempts,
            backoff_base_s=args.backoff_base,
            driver=driver,
            reclaim=not args.no_reclaim,
            device=args.device,
        )
        return worker.run(drain=args.drain, max_units=args.max_units)
    if sub == "fsck":
        from .fleet import fsck as fsck_mod

        rep = fsck_mod.fsck(
            args.root,
            fix=not args.dry_run,
            reclaim=args.reclaim,
            release_quarantined=args.release_quarantined,
        )
        if args.json:
            print(json.dumps(rep, indent=1, sort_keys=True))
        else:
            print(fsck_mod.render(rep))
        # lint-style exit: 0 clean, 1 when corruption was found (even
        # if a fixing run just quarantined it — the operator should
        # look at the .corrupt files)
        return 1 if rep["corrupt"] else 0
    if sub == "chaos":
        from .fleet import chaos as chaos_mod

        failures = []
        for chaos_seed in range(args.seed, args.seed + max(1, args.sweep)):
            res = chaos_mod.run_chaos(
                chaos_seed,
                profile=args.profile,
                out_dir=args.out,
                real=args.real,
                rounds=args.rounds or None,
                jobs=args.jobs or None,
                keep=args.keep,
                workers=getattr(args, "workers", 1),
                device=args.device,
            )
            if not res["ok"]:
                failures.append(res)
        if failures:
            for res in failures:
                print(f"chaos seed {res['seed']}: "
                      f"{len(res['violations'])} violation(s)")
            return 1
        n = max(1, args.sweep)
        print(f"fleet chaos: {n} seed(s) ok "
              f"(profile {args.profile}, first seed {args.seed})")
        return 0
    from .fleet import client

    try:
        addr = client.resolve_addr(args.addr, getattr(args, "port_file", None))
        retries = 0 if getattr(args, "no_retry", False) else client.DEFAULT_RETRIES
        if sub == "submit":
            from .fleet.store import SPEC_FIELDS

            spec = {k: getattr(args, k) for k in SPEC_FIELDS}
            out = client.submit(
                addr, spec, priority=args.priority,
                deadline_s=args.deadline,
                tenant=getattr(args, "tenant", None), retries=retries,
            )
            # stdout is exactly the job id — script-composable
            # (`JOB=$(python -m madsim_tpu_torch fleet submit ...)`)
            print(out["id"])
            return 0
        if sub == "status":
            print(json.dumps(
                client.status(addr, args.job, feed=args.feed,
                              wait=getattr(args, "wait", 0) or 0,
                              retries=retries),
                indent=1, sort_keys=True))
            return 0
        if sub == "result":
            doc = client.result(addr, args.job, retries=retries)
            print(json.dumps(doc, indent=1, sort_keys=True))
            return 0 if doc.get("state") != "failed" else 1
        if sub == "cancel":
            print(json.dumps(client.cancel(addr, args.job, retries=retries),
                             indent=1, sort_keys=True))
            return 0
        if sub == "queue":
            print(json.dumps(client.queue(addr, retries=retries),
                             indent=1, sort_keys=True))
            return 0
        if sub == "watch":
            return _fleet_watch(client, addr, args)
        if sub == "timeline":
            return _fleet_timeline(client, addr, args, retries)
        if sub == "profile":
            return _fleet_profile(client, addr, args, retries)
        if sub == "top":
            return _fleet_top(client, addr, args, retries)
        raise AssertionError(f"unhandled fleet verb {sub!r}")
    except (client.FleetClientError, RuntimeError, OSError) as exc:
        print(f"fleet {sub}: {exc}", file=sys.stderr)
        return 1


def _parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog=PROG)
    sub = parser.add_subparsers(dest="cmd", required=True)

    def obs_flags(p):
        p.add_argument("--log-level", default=os.environ.get("MADSIM_TPU_LOG"),
                       help="wire init_tracing at this level (DEBUG/INFO/...; also $MADSIM_TPU_LOG)")
        p.add_argument("--log-jsonl", default=None, metavar="PATH",
                       help="also sink logs as structured JSONL to PATH")

    def device_flag(p):
        p.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                       help="where the engines run: the CUDA card (default) or the CPU; "
                       "without a card the command exits, it never falls back")

    def common(p):
        obs_flags(p)
        device_flag(p)
        p.add_argument("--machine", default="raft")
        p.add_argument("--nodes", type=int, default=0)
        p.add_argument("--seed", type=int, default=0)
        p.add_argument("--horizon", type=float, default=5.0, help="virtual seconds")
        p.add_argument("--queue", type=int, default=96)
        p.add_argument("--faults", type=int, default=2)
        p.add_argument("--loss", type=float, default=0.0)
        p.add_argument("--max-steps", type=int, default=3000)
        p.add_argument("--fault-tmax", type=int, default=0,
                       help="fault injection window in us (0 = 60%% of horizon)")
        p.add_argument("--fault-kinds", default="pair,kill",
                       help="comma list of fault kinds to draw from: "
                       "pair,kill,dir,group,storm,delay,pause,skew,dup,torn,heal-asym "
                       "(default pair,kill; any other kind switches to the v2 schedule "
                       "derivation; dup is per-delivery duplication, not a scheduled window)")
        p.add_argument("--strict-restart", action="store_true",
                       help="crash-with-amnesia restarts: a restarted node keeps only the "
                       "leaves its Machine.durable_spec() marks durable")
        p.add_argument("--rng-stream", type=int, default=2, choices=(2, 3),
                       help="per-step RNG stream version: 2 = split-chain (default; replays "
                       "every recorded seed), 3 = counter-based (the step megakernel's)")
        p.add_argument("--compile-cache", default=None,
                       help="not ported: the JAX package's persistent compile cache")
        p.add_argument("--flight-recorder", action="store_true",
                       help="engine flight recorder: rolling per-lane trace digests, checkpoint "
                       "ring and on-device fault/queue metrics (results are equal either way)")
        p.add_argument("--coverage", action="store_true",
                       help="scenario-coverage telemetry: per-lane hit maps OR-reduced at stream "
                       "harvest (results are equal either way)")
        p.add_argument("--cov-buffer", type=int, default=None, metavar="N",
                       help="coverage slot-buffer depth per lane (default: the engine's; 0 = the "
                       "unbuffered per-event fold; the maps are equal either way)")
        p.add_argument("--provenance", action="store_true",
                       help="causal provenance: every queued event and node carries a 32-bit lineage word "
                       "(one bit per scheduled fault, ORed along deliveries); failures decode to the "
                       "implicated faults in hunt reports, shrink uses attribution to order its "
                       "candidates, and `why` renders the causal chain (results are equal either way)")
        p.add_argument("--stats", default=None, metavar="BASE",
                       help="StatsEmitter base path (also $MADSIM_TPU_STATS): per-batch stats to "
                       "BASE.jsonl, BASE.prom and BASE.json")

    def stream_flags(p):
        p.add_argument("--no-pipeline", action="store_true",
                       help="the per-segment driver (one blocking host sync a segment) instead "
                       "of the pipelined executor")
        p.add_argument("--segments-per-dispatch", type=int, default=8,
                       help="segments issued a dispatch")
        p.add_argument("--dispatch-depth", type=int, default=4,
                       help="dispatches between blocking counter polls")
        p.add_argument("--no-donate", action="store_true",
                       help="report the carry as not donated (in PyTorch one carry is alive at "
                       "a time either way; results are equal)")
        p.add_argument("--devices", type=int, default=0, metavar="N",
                       help="shard each stream's lanes over N ranks, one process per card (on the CPU with "
                       "--device cpu: N ranks over gloo); this process is rank 0 and starts the others. "
                       "Results are equal at any N; batch must be a multiple of N. 0 = unsharded")
        p.add_argument("--stop-on-plateau", type=int, default=0, metavar="N",
                       help="with --coverage: stop when N consecutive seed batches add no new slot")
        p.add_argument("--stop-after-batches", type=int, default=0, metavar="N",
                       help="stop after N seed batches (resumable via --checkpoint)")
        p.add_argument("--perf-timeline", default=None, metavar="PATH",
                       help="record the HOST wall-clock timeline of this run (compile / dispatch / "
                       "counters_poll / ring_drain / harvest / checkpoint / stats spans and the gaps between "
                       "them) as Chrome/Perfetto trace_event JSON at PATH, with a verdict (compile- vs device- "
                       "vs dispatch-gap-bound) printed after the run")
        p.add_argument("--xla-profile", default=None, metavar="DIR",
                       help="also capture the card with torch.profiler into DIR, the stream's device phases "
                       "named (the reference's spelling; heavier than --perf-timeline)")

    p = sub.add_parser("explore", help="run a seed batch, report failing seeds")
    common(p)
    p.add_argument("--seeds", type=int, default=1024)
    p.add_argument("--stream", action="store_true",
                   help="seed-streaming path (refill finished lanes; for large batches)")
    p.add_argument("--batch", type=int, default=8192, help="lanes per streaming batch")
    stream_flags(p)
    p.add_argument("--multihost", action="store_true",
                   help="shard the batch over a torch.distributed job of processes started from the "
                   "MADSIM_TPU_COORDINATOR / NUM_PROCS / PROC_ID env (one per card, or on the CPU over "
                   "gloo with --device cpu); only process 0 prints")
    p.set_defaults(fn=cmd_explore)

    p = sub.add_parser("replay", help="bit-identical replay of one seed with trace")
    common(p)
    p.add_argument("--tail", type=int, default=30, help="print last N events (0=all)")
    p.add_argument("--devices", type=int, default=0,
                   help="accepted for repro-line fidelity (hunts record the ranks they ran at); replay is "
                   "single-lane and equal at any rank count, so the value is recorded but unused")
    p.add_argument("--diff-seed", type=int, default=None,
                   help="also replay this seed and print where the two schedules first diverge")
    p.add_argument("--diff-context", type=int, default=3, help="events of context around the divergence")
    p.set_defaults(fn=cmd_replay)

    p = sub.add_parser("trace", help="replay one seed and export its virtual-time event timeline "
                       "(Perfetto trace_event JSON / structured JSONL)")
    common(p)
    p.add_argument("--perfetto", default=None, metavar="PATH",
                   help="write Chrome/Perfetto trace_event JSON with message flow arrows")
    p.add_argument("--jsonl", default=None, metavar="PATH", help="write one JSON object per event")
    p.set_defaults(fn=cmd_trace)

    p = sub.add_parser("shrink", help="minimize a failing seed's config")
    common(p)
    p.set_defaults(fn=cmd_shrink)

    p = sub.add_parser("why", help="explain a failing seed: replay with causal provenance, name the implicated "
                       "faults (kind, time, target), and render the violation's past cone as text / JSON / "
                       "Perfetto flows")
    common(p)
    p.add_argument("seed_pos", nargs="?", type=int, default=None, metavar="SEED",
                   help="the failing seed (as --seed; pass the repro line's other flags so the schedule matches)")
    p.add_argument("--tail", type=int, default=30, help="cone events to print (0 = the whole cone)")
    p.add_argument("--out", default=None, metavar="PATH", help="also write the rendered causal chain to PATH")
    p.add_argument("--json", default=None, metavar="PATH",
                   help="write the attribution as JSON (implicated kinds and faults, word, cone size)")
    p.add_argument("--perfetto", default=None, metavar="PATH",
                   help="write the timeline with causal flow arrows and the past cone highlighted")
    p.set_defaults(fn=cmd_why)

    p = sub.add_parser("hunt", help="explore + shrink + record failing seeds in the corpus")
    common(p)
    p.add_argument("--seeds", type=int, default=1024)
    p.add_argument("--stream", action="store_true", help="seed-streaming hunt")
    p.add_argument("--batch", type=int, default=8192, help="lanes per streaming batch")
    stream_flags(p)
    p.add_argument("--corpus", default="corpus.json")
    p.add_argument("--limit", type=int, default=5, help="max seeds to shrink+record")
    p.add_argument("--checkpoint", default=None, metavar="PATH",
                   help="with --stream: persist per-batch progress to PATH after every batch; "
                   "a re-run with the same arguments resumes where it stopped")
    p.add_argument("--coverage-out", default=None, metavar="PATH",
                   help="with --coverage --stream: persist the hunt's cumulative coverage map")
    p.add_argument("--all-seeds", action="store_true",
                   help="shrink the first --limit failing seeds even when they share a fail code")
    p.add_argument("--guided", action="store_true",
                   help="coverage-feedback search (needs --stream --coverage): every batch's seed vector is "
                   "chosen — half mutated children of seeds that hit new coverage slots (candidates scored "
                   "by a bias state fed from the live map's thin bands and, with --provenance, the fault "
                   "kinds in failure lineages), half fresh sequential exploration; with --stop-on-plateau N "
                   "a plateau escalates the fault vocabulary along the recorded ladder instead of stopping. "
                   "The (seed schedule, bias state) trail is recorded in the checkpoint and stats feed, so a "
                   "guided hunt resumes byte-identically")
    p.set_defaults(fn=cmd_hunt)

    p = sub.add_parser("regress", help="re-verify every corpus entry (open must reproduce, fixed must pass)")
    obs_flags(p)
    device_flag(p)
    p.add_argument("--corpus", default="corpus.json")
    p.add_argument("--promote", action="store_true", help="flip open entries that no longer fail to fixed")
    p.set_defaults(fn=cmd_regress)

    p = sub.add_parser("audit", help="bisect every corpus entry's digest trail to the first divergent "
                       "checkpoint; --record records trails and environment metadata again")
    obs_flags(p)
    device_flag(p)
    p.add_argument("--corpus", default="corpus.json")
    p.add_argument("--record", action="store_true",
                   help="record digest trails again (refuses entries that broke their status contract)")
    p.add_argument("--digest-every", type=int, default=64, help="checkpoint cadence in steps when recording")
    p.set_defaults(fn=cmd_audit)

    p = sub.add_parser("check", help="engine determinism self-check")
    common(p)
    p.add_argument("--seeds", type=int, default=64)
    p.set_defaults(fn=cmd_check)

    p = sub.add_parser("coverage", help="render a persisted scenario-coverage map; --diff OLD shows "
                       "what a run added over another")
    p.add_argument("doc", help="coverage JSON written by `hunt --coverage-out`")
    p.add_argument("--diff", default=None, metavar="OLD",
                   help="baseline coverage doc to diff against (new/lost/shared slots)")
    p.add_argument("--top", type=int, default=8, help="thinnest band x phase cells to list")
    p.add_argument("--json", action="store_true", help="machine-readable output")
    p.set_defaults(fn=cmd_coverage)

    p = sub.add_parser("serve", help="run a host service (etcd, kafka, s3) over real TCP (MADSIM_TPU_MODE=real); "
                       "pickle wire format, trusted networks only. `--service stats` serves the last run's "
                       "StatsEmitter snapshot over HTTP instead (/stats JSON, /metrics Prometheus, /healthz; "
                       "any mode)")
    p.add_argument("--service", default="etcd", choices=["etcd", "kafka", "s3", "stats"])
    p.add_argument("--addr", default="127.0.0.1:23790", help="host:port (port 0 = ephemeral)")
    p.add_argument("--stats", default=None, metavar="BASE",
                   help="stats service only: StatsEmitter base path to serve "
                   "(default $MADSIM_TPU_STATS or ./madsim_stats)")
    p.add_argument("--port-file", default=None, metavar="PATH",
                   help="stats service only: atomically write the realized port to PATH after binding "
                   "(with --addr host:0, a supervisor discovers the daemon without racing its stdout)")
    p.add_argument("--grpc", action="store_true",
                   help="etcd only: serve the genuine etcd v3 gRPC wire protocol (etcdserverpb over grpc.aio) "
                   "instead of the pickle sim protocol")
    p.add_argument("--http", action="store_true",
                   help="s3 only: serve the genuine S3 REST wire protocol instead of the pickle sim protocol")
    p.add_argument("--wire", action="store_true",
                   help="kafka only: serve the genuine Kafka wire protocol (ApiVersions/Metadata/Produce/Fetch/"
                   "group APIs) instead of the pickle sim protocol")
    p.add_argument("--advertise", default=None,
                   help="kafka --wire only: hostname to advertise in Metadata/FindCoordinator responses "
                   "(defaults to the bind host, or 127.0.0.1 when binding 0.0.0.0)")
    p.set_defaults(fn=cmd_serve)

    p = sub.add_parser("bench-ab", help="interleaved A/B cost of one engine gate: ABAB... paired reps over "
                       "identical seed ranges in one process; median paired delta with bootstrap 95%% CI and "
                       "sign test (one JSON line)")
    common(p)
    p.add_argument("--gate", required=True, choices=_AB_GATES,
                   help="the gate to cost: A runs it on, B off (rng-stream: A = v3, B = v2; pallas-megakernel: "
                   "A the step-prefix kernel, B its plain twin, both v3); every other engine flag comes from the "
                   "usual options")
    p.add_argument("--lanes", type=int, default=1024, help="lanes per streaming batch")
    p.add_argument("--seeds", type=int, default=0, help="seeds per rep (0 = 2*lanes)")
    p.add_argument("--reps", type=int, default=4, metavar="PAIRS", help="A/B rep PAIRS")
    stream_flags(p)
    p.set_defaults(fn=cmd_bench_ab, seed=3_000_000)

    p = sub.add_parser("bench", help="flagship benchmark (one JSON line); with --machine, a streaming throughput "
                       "bench of any registered machine; `bench report` renders the port's bench history trend "
                       "(no torch)")
    common(p)
    p.add_argument("action", nargs="?", choices=("report",), default=None,
                   help="report: render the drift-aware bench history trend (each capture's delta against its "
                   "own comparable neighbour: same platform, card, kernels, lanes, gates, machine and host)")
    p.add_argument("--lanes", type=int, default=0, help="lanes per streaming batch (0 = 8192)")
    p.add_argument("--seeds", type=int, default=16384, help="seeds per rep (--machine)")
    p.add_argument("--reps", type=int, default=3)
    p.add_argument("--history", default=None, metavar="PATH",
                   help="bench history JSONL to render or append to (default $MADSIM_TPU_BENCH_HISTORY, else "
                   "./TORCH_BENCH_HISTORY.jsonl)")
    stream_flags(p)
    # no machine: the flagship; timed seed ranges start clear of the
    # validation sweeps
    p.set_defaults(fn=cmd_bench, machine=None, seed=1_000_000)

    p = sub.add_parser("perf", help="host wall-clock observatory: stream a workload with the PerfRecorder on "
                       "and write the Perfetto host timeline, with a compile- vs device- vs dispatch-gap-bound "
                       "verdict")
    common(p)
    p.add_argument("out", help="host-timeline Perfetto JSON output path")
    p.add_argument("--seeds", type=int, default=2048)
    p.add_argument("--batch", type=int, default=512, help="lanes per streaming batch")
    stream_flags(p)
    p.set_defaults(fn=cmd_perf)

    p = sub.add_parser("prof", help="the three-clock profiler: stream a hunt batch with device-phase ranges and "
                       "a torch.profiler capture on (MADSIM_TPU_XPROF), and with --merge align host spans, the "
                       "device capture and a failing lane's virtual-time trace into one Perfetto session; "
                       "`prof compile` (the JAX compile autopsy) is not ported")
    common(p)
    p.add_argument("action", nargs="?", choices=("compile",), default=None,
                   help="compile: the JAX package's compile autopsy (refused: eager PyTorch has no compile)")
    p.add_argument("--out", default="prof.perfetto.json",
                   help="output trace path (host timeline, or the merged three-clock plane with --merge; "
                   ".gz compresses)")
    p.add_argument("--merge", action="store_true",
                   help="write ONE merged Perfetto session: host + device + virtual tracks, clock-sync aligned")
    p.add_argument("--seeds", type=int, default=2048)
    p.add_argument("--batch", type=int, default=512, help="lanes per streaming batch")
    p.add_argument("--trace-seed", type=int, default=None,
                   help="seed for the virtual-time track (default: first failing seed of the profiled batch, "
                   "else --seed)")
    p.add_argument("--profile-dir", default=None, metavar="DIR",
                   help="keep the raw torch.profiler capture here (default: a throwaway tempdir)")
    stream_flags(p)
    p.set_defaults(fn=cmd_prof)

    p = sub.add_parser(
        "fleet",
        help="the hunt farm: DST as a continuously operating service — "
        "a durable job store + queue (JSON-on-disk, atomic, "
        "fingerprinted), `worker` (leases jobs, runs checkpointed "
        "batch units packed by engine subkey on the card or the CPU, shrinks + files "
        "finds), `serve` (torch-free HTTP control plane: POST /jobs, "
        "GET /jobs/{id}[/result|/events|/timeline], DELETE /jobs/{id}, "
        "/queue /metrics /healthz) and thin client verbs, including "
        "the observatory (`watch` SSE tail, `timeline` Perfetto "
        "merge, `top` farm view)",
    )
    fl = p.add_subparsers(dest="fleet_cmd", required=True)

    def fleet_root(q):
        q.add_argument(
            "--root", default=os.environ.get("MADSIM_TPU_FLEET_ROOT", "fleet"),
            help="fleet state directory (jobs/, corpus.json; also "
            "$MADSIM_TPU_FLEET_ROOT)",
        )

    def fleet_client_flags(q):
        q.add_argument(
            "--addr", default=None,
            help="control-plane host:port (default $MADSIM_TPU_FLEET_ADDR "
            "or 127.0.0.1:8142)",
        )
        q.add_argument(
            "--port-file", default=None, metavar="PATH",
            help="resolve the daemon as 127.0.0.1:<port read from PATH> "
            "(the file `fleet serve --port-file` writes atomically)",
        )
        q.add_argument(
            "--no-retry", action="store_true",
            help="fail fast instead of retrying transient HTTP errors "
            "(connection refused during a server restart, 502/503/504) "
            "with seeded-jitter backoff",
        )

    q = fl.add_parser("serve", help="torch-free HTTP control plane over a fleet root")
    obs_flags(q)
    fleet_root(q)
    q.add_argument("--addr", default="127.0.0.1:8142",
                   help="bind host:port (port 0 = ephemeral)")
    q.add_argument(
        "--port-file", default=None, metavar="PATH",
        help="atomically write the realized port to PATH after binding",
    )
    q.add_argument(
        "--sweep-interval", type=float, default=5.0,
        help="seconds between lease-reclamation supervisor sweeps "
        "(expired worker leases requeue their jobs with backoff, or "
        "quarantine at the attempt cap; 0 disables)",
    )
    q.set_defaults(fn=cmd_fleet)

    q = fl.add_parser(
        "worker",
        help="lease jobs and run them one checkpointed batch unit at a "
        "time (kill -9 loses at most one batch; jobs sharing a "
        "cache_subkey run back-to-back on the live engine)",
    )
    obs_flags(q)
    device_flag(q)
    fleet_root(q)
    q.add_argument("--worker-id", default=None,
                   help="stable lease identity (default w<pid>; reusing an "
                   "id reclaims its own leases immediately after a crash)")
    q.add_argument("--lease-ttl", type=float, default=60.0,
                   help="seconds before a dead worker's jobs become "
                   "reclaimable")
    q.add_argument("--poll", type=float, default=0.5,
                   help="idle store-poll interval in seconds")
    q.add_argument("--drain", action="store_true",
                   help="exit once every job is terminal (CI/batch mode) "
                   "instead of serving forever")
    q.add_argument("--max-units", type=int, default=0,
                   help="exit after N work units (deterministic "
                   "interruption for tests; 0 = unlimited)")
    q.add_argument("--compile-cache", default=None,
                   help="not ported: the JAX package's persistent compile cache")
    q.add_argument(
        "--perf-timeline", default=None, metavar="PATH",
        help="record the worker's host timeline (per-unit fleet_unit "
        "spans with job ids wrapping the usual compile/dispatch/poll "
        "spans) as Perfetto trace_event JSON",
    )
    q.add_argument(
        "--max-attempts", type=int, default=3,
        help="consecutive deaths/hard failures before a job is "
        "quarantined as poison (exception + batch index + repro "
        "recorded on the job)",
    )
    q.add_argument(
        "--backoff-base", type=float, default=2.0,
        help="requeue backoff base: a job that died attempt k waits "
        "base * 2^(k-1) seconds before it can be leased again",
    )
    q.add_argument(
        "--no-reclaim", action="store_true",
        help="skip the lease-reclamation sweep at each poll (rely on "
        "`fleet serve`'s supervisor thread / `fleet fsck --reclaim`)",
    )
    q.add_argument(
        "--driver", choices=("real", "synthetic"), default="real",
        help="'synthetic' replaces the engine's streaming path with the "
        "torch-free deterministic stand-in (chaos harness / farm tests "
        "only: same checkpoint+stats machinery, no engine, no card)",
    )
    q.set_defaults(fn=cmd_fleet)

    q = fl.add_parser("submit", help="submit a hunt job; prints the job id")
    obs_flags(q)
    fleet_client_flags(q)
    q.add_argument("--machine", required=True)
    q.add_argument("--nodes", type=int, default=0)
    q.add_argument("--seed", type=int, default=0, help="seed-range start")
    q.add_argument("--seeds", type=int, default=1024, help="seed budget")
    q.add_argument("--batch", type=int, default=256,
                   help="lanes per batch unit (the checkpoint granularity)")
    q.add_argument("--horizon", type=float, default=5.0)
    q.add_argument("--max-steps", type=int, default=3000)
    q.add_argument("--queue", type=int, default=96)
    q.add_argument("--faults", type=int, default=2)
    q.add_argument("--loss", type=float, default=0.0)
    q.add_argument("--fault-tmax", type=int, default=0)
    q.add_argument("--fault-kinds", default="pair,kill")
    q.add_argument("--rng-stream", type=int, default=2, choices=(2, 3))
    q.add_argument("--strict-restart", action="store_true")
    q.add_argument("--coverage", action="store_true")
    q.add_argument("--provenance", action="store_true")
    q.add_argument("--flight-recorder", action="store_true")
    q.add_argument("--stop-on-plateau", type=int, default=0)
    q.add_argument(
        "--guided", action="store_true",
        help="coverage-feedback search (needs --coverage): the worker "
        "evolves this job's seed corpus AFL-style, biases fault draws "
        "toward thin coverage cells / implicated kinds, and escalates "
        "the vocabulary on plateau; the (seed schedule, bias state) "
        "trail rides the job checkpoint, so interrupt/resume and "
        "worker replacement reproduce byte-identically",
    )
    q.add_argument("--shrink-limit", type=int, default=5,
                   help="max distinct-code finds to shrink + file")
    q.add_argument("--devices", type=int, default=0, metavar="N",
                   help="shard each batch unit's lanes over N ranks (0 = unsharded); part of the "
                   "warm-compile grouping key")
    q.add_argument("--priority", type=int, default=0,
                   help="higher runs earlier (and may pay a compile switch)")
    q.add_argument("--deadline", type=float, default=None,
                   help="relative deadline in wall seconds; the worker "
                   "stops the job when it passes")
    q.add_argument(
        "--tenant", default=None,
        help="admission-accounting identity: the server's per-tenant "
        "token bucket ($MADSIM_TPU_FLEET_RATE_LIMIT) charges this name; "
        "a 429 refusal names it and the client retries after the "
        "server's Retry-After",
    )
    q.set_defaults(fn=cmd_fleet)

    for verb, hlp in (
        ("status", "job document + live per-batch feed"),
        ("result", "find + shrunk repro + why attribution (terminal jobs)"),
        ("cancel", "cancel a job (queued dies now; running at the next "
                   "unit boundary)"),
    ):
        q = fl.add_parser(verb, help=hlp)
        obs_flags(q)
        fleet_client_flags(q)
        q.add_argument("job", help="job id (from `fleet submit`)")
        if verb == "status":
            q.add_argument("--feed", type=int, default=20,
                           help="live-feed rows to include")
            q.add_argument(
                "--wait", type=float, default=0, metavar="S",
                help="long-poll: the server holds the request up to S "
                "seconds (capped server-side) and answers as soon as "
                "the job document or its stats feed changes — clients "
                "stop busy-polling GET /jobs/{id}",
            )
        q.set_defaults(fn=cmd_fleet)

    q = fl.add_parser("queue", help="state counts + per-job summaries")
    obs_flags(q)
    fleet_client_flags(q)
    q.set_defaults(fn=cmd_fleet)

    q = fl.add_parser(
        "watch",
        help="tail a job's lifecycle event stream over SSE (push, not "
        "poll: the server parks between events), one line per event; "
        "exits 0 when the job reaches a terminal state",
    )
    obs_flags(q)
    fleet_client_flags(q)
    q.add_argument("job", help="job id (from `fleet submit`)")
    q.add_argument("--since", type=int, default=0, metavar="SEQ",
                   help="resume the tail after event SEQ (0 = replay "
                   "the full event log first)")
    q.set_defaults(fn=cmd_fleet)

    q = fl.add_parser(
        "timeline",
        help="merge the job's lifecycle events with every worker's "
        "span dump (correlated by job id as trace id) into one "
        "Perfetto timeline: queue-wait, per-batch progress and worker "
        "internals on a shared wall clock",
    )
    obs_flags(q)
    fleet_client_flags(q)
    q.add_argument("job", help="job id (from `fleet submit`)")
    q.add_argument("--out", default=None, metavar="PATH",
                   help="output trace path (default "
                   "<job>.timeline.perfetto.json)")
    q.set_defaults(fn=cmd_fleet)

    q = fl.add_parser(
        "profile",
        help="the three-clock merge for a job: host timeline + the "
        "worker's device-profile capture + the failing lane's "
        "virtual-time trace (recorded when the worker runs under "
        "MADSIM_TPU_XPROF=1), aligned by xprof clock-sync markers "
        "into one Perfetto session",
    )
    obs_flags(q)
    fleet_client_flags(q)
    q.add_argument("job", help="job id (from `fleet submit`)")
    q.add_argument("--out", default=None, metavar="PATH",
                   help="output trace path (default "
                   "<job>.profile.perfetto.json)")
    q.set_defaults(fn=cmd_fleet)

    q = fl.add_parser(
        "top",
        help="one-screen farm view rendered from /queue (state counts, "
        "per-job batch/find/coverage/escalation progress, momentum, "
        "lease holder, last event) — torch-free, needs only the HTTP "
        "control plane",
    )
    obs_flags(q)
    fleet_client_flags(q)
    q.add_argument("--interval", type=float, default=2.0, metavar="S",
                   help="seconds between redraws")
    q.add_argument("--once", action="store_true",
                   help="print a single frame and exit (scripts/CI)")
    q.set_defaults(fn=cmd_fleet)

    q = fl.add_parser(
        "fsck",
        help="scan the job store + fleet corpus for truncated/"
        "unparseable/fingerprint-inconsistent files, quarantine them "
        "to *.corrupt with a per-file verdict, remove stale atomic-"
        "write tmp files, and rebuild the queue counts; exit 0 clean "
        "/ 1 corruption found",
    )
    obs_flags(q)
    fleet_root(q)
    q.add_argument("--dry-run", action="store_true",
                   help="scan + report only; quarantine/remove nothing")
    q.add_argument("--reclaim", action="store_true",
                   help="also run the lease-reclamation sweep (requeue "
                   "jobs whose worker lease expired, or quarantine at "
                   "the attempt cap)")
    q.add_argument("--release-quarantined", action="store_true",
                   help="re-queue quarantined jobs (attempt counter "
                   "reset; the quarantine post-mortem stays on the "
                   "doc)")
    q.add_argument("--json", action="store_true",
                   help="machine-readable report instead of text")
    q.set_defaults(fn=cmd_fleet)

    q = fl.add_parser(
        "chaos",
        help="attack a scratch farm with a seeded schedule of process-"
        "level faults (SIGKILL worker/server at the k-th store write, "
        "torn in-flight writes, lease-clock jumps, client calls "
        "through a bounced server) and assert the recovery "
        "invariants: no accepted job lost, every resumed job's final "
        "report byte-identical to an unperturbed oracle run; a "
        "failing seed reproduces from its printed line forever",
    )
    obs_flags(q)
    q.add_argument("--seed", type=int, default=0,
                   help="chaos schedule seed (the repro key)")
    q.add_argument("--sweep", type=int, default=1,
                   help="run N consecutive seeds starting at --seed")
    q.add_argument("--profile",
                   choices=("kill", "torn", "mixed", "spans", "claims"),
                   default="mixed",
                   help="fault-mix weighting of the schedule ('claims' "
                   "weights the contention plane: claim races, zombie "
                   "resumes, single-victim lease jumps, torn queue.log "
                   "appends)")
    q.add_argument("--workers", type=int, default=1,
                   help="race N workers against the one store every "
                   "worker round (adds the contention invariants: no "
                   "(job, batch, gen) executed twice, no find filed "
                   "twice, reports still byte-identical to the "
                   "1-worker oracle)")
    q.add_argument("--rounds", type=int, default=0,
                   help="override the schedule's round count (0 = from "
                   "the seed)")
    q.add_argument("--jobs", type=int, default=0,
                   help="override the number of tenant jobs (0 = from "
                   "the seed)")
    q.add_argument("--real", action="store_true",
                   help="drive real echo-machine engines instead of "
                   "the torch-free synthetic driver (slow: each worker "
                   "restart pays a torch import and an engine build; finds are filed and "
                   "regress-replayed)")
    device_flag(q)
    q.add_argument("--out", default=None, metavar="DIR",
                   help="keep the farm, schedule.json and fsck.json "
                   "under DIR (default: a temp dir, removed when the "
                   "seed passes)")
    q.add_argument("--keep", action="store_true",
                   help="keep the scratch farm even on success")
    q.set_defaults(fn=cmd_fleet)

    p = sub.add_parser(
        "lint",
        help="static determinism & contract analysis: D-rules "
        "(wall-clock/entropy/set-order/callback hazards, AST-only), "
        "C-rules (Machine contract: handler purity, durable/torn spec "
        "congruence, coverage projection), G-rules (fault-kind mirror "
        "and RNG-layout cross-checks), and the whole-program families "
        "— L (torch-free layer map), T (tensor taint: host syncs, "
        "donation), R (static RNG ledger), S (sharding readiness: "
        "lane-axis dataflow vs the collective registry). Exit 0 clean / "
        "1 findings / 2 usage error — pre-commit friendly",
    )
    from .analysis.cli import add_lint_args

    add_lint_args(p)
    p.set_defaults(fn=cmd_lint)
    return parser


def main(argv=None) -> int:
    parser = _parser()
    args, extra = parser.parse_known_args(argv)
    gate = _gate(args)
    if gate:
        print(gate, file=sys.stderr)
        return 2
    if extra:
        parser.error(f"unrecognized arguments: {' '.join(extra)}")
    if getattr(args, "log_level", None) or getattr(args, "log_jsonl", None):
        from .tracing import init_tracing

        init_tracing(getattr(args, "log_level", None) or "INFO", jsonl_path=getattr(args, "log_jsonl", None))
    # the fleet's control plane, a synthetic-driver worker and a
    # synthetic chaos run build no engine and run without a card; a
    # real worker is refused here, before it leases anything
    builds_engines = (args.cmd != "fleet" or (
        args.fleet_cmd == "worker" and args.driver == "real") or (
        args.fleet_cmd == "chaos" and args.real)) and not (
        # `bench report` renders the history: no engine, no torch
        args.cmd == "bench" and args.action == "report")
    if hasattr(args, "device") and builds_engines:
        from .engine.core import resolve_device

        try:
            resolve_device(_device(args))
        except RuntimeError as exc:
            print(f"{PROG}: {exc} (here: --device cpu)", file=sys.stderr)
            return 2
    if args.cmd == "perf":
        # the out positional IS the host timeline: cmd_perf runs under
        # the same --perf-timeline session as explore and hunt
        args.perf_timeline = args.out
    if not getattr(args, "multihost", False):
        with _perf_session(args):
            return args.fn(args)
    # join the job (MADSIM_TPU_COORDINATOR / NUM_PROCS / PROC_ID) before
    # any engine is built
    import torch.distributed as dist

    from .parallel import multihost

    multihost.initialize(device=_device(args))
    if multihost.process_index() != 0:
        # only process 0 writes: the others keep no timeline, capture,
        # stats feed or checkpoint
        for attr in ("perf_timeline", "xla_profile", "stats", "checkpoint"):
            if hasattr(args, attr):
                setattr(args, attr, None)
    try:
        with _perf_session(args):
            return args.fn(args)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    sys.exit(main())
