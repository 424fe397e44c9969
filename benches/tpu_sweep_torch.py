"""Parameter sweep of the port's streaming path on the card.

The port copy of benches/tpu_sweep.py, on `madsim_tpu_torch`. Sweeps
batch (lanes) x segment_steps on the flagship MadRaft bench workload
and prints one JSON line per point. Run:

    python benches/tpu_sweep_torch.py                # default grid
    python benches/tpu_sweep_torch.py 8192 192       # single point
    MADSIM_TPU_PALLAS_POP=0 python benches/tpu_sweep_torch.py 8192 192   # A/B: no megakernel
    MADSIM_TPU_RNG_STREAM=2 MADSIM_TPU_CLOG_PACKED=0 ...                 # A/B: legacy step path
    python benches/tpu_sweep_torch.py 16 96 --device cpu                 # on the CPU

The timed region matches bench.py (3*batch seeds streamed, warmed up).
Every point runs on the card unless `--device cpu` is given; without a
card and without `--device cpu` the script exits 2 with the port's "no
CUDA device" line: it never falls back to the CPU (the reference's
backend watchdog is not ported, and the XLA flag it set for `--mesh`
shapes no torch backend).

MADSIM_TPU_PALLAS_POP=0 sets `EngineConfig(pallas_megakernel=False)`,
the gate `python -m madsim_tpu_torch bench-ab --gate pallas-megakernel`
flips: the step prefix then runs the pop + gather kernel with the words
drawn and the digest folded in PyTorch (the engine reads no such
variable; this script does). Each line carries the resolved gate
(`pallas_megakernel`, where the reference's has `pallas_pop`), the
engine's device type as `platform` and, on the card, `card`: its name
and power limit as nvidia-smi gives them.

`--mesh [OUT]` runs the multi-rank capture instead: the same workload
sharded over torch.distributed ranks (`parallel.multihost`, one process
a rank, each joining from the MADSIM_TPU_* environment, then
`make_stream_runner(mesh=multihost.global_mesh())`), at 1 rank and 2
ranks (and 4 and 8 where the machine has that many cards), 1024 lanes in
192-step segments. One rank runs NCCL; ranks that outnumber the cards
share them over gloo (`--device cpu`: gloo on the CPU). Seeds/s per
point plus the ratio to the 1-rank rate, written to OUT (default
TORCH_MULTICHIP.json in the working directory) and appended to the
port's bench history (TORCH_BENCH_HISTORY.jsonl in the working directory
unless MADSIM_TPU_BENCH_HISTORY names another) with `device_count` in
the fingerprint. Where ranks share one card the document says so
(`shared_card`): their ratio is the cost of sharding on one card, not a
scaling figure. Every point streams the same seeds, so `completed` and
the coverage are the 1-rank point's.
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

DEFAULT_GRID = [
    (4096, 192),
    (8192, 192),
    (16384, 192),
    (32768, 192),
    (8192, 384),
    (16384, 384),
]
MESH_OUT = "TORCH_MULTICHIP.json"
MESH_WORLDS = (1, 2, 4, 8)

# one rank of the --mesh capture: loads this file as a module and runs
# mesh_rank_main(spec, out)
MESH_RANK_CHILD = (
    "import importlib.util, sys\n"
    "spec = importlib.util.spec_from_file_location('tpu_sweep_torch', sys.argv[1])\n"
    "mod = importlib.util.module_from_spec(spec)\n"
    "spec.loader.exec_module(mod)\n"
    "sys.exit(mod.mesh_rank_main(sys.argv[2], sys.argv[3]))\n"
)


def _on(name: str, default: str) -> bool:
    return os.environ.get(name, default) not in ("", "0")


def sweep_config():
    """The sweep's EngineConfig under the environment's gates (the same
    overrides as bench.py; defaults on)."""
    from madsim_tpu_torch.engine import EngineConfig, FaultPlan

    return EngineConfig(
        horizon_us=5_000_000,
        queue_capacity=96,
        faults=FaultPlan(n_faults=2, t_max_us=3_000_000, dur_min_us=200_000, dur_max_us=800_000),
        # step-path gates (same env overrides as bench.py; defaults = on)
        rng_stream=int(os.environ.get("MADSIM_TPU_RNG_STREAM", "3")),
        clog_packed=_on("MADSIM_TPU_CLOG_PACKED", "1"),
        # the kernel A/B: MADSIM_TPU_PALLAS_POP=0 turns the megakernel off
        pallas_megakernel=None if _on("MADSIM_TPU_PALLAS_POP", "1") else False,
        # observability gates ride the sweep like the flagship bench
        flight_recorder=_on("MADSIM_TPU_FLIGHT_RECORDER", "1"),
        coverage=_on("MADSIM_TPU_COVERAGE", "1"),
    )


def sweep_engine(device=None):
    """The flagship machine under `sweep_config()` on `device` (None: the card)."""
    from madsim_tpu_torch.engine import Engine
    from madsim_tpu_torch.models.raft import RaftMachine

    return Engine(RaftMachine(num_nodes=5, log_capacity=8), sweep_config(), device=device)


def card_of(eng):
    """The card's name and power limit (nvidia-smi), or None off the card."""
    from madsim_tpu_torch.perf.history import card

    return card() if eng.device.type == "cuda" else None


def run_point(batch: int, segment_steps: int, device=None) -> dict:
    eng = sweep_engine(device)
    cfg = eng.config
    # pipelined-executor knobs, env-tunable for A/B sweeps:
    # MADSIM_TPU_STREAM_PIPELINE=0 restores the per-segment driver
    run = eng.make_stream_runner(
        batch=batch,
        segment_steps=segment_steps,
        pipelined=_on("MADSIM_TPU_STREAM_PIPELINE", "1"),
        segments_per_dispatch=int(os.environ.get("MADSIM_TPU_STREAM_SUPERSEG", "8")),
        dispatch_depth=int(os.environ.get("MADSIM_TPU_STREAM_DEPTH", "4")),
    )
    t_c0 = time.perf_counter()
    run(1)
    compile_s = time.perf_counter() - t_c0
    t0 = time.perf_counter()
    out = run(3 * batch, seed_start=1_000_000)
    elapsed = time.perf_counter() - t0
    st = out["stats"]
    return {
        "batch": batch,
        "segment_steps": segment_steps,
        # the resolved gate, not the env echo
        "pallas_megakernel": eng.use_megakernel,
        "rng_stream": cfg.rng_stream,
        "clog_packed": cfg.clog_packed,
        "seeds_per_sec": round(out["completed"] / elapsed, 1),
        "completed": out["completed"],
        "elapsed_s": round(elapsed, 2),
        "compile_s": round(compile_s, 1),
        "platform": eng.device.type,
        "card": card_of(eng),
        "host_syncs": st["host_syncs"],
        "device_segments": st["device_segments"],
        "pipelined": st["pipelined"],
        "donation": st["donation"],
        "flight_recorder": cfg.flight_recorder,
        **(
            {
                "coverage": {
                    k: v for k, v in st["coverage"].items() if k != "curve"
                }
            }
            if "coverage" in st else {}
        ),
    }


def mesh_rank_main(spec_path: str, out_path: str) -> int:
    """One rank of the --mesh capture: joins the job from the MADSIM_TPU_*
    environment, streams its share of the lanes (`run(1)` timed as the
    first run, then `run(3 * batch)`) and writes its point to `out_path`."""
    import torch.distributed as dist

    from madsim_tpu_torch.parallel import multihost

    spec = json.loads(open(spec_path).read())
    cpu = spec["device"] == "cpu"
    multihost.initialize(device="cpu" if cpu else None)
    mesh = multihost.global_mesh()
    eng = sweep_engine("cpu" if cpu else None)
    cfg = eng.config
    run = eng.make_stream_runner(batch=spec["batch"], segment_steps=spec["segment_steps"], mesh=mesh)
    t_c0 = time.perf_counter()
    run(1)
    compile_s = time.perf_counter() - t_c0
    t0 = time.perf_counter()
    out = run(3 * spec["batch"], seed_start=1_000_000)
    elapsed = time.perf_counter() - t0
    st = out["stats"]
    point = {
        "devices": mesh.size,
        "seeds_per_sec": round(out["completed"] / elapsed, 1),
        "completed": out["completed"],
        "elapsed_s": round(elapsed, 2),
        "compile_s": round(compile_s, 1),
        "host_syncs": st["host_syncs"],
        "backend": mesh.backend,
        "coverage": {k: v for k, v in st.get("coverage", {}).items() if k != "curve"},
    }
    gates = {
        "rng_stream": cfg.rng_stream,
        "clog_packed": cfg.clog_packed,
        "pallas_megakernel": eng.use_megakernel,
        "flight_recorder": cfg.flight_recorder,
        "coverage": cfg.coverage,
        "provenance": False,
    }
    dist.destroy_process_group()
    with open(out_path, "w") as f:
        json.dump({"rank": mesh.rank, "point": point, "compile_s": compile_s, "gates": gates,
                   "platform": eng.device.type}, f)
    return 0


def _run_ranks(world: int, spec: dict, tmp: str) -> list:
    """`world` rank processes of mesh_rank_main, joined through a
    rendezvous file in `tmp`; each rank's record, in rank order."""
    import subprocess

    spec_path = os.path.join(tmp, f"spec{world}.json")
    with open(spec_path, "w") as f:
        json.dump(spec, f)
    procs = []
    for r in range(world):
        env = dict(os.environ, MADSIM_TPU_COORDINATOR=f"file://{os.path.join(tmp, f'rdv{world}')}",
                   MADSIM_TPU_NUM_PROCS=str(world), MADSIM_TPU_PROC_ID=str(r))
        out = os.path.join(tmp, f"rank{world}_{r}.json")
        procs.append((subprocess.Popen([sys.executable, "-c", MESH_RANK_CHILD, os.path.abspath(__file__),
                                        spec_path, out], env=env), out))
    failed = [r for r, (p, _) in enumerate(procs) if p.wait() != 0]
    if failed:
        raise RuntimeError(f"--mesh: rank(s) {failed} of {world} exited non-zero")
    return [json.loads(open(out).read()) for _, out in procs]


def run_mesh_sweep(out_path: str, batch: int = 1024, segment_steps: int = 192, device=None) -> dict:
    """The multi-rank capture: one hunt sharded over 1, 2 (4, 8) ranks,
    a process each. Every point runs the identical seed range (equal
    results by the shard-invariance contract, tests/test_torch_mesh.py),
    so the ONLY variable is the mesh. Returns the document it writes."""
    import tempfile

    import torch

    from madsim_tpu_torch.perf import flagship
    from madsim_tpu_torch.perf import history as bench_history

    cpu = device == "cpu"
    cards = 0 if cpu else torch.cuda.device_count()
    counts = [k for k in MESH_WORLDS if k <= max(2, cards)]
    hist_path = flagship.history_path()
    spec = {"batch": batch, "segment_steps": segment_steps, "device": "cpu" if cpu else "cuda"}
    points = []
    with tempfile.TemporaryDirectory(prefix="tpu_sweep_mesh_") as tmp:
        for k in counts:
            rank0 = _run_ranks(k, spec, tmp)[0]
            point = rank0["point"]
            points.append(point)
            print(json.dumps(point), flush=True)
            bench_history.append(hist_path, bench_history.make_record(
                f"mesh_d{k}", point["seeds_per_sec"],
                bench_history.env_fingerprint(
                    backend_platform=rank0["platform"],
                    lanes=batch, reps=1, segment_steps=segment_steps,
                    gates=rank0["gates"], device_count=k,
                ),
                compile_s=rank0["compile_s"], source="benches/tpu_sweep_torch.py --mesh",
            ))
    base = points[0]["seeds_per_sec"]
    shared = not cpu and counts[-1] > cards
    doc = {
        "batch": batch,
        "segment_steps": segment_steps,
        "platform": "cpu" if cpu else "cuda",
        "card": None if cpu else bench_history.card(),
        "cards": cards,
        # ranks past the card count share a card over gloo: their ratio to
        # the 1-rank rate is what sharding costs on one card, not scaling
        "shared_card": shared,
        **({"shared_card_reason": f"{counts[-1]} ranks on {cards} card(s): ranks share a card, so the "
                                  f"ratio is no scaling figure"} if shared else {}),
        "points": points,
        "scaling_vs_1dev": {
            str(p["devices"]): round(p["seeds_per_sec"] / base, 3)
            for p in points
        },
    }
    with open(out_path, "w") as f:
        json.dump(doc, f, indent=2)
        f.write("\n")
    print(f"wrote {out_path}", flush=True)
    return doc


def main(argv=None) -> int:
    import argparse

    from madsim_tpu_torch.engine.core import resolve_device

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("rest", nargs="*", help="BATCH SEGMENT_STEPS (one point), or OUT with --mesh")
    ap.add_argument("--mesh", action="store_true", help="the multi-rank capture")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="the engines' device (default: the card; the script never falls back to the CPU)")
    args = ap.parse_args(argv)
    device = "cpu" if args.device == "cpu" else None
    try:
        resolve_device(device)
    except RuntimeError as exc:
        print(f"madsim_tpu_torch: {exc} (here: --device cpu)", file=sys.stderr)
        return 2
    if args.mesh:
        run_mesh_sweep(args.rest[0] if args.rest else MESH_OUT, device=device)
        return 0
    if len(args.rest) >= 2:
        grid = [(int(args.rest[0]), int(args.rest[1]))]
    else:
        grid = DEFAULT_GRID
    # long sweeps are observable from outside the process: with
    # MADSIM_TPU_STATS=base set, every point also lands in base.jsonl +
    # the base.prom / base.json snapshots (`serve --service stats`)
    emitter = None
    if os.environ.get("MADSIM_TPU_STATS"):
        from madsim_tpu_torch.tracing import StatsEmitter

        emitter = StatsEmitter(os.environ["MADSIM_TPU_STATS"])
    for batch, seg in grid:
        point = run_point(batch, seg, device)
        print(json.dumps(point), flush=True)
        if emitter is not None:
            emitter.emit({"kind": "sweep_point", **point})
    if emitter is not None:
        emitter.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
