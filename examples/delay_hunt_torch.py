"""Timeout-mishandling hunt with the delay fault kind, on the port.

The port's copy of `examples/delay_hunt.py`, importing `madsim_tpu_torch`.

Most fault vocabularies (loss, partitions, kills) make messages VANISH.
The `delay` kind makes them LATE: during a timed window, ~10% of sends
take +1-5 virtual seconds (the host fabric's buggify numbers,
reference sim/net/mod.rs:287-296). Late-but-delivered is the only way
to reach a whole class of real bugs: code that treats a timeout as
failure while the request is still in flight.

The demo machine is a deadline-RPC client against a token-dedup server
(models/etcd_mvcc.py PREMATURE_GIVEUP): each op is sent once with a
300 ms deadline; on expiry the client reports failure to the
application and moves on. The bug: the abandoned request can still
land — a write the application compensated for becomes visible
(ABANDONED_WRITE, code 206). Loss destroys the in-flight copy and
clogs/kills block it at the link, so every other vocabulary finds
NOTHING; only delay reaches it.

Run:  python examples/delay_hunt_torch.py [--device cpu]

It runs on the CUDA card unless `--device cpu` is given; without a card
and without `--device cpu` it exits with an error.
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import torch

from madsim_tpu_torch.engine import Engine, EngineConfig, FaultPlan, replay, shrink
from madsim_tpu_torch.models.etcd_mvcc import ABANDONED_WRITE, EtcdMvccMachine

LANES = 256
MAX_STEPS = 3000
VANISHING = [
    ("loss storms", dict(allow_storm=True)),
    ("partitions + kills", dict(allow_partition=True, allow_kill=True)),
]


class PrematureGiveup(EtcdMvccMachine):
    PREMATURE_GIVEUP = True  # the CLI ships this as demo-giveup-mvcc


def config(**fault_kinds) -> EngineConfig:
    """The hunt's config under one fault vocabulary (partitions and kills
    off unless `fault_kinds` turn them on)."""
    kinds = dict(allow_partition=False, allow_kill=False)
    kinds.update(fault_kinds)
    return EngineConfig(
        horizon_us=8_000_000,
        queue_capacity=48,
        faults=FaultPlan(
            n_faults=3, t_max_us=3_000_000,
            dur_min_us=200_000, dur_max_us=800_000, **kinds,
        ),
    )


def engine(device=None, **fault_kinds) -> Engine:
    """The hunt's engine on `device` (None: the CUDA card)."""
    return Engine(PrematureGiveup(num_nodes=4), config(**fault_kinds), device=device)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description="delay-kind hunt of the MVCC give-up bug on madsim_tpu_torch")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where the engines run (default: the CUDA card)")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        sys.exit("delay_hunt_torch: no CUDA device; pass --device cpu to run on the CPU")
    device = "cpu" if args.device == "cpu" else None

    seeds = np.arange(LANES, dtype=np.uint32)

    # 1. the vanishing vocabularies find nothing…
    for name, kinds in VANISHING:
        res = engine(device, **kinds).make_runner(max_steps=MAX_STEPS)(seeds)
        n = int(res.failed.sum())
        print(f"{name:>20}: {n}/{LANES} seeds flagged")

    # 2. …the delay vocabulary finds the bug
    eng = engine(device, allow_delay=True)
    res = eng.make_runner(max_steps=MAX_STEPS)(seeds)
    failing = [int(s) for s in eng.failing_seeds(res).tolist()]
    codes = {int(c) for c in res.fail_code.tolist() if c}
    print(f"{'delay spikes':>20}: {len(failing)}/{LANES} seeds flagged, codes {codes}")
    assert codes == {ABANDONED_WRITE}

    # 3. bit-identical replay of one find, then shrink it to a minimal repro
    seed = failing[0]
    rp = replay(eng, seed, max_steps=MAX_STEPS, trace=False)
    assert rp.failed and rp.fail_code == ABANDONED_WRITE
    sr = shrink(eng, seed, max_steps=MAX_STEPS)
    print(f"{'replay + shrink':>20}: {sr.summary()}")
    # the minimal config still carries delay windows — the late delivery
    # IS the bug's trigger, so shrink cannot remove every fault
    assert sr.shrunk.faults.n_faults >= 1


if __name__ == "__main__":
    main()
