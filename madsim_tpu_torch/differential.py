"""Cross-engine differential harness, the device side: the port of
`madsim_tpu/differential.py`.

The batched engine explores seeds over protocol *step functions*; a
host engine runs the same protocol as free-form async code. The two use
different RNG streams and schedulers, so their traces are not
bit-comparable. What must agree is the *semantics*: the same protocol,
under the same fault schedule, upholds (or, for a seeded bug variant,
violates) the same invariants.

Three bridges:

1. `fault_schedule(engine, seed)`: the device lane's fault events, a
   pure function of (seed, FaultPlan), read from `init_batch`. This IS
   the pinned chaos schedule for the seed.
2. `host_run(seed, schedule, n=, horizon_us=, node_cls=, base_loss=)`:
   replays that schedule against the host-engine Raft at the same
   virtual times and returns its verdict (`violation`, `elected`,
   `max_commit`, `chaos_applied`, ...). The host engine runs nothing on
   the card, so the port keeps no copy of it: the caller passes it in
   (the JAX package's `madsim_tpu.differential.run_host_raft` is one).
3. `differential_raft(engine, seeds, host_run, ...)`: both engines per
   seed, compared: safety verdicts, election liveness, and the applied
   chaos stream event for event against the device schedule.

Lanes are independent, so every seed's schedule comes from one
`init_batch` and every device verdict from one `run_batch` of the whole
seed vector: the rows equal per-seed `fault_schedule` /
`run_device_raft` (tests/test_torch_differential.py holds that).
"""

from __future__ import annotations

from typing import Callable, Dict, List

import numpy as np

from .engine.core import EV_FAULT, Engine


def fault_schedules(engine: Engine, seeds) -> List[List[Dict[str, int]]]:
    """`fault_schedule` of every seed of `seeds`, from one `init_batch`."""
    state = engine.init_batch(np.asarray(list(seeds), dtype=np.int64) & 0xFFFFFFFF)
    kind, valid, t, seq = (x.cpu().numpy() for x in (state.eq_kind, state.eq_valid, state.eq_time, state.eq_seq))
    pay = state.eq_payload.cpu().numpy()
    out = []
    for lane in range(kind.shape[0]):
        sel = valid[lane] & (kind[lane] == EV_FAULT)
        lt, lseq, lpay = t[lane][sel], seq[lane][sel], pay[lane][sel]
        out.append([
            {"t_us": int(lt[i]), "op": int(lpay[i][0]), "a": int(lpay[i][1]), "b": int(lpay[i][2])}
            for i in np.lexsort((lseq, lt))
        ])
    return out


def fault_schedule(engine: Engine, seed: int) -> List[Dict[str, int]]:
    """Decode the fault events the device lane for `seed` will execute:
    [{"t_us", "op", "a", "b"}, ...] sorted by (time, seq). `a` is a node
    for pair/dir/kill ops, a node *bitmask* for group ops, and the loss
    rate (1/65536 units) for storm ops."""
    return fault_schedules(engine, [seed])[0]


def run_device_rafts(engine: Engine, seeds, max_steps: int = 3000) -> List[Dict]:
    """Every seed of `seeds` as one lane of one batch, each reduced to
    the host verdict's shape."""
    from .models.raft import ELECTION_SAFETY, LOG_MATCHING

    res = engine.make_runner(max_steps=max_steps)(np.asarray(list(seeds), dtype=np.int64) & 0xFFFFFFFF)
    failed, codes = res.failed.cpu().numpy(), res.fail_code.cpu().numpy()
    max_term = res.summary["max_term"].cpu().numpy()
    max_commit = res.summary["max_commit"].cpu().numpy()
    names = {ELECTION_SAFETY: "ELECTION_SAFETY", LOG_MATCHING: "LOG_MATCHING"}
    return [
        {
            "violation": names.get(int(codes[i]), str(int(codes[i]))) if bool(failed[i]) else None,
            "elected": int(max_term[i]) > 0 and int(max_commit[i]) > 0,
            "max_commit": int(max_commit[i]),
        }
        for i in range(len(failed))
    ]


def run_device_raft(engine: Engine, seed: int, max_steps: int = 3000) -> Dict:
    """One seed on the batched engine, reduced to the same verdict shape."""
    return run_device_rafts(engine, [seed], max_steps=max_steps)[0]


def differential_raft(
    engine: Engine,
    seeds,
    host_run: Callable[..., Dict],
    n: int = 5,
    host_node_cls=None,
    max_steps: int = 3000,
) -> Dict:
    """Run every seed on both engines under the device's fault schedule.

    Returns per-seed rows plus aggregates:
      {"rows": [...], "device_violations": int, "host_violations": int,
       "safety_disagreements": int, "schedule_mismatches": int,
       "device_elected": int, "host_elected": int}
    """
    horizon = engine.config.horizon_us
    base_loss = float(getattr(engine.config, "packet_loss_rate", 0.0))
    seeds = [int(s) for s in seeds]
    scheds = fault_schedules(engine, seeds)
    devs = run_device_rafts(engine, seeds, max_steps=max_steps)
    rows = []
    for seed, sched, dev in zip(seeds, scheds, devs):
        host = host_run(
            seed, sched, n=n, horizon_us=horizon, node_cls=host_node_cls,
            base_loss=base_loss,
        )
        rows.append(
            {
                "seed": seed,
                "schedule": sched,
                "device": dev,
                "host": host,
                # the host chaos task is abandoned when the scenario
                # returns at the horizon, so events scheduled at or past
                # it are (correctly) never applied — compare only the
                # in-horizon prefix
                "schedule_ok": host["chaos_applied"]
                == [
                    (e["t_us"], e["op"], e["a"], e["b"])
                    for e in sched
                    if e["t_us"] < horizon
                ],
            }
        )
    return {
        "rows": rows,
        "device_violations": sum(1 for r in rows if r["device"]["violation"]),
        "host_violations": sum(1 for r in rows if r["host"]["violation"]),
        "safety_disagreements": sum(
            1
            for r in rows
            if bool(r["device"]["violation"]) != bool(r["host"]["violation"])
        ),
        "schedule_mismatches": sum(1 for r in rows if not r["schedule_ok"]),
        "device_elected": sum(1 for r in rows if r["device"]["elected"]),
        "host_elected": sum(1 for r in rows if r["host"]["elected"]),
    }
