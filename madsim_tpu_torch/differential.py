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
2. `run_host_raft(seed, schedule, n=, horizon_us=, node_cls=, base_loss=)`:
   replays that schedule against the host-engine Raft
   (examples/raft_host_torch.py, on the port's own runtime) at the same
   virtual times and returns its verdict (`violation`, `elected`,
   `max_commit`, `chaos_applied`, ...).
3. `differential_raft(engine, seeds, host_run=run_host_raft, ...)`: both
   engines per seed, compared: safety verdicts, election liveness, and
   the applied chaos stream event for event against the device schedule.
   `host_run` takes any function of `run_host_raft`'s signature (the
   JAX package's own `run_host_raft` is one).

Lanes are independent, so every seed's schedule comes from one
`init_batch` and every device verdict from one `run_batch` of the whole
seed vector: the rows equal per-seed `fault_schedule` /
`run_device_raft` (tests/test_torch_differential.py holds that).
"""

from __future__ import annotations

import importlib.util
import os
from typing import Callable, Dict, List, Optional

import numpy as np

from .engine.core import (
    EV_FAULT,
    F_CLOG_DIR,
    F_CLOG_GROUP,
    F_CLOG_PAIR,
    F_DELAY_END,
    F_DELAY_SPIKE,
    F_KILL,
    F_LOSS_END,
    F_LOSS_STORM,
    F_RESTART,
    F_UNCLOG_DIR,
    F_UNCLOG_GROUP,
    F_UNCLOG_PAIR,
    Engine,
)

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load_raft_host():
    """Import the example protocol (examples/raft_host_torch.py) — the
    differential harness deliberately reuses the *example* code so the
    comparison covers what users actually write, not a purpose-built
    twin. It loads under the reference's module name, so the request
    classes' RPC type ids (`net/rpc.py`, a hash of module and class
    name) are the reference's."""
    path = os.path.join(_REPO, "examples", "raft_host_torch.py")
    spec = importlib.util.spec_from_file_location("raft_host_example", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


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


def run_host_raft(
    seed: int,
    schedule: List[Dict[str, int]],
    n: int = 5,
    horizon_us: int = 5_000_000,
    node_cls=None,
    base_loss: float = 0.0,
) -> Dict:
    """Run the host-engine example Raft under the pinned `schedule`.

    `base_loss` mirrors the device engine's static
    `EngineConfig.packet_loss_rate`: it is installed in the host fabric at
    setup, storms composite on top of it (rate = min(1, base + a/65536)),
    and F_LOSS_END restores it (not 0.0) — so both engines run under the
    same loss conditions.

    Returns {"violation": None | "ELECTION_SAFETY" | "LOG_MATCHING",
    "elected": bool, "max_commit": int, "chaos_applied": [(t_us, op, a, b)],
    "loss_trace": [(t_us, rate), ...]}.
    """
    from . import time as sim_time
    from .net import NetSim
    from .plugin import simulator
    from .runtime import Handle, Runtime
    from .task import spawn

    ex = _load_raft_host()
    cls = node_cls or ex.RaftNode

    async def scenario():
        handle = Handle.current()
        net = simulator(NetSim)
        # NetSim.config is the outer Config; the fabric reads
        # Network.config == config.net (net/network.py:154) — mutate THAT.
        net.config.net.packet_loss_rate = base_loss
        state: dict = {"loss_trace": [(0, base_loss)]}
        peers = [f"10.3.0.{i+1}:{5000+i}" for i in range(n)]
        nodes = []
        for i in range(n):
            node = (
                handle.create_node()
                .name(f"draft-{i}")
                .ip(f"10.3.0.{i+1}")
                .init(lambda i=i: cls(i, peers, state).run())
                .build()
            )
            nodes.append(node)
        ids = [nd.id for nd in nodes]

        async def chaos():
            applied = state.setdefault("chaos_applied", [])
            start = sim_time.now()

            def group_split(mask_lo, mask_hi):
                # two-word mask: lo carries bits [0, 30), hi [30, 60)
                def bit(i):
                    return (mask_lo >> i) & 1 if i < 30 else (mask_hi >> (i - 30)) & 1

                g = [ids[i] for i in range(n) if bit(i)]
                rest = [ids[i] for i in range(n) if not bit(i)]
                return g, rest

            for ev in schedule:
                target = start + ev["t_us"] / 1e6
                delta = target - sim_time.now()
                if delta > 0:
                    await sim_time.sleep(delta)
                op, a, b = ev["op"], ev["a"], ev["b"]
                if op == F_CLOG_PAIR:
                    net.partition([ids[a]], [ids[b]])
                elif op == F_UNCLOG_PAIR:
                    net.heal([ids[a]], [ids[b]])
                elif op == F_KILL:
                    handle.kill(ids[a])
                elif op == F_RESTART:
                    handle.restart(ids[a])
                elif op == F_CLOG_DIR:
                    net.clog_link(ids[a], ids[b])
                elif op == F_UNCLOG_DIR:
                    net.unclog_link(ids[a], ids[b])
                elif op == F_CLOG_GROUP:
                    net.partition(*group_split(a, b))
                elif op == F_UNCLOG_GROUP:
                    net.heal(*group_split(a, b))
                elif op == F_LOSS_STORM:
                    rate = min(1.0, base_loss + a / 65536.0)
                    net.config.net.packet_loss_rate = rate
                    state["loss_trace"].append((ev["t_us"], rate))
                elif op == F_LOSS_END:
                    net.config.net.packet_loss_rate = base_loss
                    state["loss_trace"].append((ev["t_us"], base_loss))
                elif op == F_DELAY_SPIKE:
                    # device K_DELAY window: ~10% of packets +1-5 s
                    # (the engine's DELAY_PROB/EXTRA constants mirror
                    # these fabric knobs — one semantics, two engines)
                    net.config.net.delay_spike_prob = 0.1
                    state.setdefault("delay_trace", []).append((ev["t_us"], 0.1))
                elif op == F_DELAY_END:
                    net.config.net.delay_spike_prob = 0.0
                    state.setdefault("delay_trace", []).append((ev["t_us"], 0.0))
                applied.append((ev["t_us"], op, a, b))

        spawn(chaos())
        await sim_time.sleep(horizon_us / 1e6)

        violation: Optional[str] = None
        for _term, leaders in state.get("leaders_by_term", {}).items():
            if len(leaders) > 1:
                violation = "ELECTION_SAFETY"
        # committed prefixes must agree pairwise (device invariant twin)
        stable = state.get("stable", {})
        commits = state.get("commits", {})
        for i in commits:
            for j in commits:
                if i >= j:
                    continue
                upto = min(commits[i], commits[j])
                li = stable.get(i, {}).get("log", [])
                lj = stable.get(j, {}).get("log", [])
                for idx in range(1, min(upto + 1, len(li), len(lj))):
                    if li[idx][0] != lj[idx][0]:
                        violation = violation or "LOG_MATCHING"
        return {
            "violation": violation,
            "elected": len(state.get("leaders_by_term", {})) > 0,
            "max_commit": state.get("max_commit", 0),
            "chaos_applied": list(state.get("chaos_applied", [])),
            "loss_trace": list(state.get("loss_trace", [])),
            "delay_trace": list(state.get("delay_trace", [])),
        }

    return Runtime(seed=seed).block_on(scenario())


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
    host_run: Callable[..., Dict] = run_host_raft,
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
