"""End-to-end bug hunt on the port: inject a Raft voting bug, find it at
scale on the engine, then debug it with bit-identical replay and trace
diffing.

The port's copy of `examples/bug_hunt.py`, importing `madsim_tpu_torch`.
This is the framework's signature workflow — the reason DST exists:

  1. run thousands of seeds with chaos (partitions, kills, latency)
  2. the on-device ElectionSafety invariant flags failing seeds
  3. replay one failing seed as a single lane, bit-identically, with a
     full trace
  4. diff it against a passing neighbor to find where schedules fork

Run:  python examples/bug_hunt_torch.py [--device cpu]

It runs on the CUDA card unless `--device cpu` is given; without a card
and without `--device cpu` it exits with an error.
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch

from madsim_tpu_torch.engine import Engine, EngineConfig, FaultPlan, replay, replay_diff
from madsim_tpu_torch.engine.machine import node_row, send_if
from madsim_tpu_torch.models import raft as R
from madsim_tpu_torch.models.raft import RaftMachine


class DoubleVoteRaft(RaftMachine):
    """Raft with a classic bug: granting votes without checking whether we
    already voted this term (drop the §5.2 single-vote rule). With normal
    randomized election timeouts the bug only fires when two candidacies
    happen to race — a needle-in-the-haystack for the explorer to find."""

    def on_message(self, nodes, node, src, payload, now_us, rand_u32):
        nodes2, outbox = super().on_message(nodes, node, src, payload, now_us, rand_u32)
        grant_anyway = payload[:, 0] == R.M_RV  # BUG: unconditional grant
        term = node_row(nodes, node)["term"]
        vote = self._pay(R.M_VOTE, torch.maximum(payload[:, 1], term), 1)
        return nodes2, send_if(outbox, 0, grant_anyway, src, vote)


CONFIG = EngineConfig(
    horizon_us=3_000_000,
    queue_capacity=96,
    faults=FaultPlan(n_faults=1, t_max_us=2_000_000),
)


def make_engine(device=None) -> Engine:
    """The hunt's engine on `device` (None: the CUDA card)."""
    return Engine(DoubleVoteRaft(num_nodes=5, log_capacity=8), CONFIG, device=device)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description="Raft double-vote bug hunt on madsim_tpu_torch")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where the engine runs (default: the CUDA card)")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        sys.exit("bug_hunt_torch: no CUDA device; pass --device cpu to run on the CPU")
    eng = make_engine("cpu" if args.device == "cpu" else None)

    print("=== 1. explore: stream seeds through the engine ===")
    out = eng.run_stream(2048, batch=512, segment_steps=192)
    by_code: dict = {}
    for _s, c in out["failing"]:
        by_code[c] = by_code.get(c, 0) + 1
    codes = {R.ELECTION_SAFETY: "ElectionSafety", R.LOG_MATCHING: "LogMatching"}
    summary = ", ".join(f"{n} x {codes.get(c, c)}" for c, n in sorted(by_code.items()))
    print(f"ran {out['completed']} simulations; "
          f"{len(out['failing'])} invariant violations ({summary or 'none'})")
    if not out["failing"]:
        print("no violations found — increase seeds")
        return

    seed, code = out["failing"][0]
    print(f"\n=== 2. replay failing seed {seed} (code {code}) bit-identically ===")
    rp = replay(eng, seed, max_steps=3000)
    print(f"replay: failed={rp.failed} code={rp.fail_code}, "
          f"{len(rp.trace)} events; last 3 before the violation:")
    for ev in rp.trace[-3:]:
        print("   ", ev)

    # a verified-passing neighbor: completed, not failing, not abandoned,
    # not an infra artifact (queue overflow), and confirmed by replay
    # (in-flight-at-exit seeds don't count)
    excluded = (
        {s for s, _ in out["failing"]}
        | {s for s, _ in out["infra"]}
        | set(out["abandoned"])
    )
    passing = None
    for cand in range(out["seeds_consumed"]):
        if cand in excluded:
            continue
        if not replay(eng, cand, max_steps=3000, trace=False).failed:
            passing = cand
            break
    if passing is None:
        print("\n(no passing seed in the explored range — every seed trips "
              "the bug; nothing to diff)")
        return
    print(f"\n=== 3. diff failing seed {seed} vs passing seed {passing} ===")
    replay_diff(eng, seed, passing, max_steps=3000, context=1)


if __name__ == "__main__":
    main()
