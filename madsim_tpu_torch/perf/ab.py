"""Interleaved A/B gate costing — paired deltas on a drifting box.

The port of `madsim_tpu/perf/ab.py`, host math copied as it is. A
one-rep cost, a MEDIAN of early reps against a SINGLE late rep, misreads
a gate on a host whose throughput drifts ±10% across a bench (the
reference once read the provenance gate at 8% where an interleaved A/B
measured 0.61%). The fix is the standard paired design:

* run A and B as ABAB… alternating reps in ONE process over IDENTICAL
  disjoint seed ranges (pair i of A and pair i of B consume the same
  seeds — the determinism contract makes the workloads bit-identical,
  so any rate difference is the gate, not the work);
* compute the PER-PAIR delta (a_i - b_i) / a_i — slow drift hits both
  halves of a pair nearly equally and cancels; a monotone 10% drift
  that would swamp an absolute comparison shifts a paired delta by at
  most the drift across ONE rep;
* report the MEDIAN of deltas with a seeded-bootstrap 95% CI and an
  exact two-sided sign test — so every per-gate number ships with "how
  sure are we" instead of arriving as a bare point.

Pure host math (numpy optional at call time, stdlib otherwise); the
callables being timed do the device work.
"""

from __future__ import annotations

# madsim: allow-file(D001) — the A/B harness's contract is timing host reps with the wall clock
# (perf_counter around opaque rep callables). No simulation state is
# derived from these reads.
import dataclasses
import math
import statistics
import time
from typing import Callable, List, Sequence, Tuple

# The default interleaved pair count per gate of a bench's gate costing
# (the reference's bench.py reads it; MADSIM_TPU_BENCH_AB_PAIRS
# overrides it there). A 2-pair bootstrap CI is the degenerate [min,
# max] of two deltas, a straddle no budget decision can stand on; 5
# paired deltas give the median real resampling room (the CI narrows
# roughly with sqrt(pairs)). Pinned in tests/test_torch_perf.py:
# changing it is a measurement-protocol change and should look like one.
DEFAULT_BENCH_AB_PAIRS = 5


def sign_test_p(deltas: Sequence[float]) -> float:
    """Exact two-sided sign test p-value: probability under H0 (median
    delta == 0, signs are fair coins) of a positive-count at least as
    extreme as observed. Zero deltas are discarded (the standard
    conditioning). Returns 1.0 when nothing remains."""
    signs = [d for d in deltas if d != 0]
    n = len(signs)
    if n == 0:
        return 1.0
    k = sum(1 for d in signs if d > 0)
    tail = min(k, n - k)
    p = sum(math.comb(n, i) for i in range(tail + 1)) / 2 ** n
    return min(2.0 * p, 1.0)


def bootstrap_ci(
    deltas: Sequence[float],
    n_boot: int = 4000,
    seed: int = 0,
    lo_pct: float = 2.5,
    hi_pct: float = 97.5,
) -> Tuple[float, float]:
    """Seeded percentile bootstrap CI of the median of `deltas`.
    Deterministic for a given (deltas, n_boot, seed) — the CI is part of
    a recorded bench artifact, so it must replay. With one delta the CI
    degenerates to that point (honest: one pair proves nothing)."""
    xs = list(deltas)
    if not xs:
        raise ValueError("bootstrap_ci needs at least one delta")
    if len(xs) == 1:
        return (xs[0], xs[0])
    import numpy as np

    rng = np.random.default_rng(seed)
    arr = np.asarray(xs, dtype=np.float64)
    idx = rng.integers(0, len(arr), size=(n_boot, len(arr)))
    meds = np.median(arr[idx], axis=1)
    return (
        float(np.percentile(meds, lo_pct)),
        float(np.percentile(meds, hi_pct)),
    )


def paired_stats(deltas: Sequence[float], n_boot: int = 4000, seed: int = 0) -> dict:
    """Summary statistics for a sequence of paired deltas (any unit —
    bench.py feeds percent slowdown): median, seeded-bootstrap 95% CI,
    exact sign-test p, n."""
    xs = [float(d) for d in deltas]
    if not xs:
        raise ValueError("paired_stats needs at least one delta")
    lo, hi = bootstrap_ci(xs, n_boot=n_boot, seed=seed)
    return {
        "median": statistics.median(xs),
        "ci95": [lo, hi],
        "sign_p": sign_test_p(xs),
        "n": len(xs),
    }


@dataclasses.dataclass
class ABResult:
    """One interleaved A/B measurement. Rates are units/second; deltas
    are percent slowdown of B relative to A per pair:
    100 * (a_i - b_i) / a_i (positive = B is slower)."""

    label_a: str
    label_b: str
    rates_a: List[float]
    rates_b: List[float]
    deltas_pct: List[float]
    median_a: float
    median_b: float
    median_delta_pct: float
    ci95_pct: Tuple[float, float]
    sign_p: float
    order: List[str]  # executed rep order, e.g. ["A","B","A","B"]

    def to_dict(self) -> dict:
        return {
            "a": self.label_a,
            "b": self.label_b,
            "rates_a": [round(x, 1) for x in self.rates_a],
            "rates_b": [round(x, 1) for x in self.rates_b],
            "deltas_pct": [round(x, 3) for x in self.deltas_pct],
            "median_a": round(self.median_a, 1),
            "median_b": round(self.median_b, 1),
            "median_delta_pct": round(self.median_delta_pct, 3),
            "ci95_pct": [round(self.ci95_pct[0], 3), round(self.ci95_pct[1], 3)],
            "sign_p": round(self.sign_p, 4),
            "pairs": len(self.deltas_pct),
        }

    def summary(self) -> str:
        lo, hi = self.ci95_pct
        return (
            f"{self.label_b} vs {self.label_a}: median paired delta "
            f"{self.median_delta_pct:+.2f}% (95% CI [{lo:+.2f}%, {hi:+.2f}%], "
            f"sign p={self.sign_p:.3f}, {len(self.deltas_pct)} pairs; "
            f"median {self.median_a:.1f} vs {self.median_b:.1f} units/s)"
        )


def interleaved_ab(
    rep_a: Callable[[int], int],
    rep_b: Callable[[int], int],
    pairs: int = 4,
    seed_start: int = 3_000_000,
    seeds_per_rep: int = 0,
    label_a: str = "A",
    label_b: str = "B",
    n_boot: int = 4000,
    clock: Callable[[], float] = time.perf_counter,
    recorder=None,
) -> ABResult:
    """Run `pairs` ABAB… alternating rep pairs and return paired stats.

    `rep_a(seed_start)` / `rep_b(seed_start)` run ONE rep over the seed
    range starting at `seed_start` and return the number of completed
    units (seeds); the harness owns the timing. Pair i hands BOTH reps
    the same seed_start (identical workload by the determinism
    contract), advancing by `seeds_per_rep` between pairs (0 = reuse
    the same range every pair, which is also sound — the workload is a
    pure function of the seeds).

    Callers must warm BOTH variants (compile + one untimed rep) before
    calling — the harness measures steady state, not compilation.
    `recorder` (a PerfRecorder) optionally wraps each rep in a span
    `ab_rep:<label>` so A/B reps land on the host timeline."""
    if pairs < 1:
        raise ValueError("interleaved_ab needs pairs >= 1")
    rates_a: List[float] = []
    rates_b: List[float] = []
    order: List[str] = []

    def timed(rep, label: str, start: int) -> float:
        import contextlib

        ctx = (
            recorder.span(f"ab_rep:{label}")
            if recorder is not None
            else contextlib.nullcontext()
        )
        with ctx:
            t0 = clock()
            done = rep(start)
            elapsed = max(clock() - t0, 1e-9)
        order.append(label)
        return done / elapsed

    for i in range(pairs):
        start = seed_start + i * seeds_per_rep
        rates_a.append(timed(rep_a, label_a, start))
        rates_b.append(timed(rep_b, label_b, start))

    deltas = [100.0 * (a - b) / a for a, b in zip(rates_a, rates_b)]
    st = paired_stats(deltas, n_boot=n_boot)
    return ABResult(
        label_a=label_a,
        label_b=label_b,
        rates_a=rates_a,
        rates_b=rates_b,
        deltas_pct=deltas,
        median_a=statistics.median(rates_a),
        median_b=statistics.median(rates_b),
        median_delta_pct=st["median"],
        ci95_pct=(st["ci95"][0], st["ci95"][1]),
        sign_p=st["sign_p"],
        order=order,
    )
