"""The port's cross-engine differential (`madsim_tpu_torch.differential`)
against the JAX package's, mirroring tests/test_differential.py: the
port's device side (fault schedules from `init_batch`, verdicts from
one `run_batch`) with the host Raft passed in as `host_run` (the JAX
package's `run_host_raft`). Every report equals the one the JAX
package's `differential_raft` gives on the same seeds: schedules,
device verdicts, host verdicts, `schedule_ok` and the aggregates. The
batched rows equal per-seed `fault_schedule` / `run_device_raft`. The
bugged pair and the loss storms are in
tests/test_torch_differential_chaos.py. The `_own_host_run` cases run the
port's own host Raft (`madsim_tpu_torch.differential.run_host_raft`,
the default `host_run`) and hold the whole report equal to the JAX
package's."""

import pytest

from madsim_tpu.differential import fault_schedule as jax_fault_schedule
from madsim_tpu.differential import run_host_raft
from madsim_tpu.models.raft import RaftMachine as JaxRaft
from madsim_tpu_torch.differential import differential_raft, fault_schedule, run_device_raft
from madsim_tpu_torch.differential import run_host_raft as own_run_host_raft
from madsim_tpu_torch.engine.core import F_DELAY_SPIKE
from madsim_tpu_torch.models.raft import RaftMachine

from torch_port_util import differential_engines as _engines
from torch_port_util import raft_differential as _both
from torch_port_util import raft_differential_own_host as _both_own

N_SEEDS = 12


@pytest.fixture(scope="module")
def raft_engines():
    return _engines(JaxRaft(5, 8), RaftMachine(5, 8),
                    dict(n_faults=2, t_max_us=3_000_000, dur_min_us=200_000, dur_max_us=800_000))


def test_fault_schedule_is_pure_and_ordered(raft_engines):
    jax_eng, eng = raft_engines
    s1 = fault_schedule(eng, 7)
    s2 = fault_schedule(eng, 7)
    assert s1 == s2  # pure function of (seed, plan)
    assert len(s1) == 4  # 2 faults x (apply + undo)
    times = [e["t_us"] for e in s1]
    assert times == sorted(times)
    # undo pairs each apply: op+1 appears for every even op
    ops = [e["op"] for e in s1]
    for op in ops:
        if op % 2 == 0:
            assert op + 1 in ops
    for seed in (0, 7, 123, 2_000_000_000):
        assert fault_schedule(eng, seed) == jax_fault_schedule(jax_eng, seed), seed


def test_correct_raft_agrees_across_engines(raft_engines):
    """The 'one semantics spec' contract: under identical pinned fault
    schedules, both engines uphold every safety invariant on every
    seed, apply the chaos stream event-for-event, and (modulo scheduler
    timing) both elect leaders; the port's report is the JAX package's."""
    report = _both(raft_engines, range(N_SEEDS))
    assert report["schedule_mismatches"] == 0, report
    assert report["device_violations"] == 0, report
    assert report["host_violations"] == 0, report
    assert report["safety_disagreements"] == 0
    # liveness is timing-dependent, not bit-pinned: allow slack but
    # require both engines to elect on the vast majority of seeds
    assert report["device_elected"] >= N_SEEDS - 2, report
    assert report["host_elected"] >= N_SEEDS - 2, report


def test_batched_rows_equal_per_seed_runs(raft_engines):
    """`differential_raft` takes every schedule from one `init_batch` and
    every device verdict from one `run_batch`: lanes are independent, so
    each row equals the seed run alone."""
    _, eng = raft_engines
    seeds = [0, 5, 9]
    rows = differential_raft(eng, seeds, run_host_raft)["rows"]
    for seed, row in zip(seeds, rows):
        assert row["schedule"] == fault_schedule(eng, seed)
        assert row["device"] == run_device_raft(eng, seed)


def test_host_schedule_replay_covers_v2_kinds():
    """Directional clogs, group partitions and loss storms from the
    port's schedule translate to host chaos ops and apply at the
    scheduled times; each schedule is the JAX package's."""
    jax_eng, eng = _engines(JaxRaft(5, 8), RaftMachine(5, 8),
                            dict(n_faults=3, allow_partition=False, allow_kill=False, allow_dir_clog=True,
                                 allow_group=True, allow_storm=True, t_max_us=3_000_000))
    for seed in range(6):
        sched = fault_schedule(eng, seed)
        assert sched == jax_fault_schedule(jax_eng, seed)
        out = run_host_raft(seed, sched, horizon_us=eng.config.horizon_us)
        assert out["violation"] is None
        assert out["chaos_applied"] == [
            (e["t_us"], e["op"], e["a"], e["b"]) for e in sched
        ]


def test_delay_spike_windows_apply_on_both_engines():
    """Delay-spike windows translate to the host fabric's delay-spike
    knobs at the scheduled times, the schedules agree event for event,
    and correct Raft stays safe under the delay vocabulary on BOTH
    engines; the port's report equals the JAX package's."""
    engines = _engines(JaxRaft(5, 8), RaftMachine(5, 8),
                       dict(n_faults=3, allow_partition=False, allow_kill=False, allow_delay=True,
                            t_max_us=3_000_000, dur_min_us=200_000, dur_max_us=800_000))
    out = _both(engines, range(4), max_steps=4000)
    assert out["schedule_mismatches"] == 0
    assert out["safety_disagreements"] == 0
    assert out["device_violations"] == 0 and out["host_violations"] == 0
    spiked_rows = [r for r in out["rows"] if any(e["op"] == F_DELAY_SPIKE for e in r["schedule"])]
    assert spiked_rows and all(r["host"]["delay_trace"] for r in spiked_rows)


def test_correct_raft_agrees_with_the_ports_own_host_run(raft_engines):
    """The whole differential inside the port: its device side and its
    own host runtime agree on every seed, the report equals the JAX
    package's, and `differential_raft` with no `host_run` gives the
    report it gives with the JAX package's `run_host_raft` passed in."""
    report = _both_own(raft_engines, range(N_SEEDS))
    assert report["schedule_mismatches"] == 0, report
    assert report["device_violations"] == 0, report
    assert report["host_violations"] == 0, report
    assert report["safety_disagreements"] == 0
    assert report["device_elected"] >= N_SEEDS - 2, report
    assert report["host_elected"] >= N_SEEDS - 2, report
    _, eng = raft_engines
    assert differential_raft(eng, range(N_SEEDS), run_host_raft) == report
    assert differential_raft(eng, range(N_SEEDS), own_run_host_raft) == report


def test_delay_spike_windows_with_the_ports_own_host_run():
    """Delay-spike windows reach the port's own host fabric at the
    scheduled times; the report equals the JAX package's."""
    engines = _engines(JaxRaft(5, 8), RaftMachine(5, 8),
                       dict(n_faults=3, allow_partition=False, allow_kill=False, allow_delay=True,
                            t_max_us=3_000_000, dur_min_us=200_000, dur_max_us=800_000))
    out = _both_own(engines, range(4), max_steps=4000)
    assert out["schedule_mismatches"] == 0
    assert out["safety_disagreements"] == 0
    assert out["device_violations"] == 0 and out["host_violations"] == 0
    spiked_rows = [r for r in out["rows"] if any(e["op"] == F_DELAY_SPIKE for e in r["schedule"])]
    assert spiked_rows and all(r["host"]["delay_trace"] for r in spiked_rows)
