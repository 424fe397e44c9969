"""The port's host engine held equal to the JAX package's on whole
workloads: the RNG's words and draws, the order of a timer storm with
tied deadlines, the Raft example's results and its event trace,
`run_host_raft` under every fault kind the differential schedules, the
seed harness's reproduction line, and `check_determinism` on a workload
that reads the wall clock. Where g++ exists both packages run their
native cores here (`_native/hostcore.cc`); `run_host_raft` is also held
against the port's pure-Python path (`MADSIM_TPU_NO_NATIVE=1`)."""

import importlib.util
import json
import os
import re
import subprocess
import sys
import time as wall_time

import pytest

import madsim_tpu_torch
from madsim_tpu.differential import run_host_raft as jax_run_host_raft
from madsim_tpu.models.raft import RaftMachine as JaxRaft
from madsim_tpu_torch import errors
from madsim_tpu_torch.differential import fault_schedules, run_host_raft
from madsim_tpu_torch.engine.core import F_LOSS_END, F_LOSS_STORM
from madsim_tpu_torch.models.raft import RaftMachine

from torch_host_util import JAX, PORT, both
from torch_port_util import differential_engines

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# the differential's fixture (tests/test_differential.py:21-28)
FIXTURE_FAULTS = dict(n_faults=2, t_max_us=3_000_000, dur_min_us=200_000, dur_max_us=800_000)


def load_example(name):
    path = os.path.join(REPO, "examples", name)
    spec = importlib.util.spec_from_file_location("raft_host_example", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


EXAMPLES = {PORT: "raft_host_torch.py", JAX: "raft_host.py"}


# -- the RNG -------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 42, 2**63 + 5])
def test_global_rng_words_and_draws(seed):
    def work(m):
        rng = m.rand.GlobalRng(seed)
        words = [rng.next_u32() for _ in range(10_000)]
        ranges = [rng.gen_range(lo, hi) for lo, hi in
                  [(0, 2), (0, 7), (-5, 5), (10, 2**40), (0, 2**64), (-(2**70), 2**70)] * 50]
        floats = [rng.random() for _ in range(200)]
        xs = list(range(100))
        rng.shuffle(xs)
        return words, ranges, floats, xs, rng.gen_bytes(13), rng.choice("abcdefg")

    words, *_ = both(work)
    assert len(words) == 10_000 and len(set(words)) > 9_990


# -- the clock -------------------------------------------------------------------


def test_timer_storm_with_ties_fires_in_the_same_order():
    """Timers on a bare `TimeHandle` with tied deadlines fire in push
    order; 300 tasks sleeping to tied deadlines wake in the same
    (random, seeded) order with the same virtual times."""
    def bare(m):
        th = m.time.TimeHandle(m.rand.GlobalRng(9))
        fired = []
        for i in range(500):
            th.add_timer_ns((i * 7919) % 13 * 1_000, lambda i=i: fired.append((i, th.now_ns())))
        while th.advance_to_next_event():
            pass
        return fired, th.base_system_ns

    fired, _base = both(bare)
    assert [t for _i, t in fired] == sorted(t for _i, t in fired)

    def storm(m):
        async def main():
            woke = []

            async def sleeper(i):
                start = m.time.Instant(0)
                for r in range(3):
                    await m.time.sleep_until(start + (r + 1) * 0.001 * (1 + i % 4))
                    woke.append((i, r, m.time.now_ns()))

            hs = [m.task.spawn(sleeper(i)) for i in range(300)]
            for h in hs:
                await h
            return woke

        return m.Runtime(seed=5).block_on(main())

    woke = both(storm)
    assert len(woke) == 900
    assert [i for i, _r, _t in woke[:300]] != sorted(i for i, _r, _t in woke[:300])


# -- the Raft example ------------------------------------------------------------


def test_raft_example_scenario_results_seeds_0_to_15():
    def work(m):
        ex = load_example(EXAMPLES[m])
        return [m.Runtime(seed=s).block_on(ex.scenario()) for s in range(16)]

    out = both(work)
    assert all(r["terms_with_leader"] > 0 for r in out)


def test_raft_example_event_trace_seeds_0_to_3(monkeypatch):
    """Every protocol event of the example's scenario (a campaign, a
    heartbeat round, each vote and append handled, each term change) and
    every chaos op (partition, heal, kill, restart) as (virtual ns, node,
    event, term): the same log. The JAX package polls its tasks in its
    native core, so the trace is taken at the protocol's own methods."""
    def work(m):
        ex = load_example(EXAMPLES[m])
        log = []

        def note(event, node, term=None):
            log.append((m.time.now_ns(), node, event, term))

        class TracedNode(ex.RaftNode):
            async def campaign(self, ep):
                note("campaign", self.me, self.term)
                await super().campaign(ep)

            async def heartbeat(self, ep):
                note("heartbeat", self.me, self.term)
                await super().heartbeat(ep)

            def become_follower(self, term):
                note("follow", self.me, term)
                super().become_follower(term)

            async def on_request_vote(self, req, data):
                rsp = await super().on_request_vote(req, data)
                note(f"vote-for-{req.candidate}:{rsp['granted']}", self.me, rsp["term"])
                return rsp

            async def on_append_entries(self, req, data):
                rsp = await super().on_append_entries(req, data)
                note(f"append-from-{req.leader}:{rsp['ok']}", self.me, rsp["term"])
                return rsp

        def traced(patch, cls, name, fmt):
            orig = getattr(cls, name)

            def wrapper(self, *args):
                note(name, fmt(*args))
                return orig(self, *args)

            patch.setattr(cls, name, wrapper)

        with monkeypatch.context() as patch:
            patch.setattr(ex, "RaftNode", TracedNode)
            traced(patch, m.runtime.Handle, "kill", lambda node: node)
            traced(patch, m.runtime.Handle, "restart", lambda node: node)
            traced(patch, m.net.NetSim, "partition", lambda a, b: (tuple(a), tuple(b)))
            traced(patch, m.net.NetSim, "heal", lambda a, b: (tuple(a), tuple(b)))
            results = [m.Runtime(seed=s).block_on(ex.scenario()) for s in range(4)]
        return results, log

    _results, log = both(work)
    events = {e.split("-")[0] for _t, _n, e, _term in log}
    assert {"campaign", "heartbeat", "follow", "vote", "append", "kill", "restart", "partition", "heal"} <= events


# -- run_host_raft ---------------------------------------------------------------


def _fixture_schedules():
    """(seed, schedule, horizon_us, base_loss) rows: the differential's
    fixture seeds 0-11, and the loss storms, base-loss composite, v2
    kinds and delay spikes of tests/test_differential.py:104-204."""
    rows = []
    _, eng = differential_engines(JaxRaft(5, 8), RaftMachine(5, 8), FIXTURE_FAULTS)
    rows += [(s, sc, 5_000_000, 0.0) for s, sc in zip(range(12), fault_schedules(eng, range(12)))]
    full_storm = [{"t_us": 0, "op": F_LOSS_STORM, "a": 65535, "b": 0}]
    lifted = full_storm + [{"t_us": 1_000_000, "op": F_LOSS_END, "a": 0, "b": 0}]
    rows += [(s, full_storm, 3_000_000, 0.0) for s in range(4)]
    rows += [(s, lifted, 3_000_000, 0.0) for s in range(4)]
    rows.append((0, [{"t_us": 100_000, "op": F_LOSS_STORM, "a": 32768, "b": 0},
                     {"t_us": 200_000, "op": F_LOSS_END, "a": 0, "b": 0}], 400_000, 0.25))
    _, v2 = differential_engines(JaxRaft(5, 8), RaftMachine(5, 8),
                                 dict(n_faults=3, allow_partition=False, allow_kill=False, allow_dir_clog=True,
                                      allow_group=True, allow_storm=True, t_max_us=3_000_000))
    rows += [(s, sc, 5_000_000, 0.0) for s, sc in zip(range(6), fault_schedules(v2, range(6)))]
    _, spikes = differential_engines(JaxRaft(5, 8), RaftMachine(5, 8),
                                     dict(n_faults=3, allow_partition=False, allow_kill=False, allow_delay=True,
                                          t_max_us=3_000_000, dur_min_us=200_000, dur_max_us=800_000))
    rows += [(s, sc, 5_000_000, 0.0) for s, sc in zip(range(4), fault_schedules(spikes, range(4)))]
    return rows


def test_run_host_raft_equals_jax_on_every_fault_kind():
    rows = _fixture_schedules()
    kinds = set()
    for seed, sched, horizon, base in rows:
        got = run_host_raft(seed, sched, horizon_us=horizon, base_loss=base)
        want = jax_run_host_raft(seed, sched, horizon_us=horizon, base_loss=base)
        assert got == want, (seed, sched)
        kinds |= {e["op"] for e in sched}
    assert len(kinds) >= 10  # pair, kill, dir, group, storm, delay: apply and undo


_PURE_HOST_RAFT = """
import json, sys
from madsim_tpu_torch import _native
from madsim_tpu_torch.differential import run_host_raft
assert not _native.available()
schedules = json.load(open(sys.argv[1]))
print(json.dumps([run_host_raft(seed, sched) for seed, sched in enumerate(schedules)]))
"""


def test_run_host_raft_native_pure_and_jax_agree(tmp_path):
    """`run_host_raft` on the differential's 16 fixture seeds: the port
    on its native core, the port on its pure-Python path (a process
    under `MADSIM_TPU_NO_NATIVE=1`) and the JAX package give the same
    reports."""
    _, eng = differential_engines(JaxRaft(5, 8), RaftMachine(5, 8), FIXTURE_FAULTS)
    schedules = fault_schedules(eng, range(16))
    native = [run_host_raft(seed, sched) for seed, sched in enumerate(schedules)]
    jax = [jax_run_host_raft(seed, sched) for seed, sched in enumerate(schedules)]
    assert native == jax
    path = tmp_path / "schedules.json"
    path.write_text(json.dumps(schedules))
    out = subprocess.run([sys.executable, "-c", _PURE_HOST_RAFT, str(path)], cwd=REPO, capture_output=True,
                         text=True, timeout=300, env=dict(os.environ, MADSIM_TPU_NO_NATIVE="1"))
    assert out.returncode == 0, out.stderr[-2000:]
    assert json.loads(out.stdout) == json.loads(json.dumps(native))
    assert sum(r["elected"] for r in native) >= 8


# -- the seed harness ------------------------------------------------------------


@pytest.mark.parametrize("jobs", [1, 2])
def test_builder_failure_line(capfd, jobs):
    def work(m):
        async def workload():
            if m.rand.thread_rng().next_u32() % 3 == 0:
                raise AssertionError("invariant violated")
            return "ok"

        capfd.readouterr()
        try:
            m.runtime.builder.Builder(seed=1, count=12, jobs=jobs).run(workload)
        except (AssertionError, RuntimeError) as exc:
            failed = type(exc).__name__
        else:
            failed = None
        return failed, [line for line in capfd.readouterr().err.splitlines() if line.startswith("note: ")]

    failed, notes = both(work)
    assert failed is not None
    assert notes and all(re.fullmatch(
        r"note: run with `MADSIM_TEST_SEED=\d+` environment variable to reproduce this failure", n) for n in notes)


# -- the determinism check -------------------------------------------------------


def test_check_determinism_catches_a_wall_clock_read():
    """A workload whose virtual sleep comes from the wall clock diverges
    at the first draw after the sleep, on both packages; the messages
    agree but for the virtual time, which is the wall clock's."""
    def work(m):
        t0 = wall_time.monotonic_ns()

        async def workload():
            rng = m.rand.thread_rng()
            rng.next_u32()
            await m.time.sleep(1e-9 * (1 + (wall_time.monotonic_ns() - t0)))
            rng.next_u32()

        try:
            m.Runtime.check_determinism(7, workload)
        except m.errors.NonDeterminism as exc:
            return re.sub(r"sim time \d+ ns", "sim time <t> ns", str(exc))
        return None

    msg = both(work)
    assert msg is not None and msg.startswith("non-determinism detected at draw #")


def test_nondeterminism_is_a_sim_error():
    """The port's `NonDeterminism` derives from `SimError`, as the
    reference's does, and its message for a divergence is the reference's."""
    assert issubclass(errors.NonDeterminism, errors.SimError)
    assert madsim_tpu_torch.NonDeterminism is errors.NonDeterminism
    assert [c.__name__ for c in errors.NonDeterminism.__mro__] == [
        c.__name__ for c in JAX.errors.NonDeterminism.__mro__]

    def fewer_draws(m):
        runs = []

        async def workload():
            runs.append(1)
            rng = m.rand.thread_rng()
            for _ in range(5 if len(runs) == 1 else 3):
                rng.next_u32()

        m.Runtime.check_determinism(3, workload)

    with pytest.raises(errors.SimError, match="second run made 5 RNG draws but the first made 7"):
        both(fewer_draws)

    def changed_draw(m):
        runs = []

        async def workload():
            runs.append(1)
            rng = m.rand.thread_rng()
            await m.time.sleep(0.25 * len(runs))
            rng.next_u32()

        m.Runtime.check_determinism(3, workload)

    with pytest.raises(errors.NonDeterminism, match=r"non-determinism detected at draw #\d+, sim time \d+ ns"):
        both(changed_draw)
