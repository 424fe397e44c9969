"""The port's virtual time (`madsim_tpu_torch.time`), mirroring
tests/test_time.py case for case. Each workload runs on the port and on
the JAX package (`torch_host_util.both`): the values, or the
exceptions' types and messages, are equal."""

import pytest

from torch_host_util import both


def run(m, coro_factory, seed=1):
    return m.Runtime(seed=seed).block_on(coro_factory())


def test_sleep_advances_virtual_time_instantly():
    def work(m):
        async def main():
            t0 = m.time.now()
            await m.time.sleep(100.0)  # 100 virtual seconds
            return m.time.now() - t0

        return run(m, main)

    elapsed = both(work)
    assert 100.0 <= elapsed < 100.1


def test_sleep_ordering():
    def work(m):
        async def main():
            order = []

            async def sleeper(d, tag):
                await m.time.sleep(d)
                order.append((tag, m.time.now_ns()))

            h1 = m.task.spawn(sleeper(3.0, "c"))
            h2 = m.task.spawn(sleeper(1.0, "a"))
            h3 = m.task.spawn(sleeper(2.0, "b"))
            await h1
            await h2
            await h3
            return order

        return run(m, main)

    assert [tag for tag, _t in both(work)] == ["a", "b", "c"]


def test_timeout_expires():
    def work(m):
        async def main():
            async def forever():
                await m.time.sleep(1e9)

            try:
                await m.time.timeout(2.0, forever())
            except TimeoutError as exc:
                return m.time.now(), str(exc)
            raise AssertionError("should have timed out")

        return run(m, main)

    t, _msg = both(work)
    assert 2.0 <= t < 2.1


def test_timeout_succeeds():
    def work(m):
        async def main():
            async def quick():
                await m.time.sleep(0.5)
                return 99

            return await m.time.timeout(2.0, quick())

        return run(m, main)

    assert both(work) == 99


def test_interval_burst_and_skip():
    def work(m):
        async def main():
            ticks = []
            it = m.time.interval(1.0)
            for _ in range(3):
                await it.tick()
                ticks.append(m.time.now())
            return ticks

        return run(m, main)

    ticks = both(work)
    # first tick immediate, then ~1s apart
    assert ticks[0] < 0.01
    assert 0.99 < ticks[1] - ticks[0] < 1.02
    assert 0.99 < ticks[2] - ticks[1] < 1.02


def test_advance_manual_jump():
    def work(m):
        async def main():
            t0 = m.time.now()
            m.time.advance(3600.0)
            return m.time.now() - t0

        return run(m, main)

    assert both(work) >= 3600.0


def test_instant_and_system_time():
    def work(m):
        async def main():
            i0 = m.time.Instant.now()
            s0 = m.time.SystemTime.now()
            await m.time.sleep(5.0)
            return i0.elapsed(), m.time.SystemTime.now().duration_since(s0), s0.ns_since_epoch()

        return run(m, main)

    elapsed, sys_elapsed, s0 = both(work)
    assert 5.0 <= elapsed < 5.1
    assert 5.0 <= sys_elapsed < 5.1
    # Base wall time is ~2022 + random offset (reference: sim/time/mod.rs:26-31).
    assert s0 > 1_640_000_000 * 10**9


def test_system_time_three_distinct_across_seeds():
    # (reference: sim/time/system_time.rs:122-137)
    def work(m):
        async def main():
            return m.time.SystemTime.now().ns_since_epoch()

        return [m.Runtime(seed=i // 3).block_on(main()) for i in range(9)]

    assert len(set(both(work))) == 3


def test_deadlock_detection():
    def work(m):
        async def main():
            _tx, rx = m.sync.oneshot_channel()
            await rx  # nobody ever sends

        return run(m, main)

    from madsim_tpu_torch.errors import Deadlock

    with pytest.raises(Deadlock):
        both(work)


def test_interval_missed_tick_behaviors():
    # reference: sim/time/interval.rs MissedTickBehavior {Burst, Delay, Skip}
    def work(m):
        def run_with(behavior):
            async def main():
                it = m.time.interval(1.0)
                it.missed_tick_behavior = behavior
                await it.tick()          # immediate first tick
                m.time.advance(3.5)      # miss ~3 ticks
                ticks = []
                for _ in range(3):
                    await it.tick()
                    ticks.append(round(m.time.now(), 2))
                return ticks

            return run(m, main)

        B = m.time.MissedTickBehavior
        return run_with(B.Burst), run_with(B.Delay), run_with(B.Skip)

    burst, delay, skip = both(work)
    # burst catches up: back-to-back late ticks
    assert burst[0] == burst[1] == burst[2] == pytest.approx(3.5, abs=0.1)

    # delay reschedules from now: ~1s apart after the late tick
    assert delay[0] == pytest.approx(3.5, abs=0.1)
    assert delay[1] == pytest.approx(4.5, abs=0.1)
    assert delay[2] == pytest.approx(5.5, abs=0.1)

    # skip drops missed ticks and stays aligned to the original phase
    assert skip[0] == pytest.approx(3.5, abs=0.1)
    assert skip[1] == pytest.approx(4.0, abs=0.1)
    assert skip[2] == pytest.approx(5.0, abs=0.1)


def test_nested_timeouts_cancel_cascade():
    def work(m):
        async def main():
            ran = {"inner": False}

            async def inner():
                await m.time.sleep(10.0)
                ran["inner"] = True
                return "inner-done"

            async def outer():
                return await m.time.timeout(5.0, inner())

            with pytest.raises(TimeoutError):
                await m.time.timeout(2.0, outer())
            t_fired = round(m.time.now(), 2)
            # cancelled inner work must never run (drop-cancels-children)
            await m.time.sleep(20.0)
            return t_fired, ran["inner"]

        return run(m, main)

    t_fired, inner_ran = both(work)
    assert t_fired == pytest.approx(2.0, abs=0.1)  # outer timeout fires first
    assert inner_ran is False


def test_resettable_sleep_deadline_push_and_pull():
    """tokio Sleep parity (reference: sleep.rs deadline/is_elapsed/reset):
    pushing the deadline later delays the wake; pulling it earlier while
    a task is parked wakes earlier; the handle is reusable after firing."""
    def work(m):
        sim_time = m.time

        async def main():
            t0 = sim_time.now()
            timer = sim_time.Sleep.after(1.0)
            assert not timer.is_elapsed()

            # another task pushes the deadline later (heartbeat pattern)
            async def pusher():
                await sim_time.sleep(0.5)
                timer.reset_after(2.0)  # now fires at t=2.5

            h = m.task.spawn(pusher())
            await timer
            assert abs(sim_time.now() - t0 - 2.5) < 1e-6, sim_time.now() - t0
            assert timer.is_elapsed()
            await h

            # pull earlier while parked: a later-armed timer must not hold it
            timer2 = sim_time.Sleep.after(10.0)

            async def puller():
                await sim_time.sleep(0.25)
                timer2.reset_after(0.25)  # fires at t=+0.5, not +10

            t1 = sim_time.now()
            h2 = m.task.spawn(puller())
            await timer2
            assert abs(sim_time.now() - t1 - 0.5) < 1e-6
            await h2

            # reuse after firing
            timer2.reset_after(0.125)
            t2 = sim_time.now()
            await timer2
            assert abs(sim_time.now() - t2 - 0.125) < 1e-6

            # deadline() reports the armed instant
            assert timer2.deadline() <= sim_time.Instant.now()
            return sim_time.now_ns()

        return m.Runtime(seed=3).block_on(main())

    assert both(work) > 0
