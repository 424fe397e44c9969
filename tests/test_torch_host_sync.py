"""The port's sync primitives (`madsim_tpu_torch.sync`, `.select`) and
the tokio facade's `JoinSet` and fake runtime (`madsim_tpu_torch.tokio`),
mirroring tests/test_sync.py case for case (its `test_select_and_joinset`
as `test_select` and `test_joinset_and_fake_runtime`). Each workload
runs on the port and on the JAX package (`torch_host_util.both`): the
values, or the exceptions' types and messages, are equal."""

import pytest

import madsim_tpu.tokio  # noqa: F401  (binds `madsim_tpu.tokio`)
import madsim_tpu_torch.tokio  # noqa: F401
from torch_host_util import both


def run(m, coro_factory, seed=1):
    return m.Runtime(seed=seed).block_on(coro_factory())


def test_oneshot():
    def work(m):
        async def main():
            tx, rx = m.sync.oneshot_channel()

            async def sender():
                await m.time.sleep(1.0)
                tx.send("hello")

            m.task.spawn(sender())
            return await rx, m.time.now_ns()

        return run(m, main)

    assert both(work)[0] == "hello"


def test_oneshot_closed():
    def work(m):
        async def main():
            tx, rx = m.sync.oneshot_channel()
            tx.close()
            with pytest.raises(m.errors.RecvError) as ei:
                await rx
            return str(ei.value)

        return run(m, main)

    assert both(work)


def test_mpsc_bounded_backpressure():
    def work(m):
        async def main():
            tx, rx = m.sync.mpsc_channel(2)
            sent = []

            async def producer():
                for i in range(5):
                    await tx.send(i)
                    sent.append(i)

            m.task.spawn(producer())
            await m.time.sleep(1.0)
            assert len(sent) == 2  # blocked at capacity
            got = [await rx.recv() for _ in range(5)]
            return got

        return run(m, main)

    assert both(work) == [0, 1, 2, 3, 4]


def test_mpsc_close_raises():
    def work(m):
        async def main():
            tx, rx = m.sync.mpsc_unbounded_channel()
            tx.try_send(1)
            tx.close()  # last sender gone
            assert await rx.recv() == 1
            with pytest.raises(m.errors.RecvError):
                await rx.recv()
            with pytest.raises(m.errors.TryRecvError) as ei:
                rx.try_recv()
            return ei.value.disconnected

        return run(m, main)

    assert both(work) in (True, False)


def test_watch():
    def work(m):
        async def main():
            tx, rx = m.sync.watch_channel(0)
            seen = []

            async def watcher():
                while rx.borrow() < 3:
                    await rx.changed()
                    seen.append(rx.borrow_and_update())

            h = m.task.spawn(watcher())

            async def setter():
                for i in range(1, 4):
                    await m.time.sleep(1.0)
                    tx.send(i)

            m.task.spawn(setter())
            await h
            return seen

        return run(m, main)

    assert both(work) == [1, 2, 3]


def test_mutex_mutual_exclusion():
    def work(m):
        async def main():
            mutex = m.sync.Mutex(0)
            trace = []

            async def worker(tag):
                guard = await mutex.lock()
                with guard:
                    trace.append((tag, "in"))
                    await m.time.sleep(1.0)
                    trace.append((tag, "out"))

            hs = [m.task.spawn(worker(i)) for i in range(3)]
            for h in hs:
                await h
            return trace

        return run(m, main)

    trace = both(work)
    # critical sections never interleave
    for i in range(0, len(trace), 2):
        assert trace[i][0] == trace[i + 1][0]
        assert trace[i][1] == "in" and trace[i + 1][1] == "out"


def test_rwlock():
    def work(m):
        async def main():
            lock = m.sync.RwLock(0)
            r1 = await lock.read()
            r2 = await lock.read()  # concurrent readers OK
            with r1, r2:
                pass
            w = await lock.write()
            with w:
                lock.value = 5
            return lock.value

        return run(m, main)

    assert both(work) == 5


def test_semaphore():
    def work(m):
        async def main():
            sem = m.sync.Semaphore(2)
            active = {"n": 0, "max": 0}

            async def worker():
                async with _permit(sem):
                    active["n"] += 1
                    active["max"] = max(active["max"], active["n"])
                    await m.time.sleep(1.0)
                    active["n"] -= 1

            class _permit:
                def __init__(self, sem):
                    self.sem = sem

                async def __aenter__(self):
                    self.p = await self.sem.acquire()

                async def __aexit__(self, *exc):
                    self.p.release()

            hs = [m.task.spawn(worker()) for _ in range(6)]
            for h in hs:
                await h
            return active["max"]

        return run(m, main)

    assert both(work) == 2


def test_notify():
    def work(m):
        async def main():
            n = m.sync.Notify()
            log = []

            async def waiter():
                await n.notified()
                log.append("woke")

            m.task.spawn(waiter())
            await m.time.sleep(1.0)
            n.notify_one()
            await m.time.sleep(1.0)
            return log

        return run(m, main)

    assert both(work) == ["woke"]


def test_barrier():
    def work(m):
        async def main():
            b = m.sync.Barrier(3)
            leaders = []

            async def worker(i):
                await m.time.sleep(i * 1.0)
                is_leader = await b.wait()
                leaders.append(is_leader)

            hs = [m.task.spawn(worker(i)) for i in range(3)]
            for h in hs:
                await h
            return leaders

        return run(m, main)

    leaders = both(work)
    assert sum(leaders) == 1
    assert len(leaders) == 3


def test_broadcast():
    def work(m):
        async def main():
            tx, rx1 = m.sync.broadcast_channel(16)
            rx2 = tx.subscribe()
            tx.send("a")
            tx.send("b")
            return [await rx1.recv(), await rx1.recv(), await rx2.recv(), await rx2.recv()]

        return run(m, main)

    assert both(work) == ["a", "b", "a", "b"]


def test_select():
    """The `select` half of tests/test_sync.py::test_select_and_joinset."""
    def work(m):
        async def main():
            async def fast():
                await m.time.sleep(1.0)
                return "fast"

            async def slow():
                await m.time.sleep(5.0)
                return "slow"

            idx, value = await m.select.select(slow(), fast())
            return idx, value, m.time.now_ns()

        return run(m, main)

    idx, value, _now = both(work)
    assert (idx, value) == (1, "fast")


def test_joinset_and_fake_runtime():
    """The `tokio.JoinSet` half of tests/test_sync.py::test_select_and_joinset."""
    def work(m):
        async def main():
            async def fast():
                await m.time.sleep(1.0)
                return "fast"

            js = m.tokio.JoinSet()
            for d, tag in ((3.0, "c"), (1.0, "a"), (2.0, "b")):
                async def job(d=d, tag=tag):
                    await m.time.sleep(d)
                    return tag
                js.spawn(job())
            sizes = [js.len()]
            order = [await js.join_next() for _ in range(3)]
            sizes.append(js.len())
            last = await js.join_next()

            # fake runtime forwards spawn, refuses block_on
            rt = m.tokio.runtime.Builder.new_multi_thread().enable_all().build()
            h = rt.spawn(fast())
            spawned = await h
            never_run = fast()
            with pytest.raises(NotImplementedError) as ei:
                rt.block_on(never_run)
            never_run.close()  # block_on refused it; silence the un-awaited warning
            return order, last, sizes, spawned, str(ei.value), m.time.now_ns()

        return run(m, main)

    order, last, sizes, spawned, refusal, _now = both(work)
    assert order == ["a", "b", "c"] and last is None
    assert sizes == [3, 0]
    assert spawned == "fast" and "cannot block_on inside a simulation" in refusal


def test_joinset_failed_task_does_not_poison():
    def work(m):
        async def main():
            js = m.tokio.JoinSet()

            async def bad():
                raise ValueError("task failed")

            async def good():
                await m.time.sleep(1.0)
                return "good"

            # an unhandled task panic normally aborts the sim; JoinSet holds
            # the handle, so the panic is routed to join_next instead
            js.spawn(good())
            results = []
            errors = []
            for _ in range(1):
                try:
                    results.append(await js.join_next())
                except ValueError as e:
                    errors.append(str(e))
            return results, errors

        return run(m, main)

    assert both(work) == (["good"], [])
