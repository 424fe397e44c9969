"""The port's executor and node model (`madsim_tpu_torch.task`,
`.runtime`), mirroring tests/test_task.py case for case. Each workload
runs on the port and on the JAX package (`torch_host_util.both`): the
values, or the exceptions' types and messages, are equal."""

import gc
import weakref

import pytest

from torch_host_util import both


def test_spawn_join():
    def work(m):
        async def child():
            await m.time.sleep(1.0)
            return 42

        async def main():
            return await m.task.spawn(child())

        return m.Runtime(seed=1).block_on(main())

    assert both(work) == 42


def test_abort_task():
    def work(m):
        async def main():
            flag = {"ran": False}

            async def child():
                await m.time.sleep(10.0)
                flag["ran"] = True

            h = m.task.spawn(child())
            await m.time.sleep(1.0)
            h.abort()
            with pytest.raises(m.errors.JoinError) as ei:
                await h
            assert ei.value.is_cancelled()
            await m.time.sleep(20.0)
            return flag["ran"], m.time.now_ns()

        return m.Runtime(seed=1).block_on(main())

    ran, _now = both(work)
    assert ran is False


def test_kill_node_drops_tasks_and_runs_finally():
    def work(m):
        async def main():
            handle = m.Handle.current()
            log = []

            async def server():
                try:
                    await m.time.sleep(1e9)
                finally:
                    log.append(("cleanup", m.time.now_ns()))  # Drop impl equivalent

            node = handle.create_node().name("srv").build()
            node.spawn(server())
            await m.time.sleep(1.0)
            handle.kill(node.id)
            await m.time.sleep(1.0)
            return log

        return m.Runtime(seed=1).block_on(main())

    assert [tag for tag, _t in both(work)] == ["cleanup"]


def test_restart_reruns_init():
    def work(m):
        async def main():
            handle = m.Handle.current()
            counter = {"starts": 0}

            async def service():
                counter["starts"] += 1
                await m.time.sleep(1e9)

            node = handle.create_node().init(service).build()
            await m.time.sleep(1.0)
            assert counter["starts"] == 1
            handle.restart(node.id)
            await m.time.sleep(1.0)
            return counter["starts"]

        return m.Runtime(seed=1).block_on(main())

    assert both(work) == 2


def test_pause_resume():
    def work(m):
        async def main():
            handle = m.Handle.current()
            progress = {"n": 0}

            async def worker():
                while True:
                    await m.time.sleep(1.0)
                    progress["n"] += 1

            node = handle.create_node().build()
            node.spawn(worker())
            await m.time.sleep(5.5)
            n_before = progress["n"]
            handle.pause(node.id)
            await m.time.sleep(10.0)
            n_paused = progress["n"]
            handle.resume(node.id)
            await m.time.sleep(5.0)
            return n_before, n_paused, progress["n"]

        return m.Runtime(seed=1).block_on(main())

    n_before, n_paused, n_after = both(work)
    assert n_before == 5
    assert n_paused == n_before  # no progress while paused
    assert n_after > n_paused


def test_restart_on_panic():
    def work(m):
        async def main():
            handle = m.Handle.current()
            starts = []

            async def flaky():
                starts.append(m.time.now_ns())
                if len(starts) < 3:
                    raise RuntimeError("boom")
                await m.time.sleep(1e9)

            handle.create_node().init(flaky).restart_on_panic().build()
            # restart backoff is 1-10s per attempt (reference :296-314)
            await m.time.sleep(60.0)
            return starts

        return m.Runtime(seed=1).block_on(main())

    # the same random backoffs on both packages
    assert len(both(work)) == 3


def test_unhandled_panic_fails_simulation():
    def work(m):
        async def main():
            async def bad():
                raise ValueError("unhandled")

            m.task.spawn(bad())
            await m.time.sleep(10.0)

        return m.Runtime(seed=1).block_on(main())

    with pytest.raises(ValueError, match="unhandled"):
        both(work)


def test_schedule_chaos_distinct_interleavings():
    # 10 seeds should produce several distinct interleavings
    # (reference: sim/task/mod.rs:1017-1041 asserts 10/10).
    def work(m):
        def run_seed(seed):
            async def main():
                order = []
                tx, rx = m.sync.mpsc_unbounded_channel()

                async def worker(i):
                    for _ in range(3):
                        await m.task.yield_now()
                    order.append(i)
                    await tx.send(i)

                for i in range(5):
                    m.task.spawn(worker(i))
                for _ in range(5):
                    await rx.recv()
                return tuple(order)

            return m.Runtime(seed=seed).block_on(main())

        outcomes = [run_seed(s) for s in range(10)]
        # and the same seed reproduces exactly
        assert run_seed(3) == outcomes[3]
        return outcomes

    assert len(set(both(work))) >= 5


def test_time_limit():
    def work(m):
        async def main():
            await m.time.sleep(1e6)

        rt = m.Runtime(seed=1)
        rt.set_time_limit(100.0)
        rt.block_on(main())

    from madsim_tpu_torch.errors import TimeLimitExceeded

    with pytest.raises(TimeLimitExceeded):
        both(work)


def test_ctrl_c_with_and_without_handler():
    def work(m):
        async def main():
            handle = m.Handle.current()
            log = []

            async def graceful():
                await m.signal.ctrl_c()
                log.append("got ctrl-c")

            node1 = handle.create_node().init(graceful).build()
            node2 = handle.create_node().init(lambda: m.time.sleep(1e9)).build()
            await m.time.sleep(1.0)
            handle.send_ctrl_c(node1.id)
            handle.send_ctrl_c(node2.id)  # no handler -> killed
            await m.time.sleep(1.0)
            return log, handle.is_killed(node1.id), handle.is_killed(node2.id)

        return m.Runtime(seed=1).block_on(main())

    log, n1_killed, n2_killed = both(work)
    assert log == ["got ctrl-c"]
    assert not n1_killed
    assert n2_killed


def test_metrics():
    def work(m):
        async def main():
            handle = m.Handle.current()
            node = handle.create_node().name("workers").build()
            for _ in range(3):
                node.spawn(m.time.sleep(100.0))
            await m.time.sleep(1.0)
            rt = handle._runtime
            metrics = rt.metrics()
            return metrics.num_nodes(), metrics.num_tasks_by_node().get("workers"), metrics.num_tasks()

        return m.Runtime(seed=1).block_on(main())

    num_nodes, workers, _tasks = both(work)
    assert num_nodes >= 2
    assert workers == 3


def test_spawn_on_killed_node_is_noop():
    def work(m):
        async def main():
            handle = m.Handle.current()
            node = handle.create_node().build()
            handle.kill(node.id)
            h = node.spawn(m.time.sleep(1.0))
            with pytest.raises(m.errors.JoinError) as ei:
                await h
            return str(ei.value)

        return m.Runtime(seed=1).block_on(main())

    assert both(work) == "node is killed"


def test_task_local_scoped_per_task():
    def work(m):
        LOCAL = m.task.TaskLocal()

        async def main():
            results = {}

            async def worker(tag):
                with LOCAL.scope(tag):
                    await m.time.sleep(1.0)  # interleave with the other worker
                    results[tag] = LOCAL.get()
                assert LOCAL.try_get("unset") == "unset"

            h1 = m.task.spawn(worker("a"))
            h2 = m.task.spawn(worker("b"))
            await h1
            await h2
            with pytest.raises(LookupError):
                LOCAL.get()
            return results

        return m.Runtime(seed=1).block_on(main())

    assert both(work) == {"a": "a", "b": "b"}


def test_task_local_isolated_across_runtimes():
    # ids restart per Runtime; values must not bleed
    def work(m):
        LOCAL = m.task.TaskLocal()

        async def leaky():
            async def stuck():
                with LOCAL.scope("stale"):
                    await m.time.sleep(1e9)  # still in scope at teardown

            m.task.spawn(stuck())
            await m.time.sleep(1.0)

        m.Runtime(seed=1).block_on(leaky())

        async def fresh():
            async def probe():
                return LOCAL.try_get("clean")

            return await m.task.spawn(probe())

        return m.Runtime(seed=2).block_on(fresh())

    assert both(work) == "clean"


def test_hostname_and_default_node_names():
    """Reference 0.2.34: the default node is `madsim-main`, unnamed
    nodes are `madsim-node-{id}`, and hostname() returns the current
    node's name."""
    def work(m):
        async def main():
            handle = m.Handle.current()
            names = [m.runtime.hostname()]

            unnamed = handle.create_node().build()
            named = handle.create_node().name("web-1").build()

            async def report():
                names.append(m.runtime.hostname())

            await unnamed.spawn(report())
            await named.spawn(report())
            return names

        return m.Runtime(seed=1).block_on(main())

    got = both(work)
    assert got[0] == "madsim-main"
    assert got[1].startswith("madsim-node-")
    assert got[2] == "web-1"


def test_runtime_graphs_are_reclaimed_across_sims():
    """Back-to-back sims, each ending with a task parked on a timer,
    must leave no executor (runtime graph) alive once collected."""
    def work(m):
        async def scenario():
            handle = m.Handle.current()
            a = handle.create_node().name("leak-a").ip("10.99.0.1").build()

            async def srv():
                await m.net.Endpoint.bind("0.0.0.0:700")
                await m.time.sleep(10)  # parked on a timer at teardown

            a.spawn(srv())
            await m.time.sleep(0.5)

        probes = []
        for seed in range(20):
            rt = m.Runtime(seed=seed)
            rt.block_on(scenario())
            # track only THIS test's executors: counting every live
            # TaskEntry process-wide would trip on unrelated retention
            probes.append(weakref.ref(rt.executor))
        del rt
        gc.collect()
        return sum(1 for w in probes if w() is not None)

    alive = both(work)
    assert alive == 0, f"{alive}/20 executors (runtime graphs) survived collection"
