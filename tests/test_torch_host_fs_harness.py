"""The port's fs simulator and seed harness (`madsim_tpu_torch.fs`,
`.runtime.builder`), mirroring tests/test_fs_harness.py case for case.
Each workload runs on the port and on the JAX package
(`torch_host_util.both`): the values, or the exceptions' types and
messages, are equal."""

import pytest

from madsim_tpu_torch.runtime.builder import Builder, test as sim_test

from torch_host_util import JAX, PORT, both


def test_fs_create_read_write():
    def work(m):
        fs = m.fs

        async def main():
            f = await fs.File.create("/data/log")
            await f.write_all_at(b"hello world", 0)
            await f.write_all_at(b"WORLD", 6)
            f2 = await fs.File.open("/data/log")
            data = await f2.read_all()
            meta = await f2.metadata()
            await f.set_len(5)
            return data, meta.len(), await fs.read("/data/log")

        return m.Runtime(seed=1).block_on(main())

    data, size, truncated = both(work)
    assert data == b"hello WORLD"
    assert size == 11
    assert truncated == b"hello"


def test_fs_readonly_enforced():
    def work(m):
        fs = m.fs

        async def main():
            await fs.write("/cfg", b"x")
            fs.set_readonly("/cfg")
            f = await fs.File.open("/cfg")
            with pytest.raises(fs.FsError) as ei:
                await f.write_all_at(b"y", 0)
            return str(ei.value)

        return m.Runtime(seed=1).block_on(main())

    assert both(work)


def test_fs_per_node_isolation():
    def work(m):
        fs = m.fs

        async def main():
            handle = m.Handle.current()
            await fs.write("/shared", b"main")

            async def other():
                with pytest.raises(fs.FsError):
                    await fs.File.open("/shared")  # different node: no such file
                await fs.write("/shared", b"other")

            node = handle.create_node().build()
            await node.spawn(other())
            return await fs.read("/shared")

        return m.Runtime(seed=1).block_on(main())

    assert both(work) == b"main"


def test_builder_multi_seed():
    def work(m):
        results = []

        async def workload():
            v = m.rand.thread_rng().next_u32()
            results.append(v)
            return v

        last = m.runtime.builder.Builder(seed=10, count=5).run(workload)
        return results, last

    results, last = both(work)
    assert len(results) == 5
    assert len(set(results)) == 5  # different seeds -> different draws
    assert last == results[-1]


def test_builder_parallel_processes():
    # jobs>1 runs each seed in its own forked process (real multi-core
    # parallelism, reference builder.rs:121-160); results are returned
    # for the LAST seed and every seed actually executes
    def work(m):
        async def workload():
            v = m.rand.thread_rng().next_u32()
            await m.time.sleep(0.5)
            return v

        B = m.runtime.builder.Builder
        serial = [B(seed=s, count=1).run(workload) for s in range(20, 26)]
        parallel = B(seed=20, count=6, jobs=3).run(workload)
        return serial, parallel

    serial, parallel = both(work)
    assert parallel == serial[-1]  # last seed's result, deterministic


def test_builder_parallel_failure_prints_repro_hint(capfd):
    def work(m):
        async def workload():
            if m.rand.thread_rng().next_u32() % 2 == 0:
                raise AssertionError("invariant violated")
            return "ok"

        B = m.runtime.builder.Builder
        # find a failing seed deterministically first
        failing = None
        for s in range(1, 30):
            try:
                B(seed=s, count=1).run(workload)
            except AssertionError:
                failing = s
                break
        assert failing is not None
        capfd.readouterr()
        with pytest.raises(RuntimeError, match="invariant violated"):
            B(seed=failing, count=1, jobs=2).run(workload)
        err = capfd.readouterr().err
        return failing, [line for line in err.splitlines() if line.startswith("note: ")]

    failing, notes = both(work)
    assert notes == [
        f"note: run with `MADSIM_TEST_SEED={failing}` environment variable to reproduce this failure"
    ]


def test_builder_env(monkeypatch):
    monkeypatch.setenv("MADSIM_TEST_SEED", "7")
    monkeypatch.setenv("MADSIM_TEST_NUM", "3")
    monkeypatch.setenv("MADSIM_TEST_JOBS", "2")
    monkeypatch.setenv("MADSIM_TEST_TIME_LIMIT", "12.5")
    monkeypatch.setenv("MADSIM_TEST_CHECK_DETERMINISM", "1")

    def work(m):
        b = m.runtime.builder.Builder.from_env()
        return b.seed, b.count, b.jobs, b.time_limit, b.check

    b = Builder.from_env()
    assert b.seed == 7 and b.count == 3
    assert both(work) == (7, 3, 2, 12.5, True)


def test_sim_test_decorator():
    @sim_test
    async def my_test():
        await PORT.time.sleep(1.0)
        return "ok", PORT.time.now_ns()

    @JAX.runtime.builder.test
    async def ref_test():
        await JAX.time.sleep(1.0)
        return "ok", JAX.time.now_ns()

    got = my_test()
    assert got[0] == "ok"
    assert got == ref_test()


def test_builder_check_determinism_mode():
    def work(m):
        b = m.runtime.builder.Builder(seed=1, count=2, check=True)

        async def workload():
            rng = m.rand.thread_rng()
            out = []
            for _ in range(5):
                out.append(rng.next_u32())
                await m.time.sleep(0.01)
            return out

        return b.run(workload)  # should not raise

    assert len(both(work)) == 5


def test_fs_power_fail_drops_unsynced_writes():
    # kill == power failure; synced data survives, buffered writes vanish
    def work(m):
        fs = m.fs

        async def main():
            handle = m.Handle.current()
            observed = {}

            async def app():
                f = await fs.File.create("/db")
                await f.write_all_at(b"durable", 0)
                await f.sync_all()
                await f.write_all_at(b"volatile", 7)
                assert await f.read_all() == b"durablevolatile"  # node sees its own writes
                await m.time.sleep(1e9)

            async def app_after_restart():
                observed["data"] = await fs.read("/db")
                await m.time.sleep(1e9)

            node = handle.create_node().init(app).build()
            await m.time.sleep(1.0)
            handle.kill(node.id)  # power failure
            # restart with a different init that inspects the disk
            handle._runtime.executor.nodes[node.id].init = app_after_restart
            handle.restart(node.id)
            await m.time.sleep(1.0)
            return observed["data"]

        return m.Runtime(seed=1).block_on(main())

    assert both(work) == b"durable"


def test_fs_create_truncate_is_unsynced():
    # rewriting a file without sync must not destroy the
    # previously-synced content on power failure
    def work(m):
        fs = m.fs

        async def main():
            handle = m.Handle.current()
            out = {}

            async def app():
                await fs.write("/cfg2", b"v1")          # durable
                f = await fs.File.create("/cfg2")        # truncate (unsynced)
                await f.write_all_at(b"v2-partial", 0)   # unsynced
                await m.time.sleep(1e9)

            async def check():
                out["data"] = await fs.read("/cfg2")
                await m.time.sleep(1e9)

            node = handle.create_node().init(app).build()
            await m.time.sleep(0.5)
            handle.kill(node.id)
            handle._runtime.executor.nodes[node.id].init = check
            handle.restart(node.id)
            await m.time.sleep(0.5)
            return out["data"]

        return m.Runtime(seed=1).block_on(main())

    assert both(work) == b"v1"


def test_fs_namespace_crash_consistency():
    # unsynced create vanishes; unsynced unlink rolls back
    def work(m):
        fs = m.fs

        async def main():
            handle = m.Handle.current()
            out = {}

            async def app():
                f = await fs.File.create("/never-synced")
                await f.write_all_at(b"x", 0)
                await fs.write("/durable", b"keep")  # synced
                await fs.remove_file("/durable")     # unsynced unlink
                await m.time.sleep(1e9)

            async def check():
                try:
                    await fs.File.open("/never-synced")
                    out["ghost"] = True
                except fs.FsError:
                    out["ghost"] = False
                out["durable"] = await fs.read("/durable")  # unlink rolled back
                await m.time.sleep(1e9)

            node = handle.create_node().init(app).build()
            await m.time.sleep(0.5)
            handle.kill(node.id)
            handle._runtime.executor.nodes[node.id].init = check
            handle.restart(node.id)
            await m.time.sleep(0.5)
            return out

        return m.Runtime(seed=1).block_on(main())

    out = both(work)
    assert out["ghost"] is False  # unsynced creation did not survive
    assert out["durable"] == b"keep"  # unsynced unlink was rolled back


def test_builder_config_file_env(monkeypatch, tmp_path):
    # MADSIM_TEST_CONFIG loads a TOML Config (reference: builder.rs:85-93)
    cfg_file = tmp_path / "sim.toml"
    cfg_file.write_text(
        "[net]\npacket_loss_rate = 0.25\n"
        "send_latency_min_ns = 2000000\nsend_latency_max_ns = 3000000\n"
    )
    monkeypatch.setenv("MADSIM_TEST_CONFIG", str(cfg_file))

    def work(m):
        b = m.runtime.builder.Builder.from_env()
        # the loaded config actually shapes the simulation: stable hash differs
        assert b.config.stable_hash() != m.config.Config().stable_hash()
        return b.config.net.packet_loss_rate, b.config.net.send_latency_min_ns, b.config.stable_hash()

    loss, lat_min, _hash = both(work)
    assert loss == 0.25
    assert lat_min == 2_000_000

    # and a bad config raises
    cfg_file.write_text("[net]\npacket_loss_rate = 2.5\n")
    with pytest.raises(ValueError):
        both(lambda m: m.runtime.builder.Builder.from_env())
