"""Draw observation in the port's native core for check mode (the cases
of tests/test_native_check.py on the port): `MADSIM_TEST_CHECK_DETERMINISM`
validates the loop users actually run. With the native core present,
every draw — including the C drive loop's internal scheduling/advance
draws — is hashed inside hostcore (splitmix64((idx << 32) ^ value ^
now_ns), the twin of GlobalRng._record), so check mode keeps the native
loop engaged. One more case holds the port's native draw log equal to
the JAX package's native log on one workload.

These tests skip only where there is no g++ (or where
`MADSIM_TPU_NO_NATIVE` asks for the pure path)."""

import os
import shutil
import subprocess
import sys

import pytest

import madsim_tpu
import madsim_tpu.runtime  # noqa: F401  (binds `madsim_tpu.runtime`)
import madsim_tpu_torch
from madsim_tpu_torch import _native
from madsim_tpu_torch import rand as sim_rand
from madsim_tpu_torch import time as sim_time
from madsim_tpu_torch.errors import NonDeterminism
from madsim_tpu_torch.runtime import Runtime

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

native = pytest.mark.skipif(
    shutil.which("g++") is None or bool(os.environ.get("MADSIM_TPU_NO_NATIVE")),
    reason="no g++ (or MADSIM_TPU_NO_NATIVE set): the port runs its pure-Python path",
)


def _make_workload(m):
    async def workload():
        rng = m.rand.thread_rng()
        out = []

        async def worker(i):
            await m.time.sleep(rng.random() * 0.01)
            out.append((i, rng.gen_range(0, 1000)))

        handle = m.runtime.Handle.current()
        node = handle.create_node().build()
        for i in range(4):
            node.spawn(worker(i))
        await m.time.sleep(0.1)
        return tuple(out)

    return workload


_workload = _make_workload(madsim_tpu_torch)


@native
def test_check_mode_keeps_native_loop_engaged():
    """enable_log with a native core activates core observation and the
    executor's condition keeps mod.drive selected (the whole point)."""
    rt = Runtime(seed=5)
    rt.rng.enable_log()
    assert rt.rng.native_observing
    assert rt.rng.recording
    r = rt.block_on(_workload())
    log = rt.rng.take_log()
    assert len(log) > 0
    assert not rt.rng.native_observing
    assert len(r) == 4


@native
def test_native_and_python_observation_hash_identically():
    """The native core's draw hashes equal the Python _record hashes for
    the same seed/workload — so a log taken on one loop checks the
    other (cross-loop determinism contract)."""
    rt1 = Runtime(seed=9)
    rt1.rng.enable_log()
    r1 = rt1.block_on(_workload())
    native_log = rt1.rng.take_log()

    # a runtime with the native core disabled from birth (construction
    # itself draws — the random wall-clock base — so the stream must be
    # pure-Python from word 0)
    old_available = _native.available
    try:
        _native.available = lambda: False
        rt2 = Runtime(seed=9)
    finally:
        _native.available = old_available
    assert rt2.rng._core is None
    rt2.rng.enable_log()
    r2 = rt2.block_on(_workload())
    python_log = rt2.rng.take_log()

    assert r1 == r2
    assert native_log == python_log


@native
def test_native_check_passes_clean_and_catches_planted_nondeterminism():
    # clean workload: two native-loop runs agree draw-for-draw
    assert Runtime.check_determinism(11, _workload) is not None

    # planted nondeterminism: the second run draws differently
    calls = [0]

    async def flaky():
        calls[0] += 1
        rng = sim_rand.thread_rng()
        n = 3 if calls[0] == 1 else 4
        vals = [rng.next_u32() for _ in range(n)]
        await sim_time.sleep(0.01)
        return len(vals)

    with pytest.raises(NonDeterminism):
        Runtime.check_determinism(12, flaky)


@native
def test_native_check_catches_schedule_divergence_details():
    """The mismatch message carries draw index + sim time, like the
    Python path and the reference's panic (sim/rand.rs:65-90)."""
    calls = [0]

    async def skew():
        calls[0] += 1
        rng = sim_rand.thread_rng()
        if calls[0] > 1:
            rng.next_u32()  # one extra draw shifts every later hash
        return await _workload()

    with pytest.raises(NonDeterminism, match="draw #"):
        Runtime.check_determinism(13, skew)


@native
def test_raft_example_parity_native_vs_python_path():
    """The port's Raft example produces IDENTICAL results on the native
    path (C loop + native mailbox) and the pure-Python path for the same
    seeds."""
    code = """
import sys
sys.path.insert(0, %r)
sys.path.insert(0, %r)
import raft_host_torch
from madsim_tpu_torch import _native
from madsim_tpu_torch.runtime import Runtime
print(_native.available())
for seed in range(5):
    r = Runtime(seed=seed).block_on(raft_host_torch.scenario())
    print(seed, sorted(r.items()))
""" % (REPO, os.path.join(REPO, "examples"))

    def run(extra_env):
        env = dict(os.environ)
        env.update(extra_env)
        out = subprocess.run(
            [sys.executable, "-c", code], env=env, capture_output=True,
            text=True, timeout=300,
        )
        assert out.returncode == 0, out.stderr
        return out.stdout.split("\n", 1)

    native_on, native_out = run({})
    python_on, python_out = run({"MADSIM_TPU_NO_NATIVE": "1"})
    assert (native_on, python_on) == ("True", "False")
    assert native_out == python_out
    assert len(native_out.strip().splitlines()) == 5


@native
@pytest.mark.parametrize("seed", [9, 21])
def test_native_draw_log_equals_the_jax_packages(seed):
    """One workload on the port's native loop and on the JAX package's:
    the same values and the same hashed draw log, both cores observing
    in C."""
    def logged(m):
        rt = m.runtime.Runtime(seed=seed)
        rt.rng.enable_log()
        assert rt.rng.native_observing
        value = rt.block_on(_make_workload(m)())
        return value, rt.rng.take_log()

    port_value, port_log = logged(madsim_tpu_torch)
    jax_value, jax_log = logged(madsim_tpu)
    assert len(port_log) > 10
    assert port_value == jax_value
    assert port_log == jax_log
