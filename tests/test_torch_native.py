"""The port's native C++ core (`madsim_tpu_torch._native`, hostcore.cc):
bit-identity with the port's pure-Python paths (the cases of
tests/test_native.py on the port), with the JAX package's native core,
and a build that never fails quietly where g++ exists.

These tests skip only where there is no g++ (or where
`MADSIM_TPU_NO_NATIVE` asks for the pure path): a broken build is a
failure, never a skip."""

import os
import re
import shutil
import subprocess
import sys

import pytest

from madsim_tpu import _native as jax_native
from madsim_tpu.rand import GlobalRng as JaxGlobalRng
from madsim_tpu_torch import _native
from madsim_tpu_torch.rand import GlobalRng
from madsim_tpu_torch.rand.philox import philox4x32

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

pytestmark = pytest.mark.skipif(
    shutil.which("g++") is None or bool(os.environ.get("MADSIM_TPU_NO_NATIVE")),
    reason="no g++ (or MADSIM_TPU_NO_NATIVE set): the port runs its pure-Python path",
)


def test_native_builds_where_gpp_exists():
    """g++ is here and the pure path was not asked for, so the core must
    have built and loaded, into the gitignored build directory, and the
    host engine's objects must be its types."""
    if not _native.available():
        out = subprocess.run(_native.build_command(os.devnull), capture_output=True, text=True)
        pytest.fail(f"hostcore did not build (g++ exit {out.returncode}):\n{out.stderr[-3000:]}")
    path = _native.so_path()
    assert os.path.exists(path)
    assert os.path.commonpath([path, os.path.join(REPO, "build")]) == os.path.join(REPO, "build")
    mod = _native.get_mod()
    assert mod is not jax_native.get_mod()
    rng = GlobalRng(3)
    assert type(rng._core) is mod.Rng
    assert type(rng._core) is not jax_native.get_mod().Rng


def test_hostcore_imports_only_the_port():
    """Every module the port's core imports is one of the port's: a
    core that bound the JAX package's `future.PENDING` or
    `_context.current_task` would read the other package's loop."""
    with open(os.path.join(REPO, "madsim_tpu_torch", "_native", "hostcore.cc")) as f:
        src = f.read()
    names = re.findall(r'PyImport_ImportModule\("([^"]+)"\)', src)
    assert sorted(names) == ["madsim_tpu_torch._context", "madsim_tpu_torch.future"]
    assert src.count("PyImport_Import") == len(names)


def test_native_philox_matches_python():
    k0, k1 = 0x12345678, 0x9ABCDEF0
    words = _native.philox_fill(k0, k1, 0, 8)
    expected = []
    for block in range(8):
        expected.extend(philox4x32((k0, k1), (block & 0xFFFFFFFF, block >> 32, 0, 0)))
    assert words == expected
    # counter continuation
    words2 = _native.philox_fill(k0, k1, 5, 1)
    assert words2 == expected[20:24]


def test_native_time_core_ordering():
    core = _native.make_time_core()
    fired = []
    core.push(100, lambda: fired.append("b"))
    core.push(50, lambda: fired.append("a"))
    core.push(100, lambda: fired.append("c"))  # same deadline: FIFO by seq
    core.push(50, lambda: fired.append("a2"))
    assert core.peek() == 50
    assert len(core) == 4
    while core.advance_to_next_event():
        pass
    assert fired == ["a", "a2", "b", "c"]
    assert core.now_ns() == 100
    core.advance_ns(17)
    assert core.now_ns() == 117
    assert core.peek() is None


def test_native_rng_matches_global_rng_derived_draws():
    # gen_range/random on the native core use the same bit recipe as the
    # Python GlobalRng methods (low + u64 % span; 53-bit float)
    rng_py = GlobalRng(1234)
    rng_py._core = None  # force the pure-Python buffer path
    core = _native.make_rng(*GlobalRng(1234)._key)
    for _ in range(200):
        assert core.gen_range(50, 101) == rng_py.gen_range(50, 101)
    rng_py2 = GlobalRng(77)
    rng_py2._core = None
    core2 = _native.make_rng(*GlobalRng(77)._key)
    for _ in range(50):
        assert core2.random() == rng_py2.random()
        assert core2.next_u64() == rng_py2.next_u64()


def test_global_rng_same_with_and_without_native():
    rng = GlobalRng(99)
    assert rng._core is not None
    native_draws = [rng.next_u32() for _ in range(1000)]
    # pure python reference
    key = rng._key
    expected = []
    block = 0
    while len(expected) < 1000:
        expected.extend(philox4x32(key, (block & 0xFFFFFFFF, block >> 32, 0, 0)))
        block += 1
    assert native_draws == expected[:1000]


@pytest.mark.parametrize("seed", [0, 7, 2**32 + 1, 2**64 - 1])
def test_native_rng_words_equal_the_jax_packages_native_words(seed):
    """The port's core and the JAX package's core, both live in this
    process, draw the same words, ranges and floats for one seed."""
    port, ref = GlobalRng(seed), JaxGlobalRng(seed)
    assert port._core is not None and ref._core is not None
    assert type(port._core) is not type(ref._core)
    assert [port.next_u32() for _ in range(3000)] == [ref.next_u32() for _ in range(3000)]
    assert [port.next_u64() for _ in range(500)] == [ref.next_u64() for _ in range(500)]
    assert [port.gen_range(-9, 2**40) for _ in range(500)] == [ref.gen_range(-9, 2**40) for _ in range(500)]
    assert [port.random() for _ in range(500)] == [ref.random() for _ in range(500)]


_SCENARIO = """
import madsim_tpu_torch
from madsim_tpu_torch import time as sim_time
from madsim_tpu_torch.runtime import Runtime, Handle
from madsim_tpu_torch.net import Endpoint, Request

class Ping(Request):
    def __init__(self, v): self.v = v

async def scenario():
    handle = Handle.current()
    state = {"sum": 0}
    async def serve():
        ep = await Endpoint.bind("0.0.0.0:77")
        async def on_ping(req, data):
            state["sum"] += req.v
            return req.v
        ep.add_rpc_handler(Ping, on_ping)
        await sim_time.sleep(1e9)
    srv = handle.create_node().ip("10.0.3.1").init(serve).restart_on_panic().build()
    client = handle.create_node().ip("10.0.3.2").build()
    async def drive():
        ep = await Endpoint.bind("0.0.0.0:0")
        rng = madsim_tpu_torch.rand.thread_rng()
        out = []
        for i in range(30):
            try:
                out.append(await ep.call_timeout("10.0.3.1:77", Ping(i), 1.0))
            except TimeoutError:
                out.append(-1)
            if rng.gen_bool(0.2):
                handle.kill(srv.id); handle.restart(srv.id)
            await sim_time.sleep(rng.random() * 0.1)
        return out, state["sum"], sim_time.now_ns()
    return await client.spawn(drive())

from madsim_tpu_torch import _native
print(_native.available())
print(repr(Runtime(seed=11).block_on(scenario())))
"""


def test_full_sim_identical_without_native(tmp_path):
    script = tmp_path / "scen.py"
    script.write_text(_SCENARIO)
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO
    with_native = subprocess.run(
        [sys.executable, str(script)], env=env, capture_output=True, text=True, check=True
    ).stdout
    env["MADSIM_TPU_NO_NATIVE"] = "1"
    without_native = subprocess.run(
        [sys.executable, str(script)], env=env, capture_output=True, text=True, check=True
    ).stdout
    assert with_native.startswith("True\n") and without_native.startswith("False\n")
    assert with_native.split("\n", 1)[1] == without_native.split("\n", 1)[1]
    assert "Traceback" not in with_native
