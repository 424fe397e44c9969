"""Native core loader — builds hostcore.cc (a CPython extension) with g++
on first use.

The reference runtime is native Rust; here the host engine's hot inner
loops (Philox RNG, the virtual clock + timer heap, the executor's
random-order poll loop, the tag mailbox and the datagram send path) run
in C++ as a real extension module — method calls cost nanoseconds, not
the microseconds of a ctypes round trip. Everything degrades to pure
Python with identical semantics when no toolchain is available
(`MADSIM_TPU_NO_NATIVE=1` forces the fallback); bit-identity between the
two paths is asserted by tests/test_torch_native.py.

The library goes to `build/madsim_tpu_torch/native/` beside the package
(`.gitignore` lists `build/`, as for the CUDA kernels of `ops/build.py`),
keyed by a hash of the source and the interpreter's ABI.
"""

from __future__ import annotations

import hashlib
import importlib.machinery
import importlib.util
import os
import subprocess
import sysconfig
from typing import Any, List, Optional

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "hostcore.cc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_HERE)), "build", "madsim_tpu_torch", "native")

_mod: Optional[Any] = None
_tried = False


def so_path() -> str:
    """Where the extension for this source and interpreter lives."""
    with open(_SRC, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    # key the cache by the interpreter ABI too — the extension links
    # against Python.h internals, so a stale .so from another Python
    # version must trigger a rebuild, not a segfault
    abi = sysconfig.get_config_var("SOABI") or "abi3"
    return os.path.join(BUILD_DIR, f"hostcore-{digest}-{abi}.so")


def build_command(out: str) -> List[str]:
    """The g++ command that compiles hostcore.cc into `out`."""
    include = sysconfig.get_paths()["include"]
    return ["g++", "-O2", "-shared", "-fPIC", "-std=c++17", f"-I{include}", "-o", out, _SRC]


def _build_and_load() -> Optional[Any]:
    if os.environ.get("MADSIM_TPU_NO_NATIVE"):
        return None
    try:
        path = so_path()
        if not os.path.exists(path):
            os.makedirs(BUILD_DIR, exist_ok=True)
            tmp = f"{path}.{os.getpid()}.tmp"  # unique: concurrent builders don't clobber
            subprocess.run(build_command(tmp), check=True, capture_output=True)
            os.replace(tmp, path)
        loader = importlib.machinery.ExtensionFileLoader("hostcore", path)
        spec = importlib.util.spec_from_file_location("hostcore", path, loader=loader)
        assert spec is not None
        mod = importlib.util.module_from_spec(spec)
        loader.exec_module(mod)
        return mod
    except Exception:  # noqa: BLE001 - no toolchain / build failure: fall back
        return None


def get_mod() -> Optional[Any]:
    global _mod, _tried
    if not _tried:
        _mod = _build_and_load()
        _tried = True
    return _mod


def available() -> bool:
    return get_mod() is not None


def philox_fill(k0: int, k1: int, start_block: int, nblocks: int) -> List[int]:
    """nblocks philox blocks as a flat list of 4*nblocks uint32 words —
    bit-identical to repeated rand/philox.py `philox4x32` calls."""
    mod = get_mod()
    assert mod is not None
    return mod.philox_fill(k0, k1, start_block, nblocks)


def make_rng(k0: int, k1: int):
    """A native buffered Philox draw stream (see hostcore.Rng)."""
    mod = get_mod()
    assert mod is not None
    return mod.Rng(k0, k1)


def make_time_core():
    """The native virtual clock + timer heap (see hostcore.TimeCore)."""
    mod = get_mod()
    assert mod is not None
    return mod.TimeCore()


def run_all_ready(executor, ctx, rng_core, time_core) -> None:
    """The native executor poll loop (see hostcore.run_all_ready)."""
    mod = get_mod()
    assert mod is not None
    mod.run_all_ready(executor, ctx, rng_core, time_core)
