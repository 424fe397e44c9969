"""Build the port's CUDA kernels at first use and load them with ctypes.

Each `csrc/*.cu` is compiled by its own `nvcc` process (all started
together) into a shared library with a plain C interface:

    nvcc -gencode arch=compute_90a,code=sm_90a -O3 -std=c++17 -shared -Xcompiler -fPIC

The libraries go to `build/madsim_tpu_torch/<hash>/` beside the package
(`.gitignore` lists `build/`), keyed by a hash of the sources and
flags, so a changed source rebuilds and an unchanged one loads at once.
Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess
from typing import Dict

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = pathlib.Path(__file__).resolve().parents[2] / "build" / "madsim_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-O3", "-std=c++17", "-shared", "-Xcompiler", "-fPIC",
)


def find_nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [os.path.join(cuda_home, "bin", "nvcc")] if cuda_home else []
    candidates += ["/usr/local/cuda/bin/nvcc", shutil.which("nvcc") or ""]
    for path in candidates:
        if path and os.access(path, os.X_OK):
            return path
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin and "
        "PATH): the port's CUDA kernels are built from source at first use"
    )


def _sources_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC.glob("*.cu*")):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def build(verbose: bool = False) -> Dict[str, pathlib.Path]:
    """Compile every `csrc/*.cu` that has no library yet, one nvcc per
    source in parallel. Returns {source stem: library path}. With
    `verbose`, ptxas reports each kernel's registers and shared memory
    on stderr."""
    out_dir = BUILD_ROOT / _sources_hash()
    out_dir.mkdir(parents=True, exist_ok=True)
    libs = {src.stem: out_dir / f"lib{src.stem}.so" for src in sorted(CSRC.glob("*.cu"))}
    pending = {}
    for src in sorted(CSRC.glob("*.cu")):
        lib = libs[src.stem]
        if lib.exists():
            continue
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        cmd = [find_nvcc(), *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
               "-o", str(tmp), str(src)]
        pending[src.stem] = (subprocess.Popen(cmd), tmp, lib, cmd)
    for stem, (proc, tmp, lib, cmd) in pending.items():
        if proc.wait() != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}) building {stem}: {' '.join(cmd)}")
        os.replace(tmp, lib)
    return libs


@functools.lru_cache(maxsize=None)
def load() -> Dict[str, ctypes.CDLL]:
    """Build if needed, then load every kernel library once per process."""
    return {stem: ctypes.CDLL(str(path)) for stem, path in build().items()}
