"""Build the port's CUDA kernels at first use and load them with ctypes.

Each `csrc/*.cu` is compiled by its own `nvcc` process (all started
together) into a shared library with a plain C interface:

    nvcc -gencode arch=compute_90a,code=sm_90a -O3 -std=c++17 -shared -Xcompiler -fPIC

The libraries go to `build/madsim_tpu_torch/<hash>/` beside the package
(`.gitignore` lists `build/`), keyed by a hash of the sources and
flags, so a changed source rebuilds and an unchanged one loads at once.
Another source tree (`csrc=`) builds into its own directory:
chip_smoke.py's head-to-head of two kernel designs.
Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import re
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


def _sources_hash(csrc: pathlib.Path) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(csrc.glob("*.cu*")):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def build(verbose: bool = False, csrc: pathlib.Path = CSRC) -> Dict[str, pathlib.Path]:
    """Compile every `*.cu` of `csrc` that has no library yet, one nvcc
    per source in parallel. Returns
    {source stem: library path}. With `verbose`, ptxas reports each
    kernel's registers, shared memory and spills into `<stem>.ptxas.txt`
    beside the library (see `ptxas_report`); a library built without
    one is built again."""
    out_dir = BUILD_ROOT / _sources_hash(csrc)
    out_dir.mkdir(parents=True, exist_ok=True)
    libs = {src.stem: out_dir / f"lib{src.stem}.so" for src in sorted(csrc.glob("*.cu"))}
    pending = {}
    for src in sorted(csrc.glob("*.cu")):
        lib, report = libs[src.stem], out_dir / f"{src.stem}.ptxas.txt"
        if lib.exists() and (report.exists() or not verbose):
            continue
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        cmd = [find_nvcc(), *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
               "-o", str(tmp), str(src)]
        log = open(report, "w") if verbose else None
        pending[src.stem] = (subprocess.Popen(cmd, stderr=log), tmp, lib, cmd, log)
    for stem, (proc, tmp, lib, cmd, log) in pending.items():
        code = proc.wait()
        if log is not None:
            log.close()
        if code != 0:
            detail = pathlib.Path(log.name).read_text()[-4000:] if log is not None else ""
            raise RuntimeError(f"nvcc failed ({code}) building {stem}: {' '.join(cmd)}\n{detail}")
        os.replace(tmp, lib)
    return libs


def ptxas_report(libs: Dict[str, pathlib.Path]) -> Dict[str, dict]:
    """What ptxas said of each kernel of a verbose `build`: {mangled
    kernel name: {registers, smem_bytes, spill_stores, spill_loads}}, for
    the sources whose report exists."""
    out = {}
    for stem, lib in libs.items():
        path = lib.parent / f"{stem}.ptxas.txt"
        if not path.exists():
            continue
        name = None
        for line in path.read_text().splitlines():
            m = re.search(r"Compiling entry function '([^']+)'", line)
            if m:
                name = m.group(1)
                out[name] = {"registers": None, "smem_bytes": 0, "spill_stores": None, "spill_loads": None}
            elif name is not None:
                m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
                if m:
                    out[name]["spill_stores"], out[name]["spill_loads"] = int(m.group(1)), int(m.group(2))
                m = re.search(r"Used (\d+) registers", line)
                if m:
                    out[name]["registers"] = int(m.group(1))
                m = re.search(r"(\d+) bytes smem", line)
                if m:
                    out[name]["smem_bytes"] = int(m.group(1))
    return out


@functools.lru_cache(maxsize=None)
def load(csrc: pathlib.Path = CSRC) -> Dict[str, ctypes.CDLL]:
    """Build if needed, then load every kernel library of `csrc` once per
    process."""
    return {stem: ctypes.CDLL(str(path)) for stem, path in build(csrc=csrc).items()}
