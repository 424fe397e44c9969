"""madsim_tpu_torch: the deterministic-simulation engine of `madsim_tpu`,
ported to PyTorch and CUDA.

Thousands of seed lanes of a protocol state machine advance in lockstep
on one NVIDIA H100; the hot prefix of every event step and the coverage
flush are hand-written CUDA kernels (`ops/kernels.py`, `ops/csrc/`),
each with a plain PyTorch twin that the CPU path runs. The same
(seed, config) gives the same lane state, fail codes, digest trail and
coverage map as the JAX package.

Entry points run on the card unless the caller passes `device="cpu"`:

    from madsim_tpu_torch.engine import Engine, EngineConfig, FaultPlan
    from madsim_tpu_torch.models import RaftMachine

The host engine (`runtime`, `task`, `time`, `net`, `fs`, ...) is the
reference's seeded single-threaded async runtime, in pure Python:

    from madsim_tpu_torch import Runtime, Handle, time

This package imports torch, numpy and the standard library only.
"""

from . import buggify, config, rand, time, task, plugin, runtime, sync, net, fs, signal, grpc, services
from .runtime import Runtime, Handle, NodeBuilder, NodeHandle
from .task import spawn
from .errors import (
    SimError,
    Deadlock,
    JoinError,
    TimeLimitExceeded,
    NonDeterminism,
)

__version__ = "0.1.0"

__all__ = [
    "Runtime",
    "Handle",
    "NodeBuilder",
    "NodeHandle",
    "spawn",
    "buggify",
    "config",
    "rand",
    "time",
    "task",
    "plugin",
    "runtime",
    "sync",
    "net",
    "fs",
    "signal",
    "SimError",
    "Deadlock",
    "JoinError",
    "TimeLimitExceeded",
    "NonDeterminism",
]
