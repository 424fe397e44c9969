"""Real-mode backends — the not-simulating half of the dual-build story.

The reference compiles every crate twice: with ``--cfg madsim`` the sim
implementations run; without it, the real tokio/tonic/etcd run, and
madsim's own `Endpoint` tag API runs over real TCP with length-delimited
frames and per-peer connection tasks (reference: madsim/src/std/net/
tcp.rs:42-100, rpc.rs:100-140 bincode serialization, plus optional
UCX/eRPC backends).

Python's analogue: `madsim_tpu_torch.real` provides the same `Endpoint` /
RPC surface over asyncio TCP (pickle instead of bincode), so
application code written against the tag API runs unchanged outside the
simulator. Select at import time via `madsim_tpu_torch.dual`
(MADSIM_TPU_MODE=sim|real), the cfg-flag equivalent.
"""

from .net import Endpoint

__all__ = ["Endpoint"]
