"""Dual-build facade — the Python equivalent of `#[cfg(madsim)]`.

The reference's backbone pattern: every public crate re-exports either
the real implementation or the sim one depending on the `madsim` cfg
flag (reference: madsim/src/lib.rs:15-23, madsim-tokio/src/lib.rs:1-8,
madsim-etcd-client/src/lib.rs:1-8). Python selects at import time:

    # app.py — identical code for test and production
    from madsim_tpu_torch.dual import net
    ep = await net.Endpoint.bind("0.0.0.0:500")

    MADSIM_TPU_MODE=sim  (default) -> simulated fabric, needs a Runtime
    MADSIM_TPU_MODE=real           -> asyncio TCP, runs anywhere

The L5 service clients/servers (`services.etcd/kafka/s3`) are built on
this facade, so an app using them runs unmodified against a real server
in real mode — the analogue of the reference's L5 crates re-exporting
the real client (the port's `services/` runs on it, as the JAX
package's does). `task`, `time`, and `rand` expose the subset of the
sim surface the services use, bound to asyncio/stdlib in real mode. The variables
`MADSIM_TPU_MODE` and `MADSIM_TPU_REAL_PASSTHROUGH` are the JAX
package's, so one environment selects the mode of both packages.
"""

from __future__ import annotations

import os

MODE = os.environ.get("MADSIM_TPU_MODE", "sim")

if MODE == "real":
    from . import real as net  # noqa: F401  (real.Endpoint)
    from .real.compat import rand, task, time  # noqa: F401

    IS_SIM = False
else:
    from . import net  # noqa: F401  (sim Endpoint + fabric)
    from . import rand, task, time  # noqa: F401

    IS_SIM = True

def real_passthrough_enabled() -> bool:
    """Gate for the genuine-backend probes in real mode
    (etcd gRPC / kafka ApiVersions / s3 HTTP). Default on; set
    MADSIM_TPU_REAL_PASSTHROUGH=0 to always use the sim-protocol
    servers and skip the probe latency."""
    return os.environ.get("MADSIM_TPU_REAL_PASSTHROUGH", "1").lower() not in (
        "0", "false", "off",
    )


__all__ = ["net", "task", "time", "rand", "MODE", "IS_SIM", "real_passthrough_enabled"]
