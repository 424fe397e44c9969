"""Shared helper of the tests that hold the port's host engine
(`madsim_tpu_torch.runtime`, `.task`, `.time`, `.net`, ...) against the
JAX package's: a workload written against a package namespace runs on
both, and the two outcomes must be equal."""

from __future__ import annotations

import madsim_tpu
import madsim_tpu.runtime.builder  # noqa: F401  (binds `runtime.builder`)
import madsim_tpu.select  # noqa: F401
import madsim_tpu_torch
import madsim_tpu_torch.runtime.builder  # noqa: F401
import madsim_tpu_torch.select  # noqa: F401

PORT = madsim_tpu_torch
JAX = madsim_tpu


def outcome(work, m):
    """("ok", value) or ("raise", exception type name, message, exception)."""
    try:
        return ("ok", work(m))
    except Exception as exc:  # noqa: BLE001 - compared, then re-raised
        return ("raise", type(exc).__name__, str(exc), exc)


def both(work):
    """`work(m)` on the port (m = `madsim_tpu_torch`) and on the JAX
    package (m = `madsim_tpu`). The two return equal values, or raise
    exceptions of the same type name and message; the port's value is
    returned, or its exception raised."""
    got, ref = outcome(work, PORT), outcome(work, JAX)
    assert got[:3] == ref[:3], (got, ref)
    if got[0] == "raise":
        raise got[3]
    return got[1]
