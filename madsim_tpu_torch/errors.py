"""Error types of the port."""

from __future__ import annotations


class NonDeterminism(Exception):
    """Two runs of the same seeds gave different results
    (`Engine.check_determinism`): the port's counterpart of madsim's
    "non-determinism detected" (madsim/src/sim/rand.rs:65-90)."""
