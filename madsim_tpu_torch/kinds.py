"""The fault-kind vocabulary of the port (its own copy of the table the
JAX package keeps in `madsim_tpu/kinds.py`).

`FAULT_KIND_NAMES` order is the `K_*` index space of `engine/core.py`:
the indices are baked into recorded fault schedules, so the tuple only
ever grows at the tail. `tests/test_torch_engine.py` holds this copy
equal to the reference table.
"""

from __future__ import annotations

# Scheduled fault kinds, indexed by engine/core.py's K_* constants.
FAULT_KIND_NAMES = (
    "pair", "kill", "dir", "group", "storm", "delay", "pause", "skew",
    "torn", "heal-asym",
)

# Non-scheduled chaos channels (flight-recorder extra counters).
FR_EXTRA_NAMES = ("dup", "amnesia")

# Coverage band names: bands 0/1 are the event classes, bands 2..7 the
# first six scheduled kinds; the 4-bit layout appends the rest.
COV_BAND_NAMES = ("timer", "msg", "pair", "kill", "dir", "group", "storm", "delay")
COV_BAND_NAMES_V2 = COV_BAND_NAMES + (
    "pause", "skew", "dup", "amnesia",
    "torn", "heal_asym", "reserved14", "reserved15",
)
