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

# kind name -> FaultPlan field, in K_* index order.
KIND_TO_FLAG = (
    ("pair", "allow_partition"),
    ("kill", "allow_kill"),
    ("dir", "allow_dir_clog"),
    ("group", "allow_group"),
    ("storm", "allow_storm"),
    ("delay", "allow_delay"),
    ("pause", "allow_pause"),
    ("skew", "allow_skew"),
    ("torn", "allow_torn"),
    ("heal-asym", "allow_heal_asym"),
)

# The two chaos gates that are FaultPlan flags but not scheduled kinds
# (shrink ablates them too).
EXTRA_FLAGS = (
    ("dup", "allow_dup"),
    ("strict-restart", "strict_restart"),
)

# Coverage band names: bands 0/1 are the event classes, bands 2..7 the
# first six scheduled kinds; the 4-bit layout appends the rest.
COV_BAND_NAMES = ("timer", "msg", "pair", "kill", "dir", "group", "storm", "delay")
COV_BAND_NAMES_V2 = COV_BAND_NAMES + (
    "pause", "skew", "dup", "amnesia",
    "torn", "heal_asym", "reserved14", "reserved15",
)

FLAG_BY_KIND = dict(KIND_TO_FLAG + EXTRA_FLAGS)
KIND_BY_FLAG = {field: name for name, field in KIND_TO_FLAG + EXTRA_FLAGS}
