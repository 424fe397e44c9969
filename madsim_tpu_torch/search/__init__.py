"""madsim_tpu_torch/search — coverage-feedback guided hunting.

The port of `madsim_tpu/search`: `bias.py` turns the live coverage map's
per-band marginals and harvested failure-lineage words into per-kind
draw weights (plus the recorded fault-vocabulary escalation ladder),
`mutate.py` derives deterministic child seeds for the AFL-style corpus,
`features.py` re-derives candidate schedules with one `init_batch` for
scoring, and `guided.py` runs the `--guided` batch loop with exact
(seed schedule, bias state) recording — checkpoint and resume reproduce
byte-identically, and guidance off leaves the stream path untouched.

`bias` and `mutate` are stdlib only; `features` and `guided` touch the
engine only when called.
"""

from .bias import (  # noqa: F401
    ESCALATION_LADDER,
    BiasState,
    next_escalation,
    vocabulary_for,
)
from .mutate import child_seed, children, mix32  # noqa: F401
