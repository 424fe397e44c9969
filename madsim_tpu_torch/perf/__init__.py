"""Wall-clock observability of the port: host-timeline tracing, the
device capture and the merged three-clock plane, interleaved A/B gate
costing, and drift-aware bench history.

The port of `madsim_tpu/perf/`. Everything here is HOST-side: it
measures what the Python host loop and the card do in real time. It never
touches the simulation's RNG streams, event schedules, or any
device-visible value, so results are equal with it on or off.

* `recorder`: `PerfRecorder` + contextvar span API (`maybe_span`),
  Chrome/Perfetto host-timeline export (`--perf-timeline`, `perf`);
* `xprof`: device-phase ranges, clock-sync markers, the
  `torch.profiler` capture and the merged plane (`prof`);
* `ab`: interleaved ABAB... paired-delta gate costing with bootstrap CI
  and sign test (`bench-ab`);
* `history`: the port's bench history rows with its own fingerprint.
"""

from .ab import ABResult, bootstrap_ci, interleaved_ab, paired_stats, sign_test_p
from .recorder import PerfRecorder, current_recorder, maybe_count, maybe_span

__all__ = [
    "ABResult",
    "PerfRecorder",
    "bootstrap_ci",
    "current_recorder",
    "interleaved_ab",
    "maybe_count",
    "maybe_span",
    "paired_stats",
    "sign_test_p",
]
