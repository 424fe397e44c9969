"""The hunt fleet on the port: DST as a continuously operating farm.

The port of `madsim_tpu/fleet/`: the same modules, names, store layout
and wire, so a JAX worker and the port's worker (on the CUDA card, or on
the CPU with `--device cpu`) serve one store root side by side, and a
job started by one finishes on the other to the same report.

* `store` — the durable job store and queue: JSON on disk with atomic
  writes (`runtime/atomicio`), the lifecycle state machine (queued ->
  compiling -> running -> plateaued/exhausted/found -> shrunk -> filed,
  plus cancelled/failed/quarantined), leases with fencing generations,
  the queue log, `flock` locks, and the argument fingerprint a
  checkpoint carries, in the JAX package's bytes and file names.
* `allocator` and `scheduler` — the lane allocator (one unit = one
  seed batch of one job; jobs of one `cache_subkey` run back to back
  on the worker's live engine) and the coverage-momentum read.
* `worker` — `python -m madsim_tpu_torch fleet worker`: leases a job,
  runs one checkpointed batch through the command line's streaming
  driver (a `kill -9` loses at most one batch), and on a find shrinks
  one seed per fail code, attributes it by its provenance word and
  files it in the fleet corpus with its repro line.
* `api`, `client` and `httpd` — the control plane: `fleet serve`
  (stdlib `http.server`: POST /jobs, GET /jobs/{id}[/result|/events|
  /timeline|/profile], DELETE /jobs/{id}, /queue, /metrics, /healthz)
  and the thin client verbs, each retrying transient errors with
  seeded-jitter backoff. No torch import: it runs without a card.
* `events` — the per-job lifecycle event log, its SSE stream and the
  merged Perfetto timeline.
* `fsck` — the store doctor: per-file verdicts, quarantine to
  `*.corrupt`, stale tmp and claim sweeps, queue log rebuild.
* `chaos` — the farm attacked by a seeded schedule of worker kills,
  torn writes, lease-clock jumps and server bounces, held to an
  unperturbed oracle farm byte for byte.

A job's find replays from its recorded repro line alone (`regress` on
the fleet corpus), and a whole job is described by (fingerprint, seed
schedule), both recorded in the store.
"""

from .store import (  # noqa: F401
    Job,
    JobStore,
    STATES,
    TERMINAL,
    spec_to_args,
)
