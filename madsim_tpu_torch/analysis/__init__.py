"""Static analysis for determinism and engine contracts — the port's.

The Rust reference enforces determinism *at runtime*: under
``cfg(madsim)`` every nondeterminism source (libc entropy, clocks,
thread scheduling) is intercepted and replaced with the seeded
simulator. Python/PyTorch offers no such interception point — a stray
`time.time()`, a set iterated into state or a hidden `.item()` in the
dispatch loop runs fine and only surfaces months later as corpus rot or
a stalled card. This package is the static-analysis analogue of
madsim's interception layer, a copy of the JAX package's
`madsim_tpu/analysis/` retargeted at torch code: it refuses the hazard
at review time instead of replaying it at debug time.

Seven rule families (stable IDs, `# madsim: allow(...)` suppressions,
checked-in baseline `.madsim-torch-lint-baseline.json` — see
findings.py), with the JAX package's IDs and meanings:

* **D-rules** (`drules.py`) — determinism hazards, pure stdlib-`ast`
  over any python source: wall clocks, entropy, unordered set
  iteration, `id()`/`hash()`, unordered host callbacks, python
  truthiness on tensors inside Machine handlers.
* **C-rules** (`crules.py`) — `Machine` authoring-contract checks: an
  AST half (handler purity, the voter-bitmask cap) plus an import half
  that instantiates each model at one lane on the CPU and verifies
  `durable_spec()` / `torn_spec()` congruence and the
  `coverage_projection` one-word-per-lane contract without running a
  simulation.
* **G-rules** (`grules.py`) — whole-repo gate-discipline cross-checks:
  every fault kind/flag present in every host mirror, the shrink
  ablation table, the CLI vocabulary, the gate-off bit-identity matrix
  and the golden-stream pins; plus the RNG-layout manifest audit
  (tail-only growth, `ops/rng_layout.manifest`).
* **L-rules** (`layers.py`) — the torch-free layer map over the import
  graph; **T-rules** (`trules.py`) — interprocedural tensor taint:
  host syncs in handlers' helpers and in `run_stream`'s dispatch loop,
  use after donation; **R-rules** (`rrules.py`) — the static RNG-word
  ledger; **S-rules** (`srules.py`) — the lane-axis sharding contract
  against the collective registry.

Entry point: ``python -m madsim_tpu_torch lint [paths]`` (cli.py). Every
pass but one is stdlib-only and never imports torch; the C import half
does (models are torch programs) and can be disabled with
``--no-import-check``.
"""

from .findings import Finding, Severity  # noqa: F401
