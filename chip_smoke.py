#!/usr/bin/env python3
"""Smoke run of madsim_tpu_torch, the PyTorch/CUDA port, on one NVIDIA H100.

    python3 chip_smoke.py [--against DIR ...]

Phases, each fatal on failure (the script exits non-zero before its
last line):
  1. device: the card's name and power limit (nvidia-smi), torch and CUDA;
  2. build: compile the CUDA kernels from ops/csrc (nvcc, one per source,
     all started together), with ptxas's registers, shared memory and
     spills for each kernel; a spill in any of the four kernels fails;
  3. kernels: each kernel bit for bit against its plain PyTorch twin on
     the card, at its main path's shapes and at edge shapes (odd W and
     W = 1 / 11 / 17 / 256, ragged L and L = 1 / 3 / 31 / 8191, Q = 1 / 3 /
     33 / 40 / 96 / 256, P = 0 / 1 / 7 / 13, rows off 16-byte alignment,
     all-invalid lanes; for the flush C = 1 / 3 / 4 / 5 / 16 / 17 / 64 by
     W = 1 / 64 / 512 with n = 0 and n = C, every entry on one word,
     negative slots, words past the map and unaligned rows), with its
     median time, the twin's time, the least time the card could take
     (bound) and the time of an empty kernel of the same grid and block
     (floor), each at the shape where the kernel's launches run
     (pop_earliest: the single-lane replay's L = 1, and the 8192-lane
     batch beside it);
  4. card against CPU: run_batch of 256 flagship seeds on both devices
     must give equal results; then the overcommit bug (COMMIT_TO_LOG_LEN)
     on 64 seeds that hold its known failures, through run_batch and a
     short stream, must fail the same lanes with the same codes, digest
     trails and fail ring on both;
  5. flagship stream: the MadRaft-5 hunt at 8192 lanes through
     make_stream_runner(batch=8192, segment_steps=384, pipelined=False)
     (the per-segment executor in every stream phase, so their seeds/s
     read as before), one timed run of 2*8192 seeds after the 96-step
     state run that warms the batch, with each kernel's launch count
     from the timed run (it must be > 0); failing seeds found on the
     card are re-run on the CPU and must fail with the same code;
  6. the default split-chain stream (rng_stream=2), whose step prefix is
     the pop + gather kernel: run_batch of 256 flagship seeds with the
     recorder and coverage off and of 64 with both on (card_vs_cpu_v2),
     64 multi-Paxos seeds under dir, group and storm faults
     (card_vs_cpu_multipaxos), all equal to the CPU; the single-lane
     replay of seed 66531 (replay_66531: OvercommitRaft fails
     LOG_MATCHING, RaftMachine passes, trace and state equal to the
     CPU's), which pops with the pop kernel; all eight entries of
     corpus.json (corpus: codes 150 x5, 206, 160, 212; the traced
     replays of the non-multi-Paxos entries against the CPU; each
     entry's code and digest trail on the card in phase 11's `regress`
     and `audit`); and the 8192-lane flagship
     stream under rng_stream=2 (stream_v2);
  7. the delay-spike kind and the etcd-MVCC, S3 and gossip models:
     run_batch of 256 flagship seeds with delay faults on both streams
     equal to the CPU, with the sends that took a spike counted and the
     megakernel held against its twin at W = 18 (card_vs_cpu_delay; at
     8192 lanes, and timed there, in delay_kernels); each
     model and its corpus demo on the card against the CPU, the demo
     failing with its code (card_vs_cpu_models: mvcc and s3 at Q = 48,
     gossip at 33 nodes and Q = 256); the MVCC give-up hunt at 8192 lanes
     under delay spikes (stream_mvcc), whose first ABANDONED_WRITE seed
     is MVCC_FIRST and replays equal on the card and the CPU (the CPU's
     replay made in the window: hunt_replays_cpu); then the pop kernels against
     their twins and timed at the new shapes (pop_kernels: pop + gather
     at the hunt's Q = 48 and the replay's L = 1, the pop at L = 1 with
     Q = 48 and 256 on the corpus replays' states);
  8. the chaos palette (pause, skew, dup and strict restarts): run_batch
     of 256 flagship seeds at Q = 96 under the four on both streams equal
     to the CPU, each capability counted and seen in its coverage band
     (card_vs_cpu_palette); the two demos only these gates reach, on the
     card against the CPU: VolatileCommit fails 102 under strict restarts
     with honest Raft clean, the duplicate-vote tally fails 101 under dup,
     and its first seed's traced replay is equal (card_vs_cpu_demos); the
     dup-vote hunt at 8192 lanes under the whole palette (stream_palette),
     whose first ELECTION_SAFETY seed (PALETTE_FIRST) replays equal on
     the card and the CPU, and whose first seeds failing with another
     code (PALETTE_OTHERS) are replayed on the CPU to their codes and
     listed (the CPU's replays made in the window); the megakernel at Q = 96, W = 18 and the flush at two
     entries a step in `kernels`, the pops at Q = 96 in `pop_kernels`;
  9. the storage kinds (torn restarts, asymmetric heals) and the models
     raft-compact, paxos, etcd and group: run_batch on the card against
     the CPU on both streams (card_vs_cpu_storage): the torn-snapshot
     plan on TornSnapshotRaftCompact (LOG_MATCHING only), heal-asym on
     honest Raft at Q = 48, and honest raft-compact under every kind at
     once with 1% loss (no failure; the megakernel at W = 31); the
     torn-snapshot hunt at 8192 lanes (stream_torn), failing 102 only,
     whose first find (TORN_FIRST) replays equal on the card and the CPU
     (the CPU's replay made in the window); then the
     megakernel at W = 11 / Q = 64 (8192 lanes and the replay's L = 1),
     W = 31 / Q = 96 and L = 1 / Q = 96 and the flush on the torn hunt,
     each against its twin and timed (storage_kernels); the pop kernels
     against their twins and timed, pop_earliest at the torn replay's
     L = 1 / Q = 64 among them (pop_kernels); card_vs_cpu_models runs
     paxos, etcd and group with their demos too;
 10. the triage path a found bug takes, and the kv, mq and twopc models:
     card_vs_cpu_models holds kv and twopc (counter stream) and mq (split
     chain) with the bug variants DurabilityBugKv, NoDedupBroker and
     EagerCommitTwoPc, each failing with its code only; `triage` hunts
     the double-grant etcd demo at 8192 lanes through make_runner with
     the trace ring (at least 1,024 lanes failing, 8 steps profiled with
     the ring on and off); on a hunt of the same lanes in a process of
     its own in the window (`triage_checks`, a check group), it holds the
     first failing lanes' rings against the tails of their replays on the
     card and those replays against the CPU's, shrinks the first seed on
     the card and on the CPU (equal results), records the shrunk entry on
     the card, adds it to a corpus file and checks and audits it on the CPU
     (and audits one recorded on the CPU on the card), and exports the
     card's and the CPU's traces byte for byte; `triage_kernels` holds
     and times the megakernel at the hunt's Q = 96 / W = 10 (8192 lanes
     and the replays' L = 1) and
     at the model leg's shapes, and the flush on the hunt's buffers;
     pop_kernels adds pop_gather at the model leg's batch and
     pop_earliest at the triage replays' L = 1;
 11. the command line, `python -m madsim_tpu_torch`, in subprocesses on
     the card (`cli`): a `hunt --stream` of one batch of 8192 lanes (the
     flagship's shape, rng_stream 3, strict restarts, on the
     volatile-commit Raft demo) finds, shrinks and records, with
     `--coverage-out` and `--checkpoint`, while `regress` and `audit` of
     a copy of corpus.json (all eight entries), `check` of 256 seeds, a
     64-lane explore on the card and the CPU (equal stdout) and, on its
     first find (seed 19, checked against it), `replay`, `replay
     --diff-seed`, `trace --perfetto --jsonl` (message flows) and `shrink`
     run beside it; its first four finds replay on the CPU engine to the
     same codes; `regress` and `audit` of the found corpus on the card
     and with `--device cpu` and `coverage` run on what it wrote (these
     two stages from a thread in the window, from its start: the hunt's
     seeds/s and each command's seconds are taken beside the window's
     other work); `explore --stream` of the flagship
     at one batch of 8192 lanes, lanes cut at 1,152 events (three
     segments), after the window, pipelined and with `--no-pipeline` side
     by side and nothing else beside them, prints the same lines, with
     each one's seeds/s, host syncs, dispatches, and the segments issued
     (megakernel launches over 384) against those executed;
     `cli_kernels` holds and times the megakernel at the replays' L = 1,
     `check`'s 256 lanes and the small explore's 64, and the flush at 64
     lanes. Beside the hunt runs the same hunt with
     `--provenance`, which must find the same seeds, print the fault
     attribution line, harvest a word for every find (the first four
     equal to one-lane replays on the card) and shrink its first find
     with provenance guidance in no more replays than `shrink` to the
     same config; `why` of that seed with `--json --perfetto` gives the
     same stdout and files on the card and the CPU;
 12. causal provenance in process (`provenance`): 256 lanes of the
     volatile-commit demo under the palette with heal-asym and 2% loss,
     on both streams, every lane leaf equal on the card and the CPU with
     the gate on, and every leaf but the three provenance planes equal
     with it on and off; the 8192-lane profile of the hunt's engine with
     the gate on and off (its cost a step);
 13. the unpacked clog matrix (`card_vs_cpu_clog`): the flagship at 256
     lanes under every link kind on both streams, packed against
     unpacked and the matrix on the card against the CPU; a 64-node
     gossip cluster (which only the matrix holds) at 256 lanes on both
     streams against the CPU; `clog_kernels` holds and times the
     megakernel and pop_gather at its queue of 256;
 14. guided search (`guided`): `hunt --stream --coverage --provenance
     --guided --stop-on-plateau 1` of phase 11's hunt at 2 x 8192 lanes
     on the card, a `guided_batch` line a batch (seconds, seeds/s,
     mutants, new slots, finds so far, the rung); every batch after the
     first holds as many mutants as its heartbeat counts, every seed of
     the checkpoint's trail is unique, and the first 64 finds re-run on
     the CPU with `run_seed_batch` under their escalation step's engine
     to the same codes; beside it the same hunt at 64 lanes on the card
     and with `--device cpu` gives equal stdout and checkpoints; the
     step's kernels at the base rung and the escalated one
     (`profile_guided`);
 15. the Raft differential (`differential`): the fault schedules and
     device verdicts of 64 seeds at the fixture of
     tests/test_differential.py (Q = 96, the split chain) on the card
     and on the CPU, equal; and in the window (`differential_whole`),
     the whole differential with both engines on the port: 256 seeds,
     the device side one 256-lane run_batch on the card, the host side
     the port's own runtime on its native core (`run_host_raft` on each
     seed, its seconds and seeds/s beside the card's name and power
     limit, `host_native` and the core's `.so`), with no
     schedule mismatch, no violation on either engine and no
     disagreement; the vote bug planted in both engines caught by both
     (16 seeds, 3 s); `Runtime.check_determinism` of the host example's
     scenario on 4 seeds; before it, in the same process (`native`),
     the host engine's native core (`_native/hostcore.cc`, g++) built
     from the checkout, its seconds, and held against the pure-Python
     path (a process under MADSIM_TPU_NO_NATIVE=1): `run_host_raft` on
     64 fixture seeds with equal reports and both seeds/s, the chaos
     scenario of tests/test_native.py at seed 11 with equal output, and
     `check_determinism` on 4 seeds with the core observing every draw;
     `guided_kernels` holds and times the
     megakernel and the flush at the escalated vocabulary's W (8192
     lanes), the megakernel at the 64-lane hunt's escalated W, and
     pop_gather at the differential's 64 and 256 lanes of Q = 96;
 16. the perf tooling (`perf`), the command line in subprocesses on the
     card: `prof --merge` of one 256-step segment of 8192 lanes of the
     flagship (the command line's shape, recorder and buffered coverage
     on), alone on the card, its lanes cut at 256 events: at least two
     sync points matched, the megakernel's and the flush's kernels
     launched inside madsim.step (kineto's correlation of each kernel
     with its launch), the card's busy time by device phase, the
     capture's events, export seconds and bytes, and a virtual track
     equal to the CPU's `prof --merge` of 8 lanes (`prof`); once that
     capture has stopped, beside prof's host tail, `perf` of the flagship
     at one batch of 8192 lanes, whose host timeline covers >= 90% of the wall with
     every executor span (`perf_timeline`: each span's seconds and share,
     the device wait, the dispatch gap, the verdict, the card's memory);
     the v2 leg (`prof --rng-stream 2`, whose capture holds
     pop_gather_kernel) and `bench-ab --gate coverage-unbuffered` and
     `--gate rng-stream` at 256 lanes, one rep pair each, a check that
     they run, started with the other work that times nothing (below)
     (`perf`); `perf_kernels` holds and times the shapes these
     commands first launch: the megakernel with the digest and the flush
     at bench-ab's 256 lanes, pop_gather there on the split chain, and
     the megakernel with the digest at the prof replay's L = 1;
 17. the hunt fleet (`fleet`), `python -m madsim_tpu_torch fleet` in
     subprocesses on the card against `fleet serve`, driven from a thread
     with the other work that times nothing (below): the flagship hunt as a
     job (two units of 8192 lanes, coverage and provenance) through `fleet
     worker --drain` to `filed`, its one find shrunk, explained and filed
     with `filed_by`, a repro line and `why_kinds`, `regress` of the fleet
     corpus and that repro line (`replay`) on the card; beside it, the same
     job without shrink on a second worker SIGKILLed after its first batch,
     reclaimed by a new worker process that resumes one batch back at most,
     its report equal to the first job's; a guided 64-lane job on the split
     chain, lanes cut at 384 events, whose first unit runs on the card and
     the rest on a `--device cpu` worker, equal to a CPU-only oracle, with
     failing seeds and an escalation; a one-batch profile job on a store of
     its own under MADSIM_TPU_XPROF=1 (the capture holds kernel events,
     `fleet profile` merges it); `fleet fsck` clean and `fleet chaos --seed
     3 --profile claims --workers 2` passing; each job's seconds, units
     (seeds/s, engine built or cached), warm-ups and shrink seconds;
     `fleet_kernels` holds and times pop_gather and the flush at the guided
     job's 64 lanes;
17b. lane sharding over torch.distributed (`mesh`), in a process of its
     own with the other work that times nothing: phase 5's flagship stream
     (2 x 8192 seeds) meshed over one rank on NCCL (the whole dict equal
     to phase 5's, stats included), over two ranks sharing the card (gloo,
     4096 lanes each, pipelined: every result equal, each rank's dict
     equal to the other's, the megakernel and the flush launched on
     both), `explore --multihost` over two processes from the MADSIM_TPU_*
     env (process 0's line the unsharded explore's, counts masked; nothing
     from process 1) and `explore --stream --devices 2` refused with one
     line before any rank starts; each leg's seconds, with the card's name
     and power limit (the ranks share one card: no scaling figure);
     `mesh_kernels`, after the window, holds and times the megakernel and
     the flush at a rank's 4096 lanes;
 18. the device examples (`examples`): examples/bug_hunt_torch.py (the
     DoubleVoteRaft hunt: 2,048 seeds streamed in batches of 512 lanes at
     Q = 96, 192-step segments, the first find's traced replay, a passing
     neighbour, the trace diff) and examples/delay_hunt_torch.py (three
     256-lane batches of the MVCC give-up demo at Q = 48 and up to 3,000
     steps under loss storms, partitions and kills, and delay spikes;
     the first find's replay and shrink), each as a process of its own
     on the card, started at once in the window; their stdout checked as
     tests/test_examples.py checks the JAX examples', and each one's
     wall and launches (pop_gather's by the shape of its step) on the
     phase line; `card_vs_cpu_examples` runs both examples' engines at
     256 lanes and 192 steps on the card and the CPU, equal leaf for leaf
     and in their failing seeds; `host_facades` drives the host facades
     that run no kernel (a tokio JoinSet and the fake runtime, the
     simulated gRPC round trip of all four call shapes, a real-mode
     Endpoint's send/recv and RPC on 127.0.0.1, the log records'
     simulation context strings) without grpcio or a .proto;
     `examples_kernels`, after the window, holds and times pop_gather at
     bug_hunt's 512 lanes of Q = 96, delay_hunt's 256 of Q = 48 and the
     replays' L = 1 at Q = 48 and 96, and pop_earliest at bug_hunt's
     traced replay's L = 1, Q = 96;
18b. the host services (`services`, `services_host`): in two processes
     of their own in the window, on the card, one make_runner batch of 1,024 seeds
     of each bugged variant of tests/test_differential_services.py's drift
     cases under its fault plan (NoDedupMvcc, Q = 48; NoFencingGroupMachine,
     Q = 96; ArrivalOrderS3, Q = 48), then the port's service differentials
     (differential_etcd_mvcc, differential_kafka_group, differential_s3) on
     the port's own services over the tier-1 seed sets, each batch's first
     8 failing seeds and the lease-bug service on seeds 16-27: every
     faithful seed `ok`, every bugged seed caught, the lease bug flagged,
     each set's first 4 reports equal to the CPU's; batch and replay
     seconds, replays a second and launches by shape. From a thread, the
     host half: `MADSIM_TPU_MODE=real python -m madsim_tpu_torch serve` of
     etcd, kafka --wire and s3 --http on 127.0.0.1:0 (and etcd --grpc where
     grpcio, protobuf and protoc are installed), examples/etcd_dual_torch.py
     against them equal to its sim run, one round trip of the Kafka and S3
     real clients, and chaos_pipeline_torch.py and group_consumers_torch.py
     twice each, identical; every server stopped. `services_kernels`,
     after the window, holds and times pop_gather at the batches' 1,024
     lanes and the replays' L = 1, and pop_earliest at L = 1, of Q = 48
     and 96;
18c. lint (`lint_phase`): from a thread in the window, the port's static
     analyzer on this checkout as a user runs it, one subprocess at a
     time: `python -m madsim_tpu_torch lint` (the C import half on: the
     models at one lane on the CPU) must exit 0 printing "lint: clean";
     `lint --json` gives the counts (all 0) and, probed at its exit,
     that the lint process made no CUDA context and loaded no kernel
     library; a G-rule drift (shrink's ablation table loses `dup`)
     injected into a scratch copy of the port's files under the run's
     temp directory must exit 1 naming G003. Each run's seconds, with
     the card's name and power limit;
 18d. the bench command (`bench`, `bench_kernels`), after the perf
     tooling and with nothing beside it, each form in a process of its
     own as a user runs it, writing to a history file in a temporary
     directory: `python -m madsim_tpu_torch bench --reps 1` (the flagship
     at its full width, 8192 lanes: v3, recorder, buffered coverage; a
     warm run and one timed rep of 2 x 8192 seeds), `bench --machine echo
     --seeds 8192 --reps 1` (the command line's split chain, Q = 96, 8192
     lanes) and `bench report`, which must render both rows and import no
     torch; each line's seeds/s, `compile_s`, `compile_s_warm` and card,
     the history's rows and each kernel's launches (the flagship's
     megakernel and flush, the machine's pop_gather). `bench_kernels`
     holds pop_gather against its twin at the machine's 8192 lanes of
     Q = 96 and times it there;
 18e. the repo-root bench scripts' port copies (`benches/*_torch.py`),
     each a process of its own as a user runs it: after 18d, alone,
     `rpc_bench_torch.py` on the host engine's native core and under
     MADSIM_TPU_NO_NATIVE=1 (`rpc_bench`: the JAX script's six lines and
     keys, every figure > 0, the core loaded or not, no CUDA context; the
     figures are the host's, beside the card's name and power limit),
     then `tpu_sweep_torch.py 32768 192`, the sweep grid's widest point
     (`sweep`: its line on the card with the card's name and power limit,
     at least 3 x 32768 seeds with coverage, its peak device memory, the
     megakernel and the flush launched), then `sweep_kernels`, the
     megakernel with the digest (Q = 96, W = 10) and the flush at 32768
     lanes against their twins on a state of the sweep's engine, timed;
     in the window, from a thread, `tpu_sweep_torch.py --mesh` at its own
     defaults (`sweep_mesh`: 1,024 lanes, one NCCL rank and two gloo ranks
     sharing the card, each point the 1-rank point's completed seeds and
     coverage, the document marked `shared_card`, a history row a point,
     in a temporary directory) and, in a process of its own,
     `guided_compare_torch.py`'s raft coverage row (3 nodes, 3 faults,
     2 s, 1,200 steps, 64 lanes, a budget of 256) through its own
     run_unguided and run_guided on the card and in a niced --device cpu
     process (`guided_compare`: every deterministic column equal on the
     two devices, the script's raft verdict, guided strictly more slots);
 19. a `kernels` JSON line (with each kernel's launches on the perf path,
     `launches_perf`, on the fleet's card workers, `launches_fleet`, on
     the mesh path, `launches_mesh`, on the whole differential,
     `launches_differential`, in the examples, `launches_examples`, in
     the service differentials, `launches_services`, in the bench
     command, `launches_bench`, and in the sweep's point, `launches_sweep`;
     pop_gather's `differential` and `bench`
     hold its times at the differential's 256 lanes and the bench's 8192
     lanes of Q = 96, each pop kernel's `examples` and `services` its
     times at those paths' shapes); the last line is {"ok": true,
     "device": ...}.

From phase 4 on, the in-process CPU legs run on two intra-op threads.
The work that times nothing runs at once, after phase 6's stream, with
nothing timed beside it but phase 11's three stages (`--only window`
runs it alone): phases 17, 18 and 18c from threads, phase 16's checks,
phase 6's single-lane replays in the main process, phase 18b's host half
from a thread, phase 11's first two stages and its explore pair from two
threads once those replays are done (its hunt's and its explore pair's
seeds/s, warm-up and commands' seconds are taken beside this work, so
they read lower than the same commands alone), then in the main process
the states the serial tail's kernel phases time on where they depend on
nothing the tail runs (and, as each check group ends, those built from
its results: `window_states`), and in nine
processes of their own (niced) phase 4b, phase 6's card_vs_cpu_v2 and
card_vs_cpu_multipaxos and the card-against-CPU checks of phases 7-9, 12
and 13, phase 17b, phase 15's whole differential, phase 18's checks,
phase 18b's device half (two processes) and phase 18e's guided_compare;
phase 18e's sweep_mesh from a thread;
the states the timed phases need from those checks are rebuilt in the
main process. The delay engine's megakernel at
8192 lanes is timed after it (`delay_kernels`).

With `--against DIR` (another csrc tree with the same C interface, e.g.
an earlier commit's `madsim_tpu_torch/ops/csrc` unpacked under the
git-ignored build/; repeatable), a `head_to_head` line times each design
in turns (A, B, ..., B, A), each held bit for bit against the twins
first: the step megakernel (at the flagship's W and at W past 2 *
GROUP), pop + gather and the flush at the flagship inputs, and the pop
at the replay's L = 1 and at the 8192-lane batch; with the floors of
each design's grid and block.

Each path's launch counts are set to 0 just before it runs and read
just after; a kernel of the path that never launched fails the run.

It needs a CUDA card and the repository beside it; with neither it
exits non-zero and prints no result. `--only cli` builds the kernels and
runs phase 11 alone, `--only prov` phases 11-13, `--only guided` phase
15's whole differential then phases 14-15, `--only perf` phase 16, `--only fleet` phase 17, `--only mesh`
phase 17b and `mesh_kernels`, `--only examples` phase 18 (the examples,
their checks, then `examples_kernels`), `--only services` phase 18b (both
halves, then `services_kernels`), `--only bench` phase 18d (`bench`,
then `bench_kernels`), `--only sweep` phase 18e with the sweep's whole
default grid in place of its widest point (4096 to 32768 lanes by 192
and 384 steps, each point a process of its own, one at a time), its
kernels at 16384 and 32768 lanes, then sweep_mesh and guided_compare at
once, `--only window` the work that times nothing (short checks; they
print no result line).
"""

import argparse
import json
import pathlib
import re
import statistics
import subprocess
import sys
import time
from unittest import mock

# H100 SXM peak rates (NVIDIA data sheet, 700 W): HBM bytes/s, and the
# non-tensor-core 32-bit rate, used for the integer operations here.
PEAK_BYTES_S = 3.35e12
PEAK_OPS_S = 67e12

FLAGSHIP = dict(
    horizon_us=5_000_000, queue_capacity=32, rng_stream=3, clog_packed=True,
    flight_recorder=True, coverage=True, provenance=False,
)
FLAGSHIP_FAULTS = dict(n_faults=2, t_max_us=3_000_000, dur_min_us=200_000, dur_max_us=800_000)
LANES, SEGMENT_STEPS = 8192, 384
# the seeds of the v2, mvcc, palette and torn streams: one batch of
# 8192 lanes (the flagship stream keeps two), which keeps the smoke
# inside its time limit
HUNT_SEEDS = LANES
# phases 7-9's hunts' finds, fixed by their seeds as phase 11's is
# (CLI_FIRST_FIND): each tail hunt is held to them and replays them on the
# card, while their replays on the CPU run in the window (hunt_replays_cpu)
MVCC_FIRST, PALETTE_FIRST, TORN_FIRST = 8195, 8327, 8200
PALETTE_OTHERS = ((8256, 102), (8301, 102), (8335, 102), (9748, 102))
# phases 4 and 6: lanes and run_batch's step budget (flagship lanes run
# it out); small enough that the script fits half its time limit
CHECK_LANES, CHECK_STEPS = 256, 256
# phase 4b: OvercommitRaft fails these seeds with LOG_MATCHING under the
# flagship config (the first at step 364, the last two by step 533)
OVERCOMMIT_SEEDS, OVERCOMMIT_STEPS = [232949, 134519, 143336], 640
# phase 6: the split-chain stream
V2_CHECK_LANES, V2_RECORDER_LANES, MULTIPAXOS_LANES = 256, 64, 64
MULTIPAXOS = dict(horizon_us=8_000_000, queue_capacity=96)
MULTIPAXOS_FAULTS = dict(n_faults=3, allow_dir_clog=True, allow_group=True, allow_storm=True,
                         t_max_us=3_000_000, dur_min_us=100_000, dur_max_us=800_000)
WIDE_WORDS = (17, 64)  # the head to head's megakernel word blocks past 2 * GROUP
REPLAY_SEED = 66531  # the overcommit regression of tests/test_engine.py
REPLAY_STEPS = 1024  # past both replays' ends (334 and 527 events)
REPLAY_CONFIG = dict(horizon_us=5_000_000, queue_capacity=32)
REPLAY_STATE_STEPS = 300  # the replay state the pop is timed on: seed 66531 this far in
# the delay kind and the etcd-MVCC, S3 and gossip models
# card_vs_cpu_delay: lanes, run_batch's step budget, and the steps over
# which the sends that took a spike are counted
DELAY_LANES, DELAY_STEPS, DELAY_SPIKE_STEPS = 256, 128, 128
# card_vs_cpu_models: lanes, and step budgets (mvcc and s3 lanes end in
# ~70-120 events; gossip's run past the budget)
MODEL_LANES, GOSSIP_LANES = 256, 64
MVCC_STEPS, S3_STEPS, GOSSIP_STEPS = 3000, 4000, 200
# the delay-only plan of tests/test_engine_mvcc.py, and the full vocabularies
# of tests/test_engine_s3.py (with delay) and tests/test_engine_gossip.py
MVCC = dict(horizon_us=8_000_000, queue_capacity=48)
MVCC_DELAY_FAULTS = dict(n_faults=3, allow_partition=False, allow_kill=False, allow_delay=True,
                         t_max_us=3_000_000, dur_min_us=200_000, dur_max_us=800_000)
S3_FAULTS = dict(n_faults=3, allow_dir_clog=True, allow_group=True, allow_storm=True, allow_delay=True,
                 t_max_us=3_000_000, dur_min_us=100_000, dur_max_us=800_000)
GOSSIP = dict(horizon_us=5_000_000, queue_capacity=256)
GOSSIP_FAULTS = dict(n_faults=3, allow_dir_clog=True, allow_group=True, allow_storm=True, allow_delay=True,
                     t_max_us=3_000_000, dur_min_us=200_000, dur_max_us=700_000)
# the demo-dupack-gossip corpus entry's plan and seeds around its seed 45
DUPACK_FAULTS = {**GOSSIP_FAULTS, "dur_min_us": 100_000, "dur_max_us": 800_000}
DUPACK_SEEDS, DUPACK_STEPS = list(range(38, 54)), 500
# stream_mvcc: the give-up hunt at full width, the corpus entry's plan at the full horizon
MVCC_HUNT = dict(horizon_us=8_000_000, queue_capacity=48, rng_stream=2, handler_rand_words=4, clog_packed=True,
                 flight_recorder=True, coverage=True)
MVCC_HUNT_FAULTS = dict(n_faults=2, allow_partition=False, allow_kill=False, allow_delay=True,
                        t_max_us=3_000_000, dur_min_us=100_000, dur_max_us=800_000)
CORPUS_STATE_STEPS = {"demo-giveup-mvcc": 36, "demo-dupack-gossip": 300}  # pop_earliest's L = 1 states
# the chaos palette: pause, skew, dup and strict restarts on the flagship
# plan, with the queue headroom a pause's parked deliveries need
PALETTE_FAULTS = dict(FLAGSHIP_FAULTS, allow_pause=True, allow_skew=True, allow_dup=True, strict_restart=True)
PALETTE_Q, PALETTE_LANES, PALETTE_STEPS = 96, 256, 192
# card_vs_cpu_demos: the plans of tests/test_chaos_palette.py:211-231 and
# :244-262. VolatileCommit fails 10 of seeds 0-31 by step 400 in the JAX
# package; the dup-vote seeds are those of 0-2047 the JAX package fails
# with ELECTION_SAFETY (all by step 331)
VOLATILE = dict(horizon_us=3_000_000, queue_capacity=64)
VOLATILE_FAULTS = dict(n_faults=2, t_max_us=1_800_000, dur_min_us=100_000, dur_max_us=600_000, strict_restart=True)
VOLATILE_LANES, VOLATILE_STEPS = 32, 400
DUPVOTE = dict(horizon_us=1_000_000, queue_capacity=96)
DUPVOTE_FAULTS = dict(n_faults=2, t_max_us=600_000, dur_min_us=100_000, dur_max_us=800_000, allow_dup=True)
DUPVOTE_SEEDS = [24, 48, 91, 140, 150, 312, 459, 499, 518, 736, 737, 768, 791, 807, 845, 878, 896, 903, 1077,
                 1107, 1147, 1248, 1520, 1624, 1639, 1677, 1701, 1722, 1760, 1827, 1845, 1895, 1920, 1927]
DUPVOTE_STEPS = 360
# stream_palette: the dup-vote hunt under the whole palette, at full width
PALETTE_HUNT = dict(horizon_us=1_000_000, queue_capacity=96, rng_stream=3, clog_packed=True, flight_recorder=True,
                    coverage=True, cov_buffer=16)
PALETTE_HUNT_FAULTS = dict(n_faults=2, t_max_us=600_000, dur_min_us=100_000, dur_max_us=800_000,
                           allow_pause=True, allow_skew=True, allow_dup=True, strict_restart=True)
PALETTE_REPLAY_STEPS = 40  # the hunt replay's state pop_earliest is timed on: this far in
# card_vs_cpu_models, new in phase 9: single-decree Paxos, etcd and the
# consumer group with their demos, under the plans of
# tests/test_engine_paxos.py, tests/test_engine_etcd.py and
# tests/test_engine_group.py (lanes end in ~40, ~400 and ~220 events;
# the honest etcd and group lanes are cut at 192 and 160 events)
PAXOS_PLAN = dict(horizon_us=8_000_000, queue_capacity=96)
PAXOS_FAULTS = dict(n_faults=2, t_max_us=4_000_000, dur_min_us=200_000, dur_max_us=800_000)
NOPROMISE_FAULTS = dict(n_faults=3, t_max_us=2_000_000, dur_min_us=150_000, dur_max_us=600_000)
ETCD_PLAN = dict(horizon_us=8_000_000, queue_capacity=96)
ETCD_FAULTS = dict(n_faults=2, t_max_us=5_000_000, dur_min_us=200_000, dur_max_us=800_000)
DOUBLEGRANT_PLAN = dict(horizon_us=9_000_000, queue_capacity=96)
DOUBLEGRANT_FAULTS = dict(n_faults=3, t_max_us=6_000_000, dur_min_us=150_000, dur_max_us=600_000)
GROUP_PLAN = dict(horizon_us=8_000_000, queue_capacity=96)
GROUP_FAULTS = dict(n_faults=3, t_max_us=1_500_000, dur_min_us=250_000, dur_max_us=700_000)
NOFENCING_PLAN = dict(horizon_us=9_000_000, queue_capacity=96)
NOFENCING_FAULTS = dict(n_faults=3, t_max_us=5_000_000, dur_min_us=200_000, dur_max_us=800_000, allow_kill=False)
# phase 9, the storage kinds: the torn-snapshot plan of
# tests/test_chaos_palette.py:355-382 at the hunt's width, heal-asym on
# honest Raft at Q = 48, and the 11-kind soak of :430-441
TORN_HUNT = dict(horizon_us=4_000_000, queue_capacity=64, rng_stream=3, clog_packed=True, flight_recorder=True,
                 coverage=True, cov_buffer=16)
TORN_FAULTS = dict(n_faults=3, t_max_us=1_800_000, dur_min_us=100_000, dur_max_us=600_000, allow_partition=False,
                   allow_kill=False, allow_torn=True, strict_restart=True)
HASYM_Q = 48
SOAK = dict(horizon_us=4_000_000, queue_capacity=96, packet_loss_rate=0.01)
SOAK_FAULTS = dict(n_faults=3, t_max_us=2_400_000, dur_min_us=100_000, dur_max_us=600_000, allow_dir_clog=True,
                   allow_group=True, allow_storm=True, allow_delay=True, allow_pause=True, allow_skew=True,
                   allow_dup=True, allow_torn=True, allow_heal_asym=True, strict_restart=True)
STORAGE_LANES = 256
# run_batch budgets: torn lanes fail LOG_MATCHING from ~200 events in
TORN_CHECK_STEPS, HASYM_STEPS, SOAK_STEPS = 256, 128, 128
TORN_REPLAY_STEPS = 150  # the torn replay's state its kernels are timed on: this far in
# card_vs_cpu_models, new in phase 10: kv, mq and twopc with the three bug
# variants of tests/test_engine.py, under its plans (Q = 64); kv on the
# counter stream (the megakernel at W = 7), mq on the split chain
# (pop_gather at P = 5) and twopc on the counter stream (W = 12 honest,
# W = 9 eager). Budgets: kv lanes run past 160 events, the durability bug
# fails from ~45 events in; mq lanes end in 180-330, the no-dedup broker
# fails by ~50; twopc lanes end in ~105-126, the eager commit fails by ~25
KV_PLAN = dict(horizon_us=3_000_000, queue_capacity=64)
KV_FAULTS = dict(n_faults=2, t_max_us=2_000_000, dur_min_us=100_000, dur_max_us=400_000)
KV_KILL_FAULTS = dict(n_faults=3, allow_partition=False, t_max_us=2_000_000, dur_min_us=50_000, dur_max_us=200_000)
MQ_PLAN = dict(horizon_us=6_000_000, queue_capacity=64, packet_loss_rate=0.1)
MQ_FAULTS = dict(n_faults=1, t_max_us=3_000_000, dur_min_us=100_000, dur_max_us=400_000)
NODEDUP_PLAN = dict(horizon_us=6_000_000, queue_capacity=64, packet_loss_rate=0.3)
TWOPC_PLAN = dict(horizon_us=5_000_000, queue_capacity=64, packet_loss_rate=0.1)
TWOPC_FAULTS = dict(n_faults=2, t_max_us=3_000_000, dur_min_us=100_000, dur_max_us=400_000)
EAGER_PLAN = dict(horizon_us=5_000_000, queue_capacity=64)
# phase 10, triage: the double-grant etcd hunt of tests/test_engine_etcd.py:
# 132-177 on the counter stream (the megakernel at Q = 96, W = 10), with
# the trace ring, the recorder and buffered coverage; its lanes fail
# LEASE_SAFETY 16-60 events in, so a budget of 32 events fails ~98% of them
TRIAGE = dict(horizon_us=8_000_000, queue_capacity=96, rng_stream=3, packet_loss_rate=0.05, trace_ring=32,
              clog_packed=True, flight_recorder=True, coverage=True)
TRIAGE_FAULTS = dict(n_faults=2, t_max_us=5_000_000, dur_min_us=200_000, dur_max_us=800_000)
TRIAGE_STEPS, TRIAGE_MIN_FAILING, POSTMORTEM_LANES = 32, 1024, 8
TRIAGE_STATE_STEPS = 8  # the hunt's state its kernels are timed and profiled on: this far in (lanes live)
TRIAGE_DIGEST_EVERY = 4  # the recorded entry's checkpoint cadence (a shrunk entry runs ~20 events)
# phase 12, provenance: 256 lanes of the volatile-commit demo under
# card_vs_cpu_demos' plan with the whole palette, heal-asym and 2% loss
# (on the CPU 7 lanes fail 102 by step 256, each word with the amnesia
# bit; duplicate copies queue with bit 31), and the 8192-lane profile of
# the command-line hunt's engine with the gate on and off; the first
# finds of the hunt replayed
PROV_LANES, PROV_STEPS, PROV_Q = 256, 192, 96
PROV_FAULTS = dict(VOLATILE_FAULTS, allow_pause=True, allow_skew=True, allow_dup=True, allow_heal_asym=True)
PROV_PROFILE_STEPS, PROV_STATE_STEPS, PROV_REPLAYS = 8, 32, 4
# phase 13, the unpacked clog matrix: the flagship under every link kind
# (packed against unpacked, and the matrix on the card against the CPU),
# and a 64-node gossip cluster, which only the matrix holds, under pair
# and kill (past 61 nodes no v2 schedule can be drawn, so no dir or group
# fault); its queue is the smallest power of two from 256 that overflows
# no lane over its steps
CLOG_FAULTS = dict(FLAGSHIP_FAULTS, n_faults=3, allow_dir_clog=True, allow_group=True, allow_heal_asym=True)
CLOG_STEPS = 128
GOSSIP64 = dict(horizon_us=5_000_000, clog_packed=False, flight_recorder=True, coverage=False)
GOSSIP64_FAULTS = dict(n_faults=3, t_max_us=3_000_000, dur_min_us=100_000, dur_max_us=800_000)
GOSSIP64_NODES, GOSSIP64_LANES, GOSSIP64_STEPS, GOSSIP64_MIN_Q = 64, 256, 96, 256
STARTED = time.perf_counter()
STARTED_WALL = time.time()  # the same instant on the clock child processes share


def card_line():
    """The card's name and power limit, as nvidia-smi prints them."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    lines = smi.stdout.strip().splitlines() if smi.returncode == 0 else []
    if not lines:
        fail(f"nvidia-smi gave no card: {smi.stderr.strip()}")
    return lines[0]


def emit(obj):
    """One JSON line; a phase's line also says when it ended, in seconds
    since the script started."""
    if "phase" in obj:
        obj = {**obj, "at_s": round(time.perf_counter() - STARTED, 3)}
    # one write: phase 17's thread emits beside the main thread's phases
    sys.stdout.write(json.dumps(obj) + "\n")
    sys.stdout.flush()


def fail(msg):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def device_time_ms(fn, reps=100):
    """Per-call device time of `fn`: a sleep kernel holds the stream
    while the host queues `reps` calls, so the timed region is the calls
    back to back on the card, not the host's launch rate; the median of
    5 such runs."""
    import torch

    fn()
    runs = []
    for _ in range(5):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(50_000_000)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        runs.append(start.elapsed_time(end) / reps)
    return statistics.median(runs)


def wall_time_ms(fn, reps=10):
    """Per-call time of host-bound code that ends on the card."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / reps


def misaligned_copy(x):
    """A contiguous copy of `x` one element into its storage, so that its
    rows miss 16-byte alignment."""
    import torch

    flat = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
    return flat[1:].view(x.shape).copy_(x)


def random_queues(g, lanes, q, p, dev, misaligned=False):
    """Random queue planes; with `misaligned`, the time, seq and valid
    planes are `misaligned_copy`s."""
    import torch

    def t(a):
        return torch.as_tensor(a).to(dev)

    time_ = g.integers(0, 50, (lanes, q)).astype("int32")  # dense: many ties
    seq = g.permuted(g.integers(0, 2**31 - 1, (lanes, q)), axis=1).astype("int32")
    valid = g.random((lanes, q)) < 0.5
    valid[::5] = False  # all-invalid lanes pop slot 0
    vals = [g.integers(-2**31, 2**31, (lanes, q)).astype("int32") for _ in range(3)]
    payload = g.integers(-2**31, 2**31, (lanes, q, p)).astype("int32")
    planes = [t(time_), t(seq), t(valid)]
    if misaligned:
        planes = [misaligned_copy(x) for x in planes]
    return [*planes, *(t(v) for v in vals), t(payload)]


# The lane-group kernels' edge shapes (lanes, q, p, w, rows misaligned):
# lanes not a multiple of a block's 32, Q off the int4 path (1, 3, 33),
# P = 0 / 1 / 7 / 13 (13: fields past the gather's register rounds), W =
# 1 / 11 / 17 / 256 (past 16 the digest re-reads the words), and rows off
# 16-byte alignment, which take the scalar path.
EDGE_SHAPES = [(1, 1, 0, 1, False), (3, 3, 1, 11, False), (31, 33, 7, 256, False), (8191, 32, 6, 10, False),
               (8191, 33, 7, 11, False), (3, 32, 6, 10, True), (31, 40, 13, 17, True), (1, 96, 0, 256, True)]


# The flush's edge grid: C off the int4 path (1, 3, 5, 17), one round of
# 16 entries and past it (17, 64), by W = 1 / 64 / 512.
FLUSH_C, FLUSH_W = (1, 3, 4, 5, 16, 17, 64), (1, 64, 512)


def flush_inputs(g, lanes, c, w):
    """Random flush inputs (map [L, W], buf [L, C], n [L], int32 numpy),
    lanes >= 4: lane 0 has n = 0, lanes 1-3 n = C; lane 2's entries all
    fall on one word, the odd lanes' on two neighbouring words (as a full
    buffer's crowd); a fifth of the entries (all of lane 3's) are negative
    slots or words past the map, which no column matches."""
    import numpy as np

    cov_map = g.integers(-2**31, 2**31, (lanes, w)).astype(np.int32)
    buf = g.integers(0, 32 * w, (lanes, c)).astype(np.int32)
    buf[1::2] = (32 * g.integers(0, w, (lanes, 1)) + g.integers(0, 64, (lanes, c)))[1::2]
    n = g.integers(0, c + 1, lanes).astype(np.int32)
    n[0], n[1:4] = 0, c
    bad = g.random((lanes, c)) < 0.2
    bad[3] = True
    buf[bad] = g.choice(np.array([-1, -32, -33, -2**31, 32 * w, 32 * w + 31, 2**31 - 1]), int(bad.sum()))
    buf[2] = 32 * int(g.integers(0, w)) + g.integers(0, 32, c)
    return cov_map, buf, n


def floor_ms(kernels, name, lanes, dev, entries=0):
    """Device time of an empty kernel with kernel `name`'s grid and block
    at `lanes` lanes (the flush: of `entries` buffered entries each)."""
    grid, block = kernels.kernel_geometry(name, lanes, entries)
    return device_time_ms(lambda: kernels.launch_floor(grid, block, dev))


def max_abs_err(a_outs, b_outs):
    import torch

    err = 0
    for a, b in zip(a_outs, b_outs):
        if a.shape != b.shape or a.dtype != b.dtype:
            fail(f"output shape/dtype differ: {a.shape} {a.dtype} vs {b.shape} {b.dtype}")
        if a.numel():
            err = max(err, int((a.to(torch.int64) - b.to(torch.int64)).abs().max()))
    return err


def flat_prefix(r):
    idx, any_v, popped, payload, words, digest = r
    return [idx, any_v, *popped, payload, words, *digest]


def step_kernel_ins(state):
    """A state's megakernel inputs: the queue planes, key and step, and
    the digest halves (None, None with the recorder off)."""
    digest = (state.fr["d0"], state.fr["d1"]) if state.fr else (None, None)
    return ([state.eq_time, state.eq_seq, state.eq_valid, state.eq_kind, state.eq_node, state.eq_src,
             state.eq_payload, state.rng_key, state.step], digest)


def time_step_kernel(kernels, dev, state, total_words):
    """The megakernel against its twin on a main path's state, then its
    time there, the twin's, its (bytes, operations) and its floor."""
    import torch

    ins, (d0, d1) = step_kernel_ins(state)
    got = flat_prefix(kernels.step_megakernel(*ins, total_words, d0=d0, d1=d1))
    want = flat_prefix(kernels.step_prefix_plain(*ins, total_words, d0, d1))
    torch.cuda.synchronize()
    err = max_abs_err(got, want)
    if err:
        fail(f"step_megakernel disagrees with its twin at W = {total_words}, Q = {state.eq_time.shape[1]}: "
             f"max abs err {err}")
    lanes, q = state.eq_time.shape
    ms = device_time_ms(lambda: kernels.step_megakernel(*ins, total_words, d0=d0, d1=d1))
    plain_ms = wall_time_ms(lambda: kernels.step_prefix_plain(*ins, total_words, d0, d1))
    return (err, ms, plain_ms, *step_kernel_cost(lanes, q, state.eq_payload.shape[2], total_words, d0 is not None),
            floor_ms(kernels, "step_megakernel", lanes, dev))


def check_step_kernel(kernels, g, dev, state, total_words):
    """Kernel vs twin on edge cases, then on the main path's inputs, and
    its times there."""
    import torch

    cases = []
    shapes = [(1000, 32, 6, 7, True, False), (37, 64, 4, 10, False, False), (5, 40, 3, 1, True, False)]
    shapes += [(lanes, q, p, w, True, mis) for lanes, q, p, w, mis in EDGE_SHAPES]
    shapes += [(lanes, q, p, w, False, mis) for lanes, q, p, w, mis in EDGE_SHAPES[2::3]]
    for lanes, q, p, w, digest, mis in shapes:
        qs = random_queues(g, lanes, q, p, dev, mis)
        key = torch.as_tensor(g.integers(-2**31, 2**31, (lanes, 2)).astype("int32")).to(dev)
        step = torch.as_tensor(g.integers(0, 2**31, lanes).astype("int32")).to(dev)
        d = tuple(torch.as_tensor(g.integers(-2**31, 2**31, lanes).astype("int32")).to(dev) for _ in range(2))
        cases.append((f"L{lanes}-Q{q}-P{p}-W{w}{'-digest' if digest else ''}{'-misaligned' if mis else ''}",
                      qs + [key, step], w, d if digest else (None, None)))
    for name, ins, w, (d0, d1) in cases:
        got = flat_prefix(kernels.step_megakernel(*ins, w, d0=d0, d1=d1))
        want = flat_prefix(kernels.step_prefix_plain(*ins, w, d0, d1))
        torch.cuda.synchronize()
        e = max_abs_err(got, want)
        if e:
            fail(f"step_megakernel disagrees with its twin on {name}: max abs err {e}")
    return time_step_kernel(kernels, dev, state, total_words)


def step_kernel_cost(lanes, q, p, total_words, digest=True):
    """(bytes, operations) of the megakernel's work at one shape. Bytes:
    the time, seq and valid planes whole; one 32-byte sector for each
    gathered field (kind, node, src, the payload row); key, step and
    digest in; idx, any, the tuple, payload, words and digest out.
    Operations: per Threefry pair 20 rounds of 3 + 5 injections of 3, per
    digest word ~11; the argmin ~3 compares a slot per stage. Without
    the digest (the recorder off) its bytes and operations drop out."""
    d = 1 if digest else 0
    bytes_in = lanes * (q * (4 + 4 + 1) + 4 * 32 + 8 + 4 + 8 * d)
    bytes_out = lanes * (4 + 1 + 4 * 4 + 4 * p + 4 * total_words + 8 * d)
    half = (total_words + 1) // 2
    ops = lanes * (half * (20 * 3 + 5 * 3 + 2) + d * (4 + p + total_words) * 11 + 9 * q)
    return bytes_in + bytes_out, ops


def bound(nbytes, ops):
    """The least time the card could take: (ms, "bytes" or "operations")."""
    t_bytes, t_ops = nbytes / PEAK_BYTES_S * 1e3, ops / PEAK_OPS_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def pop_planes(state, gather=True):
    """A state's queue planes, as the pop kernels take them."""
    planes = [state.eq_time, state.eq_seq, state.eq_valid]
    return planes + [state.eq_kind, state.eq_node, state.eq_src, state.eq_payload] if gather else planes


def pop_gather_bytes(lanes, q, p):
    """pop_gather's bytes: the time, seq and valid planes whole (9 B a
    slot); one 32-byte sector for each gathered field (kind, node, src,
    the payload row); idx, any, the four fields and the payload row out."""
    return lanes * (9 * q + 4 * 32 + 4 + 1 + 16 + 4 * p)


def check_pop_kernels(kernels, g, dev, state, replay_state, hunt_state, corpus_states, palette_states, torn_state,
                      models_state, triage_replay_state):
    """The pop + gather and pop kernels against their twins on the main
    paths' inputs (a split-chain flagship batch, the mvcc hunt's batch at
    Q = 48, P = 5, the palette's v2 batch at Q = 96, the model leg's mq
    batch at Q = 64, and single lanes: the replay's at Q = 32, the mvcc
    and gossip corpus replays' at Q = 48 and 256, the dup-vote demo's and
    hunt's replays at Q = 96, the torn hunt's replay at Q = 64, the
    triage replays' at Q = 96) and on edge
    shapes: 8191 lanes of Q = 96 with empty lanes, one lane, Q = 40 and
    Q = 256, and the lane-group edge shapes. Times pop + gather at the
    flagship batch, the hunt's batch, the palette's batch, the model
    leg's batch and the replays' L = 1, and the pop at L = 1 on the
    replays (where its launches run) and at the batch."""
    import torch

    main = pop_planes(state)
    hunt = pop_planes(hunt_state)
    mvcc_l1, gossip_l1 = (pop_planes(corpus_states[m]) for m in ("demo-giveup-mvcc", "demo-dupack-gossip"))
    palette_v2, dupvote_l1, palette_l1 = (pop_planes(palette_states[k]) for k in
                                          ("palette_v2", "dupvote_replay", "palette_replay"))
    cases = [("flagship-v2", main), ("replay-L1", pop_planes(replay_state)), ("mvcc-hunt", hunt),
             ("mvcc-replay-L1", mvcc_l1), ("gossip-replay-L1", gossip_l1), ("palette-v2", palette_v2),
             ("dupvote-replay-L1", dupvote_l1), ("palette-replay-L1", palette_l1),
             ("torn-replay-L1", pop_planes(torn_state)), ("models-v2", pop_planes(models_state)),
             ("triage-replay-L1", pop_planes(triage_replay_state))]
    shapes = [(8191, 96, 6, False), (1, 32, 6, False), (13, 40, 4, False), (64, 256, 6, False)]
    shapes += [(lanes, q, p, mis) for lanes, q, p, _, mis in EDGE_SHAPES]
    for lanes, q, p, mis in shapes:
        qs = random_queues(g, lanes, q, p, dev, mis)
        qs[0][::3, : max(q // 4, 1)] = 2**31 - 1  # INT32_MAX is a legal time
        cases.append((f"L{lanes}-Q{q}-P{p}{'-misaligned' if mis else ''}", qs))
    gather_err = pop_err = 0
    for name, ins in cases:
        got = kernels.pop_gather_batch(*ins)
        want = kernels.pop_gather_plain(*ins)
        got_pop, want_pop = kernels.pop_earliest_batch(*ins[:3]), kernels.pop_earliest_plain(*ins[:3])
        torch.cuda.synchronize()
        e = max_abs_err([got[0], got[1], *got[2], got[3]], [want[0], want[1], *want[2], want[3]])
        e_pop = max_abs_err(got_pop, want_pop)
        if e or e_pop:
            fail(f"pop kernels disagree with their twins on {name}: max abs err {e} / {e_pop}")
        gather_err, pop_err = max(gather_err, e), max(pop_err, e_pop)

    def timed(name, ins):
        lanes, q = ins[0].shape
        if name == "pop_gather":
            fn, plain, err = (lambda: kernels.pop_gather_batch(*ins)), (lambda: kernels.pop_gather_plain(*ins)), \
                gather_err
            nbytes = pop_gather_bytes(lanes, q, ins[6].shape[2])
        else:
            fn, plain, err = (lambda: kernels.pop_earliest_batch(*ins[:3])), \
                (lambda: kernels.pop_earliest_plain(*ins[:3])), pop_err
            nbytes = lanes * (9 * q + 4 + 1)
        return {"err": err, "lanes": lanes, "q": q, "ms": device_time_ms(fn), "plain_ms": wall_time_ms(plain),
                "floor_ms": floor_ms(kernels, name, lanes, dev), "bytes": nbytes,
                # three compares a slot, one per argmin stage
                "ops": lanes * 3 * q}

    lanes = state.eq_time.shape[0]
    replay = pop_planes(replay_state)
    return {
        "pop_gather": timed("pop_gather", main),
        "pop_gather_mvcc_hunt": timed("pop_gather", hunt),
        "pop_gather_L1": timed("pop_gather", replay),
        "pop_earliest_L1": timed("pop_earliest", replay),
        "pop_earliest_L1_Q48": timed("pop_earliest", mvcc_l1),
        "pop_earliest_L1_Q256": timed("pop_earliest", gossip_l1),
        f"pop_earliest_L{lanes}": timed("pop_earliest", main),
        "pop_gather_palette_v2": timed("pop_gather", palette_v2),
        "pop_gather_L1_Q96": timed("pop_gather", dupvote_l1),
        "pop_earliest_L1_Q96": timed("pop_earliest", palette_l1),
        "pop_earliest_L1_Q64": timed("pop_earliest", pop_planes(torn_state)),
        "pop_gather_models_v2": timed("pop_gather", pop_planes(models_state)),
        "pop_earliest_L1_Q96_triage": timed("pop_earliest", pop_planes(triage_replay_state)),
    }


def check_cov_flush(kernels, g, dev, state):
    """The flush against its twin on the main path's inputs (the flagship
    batch's full buffers) and on the edge grid (`flush_inputs` at every C
    of FLUSH_C by W of FLUSH_W, rows aligned and not), then its times."""
    import torch

    cases = []
    for lanes, c, w in ((1000, 16, 512), (33, 5, 64)):
        m = torch.as_tensor(g.integers(-2**31, 2**31, (lanes, w)).astype("int32")).to(dev)
        buf = torch.as_tensor(g.integers(0, w * 32, (lanes, c)).astype("int32")).to(dev)
        n = torch.as_tensor(g.integers(0, c + 1, lanes).astype("int32")).to(dev)
        n[::4] = 0
        cases.append((f"L{lanes}-C{c}-W{w}", m, buf, n))
    for c in FLUSH_C:
        for w in FLUSH_W:
            m, buf, n = (torch.as_tensor(a).to(dev) for a in flush_inputs(g, 70, c, w))
            cases.append((f"L70-C{c}-W{w}", m, buf, n))
            cases.append((f"L70-C{c}-W{w}-misaligned", m, misaligned_copy(buf), n))
    for name, m, buf, n in cases:
        check_cov_flush_case(kernels, name, m, buf, n)
    return time_cov_flush(kernels, dev, state.cov)


def check_cov_flush_case(kernels, name, m, buf, n):
    import torch

    got = kernels.cov_flush_batch(m.clone(), buf, n)
    want = kernels.cov_flush_plain(m, buf, n)
    torch.cuda.synchronize()
    e = max_abs_err([got], [want])
    if e:
        fail(f"cov_flush disagrees with its twin on {name}: max abs err {e}")


def time_cov_flush(kernels, dev, cov):
    """The flush against its twin on a main path's buffers, then its
    times there, (bytes, operations), the live entries and sectors, and
    its floor."""
    import torch

    check_cov_flush_case(kernels, "the main path's buffers", cov["map"], cov["buf"], cov["buf_n"])
    scratch = cov["map"].clone()  # the flush is idempotent: the map stays valid across reps
    ms = device_time_ms(lambda: kernels.cov_flush_batch(scratch, cov["buf"], cov["buf_n"]))
    plain_ms = wall_time_ms(lambda: kernels.cov_flush_plain(cov["map"], cov["buf"], cov["buf_n"]))
    lanes, c = cov["buf"].shape
    floor = floor_ms(kernels, "cov_flush", lanes, dev, c)
    live = int(cov["buf_n"].sum())
    # bytes: the buffer and counts read once; one 32-byte sector read and
    # written per distinct live (lane, sector). A sector holds 8 map
    # words, 256 slots (slot >> 8), so the entries of a lane that fall in
    # one sector cost one read-modify-write between them
    slots = cov["buf"].to(torch.int64)
    live_mask = torch.arange(c, device=dev)[None, :] < cov["buf_n"][:, None]
    lane_ids = torch.arange(lanes, device=dev)[:, None].expand(-1, c)
    sectors = torch.unique((lane_ids * (cov["map"].shape[1] // 8) + (slots >> 8))[live_mask]).numel()
    nbytes = lanes * c * 4 + lanes * 4 + sectors * 64
    ops = lanes * c * 4 + live * 3
    return 0, ms, plain_ms, nbytes, ops, live, sectors, floor


def profile_steps(eng, state, steps):
    """Wall time of `steps` event steps at the main path's shape, and the
    card's busy time in them from the kernels torch.profiler records
    (None when it records none), with the kernels that take it."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            state = eng.step_batch(state)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    by_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            us, n = by_name.get(e.name, (0.0, 0))
            by_name[e.name] = (us + e.time_range.elapsed_us(), n + 1)
    busy_us = sum(us for us, _ in by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:6]
    return {
        "steps": steps,
        "ms_per_step_profiled": wall_us / steps / 1e3,
        "device_busy_ms_per_step": busy_us / steps / 1e3 if by_name else None,
        "device_idle_share": 1 - busy_us / wall_us if by_name else None,
        "kernels_per_step": sum(n for _, n in by_name.values()) / steps if by_name else None,
        "top_kernels": [{"name": k[:90], "count": n, "us": round(us, 1)} for k, (us, n) in top],
    }


def tree_diff(a, b, path=""):
    """Paths where two numpy trees (nested dicts) differ."""
    import numpy as np

    if isinstance(a, dict):
        if a.keys() != b.keys():
            return [f"{path}: keys differ"]
        return [d for k in a for d in tree_diff(a[k], b[k], f"{path}.{k}")]
    return [] if a.dtype == b.dtype and np.array_equal(a, b) else [path]


def card_vs_cpu(make_engine, seeds, max_steps, what):
    """run_batch of `seeds` on the card and on the CPU; fails unless the
    results are equal leaf for leaf. Returns (card result, card s, CPU s)."""
    from madsim_tpu_torch.interop import tree_to_numpy

    t0 = time.perf_counter()
    on_card = tree_to_numpy(make_engine(None).run_batch(seeds, max_steps))
    t_card = time.perf_counter() - t0
    t0 = time.perf_counter()
    on_cpu = tree_to_numpy(make_engine("cpu").run_batch(seeds, max_steps))
    t_cpu = time.perf_counter() - t0
    bad = tree_diff(on_card, on_cpu)
    if bad:
        fail(f"{what}: run_batch on the card differs from the CPU in {bad[:8]}")
    return on_card, t_card, t_cpu


def card_vs_cpu_failing(torch, np, kernels):
    """Phase 4b, the card against the CPU where lanes fail: the overcommit
    bug (COMMIT_TO_LOG_LEN) on seeds that hold its known failures,
    through run_batch (fail codes, digest trail) and a short stream
    (fail ring)."""
    from madsim_tpu_torch.engine import Engine, EngineConfig, FaultPlan
    from madsim_tpu_torch.models import RaftMachine
    from madsim_tpu_torch.models.raft import LOG_MATCHING

    cfg = EngineConfig(**FLAGSHIP, faults=FaultPlan(**FLAGSHIP_FAULTS))

    class OvercommitRaft(RaftMachine):
        COMMIT_TO_LOG_LEN = True

    over = OvercommitRaft(num_nodes=5, log_capacity=8)
    over_card, over_cpu = Engine(over, cfg), Engine(over, cfg, device="cpu")
    seeds = np.array(OVERCOMMIT_SEEDS + list(range(OVERCOMMIT_SEEDS[0] - 61, OVERCOMMIT_SEEDS[0])), np.uint32)
    on_card, _, _ = card_vs_cpu(lambda d: over_card if d is None else over_cpu, seeds, OVERCOMMIT_STEPS,
                                "overcommit")
    codes = on_card["fail_code"][: len(OVERCOMMIT_SEEDS)].tolist()
    if not on_card["failed"][: len(OVERCOMMIT_SEEDS)].all() or set(codes) != {LOG_MATCHING}:
        fail(f"the known overcommit seeds {OVERCOMMIT_SEEDS} did not all fail LOG_MATCHING: {codes}")
    kw = dict(batch=32, segment_steps=64, seed_start=OVERCOMMIT_SEEDS[0] - 40, max_steps=384, pipelined=False)
    s_card, s_cpu = over_card.run_stream(64, **kw), over_cpu.run_stream(64, **kw)
    keys = ("completed", "failing", "infra", "abandoned", "seeds_consumed")
    bad = [k for k in keys if s_card[k] != s_cpu[k]]
    bad += [k for k in ("coverage", "flight_recorder") if s_card["stats"][k] != s_cpu["stats"][k]]
    if bad or (OVERCOMMIT_SEEDS[0], LOG_MATCHING) not in s_card["failing"]:
        fail(f"overcommit stream: card and CPU differ in {bad}, or seed {OVERCOMMIT_SEEDS[0]} was missed: "
             f"{s_card['failing']}")
    emit({"phase": "card_vs_cpu_failing", "lanes": len(seeds), "equal": True,
          "n_failed": int(on_card["failed"].sum()), "stream_failing": s_card["failing"]})
    return {}


def v2_engine(recorder, device=None):
    """The flagship on the split chain (rng_stream=2), the recorder and
    coverage on or off."""
    from madsim_tpu_torch.engine import Engine, EngineConfig, FaultPlan
    from madsim_tpu_torch.models import RaftMachine

    cfg = EngineConfig(**{**FLAGSHIP, "rng_stream": 2, "flight_recorder": recorder, "coverage": recorder},
                       faults=FaultPlan(**FLAGSHIP_FAULTS))
    return Engine(RaftMachine(num_nodes=5, log_capacity=8), cfg, device=device)


def split_chain_checks(torch, np, kernels):
    """Phase 6's checks on the split chain, which time nothing:
    card_vs_cpu_v2 (256 flagship seeds with the recorder and coverage
    off, 64 with both on) and card_vs_cpu_multipaxos."""
    from madsim_tpu_torch.engine import Engine, EngineConfig, FaultPlan
    from madsim_tpu_torch.models import MultiPaxosMachine

    v2 = v2_engine

    # card_vs_cpu_v2: the recorder and coverage off, then both on
    seeds = np.arange(V2_CHECK_LANES, dtype=np.uint32) + 20_000
    off, t_card, t_cpu = card_vs_cpu(lambda d: v2(False, d), seeds, CHECK_STEPS, "v2, recorder off")
    on, t_card_on, t_cpu_on = card_vs_cpu(lambda d: v2(True, d), seeds[:V2_RECORDER_LANES], CHECK_STEPS,
                                          "v2, recorder on")
    emit({"phase": "card_vs_cpu_v2", "lanes": V2_CHECK_LANES, "equal": True, "card_s": round(t_card, 3),
          "cpu_s": round(t_cpu, 3), "max_steps": int(off["steps"].max()), "n_failed": int(off["failed"].sum()),
          "recorder_on": {"lanes": V2_RECORDER_LANES, "equal": True, "card_s": round(t_card_on, 3),
                          "cpu_s": round(t_cpu_on, 3)}})

    # card_vs_cpu_multipaxos: dir, group and storm faults, delay off
    mp_cfg = EngineConfig(**MULTIPAXOS, faults=FaultPlan(**MULTIPAXOS_FAULTS))
    mp, t_card, t_cpu = card_vs_cpu(lambda d: Engine(MultiPaxosMachine(5), mp_cfg, device=d),
                                    np.arange(MULTIPAXOS_LANES, dtype=np.uint32), CHECK_STEPS, "multipaxos")
    emit({"phase": "card_vs_cpu_multipaxos", "lanes": MULTIPAXOS_LANES, "equal": True,
          "card_s": round(t_card, 3), "cpu_s": round(t_cpu, 3), "max_steps": int(mp["steps"].max()),
          "n_done": int(mp["done"].sum()), "n_failed": int(mp["failed"].sum())})
    return {}


def replay_and_corpus(torch, np, kernels):
    """Phase 6's single-lane replays: seed 66531 (replay_66531) and the
    corpus's traced replays, on the card against the CPU. Returns the
    replay's launch counts, its state of seed 66531 REPLAY_STATE_STEPS
    events in, where the pop is timed, and the mvcc and gossip corpus
    replays' states (CORPUS_STATE_STEPS)."""
    from madsim_tpu_torch.engine import Engine, EngineConfig, FaultPlan
    from madsim_tpu_torch.engine import corpus
    from madsim_tpu_torch.engine.replay import replay
    from madsim_tpu_torch.interop import tree_to_numpy
    from madsim_tpu_torch.models import build_machine
    from madsim_tpu_torch.models.multipaxos import AGREEMENT_MULTI
    from madsim_tpu_torch.models.raft import LOG_MATCHING

    # replay_66531: the single-lane replay on the card, against the CPU's
    rp_cfg = EngineConfig(**REPLAY_CONFIG, faults=FaultPlan(**FLAGSHIP_FAULTS))
    kernels.reset_launches()
    t0 = time.perf_counter()
    replays = {name: replay(Engine(build_machine(name), rp_cfg), REPLAY_SEED, max_steps=REPLAY_STEPS)
               for name in ("demo-overcommit-raft", "raft")}
    torch.cuda.synchronize()
    t_card = time.perf_counter() - t0
    replay_launches = dict(kernels.launches)
    if replay_launches["pop_earliest"] <= 0:
        fail("the card's replay never launched pop_earliest")
    bad, over, honest = [], replays["demo-overcommit-raft"], replays["raft"]
    if not (over.failed and over.fail_code == LOG_MATCHING) or honest.failed:
        fail(f"seed {REPLAY_SEED}: overcommit gave {over.failed, over.fail_code}, raft {honest.failed}")
    for name, on_card in replays.items():
        on_cpu = replay(Engine(build_machine(name), rp_cfg, device="cpu"), REPLAY_SEED, max_steps=REPLAY_STEPS)
        if on_card.trace != on_cpu.trace:
            bad.append(f"{name}: trace")
        bad += [f"{name}: {d}" for d in tree_diff(tree_to_numpy(on_card.state), tree_to_numpy(on_cpu.state))]
    if bad:
        fail(f"replay of seed {REPLAY_SEED}: the card differs from the CPU in {bad[:8]}")
    emit({"phase": "replay_66531", "overcommit": [over.fail_code, len(over.trace)],
          "raft": [honest.fail_code, len(honest.trace)], "card_s": round(t_card, 3),
          "launches": replay_launches, "equal": True})
    rp_eng = Engine(build_machine("raft"), rp_cfg)
    replay_state = rp_eng.run_segment(rp_eng.init_batch([REPLAY_SEED]), REPLAY_STATE_STEPS)

    # corpus: the traced replay a user prints of each entry but the
    #   multi-Paxos ones, on the card against the CPU; then the
    #   single-lane states pop_earliest is timed at, Q = 48 and 256. Every
    #   entry's code and digest trail on the card: the `cli` phase's
    #   `regress` and `audit` of corpus.json.
    entries = corpus.load(str(pathlib.Path(__file__).resolve().parent / "corpus.json"))
    t0 = time.perf_counter()
    found = [[e.machine, e.seed, e.fail_code, e.digest_final[0], e.config.queue_capacity] for e in entries]
    if len(found) != 8 or sorted({f[2] for f in found}) != [AGREEMENT_MULTI, 160, 206, 212]:
        fail(f"corpus.json holds {len(found)} entries with codes {sorted({f[2] for f in found})}, not the 8 "
             f"with codes 150, 160, 206 and 212")
    # the traced replay a user prints of each new entry (pop_earliest at
    # Q = 48 and 256), equal to the CPU's
    kernels.reset_launches()
    traced = {}
    for entry in entries:
        if entry.machine == "demo-nopromise-multipaxos":
            continue
        machine = build_machine(entry.machine, entry.nodes)
        before = kernels.launches["pop_earliest"]
        on_card = replay(Engine(machine, entry.config), entry.seed, max_steps=entry.max_steps)
        pops = kernels.launches["pop_earliest"] - before
        on_cpu = replay(Engine(machine, entry.config, device="cpu"), entry.seed, max_steps=entry.max_steps)
        if on_card.trace != on_cpu.trace or on_card.fail_code != entry.fail_code:
            fail(f"traced replay of {entry.machine} seed {entry.seed}: code {on_card.fail_code}, the card's "
                 f"trace {'equals' if on_card.trace == on_cpu.trace else 'differs from'} the CPU's")
        traced[entry.machine] = {"q": entry.config.queue_capacity, "events": len(on_card.trace),
                                 "pop_earliest": pops}
    trace_launches = dict(kernels.launches)
    if trace_launches["pop_earliest"] <= 0:
        fail("the corpus's traced replays never launched pop_earliest")
    emit({"phase": "corpus", "entries": found, "seconds": round(time.perf_counter() - t0, 3),
          "traced": traced, "traces_equal": True, "traced_launches": trace_launches})
    corpus_states = {}
    for entry in entries:
        if entry.machine in CORPUS_STATE_STEPS:
            c_eng = Engine(build_machine(entry.machine, entry.nodes), entry.config)
            corpus_states[entry.machine] = c_eng.run_segment(c_eng.init_batch([entry.seed]),
                                                             CORPUS_STATE_STEPS[entry.machine])
    return replay_launches, replay_state, corpus_states


def stream_v2_phase(torch, np, kernels):
    """Phase 6's stream_v2: the flagship hunt at 8192 lanes on the
    split-chain stream. Returns its launch counts, the v2 flagship state
    the pop kernels are checked on and its engine."""
    # stream_v2: the flagship hunt on the split-chain stream
    eng = v2_engine(True)
    state = eng.run_segment(eng.init_batch(np.arange(LANES, dtype=np.uint32)), 96)
    run = eng.make_stream_runner(batch=LANES, segment_steps=SEGMENT_STEPS, pipelined=False)
    # no warm stream run: the state run above warmed the batch's shapes
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    res = run(HUNT_SEEDS, seed_start=LANES)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = dict(kernels.launches)
    for name in ("pop_gather", "cov_flush"):
        if launches[name] <= 0:
            fail(f"the v2 stream never launched {name}")
    if launches["step_megakernel"]:
        fail("the v2 stream launched the v3 step megakernel")
    segments = res["stats"]["device_segments"]
    emit({"phase": "stream_v2", "completed": res["completed"], "n_failing": len(res["failing"]),
          "failing": res["failing"][:8], "n_infra": len(res["infra"]), "n_abandoned": len(res["abandoned"]),
          "seconds": round(elapsed, 3), "seeds_per_s": round(res["completed"] / elapsed, 2),
          "segments": segments, "ms_per_step": round(elapsed * 1e3 / (segments * SEGMENT_STEPS), 3),
          "slots_hit": res["stats"]["coverage"]["slots_hit"], "launches": launches})
    if res["completed"] < HUNT_SEEDS:
        fail(f"the v2 stream completed {res['completed']} < {HUNT_SEEDS} seeds")
    return launches, state, eng


def spiked_sends(torch, eng, seeds, steps):
    """(sends, spiked) over `steps` event steps of `seeds` on the card: the
    message events each step pushed (seq past the lane's old next_seq),
    and those due more than DELAY_EXTRA_MIN_US out, which only a delay
    spike gives (a plain latency is 1-10 ms)."""
    from madsim_tpu_torch.engine.core import DELAY_EXTRA_MIN_US, EV_MSG

    state = eng.init_batch(seeds)
    sends = spiked = torch.zeros((), dtype=torch.int64, device=eng.device)
    for _ in range(steps):
        old_seq = state.next_seq
        state = eng.step_batch(state)
        new = state.eq_valid & (state.eq_kind == EV_MSG) & (state.eq_seq >= old_seq[:, None])
        sends = sends + new.sum()
        spiked = spiked + (new & (state.eq_time - state.now_us[:, None] > DELAY_EXTRA_MIN_US)).sum()
    return int(sends), int(spiked)


def delay_engine(stream, device=None):
    """The flagship Raft with delay faults on `stream`."""
    from madsim_tpu_torch.engine import Engine, EngineConfig, FaultPlan
    from madsim_tpu_torch.models import RaftMachine

    cfg = EngineConfig(**{**FLAGSHIP, "rng_stream": stream}, faults=FaultPlan(**FLAGSHIP_FAULTS, allow_delay=True))
    return Engine(RaftMachine(num_nodes=5, log_capacity=8), cfg, device=device)


def delay_checks(torch, np, kernels):
    """Phase 7: the delay-spike kind (card_vs_cpu_delay: the flagship Raft
    with delay faults on both streams, card against CPU, the sends that
    took a spike counted, the megakernel at W = 18 and pop_gather held
    against their twins on its state)."""
    out = {}
    seeds = np.arange(DELAY_LANES, dtype=np.uint32) + 30_000
    for stream, kernel in ((3, "step_megakernel"), (2, "pop_gather")):
        card = delay_engine(stream)
        kernels.reset_launches()
        res, t_card, t_cpu = card_vs_cpu(lambda d: card if d is None else delay_engine(stream, "cpu"), seeds,
                                         DELAY_STEPS, f"delay spikes, rng_stream={stream}")
        launches = dict(kernels.launches)
        if launches[kernel] <= 0:
            fail(f"delay spikes on rng_stream={stream} never launched {kernel}")
        sends, spiked = spiked_sends(torch, card, seeds, DELAY_SPIKE_STEPS)
        if not spiked:
            fail(f"delay spikes on rng_stream={stream}: no send took a spike in {DELAY_SPIKE_STEPS} steps")
        state = card.run_segment(card.init_batch(seeds), 96)
        w = card._rng_layout.total_words
        if stream == 3:
            ins, d = step_kernel_ins(state)
            err = max_abs_err(flat_prefix(kernels.step_megakernel(*ins, w, *d)),
                              flat_prefix(kernels.step_prefix_plain(*ins, w, *d)))
        else:
            planes = pop_planes(state)
            got, want = kernels.pop_gather_batch(*planes), kernels.pop_gather_plain(*planes)
            err = max_abs_err([got[0], got[1], *got[2], got[3]], [want[0], want[1], *want[2], want[3]])
        if err:
            fail(f"{kernel} disagrees with its twin on the delay state (rng_stream={stream}): max abs err {err}")
        out[f"rng_stream={stream}"] = {
            "lanes": DELAY_LANES, "equal": True, "card_s": round(t_card, 3), "cpu_s": round(t_cpu, 3),
            "max_steps": int(res["steps"].max()), "n_failed": int(res["failed"].sum()),
            "delay_windows": int(res["fr"]["inj"][:, 5].sum()), "sends": sends, "spiked_sends": spiked,
            "launches": launches, "words": w, kernel: {"max_abs_err": err}}
    emit({"phase": "card_vs_cpu_delay", **out})
    return {}


def delay_kernels(np, kernels, dev):
    """The delay engine's megakernel (v3, W = 18) at the hunt's width,
    8192 lanes 96 steps in: held against its twin and timed
    (`delay_kernels`)."""
    big, w = built("delay", lambda: delay_state(np))
    big_ins, big_d = step_kernel_ins(big)
    err = max_abs_err(flat_prefix(kernels.step_megakernel(*big_ins, w, *big_d)),
                      flat_prefix(kernels.step_prefix_plain(*big_ins, w, *big_d)))
    if err:
        fail(f"step_megakernel disagrees with its twin on the 8192-lane delay state: max abs err {err}")
    nbytes, ops = step_kernel_cost(LANES, big.eq_time.shape[1], big.eq_payload.shape[2], w)
    emit({"phase": "delay_kernels", f"step_megakernel_L{LANES}_W{w}": {
        "lanes": LANES, "words": w, "max_abs_err": err,
        "ms": device_time_ms(lambda: kernels.step_megakernel(*big_ins, w, *big_d)),
        "floor_ms": floor_ms(kernels, "step_megakernel", LANES, dev), "bound_ms": bound(nbytes, ops)[0],
        "bytes": nbytes, "ops": ops}})


def mvcc_hunt_engine(device=None):
    """The give-up hunt's engine: demo-giveup-mvcc under delay spikes."""
    from madsim_tpu_torch.engine import Engine, EngineConfig, FaultPlan
    from madsim_tpu_torch.models import build_machine

    return Engine(build_machine("demo-giveup-mvcc"), EngineConfig(**MVCC_HUNT, faults=FaultPlan(**MVCC_HUNT_FAULTS)),
                  device=device)


def hunt_replays_cpu(torch, np, kernels):
    """The CPU's side of phases 7-9's replays (a CHECK_GROUPS check: it
    times nothing): MVCC_FIRST, PALETTE_FIRST and TORN_FIRST replayed on
    their hunt's CPU engine (replay_doc: code, trace, final state), and
    each of PALETTE_OTHERS replayed there to its code."""
    from madsim_tpu_torch.engine.replay import replay

    palette = palette_hunt_engine("cpu")
    out = {name: replay_doc(replay(eng, seed)) for name, eng, seed in (
        ("mvcc", mvcc_hunt_engine("cpu"), MVCC_FIRST), ("palette", palette, PALETTE_FIRST),
        ("torn", torn_hunt_engine("cpu"), TORN_FIRST))}
    out["palette_others"] = [[seed, replay(palette, seed, trace=False).fail_code] for seed, _ in PALETTE_OTHERS]
    return out


def replay_doc(rp):
    """A replay's code, trace (each event's fields) and final state (each
    leaf's dtype, shape and values by its path), as JSON gives them back."""
    import dataclasses

    from madsim_tpu_torch.interop import tree_to_numpy

    leaves = {}

    def walk(tree, path):
        if isinstance(tree, (dict, tuple)):
            for k, v in (tree.items() if isinstance(tree, dict) else enumerate(tree)):
                walk(v, f"{path}.{k}")
        else:
            leaves[path] = [str(tree.dtype), list(tree.shape), tree.ravel().tolist()]

    walk(tree_to_numpy(rp.state), "")
    return json.loads(json.dumps({"fail_code": rp.fail_code, "trace": [dataclasses.astuple(e) for e in rp.trace],
                                  "state": leaves}))


def replay_diff(card, cpu):
    """Where the card's replay differs from the CPU's replay_doc: the
    code, the trace, each state leaf's path."""
    card = replay_doc(card)
    state = sorted(k for k in card["state"].keys() | cpu["state"].keys() if card["state"].get(k) != cpu["state"].get(k))
    return [k for k in ("fail_code", "trace") if card[k] != cpu[k]] + state


def stream_mvcc_phase(torch, np, kernels, cpu):
    """Phase 7's stream_mvcc: the give-up hunt at 8192 lanes, its first
    ABANDONED_WRITE seed (MVCC_FIRST) replayed on the card against `cpu`,
    the CPU's replay (hunt_replays_cpu). Returns the hunt's launch counts
    and its batch state (8192 lanes, Q = 48, P = 5), where pop + gather
    is timed."""
    from collections import Counter

    from madsim_tpu_torch.engine.replay import replay
    from madsim_tpu_torch.models.etcd_mvcc import ABANDONED_WRITE

    # stream_mvcc: the give-up hunt at full width, through the entry points
    eng = mvcc_hunt_engine()
    state = eng.run_segment(eng.init_batch(np.arange(LANES, dtype=np.uint32)), 24)
    run = eng.make_stream_runner(batch=LANES, segment_steps=SEGMENT_STEPS, pipelined=False)
    # no warm stream run: the state run above warmed the batch's shapes
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    res = run(HUNT_SEEDS, seed_start=LANES)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = dict(kernels.launches)
    for name in ("pop_gather", "cov_flush"):
        if launches[name] <= 0:
            fail(f"the mvcc hunt never launched {name}")
    by_code = Counter(code for _, code in res["failing"])
    first = next((seed for seed, code in res["failing"] if code == ABANDONED_WRITE), None)
    if first != MVCC_FIRST or res["completed"] < HUNT_SEEDS:
        fail(f"the mvcc hunt completed {res['completed']} seeds, failing by code {dict(by_code)}, its first "
             f"ABANDONED_WRITE seed {first}, not {MVCC_FIRST}")
    t1 = time.perf_counter()
    before = kernels.launches["pop_earliest"]
    on_card = replay(mvcc_hunt_engine(), first)
    t_replay = time.perf_counter() - t1
    pops = kernels.launches["pop_earliest"] - before
    bad = replay_diff(on_card, cpu)
    if on_card.fail_code != ABANDONED_WRITE or bad:
        fail(f"mvcc seed {first}: the card replay gave {on_card.fail_code} and differs from the CPU's in {bad[:8]}")
    segments = res["stats"]["device_segments"]
    emit({"phase": "stream_mvcc", "completed": res["completed"], "failing_by_code": dict(by_code),
          "n_infra": len(res["infra"]), "n_abandoned": len(res["abandoned"]), "seconds": round(elapsed, 3),
          "seeds_per_s": round(res["completed"] / elapsed, 2), "segments": segments,
          "ms_per_step": round(elapsed * 1e3 / (segments * SEGMENT_STEPS), 3),
          "slots_hit": res["stats"]["coverage"]["slots_hit"], "launches": launches,
          "replay": {"seed": first, "fail_code": on_card.fail_code, "events": len(on_card.trace),
                     "pop_earliest": pops, "card_s": round(t_replay, 3), "equal": True},
          "profile": profile_steps(eng, state, steps=8)})
    return launches, state


def card_vs_cpu_models(torch, np, kernels):
    """card_vs_cpu_models: run_batch of each model and its corpus demo or
    bug variant on the card against the CPU. Returns the prefix kernel's
    launches of kv, mq and twopc, the models whose kernels are timed on
    their own states (model_states_of)."""
    from collections import Counter

    from madsim_tpu_torch.engine import Engine, EngineConfig, FaultPlan
    from madsim_tpu_torch.models import KvMachine, MqMachine, TwoPcMachine, build_machine
    from madsim_tpu_torch.models.etcd_mvcc import ABANDONED_WRITE
    from madsim_tpu_torch.models.kv import STALE_READ
    from madsim_tpu_torch.models.mq import DUP_OR_GAP
    from madsim_tpu_torch.models.twopc import ATOMICITY

    # a demo must fail with its code on some seed. The bug variants of
    # tests/test_engine.py are subclasses, as there, in no registry
    class DurabilityBugKv(KvMachine):
        def restart_if(self, nodes, i, cond, rng_key):
            return self._wipe_node_if(nodes, i, cond, rng_key)  # the server's store too

    class NoDedupBroker(MqMachine):
        def _accepts(self, nodes, producer, seq):
            return torch.ones_like(seq, dtype=torch.bool)  # retried duplicates append

    class EagerCommitTwoPc(TwoPcMachine):
        def _all_votes_in(self, votes_recv):
            return votes_recv != 0  # decide at the first vote

    bugs = {"DurabilityBugKv": DurabilityBugKv(4), "NoDedupBroker": NoDedupBroker(4),
            "EagerCommitTwoPc": EagerCommitTwoPc(4)}
    out, launches_of = {}, {}
    lanes = range(MODEL_LANES)
    for name, base, faults, model_seeds, steps, code in (
        ("kv", {**KV_PLAN, "rng_stream": 3}, KV_FAULTS, lanes, 160, None),
        ("DurabilityBugKv", {**KV_PLAN, "rng_stream": 3}, KV_KILL_FAULTS, lanes, 160, STALE_READ),
        ("mq", MQ_PLAN, MQ_FAULTS, lanes, 256, None),
        ("NoDedupBroker", NODEDUP_PLAN, {}, lanes, 64, DUP_OR_GAP),
        ("twopc", {**TWOPC_PLAN, "rng_stream": 3}, TWOPC_FAULTS, lanes, 128, None),
        ("EagerCommitTwoPc", {**EAGER_PLAN, "rng_stream": 3}, {}, lanes, 48, ATOMICITY),
        ("etcd-mvcc", MVCC, MVCC_DELAY_FAULTS, range(MODEL_LANES), MVCC_STEPS, None),
        ("demo-giveup-mvcc", MVCC, MVCC_DELAY_FAULTS, range(64), MVCC_STEPS, ABANDONED_WRITE),
        ("s3", MVCC, S3_FAULTS, range(MODEL_LANES), S3_STEPS, None),
        ("demo-abortleak-s3", MVCC, S3_FAULTS, range(64), S3_STEPS, 212),
        ("gossip", GOSSIP, GOSSIP_FAULTS, range(GOSSIP_LANES), GOSSIP_STEPS, None),
        ("demo-dupack-gossip", GOSSIP, DUPACK_FAULTS, DUPACK_SEEDS, DUPACK_STEPS, 160),
        ("paxos", PAXOS_PLAN, PAXOS_FAULTS, range(64), 600, None),
        ("demo-nopromise-paxos", PAXOS_PLAN, NOPROMISE_FAULTS, range(128), 64, 140),
        ("etcd", ETCD_PLAN, ETCD_FAULTS, range(64), 192, None),
        ("demo-doublegrant-etcd", DOUBLEGRANT_PLAN, DOUBLEGRANT_FAULTS, range(100, 164), 200, 120),
        ("group", GROUP_PLAN, GROUP_FAULTS, range(64), 160, None),
        ("demo-nofencing-group", NOFENCING_PLAN, NOFENCING_FAULTS, range(500, 564), 160, 131),
    ):
        cfg = EngineConfig(**base, faults=FaultPlan(**faults))
        machine = bugs[name] if name in bugs else build_machine(name)
        kernel = "step_megakernel" if cfg.rng_stream == 3 else "pop_gather"
        kernels.reset_launches()
        res, t_card, t_cpu = card_vs_cpu(lambda d: Engine(machine, cfg, device=d),
                                         np.array(model_seeds, dtype=np.uint32), steps, name)
        launches = dict(kernels.launches)
        if launches[kernel] <= 0:
            fail(f"{name} on the card never launched {kernel}")
        codes = Counter(int(c) for c, f in zip(res["fail_code"], res["failed"]) if f)
        # kv, mq and twopc run clean, their bugs fail with their code only
        strict = name in bugs or name in ("kv", "mq", "twopc")
        if (code is not None and not codes[code]) or (strict and set(codes) != ({code} if code else set())):
            fail(f"{name}: no seed failed with code {code}, or another code came up ({dict(codes)})")
        out[name] = {"lanes": len(model_seeds), "q": base["queue_capacity"], "rng_stream": cfg.rng_stream,
                     "equal": True, "card_s": round(t_card, 3), "cpu_s": round(t_cpu, 3),
                     "max_steps": int(res["steps"].max()), "n_done": int(res["done"].sum()),
                     "fail_codes": dict(codes), kernel: launches[kernel]}
        if name in KERNEL_MODELS:
            launches_of[name] = launches[kernel]
    emit({"phase": "card_vs_cpu_models", **out})
    return launches_of


# the models whose prefix kernel is held and timed on their own state
# (triage_kernels, pop_kernels): plan, faults and card_vs_cpu_models' step
# budget; the state is a third of that budget in
KERNEL_MODELS = {"kv": ({**KV_PLAN, "rng_stream": 3}, KV_FAULTS, 160), "mq": (MQ_PLAN, MQ_FAULTS, 256),
                 "twopc": ({**TWOPC_PLAN, "rng_stream": 3}, TWOPC_FAULTS, 128)}


def model_states_of(np, launches_of):
    """The states the model leg's prefix kernels are timed on, with the
    check's launches: the counter-stream models' (with their word
    blocks) and mq's on the split chain."""
    from madsim_tpu_torch.engine import Engine, EngineConfig, FaultPlan
    from madsim_tpu_torch.models import build_machine

    model_states = {"v3": [], "v2": None}
    for name, (base, faults, steps) in KERNEL_MODELS.items():
        card = Engine(build_machine(name), EngineConfig(**base, faults=FaultPlan(**faults)))
        state = card.run_segment(card.init_batch(np.arange(MODEL_LANES, dtype=np.uint32)), steps // 3)
        if card.config.rng_stream == 2:
            model_states["v2"] = (state, launches_of[name])
        else:
            model_states["v3"].append((name, state, card._rng_layout.total_words, launches_of[name]))
    return model_states


def coverage_bands(res, band_bits):
    """Per-band slot counts of the OR of a run_batch result's lane maps."""
    from madsim_tpu_torch.ops.coverage import COV_SLOTS_LOG2_DEFAULT
    from madsim_tpu_torch.runtime.coverage import coverage_dict, unpack_map

    lane_maps = unpack_map(res["cov"]["map"], COV_SLOTS_LOG2_DEFAULT)
    return coverage_dict(lane_maps.any(axis=0), COV_SLOTS_LOG2_DEFAULT, band_bits=band_bits)["by_band"]


def palette_hunt_engine(device=None):
    """The dup-vote hunt's engine: demo-dupvote-raft under the whole palette."""
    from madsim_tpu_torch.engine import Engine, EngineConfig, FaultPlan
    from madsim_tpu_torch.models import build_machine

    return Engine(build_machine("demo-dupvote-raft"),
                  EngineConfig(**PALETTE_HUNT, faults=FaultPlan(**PALETTE_HUNT_FAULTS)), device=device)


def palette_checks(torch, np, kernels):
    """Phase 8: the chaos palette. card_vs_cpu_palette (the flagship Raft
    at Q = 96 under pause, skew, dup and strict restarts, both streams)
    and card_vs_cpu_demos (VolatileCommit under strict restarts, the
    dup-vote tally under dup, with a traced replay). Returns the traced
    replay's events, for palette_states_of."""
    from collections import Counter

    from madsim_tpu_torch.engine import Engine, EngineConfig, FaultPlan
    from madsim_tpu_torch.engine.core import K_PAUSE, K_SKEW
    from madsim_tpu_torch.engine.replay import replay
    from madsim_tpu_torch.interop import tree_to_numpy
    from madsim_tpu_torch.models import RaftMachine, build_machine
    from madsim_tpu_torch.models.raft import ELECTION_SAFETY, LOG_MATCHING

    # card_vs_cpu_palette: both streams; v3 launches the megakernel at W = 18
    raft, out = RaftMachine(num_nodes=5, log_capacity=8), {}
    seeds = np.arange(PALETTE_LANES, dtype=np.uint32) + 50_000
    for stream, kernel in ((3, "step_megakernel"), (2, "pop_gather")):
        cfg = EngineConfig(**{**FLAGSHIP, "rng_stream": stream, "queue_capacity": PALETTE_Q},
                           faults=FaultPlan(**PALETTE_FAULTS))
        card = Engine(raft, cfg)
        kernels.reset_launches()
        res, t_card, t_cpu = card_vs_cpu(lambda d: card if d is None else Engine(raft, cfg, device="cpu"), seeds,
                                         PALETTE_STEPS, f"the palette, rng_stream={stream}")
        launches = dict(kernels.launches)
        if launches[kernel] <= 0:
            fail(f"the palette on rng_stream={stream} never launched {kernel}")
        counts = {"pause": int(res["fr"]["inj"][:, K_PAUSE].sum()), "skew": int(res["fr"]["inj"][:, K_SKEW].sum()),
                  "dup": int(res["fr"]["dup"].sum()), "amnesia": int(res["fr"]["amnesia"].sum())}
        all_bands = coverage_bands(res, card.cov_band_bits)
        bands = {b: all_bands[b] for b in ("pause", "skew", "dup", "amnesia")}
        if not all(counts.values()) or not all(bands.values()):
            fail(f"the palette on rng_stream={stream}: a capability never showed: {counts}, bands {bands}")
        out[f"rng_stream={stream}"] = {
            "lanes": PALETTE_LANES, "q": PALETTE_Q, "words": card._rng_layout.total_words, "equal": True,
            "card_s": round(t_card, 3), "cpu_s": round(t_cpu, 3), "max_steps": int(res["steps"].max()),
            "n_failed": int(res["failed"].sum()), "counts": counts, "bands": bands, "launches": launches}
    emit({"phase": "card_vs_cpu_palette", **out})

    # card_vs_cpu_demos: the two demos only these gates reach, each under its
    #   reference test's plan on the default stream
    out = {}
    volatile_cfg = EngineConfig(**VOLATILE, faults=FaultPlan(**VOLATILE_FAULTS))
    seeds = np.arange(VOLATILE_LANES, dtype=np.uint32)
    for name in ("demo-volatilecommit-raft", "raft"):
        machine = build_machine(name)
        kernels.reset_launches()
        res, t_card, t_cpu = card_vs_cpu(lambda d: Engine(machine, volatile_cfg, device=d), seeds, VOLATILE_STEPS,
                                         f"{name} under strict restarts")
        codes = Counter(int(c) for c, f in zip(res["fail_code"], res["failed"]) if f)
        if (name == "raft" and codes) or (name != "raft" and set(codes) != {LOG_MATCHING}):
            fail(f"{name} under strict restarts failed with {dict(codes)}")
        out[name] = {"lanes": VOLATILE_LANES, "equal": True, "card_s": round(t_card, 3), "cpu_s": round(t_cpu, 3),
                     "fail_codes": dict(codes), "pop_gather": kernels.launches["pop_gather"]}
    dupvote_cfg = EngineConfig(**DUPVOTE, faults=FaultPlan(**DUPVOTE_FAULTS))
    machine = build_machine("demo-dupvote-raft")
    kernels.reset_launches()
    res, t_card, t_cpu = card_vs_cpu(lambda d: Engine(machine, dupvote_cfg, device=d),
                                     np.array(DUPVOTE_SEEDS, dtype=np.uint32), DUPVOTE_STEPS, "demo-dupvote-raft")
    codes = Counter(int(c) for c, f in zip(res["fail_code"], res["failed"]) if f)
    if set(codes) != {ELECTION_SAFETY}:
        fail(f"demo-dupvote-raft under dup failed with {dict(codes)} on its seeds")
    batch_launches = dict(kernels.launches)
    # the traced replay of its first seed, pop_earliest and pop + gather at L = 1
    kernels.reset_launches()
    on_card = replay(Engine(machine, dupvote_cfg), DUPVOTE_SEEDS[0], max_steps=DUPVOTE_STEPS)
    replay_launches = dict(kernels.launches)
    on_cpu = replay(Engine(machine, dupvote_cfg, device="cpu"), DUPVOTE_SEEDS[0], max_steps=DUPVOTE_STEPS)
    bad = tree_diff(tree_to_numpy(on_card.state), tree_to_numpy(on_cpu.state))
    if on_card.fail_code != ELECTION_SAFETY or on_card.trace != on_cpu.trace or bad:
        fail(f"dup-vote seed {DUPVOTE_SEEDS[0]}: the card replay gave {on_card.fail_code} and differs from the "
             f"CPU's in {bad[:8] or 'the trace'}")
    if min(replay_launches["pop_earliest"], replay_launches["pop_gather"]) <= 0:
        fail(f"the dup-vote replay on the card launched {replay_launches}")
    out["demo-dupvote-raft"] = {"lanes": len(DUPVOTE_SEEDS), "equal": True, "card_s": round(t_card, 3),
                                "cpu_s": round(t_cpu, 3), "fail_codes": dict(codes),
                                "launches": batch_launches,
                                "replay": {"seed": DUPVOTE_SEEDS[0], "events": len(on_card.trace),
                                           "launches": replay_launches, "equal": True}}
    emit({"phase": "card_vs_cpu_demos", **out})
    return {"dupvote_events": len(on_card.trace)}


def palette_states_of(np, info):
    """The states the pops are timed on: the palette's v2 batch (256
    lanes, Q = 96, 96 steps in) and the dup-vote demo replay's lane (v2,
    Q = 96, half its traced replay's events in)."""
    from madsim_tpu_torch.engine import Engine, EngineConfig, FaultPlan
    from madsim_tpu_torch.models import RaftMachine, build_machine

    cfg = EngineConfig(**{**FLAGSHIP, "rng_stream": 2, "queue_capacity": PALETTE_Q}, faults=FaultPlan(**PALETTE_FAULTS))
    card = Engine(RaftMachine(num_nodes=5, log_capacity=8), cfg)
    d_eng = Engine(build_machine("demo-dupvote-raft"), EngineConfig(**DUPVOTE, faults=FaultPlan(**DUPVOTE_FAULTS)))
    return {"palette_v2": card.run_segment(card.init_batch(np.arange(PALETTE_LANES, dtype=np.uint32) + 50_000), 96),
            "dupvote_replay": d_eng.run_segment(d_eng.init_batch(DUPVOTE_SEEDS[:1]), info["dupvote_events"] // 2)}


def stream_palette_phase(torch, np, kernels, states, cpu):
    """Phase 8's stream_palette: the dup-vote hunt at 8192 lanes, its first
    ELECTION_SAFETY seed (PALETTE_FIRST) replayed on the card against
    `cpu`, the CPU's replays (hunt_replays_cpu: that seed's and those of
    PALETTE_OTHERS, the hunt's first four seeds failing with another
    code, to their codes). Adds to `states` the hunt replay's lane (v3,
    Q = 96), where the pops are timed; returns the hunt's launch
    counts."""
    from collections import Counter

    from madsim_tpu_torch.engine.replay import replay
    from madsim_tpu_torch.models.raft import ELECTION_SAFETY

    # stream_palette: the dup-vote hunt at full width, through the entry points
    eng = palette_hunt_engine()
    machine = eng.machine
    state = eng.run_segment(eng.init_batch(np.arange(LANES, dtype=np.uint32)), 96)
    run = eng.make_stream_runner(batch=LANES, segment_steps=SEGMENT_STEPS, pipelined=False)
    # no warm stream run: the state run above warmed the batch's shapes
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    res = run(HUNT_SEEDS, seed_start=LANES)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = dict(kernels.launches)
    for name in ("step_megakernel", "cov_flush"):
        if launches[name] <= 0:
            fail(f"the palette hunt never launched {name}")
    by_code = Counter(code for _, code in res["failing"])
    first = next((seed for seed, code in res["failing"] if code == ELECTION_SAFETY), None)
    if first != PALETTE_FIRST or res["completed"] < HUNT_SEEDS:
        fail(f"the palette hunt completed {res['completed']} seeds, failing by code {dict(by_code)}, its first "
             f"ELECTION_SAFETY seed {first}, not {PALETTE_FIRST}")
    t1 = time.perf_counter()
    before = dict(kernels.launches)
    on_card = replay(eng, first)
    t_replay = time.perf_counter() - t1
    pops = kernels.launches["pop_earliest"] - before["pop_earliest"]
    replay_steps = kernels.launches["step_megakernel"] - before["step_megakernel"]
    bad = replay_diff(on_card, cpu["palette"])
    if on_card.fail_code != ELECTION_SAFETY or bad:
        fail(f"palette hunt seed {first}: the card replay gave {on_card.fail_code} and differs from the CPU's in "
             f"{bad[:8]}")
    # seeds failing with another code are findings: each replays on the CPU
    # with the code the card gave
    others = [(seed, code) for seed, code in res["failing"] if code != ELECTION_SAFETY][:4]
    if others != list(PALETTE_OTHERS) or [list(o) for o in others] != cpu["palette_others"]:
        fail(f"palette hunt: the card's first other finds {others}, PALETTE_OTHERS {list(PALETTE_OTHERS)}, "
             f"their codes on the CPU {cpu['palette_others']}")
    segments = res["stats"]["device_segments"]
    fr = res["stats"]["flight_recorder"]
    emit({"phase": "stream_palette", "completed": res["completed"], "failing_by_code": dict(by_code),
          "failing_share": round(len(res["failing"]) / res["completed"], 6), "n_infra": len(res["infra"]),
          "n_abandoned": len(res["abandoned"]), "seconds": round(elapsed, 3),
          "seeds_per_s": round(res["completed"] / elapsed, 2), "segments": segments,
          "ms_per_step": round(elapsed * 1e3 / (segments * SEGMENT_STEPS), 3),
          "faults_injected": fr["faults_injected"], "dup_injected": fr["dup_injected"],
          "amnesia_restarts": fr["amnesia_restarts"], "slots_hit": res["stats"]["coverage"]["slots_hit"],
          "by_band": res["stats"]["coverage"]["by_band"], "launches": launches,
          "replay": {"seed": first, "fail_code": on_card.fail_code, "events": len(on_card.trace),
                     "pop_earliest": pops, "step_megakernel": replay_steps, "card_s": round(t_replay, 3),
                     "equal": True},
          "other_codes_replayed_on_cpu": others,
          "profile": profile_steps(eng, state, steps=8)})
    states["palette_replay"] = eng.run_segment(eng.init_batch([first]), PALETTE_REPLAY_STEPS)
    states["palette_replay_launches"] = replay_steps
    states["palette_words"] = eng._rng_layout.total_words
    return launches


def torn_hunt_engine(device=None):
    """The torn-snapshot hunt's engine: demo-tornsnapshot-raft under torn restarts."""
    from madsim_tpu_torch.engine import Engine, EngineConfig, FaultPlan
    from madsim_tpu_torch.models import build_machine

    return Engine(build_machine("demo-tornsnapshot-raft"),
                  EngineConfig(**TORN_HUNT, faults=FaultPlan(**TORN_FAULTS)), device=device)


def storage_checks(torch, np, kernels):
    """Phase 9: the storage kinds. card_vs_cpu_storage (the torn plan on
    TornSnapshotRaftCompact, heal-asym on honest Raft at Q = 48, honest
    raft-compact under every kind, each on both streams). Returns the
    soak's v3 launches and word block, for soak_state_of."""
    from collections import Counter

    from madsim_tpu_torch.engine import Engine, EngineConfig, FaultPlan
    from madsim_tpu_torch.engine.core import K_HEAL_ASYM, K_TORN
    from madsim_tpu_torch.models import build_machine
    from madsim_tpu_torch.models.raft import LOG_MATCHING

    hunt = {k: v for k, v in TORN_HUNT.items() if k != "rng_stream"}
    flags = {k: FLAGSHIP[k] for k in ("flight_recorder", "coverage")}
    cases = (
        ("torn", "demo-tornsnapshot-raft", hunt, TORN_FAULTS, TORN_CHECK_STEPS),
        ("heal_asym", "raft", {**FLAGSHIP, "queue_capacity": HASYM_Q}, {**FLAGSHIP_FAULTS, "allow_heal_asym": True},
         HASYM_STEPS),
        ("soak", "raft-compact", {**SOAK, **flags}, SOAK_FAULTS, SOAK_STEPS),
    )
    seeds = np.arange(STORAGE_LANES, dtype=np.uint32) + 60_000
    out, found = {}, {}
    for name, machine_name, base, faults, steps in cases:
        machine = build_machine(machine_name)
        for stream, kernel in ((3, "step_megakernel"), (2, "pop_gather")):
            cfg = EngineConfig(**{**base, "rng_stream": stream}, faults=FaultPlan(**faults))
            card = Engine(machine, cfg)
            kernels.reset_launches()
            res, t_card, t_cpu = card_vs_cpu(lambda d: card if d is None else Engine(machine, cfg, device="cpu"),
                                             seeds, steps, f"{name}, rng_stream={stream}")
            launches = dict(kernels.launches)
            if launches[kernel] <= 0:
                fail(f"{name} on rng_stream={stream} never launched {kernel}")
            codes = Counter(int(c) for c, f in zip(res["fail_code"], res["failed"]) if f)
            inj = res["fr"]["inj"].sum(axis=0)
            counts = {"torn": int(inj[K_TORN]), "heal_asym": int(inj[K_HEAL_ASYM])}
            if (name == "torn" and set(codes) != {LOG_MATCHING}) or (name == "soak" and codes):
                fail(f"{name} on rng_stream={stream} failed with {dict(codes)}")
            kinds = {"torn": ("torn",), "heal_asym": ("heal_asym",), "soak": ("torn", "heal_asym")}[name]
            if not all(counts[k] for k in kinds):
                fail(f"{name} on rng_stream={stream}: a storage kind was never injected ({counts})")
            all_bands = coverage_bands(res, card.cov_band_bits)
            out[f"{name} rng_stream={stream}"] = {
                "machine": machine_name, "lanes": STORAGE_LANES, "q": base["queue_capacity"],
                "words": card._rng_layout.total_words, "equal": True, "card_s": round(t_card, 3),
                "cpu_s": round(t_cpu, 3), "max_steps": int(res["steps"].max()), "fail_codes": dict(codes),
                "counts": counts, "bands": {b: all_bands[b] for b in ("torn", "heal_asym", "amnesia")},
                "launches": launches}
            if name == "soak" and stream == 3:
                found["soak_launches"] = launches["step_megakernel"]
                found["soak_words"] = card._rng_layout.total_words
    emit({"phase": "card_vs_cpu_storage", **out})
    return found


def soak_state_of(np):
    """The soak's v3 batch (raft-compact, 256 lanes, Q = 96, W = 31, 96
    steps in), where the megakernel is timed."""
    from madsim_tpu_torch.engine import Engine, EngineConfig, FaultPlan
    from madsim_tpu_torch.models import build_machine

    flags = {k: FLAGSHIP[k] for k in ("flight_recorder", "coverage")}
    card = Engine(build_machine("raft-compact"),
                  EngineConfig(**{**SOAK, **flags, "rng_stream": 3}, faults=FaultPlan(**SOAK_FAULTS)))
    return card.run_segment(card.init_batch(np.arange(STORAGE_LANES, dtype=np.uint32) + 60_000), 96)


def stream_torn_phase(torch, np, kernels, found, cpu):
    """Phase 9's stream_torn: the torn-snapshot hunt at 8192 lanes, its
    first seed (TORN_FIRST) replayed on the card against `cpu`, the
    CPU's replay (hunt_replays_cpu). Adds to `found` the
    states and launch counts the new kernel shapes are timed at: the
    hunt's batch (8192 lanes, Q = 64, W = 11) with its buffers a flush
    period in and the hunt replay's lane (Q = 64)."""
    from collections import Counter

    from madsim_tpu_torch.engine.replay import replay
    from madsim_tpu_torch.models.raft import LOG_MATCHING

    # stream_torn: the torn-snapshot hunt at full width, through the entry points
    eng = torn_hunt_engine()
    state = eng.run_segment(eng.init_batch(np.arange(LANES, dtype=np.uint32)), 96)
    run = eng.make_stream_runner(batch=LANES, segment_steps=SEGMENT_STEPS, pipelined=False)
    # no warm stream run: the state run above warmed the batch's shapes
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    res = run(HUNT_SEEDS, seed_start=LANES)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = dict(kernels.launches)
    for name in ("step_megakernel", "cov_flush"):
        if launches[name] <= 0:
            fail(f"the torn hunt never launched {name}")
    by_code = Counter(code for _, code in res["failing"])
    first = res["failing"][0][0] if res["failing"] else None
    if set(by_code) != {LOG_MATCHING} or res["completed"] < HUNT_SEEDS or first != TORN_FIRST:
        fail(f"the torn hunt completed {res['completed']} seeds, failing by code {dict(by_code)}: not "
             f"LOG_MATCHING alone, or its first seed {first}, not {TORN_FIRST}")
    t1 = time.perf_counter()
    before = dict(kernels.launches)
    on_card = replay(eng, first)
    t_replay = time.perf_counter() - t1
    replay_launches = {k: kernels.launches[k] - before[k] for k in ("pop_earliest", "step_megakernel")}
    bad = replay_diff(on_card, cpu)
    if on_card.fail_code != LOG_MATCHING or cpu["fail_code"] != LOG_MATCHING or bad:
        fail(f"torn hunt seed {first}: the card replay gave {on_card.fail_code}, the CPU's {cpu['fail_code']}, "
             f"differing in {bad[:8]}")
    segments = res["stats"]["device_segments"]
    fr = res["stats"]["flight_recorder"]
    emit({"phase": "stream_torn", "completed": res["completed"], "failing_by_code": dict(by_code),
          "failing_share": round(len(res["failing"]) / res["completed"], 6), "n_infra": len(res["infra"]),
          "n_abandoned": len(res["abandoned"]), "seconds": round(elapsed, 3),
          "seeds_per_s": round(res["completed"] / elapsed, 2), "segments": segments,
          "ms_per_step": round(elapsed * 1e3 / (segments * SEGMENT_STEPS), 3),
          "faults_injected": fr["faults_injected"], "amnesia_restarts": fr["amnesia_restarts"],
          "slots_hit": res["stats"]["coverage"]["slots_hit"], "by_band": res["stats"]["coverage"]["by_band"],
          "launches": launches,
          "replay": {"seed": first, "fail_code": on_card.fail_code, "events": len(on_card.trace),
                     "launches": replay_launches, "card_s": round(t_replay, 3), "equal": True},
          "profile": profile_steps(eng, state, steps=8)})
    for _ in range(eng._cov_flush_every):
        state = eng.step_batch(state)
    found.update(hunt_state=state, hunt_words=eng._rng_layout.total_words, hunt_launches=launches,
                 replay_launches=replay_launches,
                 replay_state=eng.run_segment(eng.init_batch([first]), TORN_REPLAY_STEPS))
    return found


def triage_engine(device=None):
    """The triage hunt's engine: demo-doublegrant-etcd with the trace ring."""
    from madsim_tpu_torch.engine import Engine, EngineConfig, FaultPlan
    from madsim_tpu_torch.models import build_machine

    return Engine(build_machine("demo-doublegrant-etcd"), EngineConfig(**TRIAGE, faults=FaultPlan(**TRIAGE_FAULTS)),
                  device=device)


def trace_keys(events):
    return [(e.step, e.time_us, e.kind, e.node, e.src, e.payload) for e in events]


def triage_phase(torch, np, kernels, eng, checks, states):
    """Phase 10: what a user does with a found bug, on the card. The hunt
    (make_runner at 8192 lanes, TRIAGE_STEPS events, with 8 steps profiled
    with the ring on and off), then `checks`, what the window's triage
    check group (triage_checks) gave for a hunt of the same lanes, and
    `states`, what triage_states_of built from it. One `triage` line.
    Returns what `triage_kernels` and `pop_kernels` time: the hunt's
    state and launches, a replay's state and the post-mortem's launches."""
    import dataclasses
    from collections import Counter

    from madsim_tpu_torch.engine import Engine
    from madsim_tpu_torch.models.etcd import LEASE_SAFETY

    seeds = np.arange(LANES, dtype=np.uint32)

    # 1. the hunt, through the entry points: make_runner, failing_seeds
    run = eng.make_runner(max_steps=TRIAGE_STEPS)
    run(seeds[:256])  # warm
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    res = run(seeds)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    hunt_launches = dict(kernels.launches)
    for name in ("step_megakernel", "cov_flush"):
        if hunt_launches[name] <= 0:
            fail(f"the triage hunt never launched {name}")
    failing = eng.failing_seeds(res).tolist()
    by_code = Counter(res.fail_code[res.failed].tolist())
    if len(failing) < TRIAGE_MIN_FAILING or set(by_code) != {LEASE_SAFETY}:
        fail(f"the triage hunt failed {len(failing)} lanes by code {dict(by_code)}: not >= {TRIAGE_MIN_FAILING} "
             f"LEASE_SAFETY alone")
    ring_bytes = sum(v.numel() * v.element_size() for v in res.ring.values())
    # the ring's price: 8 steps of the same batch with the ring on and off
    state = eng.run_segment(eng.init_batch(seeds), TRIAGE_STATE_STEPS)
    no_ring = Engine(eng.machine, dataclasses.replace(eng.config, trace_ring=0))
    profiles = {"ring_on": profile_steps(eng, state, steps=8),
                "ring_off": profile_steps(no_ring, no_ring.run_segment(no_ring.init_batch(seeds), TRIAGE_STATE_STEPS),
                                          steps=8)}
    hunt = {"lanes": LANES, "max_steps": TRIAGE_STEPS, "seconds": round(elapsed, 3),
            "ms_per_step": round(elapsed * 1e3 / TRIAGE_STEPS, 3), "n_failing": len(failing),
            "failing_by_code": dict(by_code), "ring_bytes": ring_bytes, "launches": hunt_launches, **profiles}
    if checks["seeds"] != res.seeds.tolist() or checks["failed"] != res.failed.tolist():
        fail("the triage hunt's lanes differ from those of the same hunt the window checked")
    emit({"phase": "triage", "hunt": hunt, **checks["line"]})
    for _ in range(eng._cov_flush_every):
        state = eng.step_batch(state)  # a flush period of entries in the buffers
    return {"hunt_state": state, "hunt_launches": hunt_launches, "words": eng._rng_layout.total_words, **states}


def triage_checks(torch, np, kernels):
    """Phase 10's checks (in CHECK_GROUPS' tail_replays: a process of its
    own in the window, so that its launch counts are its own), on an untimed
    triage hunt of the lanes the tail's timed hunt runs (triage_phase
    holds the two equal): the post-mortem (the first failing lanes'
    rings against the tails of their replays on the card, those replays
    against the CPU's), the shrink of the first failing seed on the card
    and on the CPU, the shrunk entry recorded on the card, added to a
    corpus file and checked and audited on the CPU (and one recorded on
    the CPU audited on the card), and the exports of the card's and the
    CPU's traces, byte for byte. Returns the `triage` line's fields but
    the hunt's, the post-mortem's and the corpus replays' launches, what
    triage_states_of builds the kernel phases' states from (the first
    failing seed and its whole shrunk config) and the hunt's seeds and
    failed lanes."""
    import dataclasses
    import tempfile

    from madsim_tpu_torch.engine import audit, corpus, trace_export
    from madsim_tpu_torch.engine.replay import replay
    from madsim_tpu_torch.engine.shrink import shrink
    from madsim_tpu_torch.models import build_machine
    from madsim_tpu_torch.models.etcd import LEASE_SAFETY

    eng, cpu = triage_engine(), triage_engine("cpu")
    res = eng.make_runner(max_steps=TRIAGE_STEPS)(np.arange(LANES, dtype=np.uint32))

    # 2. the post-mortem: the first failing lanes' rings are the tails of
    #    their replays on the card, and those replays are the CPU's
    lanes = np.nonzero(res.failed.cpu().numpy())[0][:POSTMORTEM_LANES].tolist()
    kernels.reset_launches()
    t_card = t_cpu = 0.0
    traces = {}
    for lane in lanes:
        seed = int(res.seeds[lane])
        ring = eng.ring_trace(res, lane)
        t0 = time.perf_counter()
        on_card = replay(eng, seed, max_steps=TRIAGE_STEPS)
        t_card += time.perf_counter() - t0
        t0 = time.perf_counter()
        on_cpu = replay(cpu, seed, max_steps=TRIAGE_STEPS)
        t_cpu += time.perf_counter() - t0
        if not ring or trace_keys(ring) != trace_keys(on_card.trace[-len(ring):]):
            fail(f"triage lane {lane} (seed {seed}): its ring differs from the tail of its replay on the card")
        if on_card.trace != on_cpu.trace or {on_card.fail_code, on_cpu.fail_code} != {LEASE_SAFETY}:
            fail(f"triage seed {seed}: the card's replay ({on_card.fail_code}) differs from the CPU's "
                 f"({on_cpu.fail_code})")
        traces[seed] = (on_card.trace, on_cpu.trace)
    postmortem_launches = dict(kernels.launches)
    if min(postmortem_launches["pop_earliest"], postmortem_launches["step_megakernel"]) <= 0:
        fail(f"the post-mortem replays on the card launched {postmortem_launches}")
    postmortem = {"lanes": lanes, "events": [len(t[0]) for t in traces.values()], "equal": True,
                  "card_s": round(t_card, 3), "cpu_s": round(t_cpu, 3), "launches": postmortem_launches}

    # 3. the shrink of the first failing seed, on the card and on the CPU
    seed = int(res.seeds[lanes[0]])
    kernels.reset_launches()
    t0 = time.perf_counter()
    sr = shrink(eng, seed, max_steps=TRIAGE_STEPS)
    t_card = time.perf_counter() - t0
    shrink_launches = dict(kernels.launches)
    t0 = time.perf_counter()
    sr_cpu = shrink(cpu, seed, max_steps=TRIAGE_STEPS)
    t_cpu = time.perf_counter() - t0
    fields = ("steps", "fail_time_us", "attempts", "kinds_removed")
    if corpus.config_to_dict(sr.shrunk) != corpus.config_to_dict(sr_cpu.shrunk) or \
            any(getattr(sr, f) != getattr(sr_cpu, f) for f in fields) or sr.fail_code != LEASE_SAFETY:
        fail(f"the shrink of seed {seed} on the card ({sr.summary()}) differs from the CPU's ({sr_cpu.summary()})")
    shrunk = {"seed": seed, "summary": sr.summary(), "replays": sr.attempts, "card_s": round(t_card, 3),
              "cpu_s": round(t_cpu, 3), "equal": True, "launches": shrink_launches}

    # 4. the corpus: recorded on the card, added, checked and audited on the
    #    CPU; recorded on the CPU, audited on the card
    entry = corpus.CorpusEntry(machine="demo-doublegrant-etcd", seed=seed, fail_code=sr.fail_code, status="open",
                               config=sr.shrunk, max_steps=sr.steps, note="the triage phase's shrunk find")
    kernels.reset_launches()
    t0 = time.perf_counter()
    card_entry, trail = audit.record_entry(entry, build_machine, every=TRIAGE_DIGEST_EVERY)
    t_record = time.perf_counter() - t0
    corpus_launches = kernels.launches["step_megakernel"]
    cpu_entry, _ = audit.record_entry(entry, build_machine, every=TRIAGE_DIGEST_EVERY, device="cpu")
    with tempfile.TemporaryDirectory() as tmp:
        card_file, cpu_file = f"{tmp}/card.json", f"{tmp}/cpu.json"
        if not corpus.add(card_file, card_entry) or corpus.add(card_file, card_entry):
            fail("corpus.add did not add the entry once and refuse it the second time")
        (from_card,) = corpus.load(card_file)
        check = corpus.check(from_card, build_machine, device="cpu")
        on_cpu = audit.audit_entry(from_card, build_machine, device="cpu")
        corpus.add(cpu_file, cpu_entry)
        (from_cpu,) = corpus.load(cpu_file)
        before = kernels.launches["step_megakernel"]
        on_card = audit.audit_entry(from_cpu, build_machine)
        corpus_launches += kernels.launches["step_megakernel"] - before
    if not check.verdict.startswith("still open") or on_cpu.status != "match" or on_card.status != "match" or \
            card_entry.digests != cpu_entry.digests or card_entry.digest_final != cpu_entry.digest_final:
        fail(f"the recorded entry: check '{check.verdict}', audits {on_cpu.status} (CPU) / {on_card.status} (card)")
    corpus_line = {"checkpoints": len(card_entry.digests), "digest_final": card_entry.digest_final,
                   "check": check.verdict, "audit_cpu": on_cpu.status, "audit_card": on_card.status,
                   "record_card_s": round(t_record, 3), "step_megakernel": corpus_launches, "meta": card_entry.meta}

    # 5. the exports of the card's and the CPU's traces, byte for byte
    seed, (card_trace, cpu_trace) = next(iter(traces.items()))
    sizes = {}
    with tempfile.TemporaryDirectory() as tmp:
        for name, write in (("perfetto", trace_export.write_perfetto), ("jsonl", trace_export.write_jsonl)):
            blobs = []
            for who, trace in (("card", card_trace), ("cpu", cpu_trace)):
                path = f"{tmp}/{who}.{name}"
                write(path, trace, machine="demo-doublegrant-etcd", seed=seed)
                blobs.append(pathlib.Path(path).read_bytes())
            if blobs[0] != blobs[1]:
                fail(f"the {name} export of seed {seed}'s card trace differs from the CPU's")
            sizes[name] = len(blobs[0])
    return {"line": {"postmortem": postmortem, "shrink": shrunk, "corpus": corpus_line,
                     "export": {"seed": seed, "bytes": sizes, "equal": True}},
            "replay_launches": postmortem_launches, "entry_launches": corpus_launches, "seed": seed,
            "shrunk": dataclasses.asdict(sr.shrunk), "seeds": res.seeds.tolist(), "failed": res.failed.tolist()}


def triage_states_of(np, info):
    """The states triage_kernels and pop_kernels time on, from the triage
    check group's results `info`: the first failing seed's lane
    TRIAGE_STATE_STEPS in, and the corpus replays' shape (that seed's
    lane under its shrunk config, the recorder on); with the group's
    launches."""
    import dataclasses

    from madsim_tpu_torch.engine import Engine, corpus

    eng, seed = triage_engine(), info["seed"]
    shrunk_eng = Engine(eng.machine, dataclasses.replace(corpus.config_from_dict(info["shrunk"]), trace_ring=0,
                                                         flight_recorder=True, fr_digest_every=TRIAGE_DIGEST_EVERY))
    return {"replay_state": eng.run_segment(eng.init_batch([seed]), TRIAGE_STATE_STEPS),
            "replay_launches": info["replay_launches"],
            "entry_state": shrunk_eng.run_segment(shrunk_eng.init_batch([seed]), TRIAGE_STATE_STEPS),
            "entry_words": shrunk_eng._rng_layout.total_words, "entry_launches": info["entry_launches"]}


def triage_kernels(kernels, dev, found, model_states):
    """Each new shape of phase 10, held and timed where it runs: the
    megakernel at the triage hunt's 8192 lanes, Q = 96, W = 10, its
    replays' L = 1, the recorded entry's L = 1 (the shrunk config's
    narrower word block), and at the model leg's counter-stream shapes
    (256 lanes, Q = 64); the flush on the hunt's buffers. pop_gather at the
    model leg's split chain and pop_earliest at the replays' L = 1 are in
    `pop_kernels`."""
    time_kernel_shapes(kernels, dev, "triage_kernels", (
        ("step_megakernel_triage", found["hunt_state"], found["words"], found["hunt_launches"]["step_megakernel"]),
        ("step_megakernel_L1_Q96_W10", found["replay_state"], found["words"],
         found["replay_launches"]["step_megakernel"]),
        (f"step_megakernel_L1_Q96_W{found['entry_words']}", found["entry_state"], found["entry_words"],
         found["entry_launches"]),
        *((f"step_megakernel_{name}", state, words, n) for name, state, words, n in model_states["v3"]),
    ), (("cov_flush_triage", found["hunt_state"].cov, found["hunt_launches"]["cov_flush"]),))


def time_pop(kernels, dev, state, gather=True):
    """pop_gather (with `gather`) or pop_earliest against its twin on a
    main path's state, then its time there, the twin's, (bytes,
    operations) and its floor."""
    import torch

    if gather:
        name, ins = "pop_gather", pop_planes(state)
        fn, plain = kernels.pop_gather_batch, kernels.pop_gather_plain

        def flat(r):
            return [r[0], r[1], *r[2], r[3]]
    else:
        name, ins = "pop_earliest", pop_planes(state, gather=False)
        fn, plain, flat = kernels.pop_earliest_batch, kernels.pop_earliest_plain, list
    got, want = fn(*ins), plain(*ins)
    torch.cuda.synchronize()
    err = max_abs_err(flat(got), flat(want))
    lanes, q = state.eq_time.shape
    if err:
        fail(f"{name} disagrees with its twin at L = {lanes}, Q = {q}: max abs err {err}")
    ms = device_time_ms(lambda: fn(*ins))
    plain_ms = wall_time_ms(lambda: plain(*ins))
    # the pop alone reads the three planes whole (9 B a slot) and writes
    # idx and any; three compares a slot, one per argmin stage
    nbytes = pop_gather_bytes(lanes, q, state.eq_payload.shape[2]) if gather else lanes * (9 * q + 4 + 1)
    return err, ms, plain_ms, nbytes, lanes * 3 * q, floor_ms(kernels, name, lanes, dev)


def time_kernel_shapes(kernels, dev, phase, steps, flushes, pops=(), earliest=()):
    """Each megakernel shape (name, state, words, launches), each flush
    (name, the coverage leaves, launches), each pop + gather shape and
    each pop shape (name, state, launches) against its twin on the state
    of the path that launches it, then timed there with its floor and
    bound; one `phase` line."""
    out = {}
    for name, state, words, n in steps:
        err, ms, plain, nbytes, ops, floor = time_step_kernel(kernels, dev, state, words)
        out[name] = {"lanes": state.eq_time.shape[0], "q": state.eq_time.shape[1], "words": words,
                     "digest": bool(state.fr), "ms": ms, "plain_ms": plain, "floor_ms": floor, "bytes": nbytes,
                     "ops": ops, "launches": n, "max_abs_err": err}
    for name, cov, n in flushes:
        err, ms, plain, nbytes, ops, live, sectors, floor = time_cov_flush(kernels, dev, cov)
        out[name] = {"lanes": cov["buf"].shape[0], "ms": ms, "plain_ms": plain, "floor_ms": floor,
                     "bytes": nbytes, "ops": ops, "live_entries": live, "live_sectors": sectors, "launches": n,
                     "max_abs_err": err}
    for gather, shapes in ((True, pops), (False, earliest)):
        for name, state, n in shapes:
            err, ms, plain, nbytes, ops, floor = time_pop(kernels, dev, state, gather)
            out[name] = {"lanes": state.eq_time.shape[0], "q": state.eq_time.shape[1], "ms": ms, "plain_ms": plain,
                         "floor_ms": floor, "bytes": nbytes, "ops": ops, "launches": n, "max_abs_err": err}
    for k in out.values():
        k["bound_ms"], k["bound_by"] = bound(k["bytes"], k["ops"])
        k["launches_x_excess_ms"] = k["launches"] * (k["ms"] - k["bound_ms"])
    emit({"phase": phase, **out})
    return out


def storage_kernels(kernels, dev, found, palette_states):
    """Each new megakernel and flush shape of phases 8-9, held and timed
    where it runs: the megakernel at the torn hunt's W = 11 / Q = 64
    (8192 lanes) and its replay's L = 1, the soak's W = 31 / Q = 96 (256
    lanes) and the palette hunt replay's L = 1 / Q = 96; the flush on the
    torn hunt's buffers. The torn replay's pop_earliest is held and timed
    in `pop_kernels`."""
    time_kernel_shapes(kernels, dev, "storage_kernels", (
        ("step_megakernel_torn", found["hunt_state"], found["hunt_words"], found["hunt_launches"]["step_megakernel"]),
        ("step_megakernel_L1_Q64", found["replay_state"], found["hunt_words"],
         found["replay_launches"]["step_megakernel"]),
        ("step_megakernel_soak", found["soak_state"], found["soak_words"], found["soak_launches"]),
        ("step_megakernel_L1_Q96", palette_states["palette_replay"], palette_states["palette_words"],
         palette_states["palette_replay_launches"]),
    ), (("cov_flush_torn", found["hunt_state"].cov, found["hunt_launches"]["cov_flush"]),))


def time_in_turns(kernels, designs, fn):
    """Device time of `fn` under each design's libraries, in turns: the
    designs in order, then in reverse (A, B, B, A). {name: [ms, ms]}."""
    out = {name: [] for name, _ in designs}
    for name, libs in designs + designs[::-1]:
        with mock.patch.object(kernels, "load", lambda: libs):
            out[name].append(device_time_ms(fn))
    return out


def check_designs(kernels, designs, fn, plain, what):
    """Each design's outputs of `fn` bit for bit against the twin's."""
    import torch

    want = plain()
    for name, libs in designs:
        with mock.patch.object(kernels, "load", lambda: libs):
            got = fn()
        torch.cuda.synchronize()
        e = max_abs_err(got, want)
        if e:
            fail(f"head to head: {what} of design {name} disagrees with its twin: max abs err {e}")


def ptxas_line(build, libs):
    """ptxas's account of each kernel; fails if a kernel spills or
    reports nothing."""
    report = build.ptxas_report(libs)
    for key in ("step_megakernel_kernel", "pop_gather_kernel", "pop_earliest_kernel", "cov_flush_kernel"):
        mine = {name: r for name, r in report.items() if key in name}
        if not mine:
            fail(f"ptxas reported nothing for {key}")
        for name, r in mine.items():
            if r["spill_stores"] or r["spill_loads"]:
                fail(f"{name} spills: {r}")
    return report


# phase 11, the command line: `python -m madsim_tpu_torch` in
# subprocesses on the card. The hunt is the flagship's shape under the
# command line's own plan (100-800 ms faults) with strict restarts, on
# the volatile-commit Raft demo, whose bug this shape finds in ~11% of
# seeds (the port on the CPU: 31 of the first 279 seeds, all 102).
CLI_LANES = 8192
CLI_SHAPE = ["--rng-stream", "3", "--queue", "32", "--horizon", "5", "--faults", "2", "--fault-tmax", "3000000"]
CLI_HUNT = ["--machine", "demo-volatilecommit-raft", "--strict-restart", *CLI_SHAPE]
# the explore pair: lanes cut at 1,152 events, three 384-step segments,
# where a flagship lane ends (so the pipelined executor predicates
# segments and stops issuing as it does uncut)
CLI_EXPLORE = ["explore", "--stream", "--machine", "raft", "--seeds", str(CLI_LANES), "--batch",
               str(CLI_LANES), "--max-steps", "1152", *CLI_SHAPE, "--flight-recorder", "--coverage", "--log-level",
               "INFO"]
# the 64-lane explore on the card and the CPU: lanes cut at 384 events
CLI_SMALL = ["explore", "--stream", "--machine", "raft", "--seeds", "64", "--batch", "64", "--max-steps", "384",
             *CLI_SHAPE, "--flight-recorder", "--coverage"]
CLI_JOBS = 6  # commands run at once where nothing is timed (8 host cores)
# the hunt's first failing seed (code 102), so the commands that take only
# a seed (shrink, replay, trace, why) start beside the hunt; a hunt that
# finds another first fails the phase
CLI_FIRST_FIND = 19
# runs the module as `python -m` does, then writes to the path given
# first the wrappers' launch counts of that process, the executor
# statistics and launches of each of its run_stream calls and each guided
# batch's (run_seed_batch's) word block, lanes and launches
CLI_LAUNCHER = (
    "import atexit, json, runpy, sys\n"
    "out = sys.argv.pop(1)\n"
    "from madsim_tpu_torch.engine.core import Engine\n"
    "from madsim_tpu_torch.ops import kernels\n"
    "streams, run_stream = [], Engine.run_stream\n"
    "def counted(self, *args, **kwargs):\n"
    "    before = dict(kernels.launches)\n"
    "    res = run_stream(self, *args, **kwargs)\n"
    "    streams.append({**{k: v for k, v in res['stats'].items() if isinstance(v, (bool, int))},\n"
    "                    'launches': {k: v - before.get(k, 0) for k, v in kernels.launches.items()}})\n"
    "    return res\n"
    "Engine.run_stream = counted\n"
    "batches, run_seed_batch = [], Engine.run_seed_batch\n"
    "def counted_batch(self, *args, **kwargs):\n"
    "    before = dict(kernels.launches)\n"
    "    res = run_seed_batch(self, *args, **kwargs)\n"
    "    batches.append({'words': self._rng_layout.total_words, 'lanes': res['completed'],\n"
    "                    'launches': {k: v - before.get(k, 0) for k, v in kernels.launches.items()}})\n"
    "    return res\n"
    "Engine.run_seed_batch = counted_batch\n"
    "atexit.register(lambda: json.dump({'launches': kernels.launches, 'streams': streams, 'batches': batches},\n"
    "                                  open(out, 'w')))\n"
    "sys.argv[0] = 'madsim_tpu_torch'\n"
    "runpy.run_module('madsim_tpu_torch', run_name='__main__', alter_sys=True)\n"
)

# phase 14, guided search: phase 11's hunt arguments with coverage,
# provenance and guidance at full width (two batches of 8192 lanes; a
# guided batch runs every lane to its end, so the batch lasts as long as
# its longest lane: on the JAX package's CPU run of 2048 of these seeds
# the median lane ends at 219 events, the 99th percentile at 1,829, the
# longest at 2,655, so lanes are cut at 600 events, a depth that keeps the
# smoke inside its time limit); beside it the same hunt at 64 lanes, five
# batches (the last under the escalated vocabulary: on the CPU port the
# cell grid plateaus after the fourth at this cut too), lanes cut at 384
# events, on the card and the CPU; the first finds of the full-width hunt
# re-run on the CPU
GUIDED_ARGS = [*CLI_HUNT, "--stream", "--coverage", "--provenance", "--guided", "--stop-on-plateau", "1",
               "--limit", "0", "--log-level", "INFO"]
GUIDED_LANES, GUIDED_BATCHES, GUIDED_STEPS = 8192, 2, 600
GUIDED_SMALL_LANES, GUIDED_SMALL_BATCHES, GUIDED_SMALL_STEPS = 64, 5, 384
GUIDED_RERUN = 64
GUIDED_STATE_STEPS = 64  # the escalated batch's state its kernels are timed on: this far in
# phase 15, the Raft differential's device side at the fixture of
# tests/test_differential.py:21-28 (Q = 96, the split chain), 64 seeds
DIFF = dict(horizon_us=5_000_000, queue_capacity=96)
DIFF_FAULTS = dict(n_faults=2, t_max_us=3_000_000, dur_min_us=200_000, dur_max_us=800_000)
DIFF_LANES, DIFF_STEPS = 64, 3000
DIFF_STATE_STEPS = 96  # the differential's states its pop is timed on: this far in (lanes live)
# the whole differential, both engines on the port: 256 seeds of the
# fixture; the vote bug planted in both engines, on the plan of
# tests/test_differential.py:62-102 (16 seeds, a 3 s horizon); and
# Runtime.check_determinism of the host example's scenario on 4 seeds
DIFF_WHOLE_LANES = 256
DIFF_BUG = dict(horizon_us=3_000_000, queue_capacity=96)
DIFF_BUG_FAULTS = dict(n_faults=2, t_max_us=2_000_000, dur_min_us=200_000, dur_max_us=600_000)
DIFF_BUG_SEEDS, DIFF_DETERMINISM_SEEDS = 16, 4
# the host engine's native core (madsim_tpu_torch/_native/hostcore.cc)
# against its pure-Python path (MADSIM_TPU_NO_NATIVE=1, a process of its
# own): run_host_raft on 64 seeds of the differential's fixture, the chaos
# scenario of tests/test_native.py:80-116 at seed 11, and
# Runtime.check_determinism of the host example's scenario on 4 seeds
NATIVE_SEEDS, NATIVE_CHECK_SEEDS = 64, 4


# phase 16, the perf tooling: the command line's perf commands on the
# flagship (raft, the command line's flagship shape, the recorder and
# buffered coverage on). `perf` streams one batch of 8192 lanes in
# 384-step segments; `prof` captures one 256-step segment (its run_stream's
# default) of 8192 lanes, its lanes cut at 256 events so that one
# segment completes them all: ~1,050 kernels a step, their launches and
# kineto's flow arrows make ~1.1 M events; the v2 leg the same on the
# split chain; `bench-ab` of two gates at 256 lanes, one rep pair, lanes
# cut at 128 events (a check that it runs, not a gate's cost). The CPU's
# `prof --merge` of 8 lanes replays the same trace seed for the virtual
# track.
PERF_LANES = 8192
PERF_ARGS = ["--machine", "raft", *CLI_SHAPE, "--flight-recorder", "--coverage"]
PERF_ARGS_V2 = ["--machine", "raft", "--rng-stream", "2", *CLI_SHAPE[2:], "--flight-recorder", "--coverage"]
PERF_SPANS = ("compile", "dispatch", "counters_poll", "ring_drain", "harvest", "run_stream", "engine_build")
PROF_STEPS, PROF_TRACE_SEED, PROF_CPU_LANES = 256, 5, 8
AB_LANES, AB_STEPS = 256, 128
# the device phases whose busy time the capture is split by (the innermost
# madsim.* range around each kernel's launch); `cov_flush` is the cadence
# and exit flushes, `outside` no phase
PROF_PHASES = ("step", "cov_flush", "refill", "harvest", "ring_append", "fr_fold", "cov_fold", "counters",
               "dispatch", "compile", "init", "counters_poll", "ring_drain", "outside")


# phase 17, the hunt fleet: `fleet serve` over one store root, and the
# jobs through `fleet worker` subprocesses. The flagship job is phase
# 11's hunt (CLI_HUNT: rng_stream 3, Q = 32, 5 s horizon, strict
# restarts) as a job spec with coverage and provenance, two units of 8192
# lanes, one find shrunk and filed; the replacement job is the same spec
# without shrink, at a lower priority so the first worker never takes it.
# The handover job is a guided 64-lane hunt on the spec's default split
# chain (pop_gather), lanes cut at 384 events as phase 14's 64-lane twin:
# on the CPU port its first batch already fails seeds and its cell grid
# plateaus after the sixth, so the seventh runs under escalation step 1;
# the card's worker runs its first unit, a CPU worker the other six and
# the closing unit. The profile job is one 64-lane batch of it cut at 12
# events under MADSIM_TPU_XPROF=1: a v2 step is ~1,690 kernels, ~7,000
# capture events with their launches and flow arrows, so the unit's
# capture (its warm-up and its batch) stays near 0.17 M events, which
# `fleet profile` merges inside the client's 30 s on a busy host. Every worker runs with
# --log-level INFO (warm-ups and heartbeats on stderr).
FLEET_LANES, FLEET_UNITS = 8192, 2
FLEET_SPEC = {"machine": "demo-volatilecommit-raft", "strict_restart": True, "rng_stream": 3, "queue": 32,
              "horizon": 5.0, "faults": 2, "fault_tmax": 3_000_000, "coverage": True, "provenance": True,
              "batch": FLEET_LANES, "seeds": FLEET_UNITS * FLEET_LANES, "shrink_limit": 1}
FLEET_GUIDED_BATCHES = 7
FLEET_GUIDED = {"machine": "demo-volatilecommit-raft", "strict_restart": True, "queue": 32, "horizon": 5.0,
                "faults": 2, "fault_tmax": 3_000_000, "coverage": True, "provenance": True, "guided": True,
                "stop_on_plateau": 1, "batch": 64, "seeds": FLEET_GUIDED_BATCHES * 64, "max_steps": 384,
                "shrink_limit": 0}
FLEET_PROFILE = {**FLEET_GUIDED, "seeds": 64, "max_steps": 12}
FLEET_TTL = 5  # the killed worker's lease: it lapses inside a unit, and no one reclaims it there
FLEET_UNIT = re.compile(r"unit (\S+): batch (\d+)/(\d+), (\d+) seeds total in ([0-9.]+)s, engine (\w+), "
                        r"(\d+) failing so far")


# every process spawn_cli starts, killed at exit if still running (a
# failure elsewhere must not leave phase 17's workers behind)
_CHILDREN = []


def _kill_children():
    for proc in _CHILDREN:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def _track(proc):
    """Kill `proc` at exit if it still runs."""
    if not _CHILDREN:
        import atexit

        atexit.register(_kill_children)
    _CHILDREN.append(proc)


def spawn_cli(tmp, name, argv, cpu_threads=None, extra_env=None):
    """Start one `python -m madsim_tpu_torch` run (the launch-counting
    launcher) in `tmp` without waiting, its output to files: a handle for
    `reap_cli`."""
    import os

    env = dict(os.environ, PYTHONPATH=str(pathlib.Path(__file__).resolve().parent), **(extra_env or {}))
    if cpu_threads:
        env["OMP_NUM_THREADS"] = str(cpu_threads)
    t = pathlib.Path(tmp)
    with open(t / f"{name}.out", "w") as out, open(t / f"{name}.err", "w") as err:
        proc = subprocess.Popen([sys.executable, "-c", CLI_LAUNCHER, str(t / f"{name}.launches.json"), *argv],
                                cwd=tmp, env=env, stdout=out, stderr=err)
    _track(proc)
    return {"name": name, "argv": argv, "proc": proc, "t0": time.perf_counter(), "t0_wall": time.time(), "tmp": t}


def reap_cli(job, rc=0, timeout=900):
    """Wait for a `spawn_cli` run: run_cli's dict; fails unless it exits
    `rc` (None: any code)."""
    proc, t, name = job["proc"], job["tmp"], job["name"]
    try:
        proc.wait(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
    counts = t / f"{name}.launches.json"
    # the launcher writes its counts as it exits: their file's time is the
    # run's end, however late it is reaped
    s = counts.stat().st_mtime - job["t0_wall"] if counts.exists() else time.perf_counter() - job["t0"]
    res = {"name": name, "rc": proc.returncode, "out": (t / f"{name}.out").read_text(),
           "err": (t / f"{name}.err").read_text(), "s": round(s, 3),
           **(json.loads(counts.read_text()) if counts.exists() else {"launches": {}, "streams": [], "batches": []})}
    if rc is not None and proc.returncode != rc:
        fail(f"cli {name}: `{' '.join(job['argv'])}` exited {proc.returncode}, expected {rc}:\n"
             f"{res['out'][-3000:]}\n{res['err'][-3000:]}")
    return res


def run_cli(tmp, name, argv, rc=0, cpu_threads=None, timeout=900):
    """One `python -m madsim_tpu_torch` run in a subprocess, in `tmp`:
    {"name", "rc", "out", "err", "s", "launches", "streams", "batches"};
    fails unless it exits `rc`."""
    return reap_cli(spawn_cli(tmp, name, argv, cpu_threads), rc, timeout)


def run_cli_jobs(tmp, jobs):
    """Several run_cli jobs at once: {name: result}."""
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(CLI_JOBS) as pool:
        futures = {name: pool.submit(run_cli, tmp, name, *job) for name, job in jobs.items()}
        return {name: f.result() for name, f in futures.items()}


def cli_wall_free(out):
    """A command line's stdout with its wall-clock figures masked."""
    import re

    return re.sub(r" in \d+\.\ds \(\d+ seeds/s\)", " in <wall>", out)


def cli_rates(err):
    """Seconds and seeds/s of each streamed batch, from the heartbeat log
    lines (`--log-level INFO`), and the warm-up's seconds."""
    import re

    batches = [(float(s), int(r)) for s, r in re.findall(r"batch \d+/\d+: \d+ seeds in ([0-9.]+)s \((\d+) seeds/s\)", err)]
    warm = re.findall(r"warm-up run_stream\(1, batch=\d+\): ([0-9.]+)s", err)
    return {"batch_s": [b[0] for b in batches], "batch_seeds_per_s": [b[1] for b in batches],
            "warm_s": float(warm[0]) if warm else None}


def cli_stages(torch, np):
    """Phase 11's first two stages, which the full run drives from a
    thread in the window from its start (their timings are taken beside
    other work either way; they launch nothing in this process). (1) A full-width
    `hunt --stream` (one batch of 8192 lanes, rng_stream 3) finds,
    shrinks and records, while the commands that need nothing of it or
    only its first find (CLI_FIRST_FIND, checked against it) run beside
    it: `regress` and `audit` of a copy of corpus.json, `check`, the
    64-lane explore on the card and on the CPU (equal stdout), `replay`,
    `replay --diff-seed`, `trace --perfetto --jsonl` (message flows),
    `shrink` and `why` on the card and the CPU. (2) On what the hunt
    wrote, at once: its first four failing seeds replay on the CPU engine
    to the same codes; `regress` and `audit` of the found corpus on the
    card and with `--device cpu`, and `coverage`. Returns the `cli`
    line's fields but the explore pair's, with the provenance hunt's and
    each command's launches."""
    import re
    import shutil
    import tempfile
    from concurrent.futures import ThreadPoolExecutor

    from madsim_tpu_torch.__main__ import _build_engine, _parser

    with tempfile.TemporaryDirectory(prefix="madsim_cli_") as tmp:
        files = {k: str(pathlib.Path(tmp) / f) for k, f in (
            ("corpus", "found.json"), ("ckpt", "hunt.ckpt.json"), ("cov", "hunt.cov.json"),
            ("perfetto", "trace.json"), ("jsonl", "trace.jsonl"), ("repo_corpus", "corpus.json"),
            ("prov_corpus", "found_prov.json"), ("prov_ckpt", "hunt_prov.ckpt.json"),
            ("why_json", "why.json"), ("why_perfetto", "why.perfetto.json"),
            ("why_json_cpu", "why_cpu.json"), ("why_perfetto_cpu", "why_cpu.perfetto.json"))}
        shutil.copy(pathlib.Path(__file__).resolve().parent / "corpus.json", files["repo_corpus"])

        # 1. the hunt, with provenance and without, and beside them what
        #    needs nothing of them or only its first find
        one = [*CLI_HUNT, "--seed", str(CLI_FIRST_FIND)]
        t0 = time.perf_counter()
        hunt_argv = ["hunt", "--stream", *CLI_HUNT, "--seeds", str(CLI_LANES), "--batch", str(CLI_LANES),
                     "--flight-recorder", "--coverage", "--log-level", "INFO"]
        with ThreadPoolExecutor(2) as pool:
            hunt_job = pool.submit(run_cli, tmp, "hunt", [
                *hunt_argv, "--coverage-out", files["cov"], "--checkpoint", files["ckpt"],
                "--corpus", files["corpus"]], 1)
            prov_job = pool.submit(run_cli, tmp, "hunt_prov", [
                *hunt_argv, "--provenance", "--checkpoint", files["prov_ckpt"], "--corpus", files["prov_corpus"]], 1)
            res = run_cli_jobs(tmp, {  # name: (argv, exit code, CPU threads), the longest first
                "shrink": (["shrink", *one], 0),
                "corpus_audit": (["audit", "--corpus", files["repo_corpus"]], 0),
                "small_card": (CLI_SMALL, 0),
                "corpus_regress": (["regress", "--corpus", files["repo_corpus"]], 0),
                "check": (["check", *CLI_HUNT, "--seeds", "256", "--max-steps", "192"], 0),
                "small_cpu": ([*CLI_SMALL, "--device", "cpu"], 0, 2),
                "replay_diff": (["replay", *one, "--diff-seed", str(CLI_FIRST_FIND + 1)], 0),
                "replay": (["replay", *one, "--tail", "5"], 1),
                "trace": (["trace", *one, "--perfetto", files["perfetto"], "--jsonl", files["jsonl"]], 1),
                "why": (["why", str(CLI_FIRST_FIND), *CLI_HUNT, "--json", files["why_json"], "--perfetto",
                         files["why_perfetto"]], 0),
                "why_cpu": (["why", str(CLI_FIRST_FIND), *CLI_HUNT, "--json", files["why_json_cpu"], "--perfetto",
                             files["why_perfetto_cpu"], "--device", "cpu"], 0, 2),
            })
            hunt, hunt_prov = hunt_job.result(), prov_job.result()
        stage1_s = round(time.perf_counter() - t0, 3)
        m = re.search(r"hunted (\d+) seeds: (\d+) failing", hunt["out"])
        added = re.search(r"(\d+) new entries in", hunt["out"])
        if not m or not added or int(added.group(1)) < 1 or "+ corpus: " not in hunt["out"]:
            fail(f"cli hunt found, shrank or recorded nothing:\n{hunt['out']}")
        for name in ("step_megakernel", "cov_flush"):
            if hunt["launches"].get(name, 0) <= 0:
                fail(f"cli hunt never launched {name}: {hunt['launches']}")
        ckpt = json.loads(pathlib.Path(files["ckpt"]).read_text())
        failing = [tuple(x) for x in ckpt["failing"]]
        if not ckpt["done"] or len(failing) != int(m.group(2)):
            fail(f"cli hunt's checkpoint: done={ckpt['done']}, {len(failing)} failing, printed {m.group(2)}")
        seed, code = failing[0]
        if seed != CLI_FIRST_FIND:
            fail(f"cli hunt's first find is seed {seed}, not {CLI_FIRST_FIND}, which shrink, replay, trace and why "
                 f"ran on")
        prov = cli_provenance_hunt(hunt, hunt_prov, files, failing)
        for name in ("corpus_regress", "corpus_audit"):
            if "8/8 entries satisfied" not in res[name]["out"]:
                fail(f"cli {name} of corpus.json:\n{res[name]['out']}")
        if "determinism check passed for 256 seeds" not in res["check"]["out"]:
            fail(f"cli check:\n{res['check']['out']}")
        if cli_wall_free(res["small_card"]["out"]) != cli_wall_free(res["small_cpu"]["out"]):
            fail(f"cli 64-lane explore: the card and the CPU differ:\n{res['small_card']['out']}\n"
                 f"{res['small_cpu']['out']}")

        # 2. on what the hunt wrote
        t0 = time.perf_counter()
        with ThreadPoolExecutor(1) as pool:
            jobs = pool.submit(run_cli_jobs, tmp, {
                "regress": (["regress", "--corpus", files["corpus"]], 0),
                "audit": (["audit", "--corpus", files["corpus"]], 0),
                "regress_cpu": (["regress", "--corpus", files["corpus"], "--device", "cpu"], 0, 2),
                "audit_cpu": (["audit", "--corpus", files["corpus"], "--device", "cpu"], 0, 2),
                "coverage": (["coverage", files["cov"]], 0),
            })
            # the first four finds on the CPU engine, meanwhile
            cpu_eng = _build_engine(_parser().parse_args(["explore", *CLI_HUNT, "--device", "cpu"]))
            threads = torch.get_num_threads()
            torch.set_num_threads(2)
            replay = cpu_eng.run_batch(np.array([s for s, _ in failing[:4]], dtype=np.uint32), 3000)
            torch.set_num_threads(threads)
            # and the provenance hunt's words of its first finds against
            # one-lane replays on the card, in a process of their own
            prov["replays"] = cli_prov_replays_process(tmp, prov["words"], failing[:PROV_REPLAYS])
            res.update(jobs.result())
        stage2_s = round(time.perf_counter() - t0, 3)
        codes = [int(c) if f else 0 for f, c in zip(replay.failed.tolist(), replay.fail_code.tolist())]
        if codes != [c for _, c in failing[:4]]:
            fail(f"cli hunt's finds {failing[:4]} replayed on the CPU with codes {codes}")
        n_found = len(json.loads(pathlib.Path(files["corpus"]).read_text())["entries"])
        for name in ("regress", "audit", "regress_cpu", "audit_cpu"):
            if f"{n_found}/{n_found} entries satisfied" not in res[name]["out"]:
                fail(f"cli {name} of the found corpus:\n{res[name]['out']}")
        if f"seed {seed}: FAILED (code {code})" not in res["replay"]["out"]:
            fail(f"cli replay of seed {seed}:\n{res['replay']['out']}")
        if not re.search(r"diverge|identical|prefix-match", res["replay_diff"]["out"]):
            fail(f"cli replay --diff-seed:\n{res['replay_diff']['out']}")
        flows = re.search(r"wrote (\d+) events \((\d+) message flows\)", res["trace"]["out"])
        if not flows or int(flows.group(2)) < 1 or not pathlib.Path(files["jsonl"]).exists():
            fail(f"cli trace:\n{res['trace']['out']}")
        if f"seed {seed} fails with code {code}" not in res["shrink"]["out"] or "minimal repro:" not in \
                res["shrink"]["out"]:
            fail(f"cli shrink:\n{res['shrink']['out']}")
        if "demo-volatilecommit-raft:" not in res["coverage"]["out"]:
            fail(f"cli coverage:\n{res['coverage']['out']}")
        prov["why"] = cli_why_pair(res, files, seed, code)
        unguided = re.search(r"\[(\d+) verification replays\]", res["shrink"]["out"])
        if not unguided or prov["guided_attempts"] > int(unguided.group(1)):
            fail(f"cli: the guided shrink took {prov['guided_attempts']} replays, `shrink`:\n{res['shrink']['out']}")
        prov["shrink_attempts"] = int(unguided.group(1))
        for name in ("regress", "audit", "replay", "shrink", "check", "corpus_regress", "small_card", "why"):
            if sum(res[name]["launches"].values()) <= 0:
                fail(f"cli {name} on the card launched no kernel: {res[name]['launches']}")

        out = {
            "hunt": {"machine": "demo-volatilecommit-raft", "seeds": int(m.group(1)), "failing": int(m.group(2)),
                     "codes": sorted({c for _, c in failing}), "recorded": int(added.group(1)),
                     "first_finds": failing[:4], "subprocess_s": hunt["s"], "launches": hunt["launches"],
                     **cli_rates(hunt["err"]), **{key: [c[key] for c in hunt["streams"]] for key in (
                         "device_segments", "dispatches", "host_syncs", "drains")}},
            "stage_s": [stage1_s, stage2_s],
            "commands": {k: {"s": r["s"], "rc": r["rc"]} for k, r in res.items()},
            "found_entries": n_found, "trace_flows": int(flows.group(2)), "small_equal": True,
        }
        prov.pop("words")
        out["provenance"] = {**prov, "subprocess_s": hunt_prov["s"], "launches": hunt_prov["launches"],
                             **cli_rates(hunt_prov["err"])}
    out["launches"] = {k: r["launches"] for k, r in res.items()}
    return out


def cli_phase(torch, np, stages=None):
    """Phase 11: the command line as a user runs it, in subprocesses on
    the card (`cli` line): `stages`, the first two stages' fields
    (cli_stages, run here unless the window ran them), then the third
    (cli_explore_pair), here with nothing beside it."""
    if stages is None:
        stages = cli_stages(torch, np)
    explore, stage3_s = cli_explore_pair()
    out = {**stages, "stage_s": [*stages["stage_s"], stage3_s], "explore": explore}
    emit({"phase": "cli", **{k: v for k, v in out.items() if k not in ("provenance", "launches")}})
    return out


def cli_explore_pair():
    """Phase 11's third stage: `explore --stream` of the flagship at one
    batch of 8192 lanes, lanes cut at 1,152 events, pipelined and with
    `--no-pipeline`, the two at once and nothing else beside them, so
    both see the same host: the same lines, and each one's seeds/s, host
    syncs and steps issued. Returns ({name: fields}, the stage's seconds)."""
    import re
    import tempfile

    with tempfile.TemporaryDirectory(prefix="madsim_cli_") as tmp:
        # 3. pipelined against per-segment, the two at once
        t0 = time.perf_counter()
        pair = run_cli_jobs(tmp, {"pipelined": (CLI_EXPLORE, 0), "per_segment": ([*CLI_EXPLORE, "--no-pipeline"], 0)})
        stage3_s = round(time.perf_counter() - t0, 3)
        lines = {name: [ln for ln in cli_wall_free(r["out"]).splitlines() if not ln.startswith("executor: ")]
                 for name, r in pair.items()}
        if lines["pipelined"] != lines["per_segment"]:
            fail(f"cli explore: pipelined and per-segment differ:\n{pair['pipelined']['out']}\n"
                 f"{pair['per_segment']['out']}")
        explore = {}
        for name, r in pair.items():
            st = re.search(r"streamed (\d+) seeds in ([0-9.]+)s \((\d+) seeds/s\)", r["out"])
            ex = re.search(r"executor: (\d+) segments, (\d+) host syncs, (\d+) drains", r["out"])
            explore[name] = {"completed": int(st.group(1)), "seconds": float(st.group(2)),
                             "seeds_per_s": int(st.group(3)), "last_batch_segments": int(ex.group(1)),
                             "last_batch_host_syncs": int(ex.group(2)), "last_batch_drains": int(ex.group(3)),
                             "subprocess_s": r["s"], **cli_rates(r["err"]),
                             # every run_stream call, the warm-up's first
                             **{key: [c[key] for c in r["streams"]]
                                for key in ("device_segments", "dispatches", "host_syncs", "drains")},
                             "steps_issued": r["launches"].get("step_megakernel", 0)}
            # the segments issued (the megakernel launches a step) against
            # those executed, over the warm-up and the batches
            explore[name]["segments_issued"] = round(explore[name]["steps_issued"] / 384, 3)
            if explore[name]["segments_issued"] < sum(explore[name]["device_segments"]):
                fail(f"cli explore {name}: fewer segments issued than executed: {explore[name]}")
    return explore, stage3_s


def cli_provenance_hunt(hunt, hunt_prov, files, failing):
    """Phase 11's `hunt --stream --provenance` against the gate-off hunt
    beside it: the same finds (the provenance changes no result), the
    fault-attribution line, a word for every find in its checkpoint, and
    its guided shrink of the first find reaching the gate-off hunt's
    shrunk config. Returns the words and what the line reports."""
    import re

    m = re.search(r"hunted (\d+) seeds: (\d+) failing", hunt["out"])
    m_prov = re.search(r"hunted (\d+) seeds: (\d+) failing", hunt_prov["out"])
    att = re.search(r"fault attribution: \[([^\]]*)\]", hunt_prov["out"])
    ckpt = json.loads(pathlib.Path(files["prov_ckpt"]).read_text())
    if not m_prov or m_prov.groups() != m.groups() or [tuple(x) for x in ckpt["failing"]] != failing:
        fail(f"cli hunt --provenance found other seeds than the hunt:\n{hunt_prov['out']}\n{hunt['out']}")
    if not att or sorted(int(k) for k in ckpt["prov"]) != sorted(s for s, _ in failing):
        fail(f"cli hunt --provenance: no attribution line, or words missing:\n{hunt_prov['out']}")
    guided = re.search(r"\+ corpus: .*\[(\d+) verification replays, provenance-guided by \[([^\]]*)\]\]",
                       hunt_prov["out"])
    entries = {k: json.loads(pathlib.Path(files[k]).read_text())["entries"] for k in ("corpus", "prov_corpus")}
    if not guided or len(entries["prov_corpus"]) != 1 or \
            entries["prov_corpus"][0]["config"] != entries["corpus"][0]["config"]:
        fail(f"cli hunt --provenance: its guided shrink did not reach the hunt's shrunk config:\n"
             f"{hunt_prov['out']}\n{entries}")
    if hunt_prov["launches"].get("step_megakernel", 0) <= 0 or hunt_prov["launches"].get("cov_flush", 0) <= 0:
        fail(f"cli hunt --provenance launched {hunt_prov['launches']}")
    return {"seeds": int(m_prov.group(1)), "failing": int(m_prov.group(2)), "attribution": att.group(1),
            "guided_attempts": int(guided.group(1)), "guided_by": guided.group(2), "same_finds": True,
            "same_shrunk_config": True, "words": {int(k): v for k, v in ckpt["prov"].items()}}


# runs cli_prov_replays(words, finds) from the JSON file argv[2] and writes
# its result to argv[3]
CLI_PROV_REPLAYS = (
    "import json, sys\n"
    "sys.path.insert(0, sys.argv[1])\n"
    "import torch\n"
    "torch.set_num_threads(2)\n"
    "import chip_smoke\n"
    "words, finds = json.load(open(sys.argv[2]))\n"
    "res = chip_smoke.cli_prov_replays({int(k): v for k, v in words.items()}, [tuple(f) for f in finds])\n"
    "json.dump(res, open(sys.argv[3], 'w'))\n"
)


def cli_prov_replays_process(tmp, words, finds):
    """cli_prov_replays in a process of its own, so that phase 11 launches
    no kernel in the smoke's process (the window counts launches there
    while it runs); fails with that process's failure."""
    import os

    args, out = pathlib.Path(tmp) / "prov_replays_in.json", pathlib.Path(tmp) / "prov_replays.json"
    args.write_text(json.dumps([{str(k): v for k, v in words.items()}, [list(f) for f in finds]]))
    proc = subprocess.Popen([sys.executable, "-c", CLI_PROV_REPLAYS, str(pathlib.Path(__file__).resolve().parent),
                             str(args), str(out)], env=dict(os.environ, OMP_NUM_THREADS="2"),
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    _track(proc)
    _, err = proc.communicate(timeout=900)
    if proc.returncode != 0:
        fail(f"cli hunt --provenance: the one-lane replays exited {proc.returncode}:\n{err[-3000:]}")
    return json.loads(out.read_text())


def cli_prov_replays(words, finds):
    """One-lane replays on the card, with the hunt's engine and the gate
    on, of `finds`: each must fail with its code and the word the
    hunt's failure ring harvested."""
    from madsim_tpu_torch.__main__ import _build_engine, _parser
    from madsim_tpu_torch.engine.replay import replay

    eng = _build_engine(_parser().parse_args(["explore", *CLI_HUNT, "--provenance"]))
    t0 = time.perf_counter()
    got = []
    for seed, code in finds:
        rp = replay(eng, seed, max_steps=3000, trace=False)
        if not rp.failed or rp.fail_code != code or rp.fail_prov != words[seed]:
            fail(f"cli hunt --provenance: seed {seed} harvested word 0x{words[seed]:08x} code {code}, replayed "
                 f"0x{rp.fail_prov:08x} code {rp.fail_code if rp.failed else 0}")
        got.append([seed, f"0x{rp.fail_prov:08x}"])
    return {"seeds_words": got, "equal": True, "s": round(time.perf_counter() - t0, 3)}


def cli_why_pair(res, files, seed, code):
    """`why <seed> --json --perfetto` on the card and with `--device cpu`:
    the same stdout (the file names aside), JSON and Perfetto bytes."""
    card, cpu = res["why"]["out"], res["why_cpu"]["out"]
    for key in ("why_json", "why_perfetto"):
        cpu = cpu.replace(files[key + "_cpu"], files[key])
    same_files = all(pathlib.Path(files[k]).read_bytes() == pathlib.Path(files[k + "_cpu"]).read_bytes()
                     for k in ("why_json", "why_perfetto"))
    if card != cpu or not same_files or f"seed {seed} fails with code {code}" not in card:
        fail(f"cli why: the card and the CPU differ (files equal: {same_files}):\n{card}\n{cpu}")
    doc = json.loads(pathlib.Path(files["why_json"]).read_text())
    flows = re.search(r"\((\d+) causal flows", card)
    return {"prov_word": f"0x{doc['prov_word']:08x}", "implicated_kinds": doc["implicated_kinds"],
            "cone_events": doc["cone_events"], "trace_events": doc["trace_events"],
            "causal_flows": int(flows.group(1)) if flows else None, "card_s": res["why"]["s"],
            "cpu_s": res["why_cpu"]["s"], "equal": True}


def cli_kernels(kernels, np, dev, cli):
    """Each new kernel shape of phase 11, held against its twin and timed
    on a state of the engine the command line builds (`cli_kernels`
    line): the megakernel at the found seed's single-lane replays (L = 1,
    Q = 32; `shrink`'s launches), at `check`'s 256 lanes and at the small
    explore's 64 lanes; the flush on the small explore's buffers."""
    seed = cli["hunt"]["first_finds"][0][0]
    hunt_argv = ["explore", *CLI_HUNT]
    replay_state, words = command_state(np, hunt_argv, 1, seed)
    check_state, _ = built("cli_check", lambda: command_state(np, hunt_argv, 256))
    small_state, small_words = built("cli_small", lambda: command_state(np, CLI_SMALL, 64))
    launches = cli["launches"]
    time_kernel_shapes(kernels, dev, "cli_kernels", (
        (f"step_megakernel_L1_Q32_W{words}", replay_state, words, launches["shrink"].get("step_megakernel", 0)),
        (f"step_megakernel_L256_Q32_W{words}", check_state, words, launches["check"].get("step_megakernel", 0)),
        (f"step_megakernel_L64_Q32_W{small_words}", small_state, small_words,
         launches["small_card"].get("step_megakernel", 0)),
    ), (("cov_flush_L64", small_state.cov, launches["small_card"].get("cov_flush", 0)),))


def segment_state(eng, seeds, steps):
    """The lane state of `seeds` after `steps` event steps, as numpy."""
    from madsim_tpu_torch.interop import tree_to_numpy

    return tree_to_numpy(eng.run_segment(eng.init_batch(seeds), steps))


def without(tree, names):
    return {k: v for k, v in tree.items() if k not in names}


def provenance_legs(np):
    """Phase 12's in-process checks, which time nothing: 256 lanes of the
    volatile-commit demo under the whole palette with heal-asym and 2%
    loss on both streams, every lane leaf on the card equal to the CPU's
    with the gate on, and every leaf but the three provenance planes
    equal with the gate on and off on the card. Returns each stream's
    figures."""
    from madsim_tpu_torch.engine import Engine, EngineConfig, FaultPlan
    from madsim_tpu_torch.engine.core import PROV_BIT_AMNESIA, PROV_BIT_DUP
    from madsim_tpu_torch.models import build_machine

    planes = ("node_prov", "eq_prov", "fail_prov")
    m = build_machine("demo-volatilecommit-raft")
    seeds = np.arange(PROV_LANES, dtype=np.uint32) + 60_000
    legs = {}
    for stream in (3, 2):
        def eng(device=None, prov=True):
            cfg = EngineConfig(**{**FLAGSHIP, **VOLATILE, "rng_stream": stream, "queue_capacity": PROV_Q,
                                  "packet_loss_rate": 0.02, "provenance": prov}, faults=FaultPlan(**PROV_FAULTS))
            return Engine(m, cfg, device=device)

        secs, states = {}, {}
        for name, device, prov in (("card", None, True), ("cpu", "cpu", True), ("off", None, False)):
            t0 = time.perf_counter()
            states[name] = segment_state(eng(device, prov), seeds, PROV_STEPS)
            secs[name] = round(time.perf_counter() - t0, 3)
        bad = tree_diff(states["card"], states["cpu"])
        if bad:
            fail(f"provenance v{stream}: the card's lanes differ from the CPU's in {bad[:8]}")
        if any(states["off"][k].shape[1:] != (0,) for k in planes):
            fail(f"provenance v{stream}: the gate off left planes {[states['off'][k].shape for k in planes]}")
        bad = tree_diff(without(states["card"], planes), without(states["off"], planes))
        if bad:
            fail(f"provenance v{stream}: the gate on changed {bad[:8]}")
        failed = states["card"]["failed"]
        words = states["card"]["fail_prov"][failed]
        if not failed.any() or not (words >> PROV_BIT_AMNESIA & 1).any():
            fail(f"provenance v{stream}: no failing lane with the amnesia bit: {failed.sum()} failed")
        legs[f"v{stream}"] = {"lanes": PROV_LANES, "steps": PROV_STEPS, "failed": int(failed.sum()),
                              "codes": sorted({int(c) for c in states["card"]["fail_code"][failed]}),
                              "words_amnesia": int((words >> PROV_BIT_AMNESIA & 1).sum()),
                              "words_dup": int((words >> PROV_BIT_DUP & 1).sum()),
                              "queued_dup_words": int((states["card"]["eq_prov"] >> PROV_BIT_DUP & 1).sum()),
                              "card_s": secs["card"], "cpu_s": secs["cpu"], "off_card_s": secs["off"]}
    return legs


def provenance_phase(np, cli, legs):
    """Phase 12: causal provenance. What the command line did with it in
    phase 11 (the 8192-lane `hunt --stream --provenance` beside the
    gate-off hunt: the same finds, the attribution line, the guided
    shrink against the unguided one, the hunt's words of its first finds
    against one-lane replays on the card, `why` on the card and the CPU),
    the in-process `legs` (provenance_legs), and the 8192-lane profile of
    the hunt's engine with the gate on and off (kernels and busy ms a
    step, idle share)."""
    from madsim_tpu_torch.__main__ import _build_engine, _parser

    # the gate's cost a step, at the command-line hunt's full width
    profiles = {}
    for name, extra in (("on", ["--provenance"]), ("off", [])):
        hunt_eng = _build_engine(_parser().parse_args(["explore", *CLI_HUNT, *extra]))
        state = hunt_eng.run_segment(hunt_eng.init_batch(np.arange(CLI_LANES, dtype=np.uint32)), PROV_STATE_STEPS)
        profiles[name] = profile_steps(hunt_eng, state, steps=PROV_PROFILE_STEPS)
        del state
    emit({"phase": "provenance", "cli": cli["provenance"], **legs, "profile_on": profiles["on"],
          "profile_off": profiles["off"]})


def clog_checks(torch, np, kernels):
    """Phase 13: the unpacked clog matrix (`card_vs_cpu_clog`). The
    flagship at 256 lanes under pair, kill, dir, group and heal-asym
    faults on both streams: packed against unpacked on the card (every
    leaf but the clog state), and the matrix's lanes on the card against
    the CPU's, matrix included. Then a 64-node gossip cluster at 256 lanes
    on both streams, card against CPU, at the smallest power-of-two queue
    from 256 that overflows no lane. Returns its queue, word block and
    launches by stream, for clog_states_of."""
    from madsim_tpu_torch.engine import OVERFLOW, Engine, EngineConfig, FaultPlan
    from madsim_tpu_torch.interop import tree_to_numpy
    from madsim_tpu_torch.models import RaftMachine
    from madsim_tpu_torch.models.gossip import GossipMachine

    raft = RaftMachine(num_nodes=5, log_capacity=8)
    seeds = np.arange(CHECK_LANES, dtype=np.uint32) + 70_000
    out = {}
    for stream in (3, 2):
        def eng(device=None, packed=False):
            cfg = EngineConfig(**{**FLAGSHIP, "rng_stream": stream, "clog_packed": packed},
                               faults=FaultPlan(**CLOG_FAULTS))
            return Engine(raft, cfg, device=device)

        t0 = time.perf_counter()
        card = segment_state(eng(), seeds, CLOG_STEPS)
        t_card = time.perf_counter() - t0
        t0 = time.perf_counter()
        cpu = segment_state(eng("cpu"), seeds, CLOG_STEPS)
        t_cpu = time.perf_counter() - t0
        packed = segment_state(eng(None, True), seeds, CLOG_STEPS)
        bad = tree_diff(card, cpu)
        if bad:
            fail(f"clog matrix v{stream}: the card's lanes differ from the CPU's in {bad[:8]}")
        bad = tree_diff(without(card, ("clogged",)), without(packed, ("clogged",)))
        if bad or card["clogged"].shape != (CHECK_LANES, 5, 5):
            fail(f"clog v{stream}: packed and unpacked differ in {bad[:8]} (matrix {card['clogged'].shape})")
        out[f"flagship_v{stream}"] = {"lanes": CHECK_LANES, "steps": CLOG_STEPS, "card_s": round(t_card, 3),
                                      "cpu_s": round(t_cpu, 3), "clog_hwm": int(card["fr"]["clog_hwm"].max()),
                                      "failed": int(card["failed"].sum())}
    gossip = GossipMachine(num_nodes=GOSSIP64_NODES)
    seeds = np.arange(GOSSIP64_LANES, dtype=np.uint32) + 80_000
    kernel_states = {}
    for stream, kernel in ((3, "step_megakernel"), (2, "pop_gather")):
        q, tried = GOSSIP64_MIN_Q, []
        while True:
            cfg = EngineConfig(**GOSSIP64, rng_stream=stream, queue_capacity=q, faults=FaultPlan(**GOSSIP64_FAULTS))
            card_eng = Engine(gossip, cfg)
            torch.cuda.synchronize()
            kernels.reset_launches()
            t0 = time.perf_counter()
            state = card_eng.run_segment(card_eng.init_batch(seeds), GOSSIP64_STEPS)
            torch.cuda.synchronize()
            t_card = time.perf_counter() - t0
            launches = dict(kernels.launches)
            overflow = int((state.fail_code == OVERFLOW).sum())
            tried.append((q, overflow))
            if not overflow:
                break
            q *= 2
        if launches.get(kernel, 0) <= 0:
            fail(f"gossip 64 v{stream} never launched {kernel}: {launches}")
        t0 = time.perf_counter()
        cpu = segment_state(Engine(gossip, cfg, device="cpu"), seeds, GOSSIP64_STEPS)
        t_cpu = time.perf_counter() - t0
        bad = tree_diff(tree_to_numpy(state), cpu)
        if bad:
            fail(f"gossip 64 v{stream}: the card's lanes differ from the CPU's in {bad[:8]}")
        kernel_states[stream] = [q, card_eng._rng_layout.total_words, launches[kernel]]
        out[f"gossip64_v{stream}"] = {"nodes": GOSSIP64_NODES, "lanes": GOSSIP64_LANES, "steps": GOSSIP64_STEPS,
                                      "q": q, "tried_q_overflow": tried, "card_s": round(t_card, 3),
                                      "cpu_s": round(t_cpu, 3), "failed": int(state.failed.sum()),
                                      "queue_max": int(state.eq_valid.sum(dim=1).max()), "launches": launches}
    emit({"phase": "card_vs_cpu_clog", "equal": True, **out})
    return kernel_states


def clog_states_of(np, info):
    """The 64-node gossip states clog_kernels times at, by stream: the
    check's first queue that overflowed no lane, GOSSIP64_STEPS in, with
    its word block and launches."""
    from madsim_tpu_torch.engine import Engine, EngineConfig, FaultPlan
    from madsim_tpu_torch.models.gossip import GossipMachine

    out = {}
    for stream, (q, words, n) in info.items():
        cfg = EngineConfig(**GOSSIP64, rng_stream=int(stream), queue_capacity=q, faults=FaultPlan(**GOSSIP64_FAULTS))
        card = Engine(GossipMachine(num_nodes=GOSSIP64_NODES), cfg)
        seeds = np.arange(GOSSIP64_LANES, dtype=np.uint32) + 80_000
        out[int(stream)] = (card.run_segment(card.init_batch(seeds), GOSSIP64_STEPS), words, n)
    return out


def clog_kernels(kernels, dev, kernel_states):
    """The 64-node gossip shapes of phase 13, the megakernel (v3) and
    pop_gather (v2), held against their twins and timed
    (`clog_kernels`)."""
    (v3_state, words, v3_n), (v2_state, _, v2_n) = kernel_states[3], kernel_states[2]
    time_kernel_shapes(kernels, dev, "clog_kernels", (
        (f"step_megakernel_gossip64_L{GOSSIP64_LANES}_Q{v3_state.eq_time.shape[1]}_W{words}", v3_state, words, v3_n),
    ), (), pops=((f"pop_gather_gossip64_L{GOSSIP64_LANES}_Q{v2_state.eq_time.shape[1]}", v2_state, v2_n),))


def differential_side(device=None):
    """Phase 15's device side of the Raft differential on `device` (the
    card by default): every seed's fault schedule (one `init_batch`) and
    device verdict (one `run_batch`) at the fixture's config."""
    from madsim_tpu_torch.differential import fault_schedules, run_device_rafts
    from madsim_tpu_torch.engine import Engine, EngineConfig, FaultPlan
    from madsim_tpu_torch.models import RaftMachine

    eng = Engine(RaftMachine(num_nodes=5, log_capacity=8), EngineConfig(**DIFF, faults=FaultPlan(**DIFF_FAULTS)),
                 device=device)
    seeds = list(range(DIFF_LANES))
    return {"schedules": fault_schedules(eng, seeds), "verdicts": run_device_rafts(eng, seeds, DIFF_STEPS)}


def vote_granting_pair():
    """The vote bug of tests/test_differential.py:62-102 planted in both
    authoring models: a device Raft whose every RequestVote also sends a
    granting vote, and a host Raft node (examples/raft_host_torch.py)
    that grants every vote."""
    import torch

    from madsim_tpu_torch.differential import _load_raft_host
    from madsim_tpu_torch.engine.machine import send_if
    from madsim_tpu_torch.models import RaftMachine
    from madsim_tpu_torch.models import raft as R
    from madsim_tpu_torch.utils import take

    class BuggyDeviceRaft(RaftMachine):
        def on_message(self, nodes, node, src, payload, now_us, rand_u32):
            nodes2, outbox = super().on_message(nodes, node, src, payload, now_us, rand_u32)
            is_rv = payload[:, 0] == R.M_RV
            vote = self._pay(R.M_VOTE, torch.maximum(payload[:, 1], take(nodes.term, node)), 1)
            return nodes2, send_if(outbox, 0, is_rv, src, vote)

    class BuggyHostNode(_load_raft_host().RaftNode):
        async def on_request_vote(self, req, data):
            if req.term > self.term:
                self.become_follower(req.term)
            return {"term": self.term, "granted": True}

    return BuggyDeviceRaft(num_nodes=5, log_capacity=8), BuggyHostNode


def differential_checks(torch, np, kernels):
    """Phase 15's whole differential (a CHECK_GROUPS group: a process of
    its own in the window), both engines on the port: `differential_raft`
    of 256 seeds at the fixture, the device side one 256-lane run_batch
    on the card (its launches counted from 0) and the host side the
    port's `run_host_raft` on each seed, timed apart: no schedule
    mismatch, no violation on either engine, no disagreement; the vote
    bug planted in both engines caught by both (16 seeds); and
    `Runtime.check_determinism` of the host example's scenario on 4
    seeds. The host side runs on the native core (`native_checks` built
    it and held it against the pure-Python path first)."""
    import os

    from madsim_tpu_torch.differential import _load_raft_host, differential_raft, run_host_raft
    from madsim_tpu_torch.engine import Engine, EngineConfig, FaultPlan
    from madsim_tpu_torch.models import RaftMachine
    from madsim_tpu_torch.runtime import Runtime

    from madsim_tpu_torch import _native
    from madsim_tpu_torch.rand import GlobalRng

    host_native = _native.available() and type(GlobalRng(0)._core) is _native.get_mod().Rng
    if not host_native:
        fail("the differential's host side is not on the native core")
    host = {"s": 0.0, "seeds": 0}

    def timed_host_run(*args, **kw):
        t = time.perf_counter()
        out = run_host_raft(*args, **kw)
        host["s"] += time.perf_counter() - t
        host["seeds"] += 1
        return out

    eng = Engine(RaftMachine(num_nodes=5, log_capacity=8), EngineConfig(**DIFF, faults=FaultPlan(**DIFF_FAULTS)))
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    report = differential_raft(eng, range(DIFF_WHOLE_LANES), timed_host_run, max_steps=DIFF_STEPS)
    torch.cuda.synchronize()
    whole_s = time.perf_counter() - t0
    launches = dict(kernels.launches)
    counts = {k: v for k, v in report.items() if k != "rows"}
    if host["seeds"] != DIFF_WHOLE_LANES:
        fail(f"differential: {host['seeds']} host runs for {DIFF_WHOLE_LANES} seeds")
    for key in ("schedule_mismatches", "device_violations", "host_violations", "safety_disagreements"):
        if counts[key]:
            bad = [r["seed"] for r in report["rows"] if r["device"]["violation"] or r["host"]["violation"]
                   or not r["schedule_ok"]]
            fail(f"differential of {DIFF_WHOLE_LANES} seeds: {key} = {counts[key]} (seeds {bad[:16]}): {counts}")
    if launches.get("pop_gather", 0) <= 0:
        fail(f"the whole differential never launched pop_gather: {launches}")

    bug_machine, bug_node = vote_granting_pair()
    bug_eng = Engine(bug_machine, EngineConfig(**DIFF_BUG, faults=FaultPlan(**DIFF_BUG_FAULTS)))
    t0 = time.perf_counter()
    bug = differential_raft(bug_eng, range(DIFF_BUG_SEEDS), run_host_raft, host_node_cls=bug_node,
                            max_steps=DIFF_STEPS)
    bug_s = time.perf_counter() - t0
    bug_counts = {k: v for k, v in bug.items() if k != "rows"}
    if bug["schedule_mismatches"] or bug["device_violations"] < 1 or bug["host_violations"] < 1:
        fail(f"the vote bug was not caught by both engines: {bug_counts}")

    scenario = _load_raft_host().scenario
    t0 = time.perf_counter()
    determinism = [Runtime.check_determinism(seed, scenario) for seed in range(DIFF_DETERMINISM_SEEDS)]
    determinism_s = time.perf_counter() - t0

    emit({"phase": "differential_whole", "card": card_line(), "seeds": DIFF_WHOLE_LANES, **counts,
          "seconds": round(whole_s, 3), "device_s": round(whole_s - host["s"], 3), "host_s": round(host["s"], 3),
          "host_seeds_per_s": round(DIFF_WHOLE_LANES / host["s"], 2), "host_native": host_native,
          "native_so": os.path.relpath(_native.so_path(), pathlib.Path(__file__).resolve().parent),
          "launches": launches,
          "bug_pair": {"seeds": DIFF_BUG_SEEDS, **bug_counts, "seconds": round(bug_s, 3)},
          "check_determinism": {"seeds": DIFF_DETERMINISM_SEEDS, "passed": True,
                                "terms_with_leader": [r["terms_with_leader"] for r in determinism],
                                "seconds": round(determinism_s, 3)}})
    return {"launches": launches}


NATIVE_PURE_RAFT = (
    "import json, sys, time\n"
    "sys.path.insert(0, sys.argv[1])\n"
    "from madsim_tpu_torch import _native\n"
    "from madsim_tpu_torch.differential import run_host_raft\n"
    "assert not _native.available()\n"
    "schedules = json.load(open(sys.argv[2]))\n"
    "t0 = time.perf_counter()\n"
    "reports = [run_host_raft(seed, sched) for seed, sched in enumerate(schedules)]\n"
    "print(json.dumps({'s': time.perf_counter() - t0, 'reports': reports}))\n"
)

# tests/test_native.py:80-116 on the port: an RPC server killed and
# restarted at random under 30 timed calls; its first line says which
# path ran
NATIVE_CHAOS = (
    "import sys\n"
    "sys.path.insert(0, sys.argv[1])\n"
    "import madsim_tpu_torch\n"
    "from madsim_tpu_torch import _native, time as sim_time\n"
    "from madsim_tpu_torch.runtime import Runtime, Handle\n"
    "from madsim_tpu_torch.net import Endpoint, Request\n"
    "class Ping(Request):\n"
    "    def __init__(self, v): self.v = v\n"
    "async def scenario():\n"
    "    handle = Handle.current()\n"
    "    state = {'sum': 0}\n"
    "    async def serve():\n"
    "        ep = await Endpoint.bind('0.0.0.0:77')\n"
    "        async def on_ping(req, data):\n"
    "            state['sum'] += req.v\n"
    "            return req.v\n"
    "        ep.add_rpc_handler(Ping, on_ping)\n"
    "        await sim_time.sleep(1e9)\n"
    "    srv = handle.create_node().ip('10.0.3.1').init(serve).restart_on_panic().build()\n"
    "    client = handle.create_node().ip('10.0.3.2').build()\n"
    "    async def drive():\n"
    "        ep = await Endpoint.bind('0.0.0.0:0')\n"
    "        rng = madsim_tpu_torch.rand.thread_rng()\n"
    "        out = []\n"
    "        for i in range(30):\n"
    "            try:\n"
    "                out.append(await ep.call_timeout('10.0.3.1:77', Ping(i), 1.0))\n"
    "            except TimeoutError:\n"
    "                out.append(-1)\n"
    "            if rng.gen_bool(0.2):\n"
    "                handle.kill(srv.id); handle.restart(srv.id)\n"
    "            await sim_time.sleep(rng.random() * 0.1)\n"
    "        return out, state['sum'], sim_time.now_ns()\n"
    "    return await client.spawn(drive())\n"
    "print(_native.available())\n"
    "print(repr(Runtime(seed=11).block_on(scenario())))\n"
)


def native_build():
    """The loader's g++ command run here, into a directory of its own,
    timed: a failed build fails the smoke with g++'s stderr. Then the
    loader itself must give the core (the `.so` it built or found)."""
    import os
    import shutil
    import tempfile

    from madsim_tpu_torch import _native

    if os.environ.get("MADSIM_TPU_NO_NATIVE"):
        fail("MADSIM_TPU_NO_NATIVE is set: the smoke runs the host engine on its native core")
    tmp = tempfile.mkdtemp(prefix="madsim_native_")
    try:
        t0 = time.perf_counter()
        out = subprocess.run(_native.build_command(os.path.join(tmp, "hostcore.so")), capture_output=True,
                             text=True, timeout=300)
        build_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    if out.returncode != 0:
        fail(f"the native host core did not build (g++ exit {out.returncode}):\n{out.stderr[-3000:]}")
    if not _native.available():
        fail(f"the native host core built but the loader gave none ({_native.so_path()})")
    return {"build_s": build_s, "so": os.path.relpath(_native.so_path(), pathlib.Path(__file__).resolve().parent)}


def native_checks(torch, np, kernels):
    """Phase 15's native line (a check of the differential's CHECK_GROUPS
    group, before the differential): the host engine's core built from
    the checkout, and each workload on it held equal to the same workload
    on the pure-Python path in a process under MADSIM_TPU_NO_NATIVE=1:
    `run_host_raft` on NATIVE_SEEDS seeds of the differential's fixture
    (both rates), the chaos scenario at seed 11; and
    `Runtime.check_determinism` on NATIVE_CHECK_SEEDS seeds with the core
    observing every draw while the log is on."""
    import os
    import tempfile

    from madsim_tpu_torch import _native
    from madsim_tpu_torch.differential import _load_raft_host, fault_schedules, run_host_raft
    from madsim_tpu_torch.engine import Engine, EngineConfig, FaultPlan
    from madsim_tpu_torch.models import RaftMachine
    from madsim_tpu_torch.rand import GlobalRng, thread_rng
    from madsim_tpu_torch.runtime import Runtime

    build = native_build()
    if type(GlobalRng(0)._core) is not _native.get_mod().Rng:
        fail("the port's GlobalRng does not draw from the native core")
    repo = str(pathlib.Path(__file__).resolve().parent)
    pure_env = dict(os.environ, MADSIM_TPU_NO_NATIVE="1")

    eng = Engine(RaftMachine(num_nodes=5, log_capacity=8), EngineConfig(**DIFF, faults=FaultPlan(**DIFF_FAULTS)))
    schedules = fault_schedules(eng, range(NATIVE_SEEDS))
    t0 = time.perf_counter()
    native = [run_host_raft(seed, sched) for seed, sched in enumerate(schedules)]
    native_s = time.perf_counter() - t0
    with tempfile.TemporaryDirectory(prefix="madsim_native_") as tmp:
        path = pathlib.Path(tmp) / "schedules.json"
        path.write_text(json.dumps(schedules))
        t0 = time.perf_counter()
        out = subprocess.run([sys.executable, "-c", NATIVE_PURE_RAFT, repo, str(path)], env=pure_env,
                             capture_output=True, text=True, timeout=600)
        pure_process_s = time.perf_counter() - t0
    if out.returncode != 0:
        fail(f"run_host_raft on the pure-Python path exited {out.returncode}:\n{out.stderr[-3000:]}")
    pure = json.loads(out.stdout)
    if pure["reports"] != json.loads(json.dumps(native)):
        bad = [s for s, (a, b) in enumerate(zip(pure["reports"], json.loads(json.dumps(native)))) if a != b]
        fail(f"run_host_raft differs between the native core and the pure-Python path on seeds {bad[:16]}")

    chaos = {}
    for name, env in (("native", dict(os.environ)), ("pure", pure_env)):
        run = subprocess.run([sys.executable, "-c", NATIVE_CHAOS, repo], env=env, capture_output=True, text=True,
                             timeout=300)
        if run.returncode != 0:
            fail(f"the chaos scenario on the {name} path exited {run.returncode}:\n{run.stderr[-3000:]}")
        chaos[name] = run.stdout.split("\n", 1)
    if (chaos["native"][0], chaos["pure"][0]) != ("True", "False"):
        fail(f"the chaos scenario ran on the wrong paths: {chaos['native'][0]}, {chaos['pure'][0]}")
    if chaos["native"][1] != chaos["pure"][1]:
        fail(f"the chaos scenario differs: native {chaos['native'][1][:300]!r}, pure {chaos['pure'][1][:300]!r}")

    scenario = _load_raft_host().scenario
    observing = []

    async def observed():
        observing.append(thread_rng().native_observing)
        return await scenario()

    t0 = time.perf_counter()
    determinism = [Runtime.check_determinism(seed, observed) for seed in range(NATIVE_CHECK_SEEDS)]
    determinism_s = time.perf_counter() - t0
    if observing != [True] * (2 * NATIVE_CHECK_SEEDS):
        fail(f"check_determinism ran without the native core observing: {observing}")

    emit({"phase": "native", "card": card_line(), "so": build["so"], "build_s": round(build["build_s"], 3),
          "host_raft": {"seeds": NATIVE_SEEDS, "equal": True, "elected": sum(r["elected"] for r in native),
                        "native_s": round(native_s, 3), "native_seeds_per_s": round(NATIVE_SEEDS / native_s, 2),
                        "pure_s": round(pure["s"], 3), "pure_seeds_per_s": round(NATIVE_SEEDS / pure["s"], 2),
                        "pure_process_s": round(pure_process_s, 3),
                        "speedup": round(pure["s"] / native_s, 3)},
          "chaos_seed_11": {"equal": True, "result_chars": len(chaos["native"][1])},
          "check_determinism": {"seeds": NATIVE_CHECK_SEEDS, "passed": True, "native_observing": True,
                                "terms_with_leader": [r["terms_with_leader"] for r in determinism],
                                "seconds": round(determinism_s, 3)}})
    return {"so": build["so"]}


GUIDED_BEAT = re.compile(
    r"guided batch (\d+)/(\d+): (\d+) seeds \((\d+) mutants\) in ([0-9.]+)s \((\d+) seeds/s\) on \d+ device\(s\), "
    r"coverage (\d+) slots \(\+(\d+)\), (\d+) failing so far, escalation (\d+) \[([^\]]*)\]"
    r"(?: -> escalated to step (\d+))?")


def guided_batches(err):
    """The guided heartbeat lines of a hunt's log, one dict a batch."""
    keys = ("batch", "batches", "seeds", "mutants", "seconds", "seeds_per_s", "slots", "new_slots", "failing",
            "escalation", "kinds", "escalated_to")
    out = []
    for m in GUIDED_BEAT.finditer(err):
        row = dict(zip(keys, m.groups()))
        out.append({k: (v if k == "kinds" else None if v is None else float(v) if k == "seconds" else int(v))
                    for k, v in row.items()})
    return out


def guided_phase(torch, np, kernels, dev, diff_whole):
    """Phases 14 and 15: guided search at full width (`guided`), and the
    Raft differential's device side (`differential`; the whole
    differential, `diff_whole`, ran in the window). At once: `hunt
    --guided` of phase 11's hunt at 2 x 8192 lanes on the card (a
    `guided_batch` line a batch: seconds, seeds/s, mutants, new slots,
    finds so far, the rung), the same at 64 lanes on the card and with
    `--device cpu` (equal stdout and checkpoints), the differential's
    fault schedules and verdicts of 64 seeds on the CPU in a subprocess;
    in this process the same on the card (equal). Then the checks of the
    full-width hunt: mutants in every batch after the first, as many as
    its heartbeat counts; every seed of its trail unique; its first 64
    finds re-run on the CPU with `run_seed_batch` under their escalation
    step's engine, to the same codes. Then each new kernel shape, held
    against its twin and timed (`guided_kernels`): the megakernel and the
    flush at 8192 lanes under the escalated vocabulary, the megakernel at
    the 64-lane hunt's escalated W, pop_gather at the differential's 64
    and 256 lanes of Q = 96. Returns the `guided_kernels` entries."""
    import os
    import tempfile
    from concurrent.futures import ThreadPoolExecutor

    from madsim_tpu_torch.__main__ import _build_engine, _parser
    from madsim_tpu_torch.search.guided import engine_for_escalation

    with tempfile.TemporaryDirectory(prefix="madsim_guided_") as tmp:
        dirs = {k: pathlib.Path(tmp) / k for k in ("full", "small_card", "small_cpu")}
        for d in dirs.values():
            d.mkdir()
        full_argv = ["hunt", *GUIDED_ARGS, "--seeds", str(GUIDED_BATCHES * GUIDED_LANES), "--batch",
                     str(GUIDED_LANES), "--max-steps", str(GUIDED_STEPS), "--checkpoint", "ck.json", "--corpus",
                     "c.json"]
        small_argv = ["hunt", *GUIDED_ARGS, "--seeds", str(GUIDED_SMALL_BATCHES * GUIDED_SMALL_LANES), "--batch",
                      str(GUIDED_SMALL_LANES), "--max-steps", str(GUIDED_SMALL_STEPS), "--checkpoint", "ck.json",
                      "--corpus", "c.json"]
        diff_out = pathlib.Path(tmp) / "differential_cpu.json"
        diff_code = ("import json, sys\n"
                     f"sys.path.insert(0, {str(pathlib.Path(__file__).resolve().parent)!r})\n"
                     "import chip_smoke\n"
                     "json.dump(chip_smoke.differential_side('cpu'), open(sys.argv[1], 'w'))\n")
        env = dict(os.environ, OMP_NUM_THREADS="2")
        t0 = time.perf_counter()
        with ThreadPoolExecutor(4) as pool:
            full_job = pool.submit(run_cli, str(dirs["full"]), "guided", full_argv, 1)
            small_jobs = {k: pool.submit(run_cli, str(dirs[k]), k, small_argv + (["--device", "cpu"] if k ==
                                         "small_cpu" else []), 1, 2 if k == "small_cpu" else None)
                          for k in ("small_card", "small_cpu")}
            diff_job = pool.submit(subprocess.run, [sys.executable, "-c", diff_code, str(diff_out)], env=env,
                                   capture_output=True, text=True, timeout=900)
            # the differential's device side on the card, meanwhile
            torch.cuda.synchronize()
            kernels.reset_launches()
            t_diff = time.perf_counter()
            diff_card = differential_side()
            torch.cuda.synchronize()
            diff_card_s = time.perf_counter() - t_diff
            diff_launches = dict(kernels.launches)
            done = diff_job.result()
            diff_cpu_s = time.perf_counter() - t_diff
            full = full_job.result()
            small = {k: j.result() for k, j in small_jobs.items()}
        stage_s = round(time.perf_counter() - t0, 3)
        if done.returncode != 0:
            fail(f"differential on the CPU exited {done.returncode}:\n{done.stderr[-3000:]}")
        diff_cpu = json.loads(diff_out.read_text())
        # tuples of the card's side as JSON gives them back
        if json.loads(json.dumps(diff_card)) != diff_cpu:
            fail("differential: the card's schedules or verdicts differ from the CPU's")
        if diff_launches.get("pop_gather", 0) <= 0:
            fail(f"differential on the card never launched pop_gather: {diff_launches}")
        verdicts = diff_card["verdicts"]
        emit({"phase": "differential", "seeds": DIFF_LANES, "equal": True, "card_s": round(diff_card_s, 3),
              "cpu_subprocess_s": round(diff_cpu_s, 3), "fault_events": sum(len(x) for x in diff_card["schedules"]),
              "device_violations": sum(1 for v in verdicts if v["violation"]),
              "device_elected": sum(1 for v in verdicts if v["elected"]), "launches": diff_launches})

        # the full-width hunt
        beats = guided_batches(full["err"])
        ckpt = json.loads((dirs["full"] / "ck.json").read_text())
        trail = ckpt["guided"]["trail"]
        for b in beats:
            emit({"phase": "guided_batch", **b})
        if len(beats) != GUIDED_BATCHES or len(trail) != GUIDED_BATCHES or not ckpt["done"]:
            fail(f"guided hunt ran {len(beats)} heartbeats, {len(trail)} trail records (done={ckpt['done']}):\n"
                 f"{full['out']}\n{full['err'][-3000:]}")
        for b, rec in zip(beats[1:], trail[1:]):
            if b["mutants"] <= 0 or b["mutants"] != rec["mutants"]:
                fail(f"guided batch {b['batch']}: {b['mutants']} mutants in the heartbeat, {rec['mutants']} in "
                     f"the trail")
        seeds = [s for rec in trail for s in rec["seeds"]]
        if len(seeds) != len(set(seeds)) or len(seeds) != ckpt["completed"]:
            fail(f"guided trail: {len(seeds)} seeds, {len(set(seeds))} unique, {ckpt['completed']} completed")
        for name in ("step_megakernel", "cov_flush"):
            if full["launches"].get(name, 0) <= 0:
                fail(f"guided hunt never launched {name}: {full['launches']}")
        failing = [tuple(x) for x in ckpt["failing"]]
        esc = {int(k): v for k, v in ckpt["guided"]["failing_escalation"].items()}
        summary = re.search(r"hunted (\d+) seeds: (\d+) failing(?:, (\d+) abandoned)?", full["out"])
        g_line = re.search(r"guided: escalation step (\d+), (\d+) corpus parents, (\d+) mutants over (\d+) batches",
                           full["out"])
        att = re.search(r"fault attribution: \[([^\]]*)\]", full["out"])
        if not summary or not g_line or int(summary.group(2)) != len(failing) or not failing:
            fail(f"guided hunt: its summary does not match its checkpoint, or it found nothing:\n{full['out']}")

        # its first finds on the CPU engine, under their escalation step's engine
        cpu_base = _build_engine(_parser().parse_args([*full_argv, "--device", "cpu"]))
        first = failing[:GUIDED_RERUN]
        threads = torch.get_num_threads()
        torch.set_num_threads(4)
        t0 = time.perf_counter()
        rerun = {}
        for step in sorted({esc[s] for s, _ in first}):
            group = [(s, c) for s, c in first if esc[s] == step]
            out = engine_for_escalation(cpu_base, step).run_seed_batch([s for s, _ in group],
                                                                        max_steps=GUIDED_STEPS)
            if sorted(out["failing"] + out["infra"]) != sorted(group):
                fail(f"guided finds under escalation step {step} re-ran on the CPU as {out['failing']}, "
                     f"{out['infra']}; the card found {group}")
            rerun[str(step)] = len(group)
        rerun_s = round(time.perf_counter() - t0, 3)
        torch.set_num_threads(threads)

        # the 64-lane hunt, card against CPU
        card_out, cpu_out = cli_wall_free(small["small_card"]["out"]), cli_wall_free(small["small_cpu"]["out"])
        card_ck, cpu_ck = ((dirs[k] / "ck.json").read_bytes() for k in ("small_card", "small_cpu"))
        if card_out != cpu_out or card_ck != cpu_ck:
            fail(f"64-lane guided hunt: the card and the CPU differ (checkpoints equal: {card_ck == cpu_ck}):\n"
                 f"{card_out}\n{cpu_out}")
        small_trail = json.loads(card_ck)["guided"]["trail"]
        esc_engines = sorted({r["escalated_to"] for r in trail if r["escalated_to"]})
        emit({"phase": "guided", "lanes": GUIDED_LANES, "batches": GUIDED_BATCHES, "max_steps": GUIDED_STEPS,
              "stage_s": stage_s, "subprocess_s": full["s"], "seeds": int(summary.group(1)),
              "failing": len(failing), "abandoned": int(summary.group(3) or 0),
              "codes": sorted({c for _, c in failing}), "escalation": int(g_line.group(1)),
              "parents": int(g_line.group(2)), "mutants": int(g_line.group(3)),
              "escalated_engines_built": len(esc_engines), "escalated_to": esc_engines,
              "finds_by_escalation": {str(k): sum(1 for s, _ in failing if esc[s] == k) for k in sorted(set(esc.values()))},
              "attribution": att.group(1) if att else None, "trail_unique": True,
              "rerun_on_cpu": {"finds": len(first), "by_escalation": rerun, "s": rerun_s, "same_codes": True},
              "launches": full["launches"], "batch_launches": full["batches"],
              "small": {"lanes": GUIDED_SMALL_LANES, "batches": len(small_trail), "equal": True,
                        "card_s": small["small_card"]["s"], "cpu_s": small["small_cpu"]["s"],
                        "escalations": [r["escalated_to"] for r in small_trail if r["escalated_to"]],
                        "failing": len(json.loads(card_ck)["failing"]),
                        "launches": small["small_card"]["launches"]}})

    # each new kernel shape, on a state of the engine that launches it
    card_base = _build_engine(_parser().parse_args(full_argv))
    steps, flushes = [], []
    by_words = {}
    for b in full["batches"]:
        n = by_words.setdefault(b["words"], {"step_megakernel": 0, "cov_flush": 0})
        for k in n:
            n[k] += b["launches"].get(k, 0)
    # where a step's time goes, at the base rung and the top one
    profiles = {}
    for rung in sorted({0, max(r["escalation"] for r in trail)}):
        eng = engine_for_escalation(card_base, rung)
        words = eng._rng_layout.total_words
        rec = next(r for r in trail if r["escalation"] == rung)
        state = eng.run_segment(eng.init_batch(np.asarray(rec["seeds"], dtype=np.int64)), GUIDED_STATE_STEPS)
        for _ in range(eng._cov_flush_every):  # coverage buffers a flush period in
            state = eng.step_batch(state)
        profiles[f"escalation_{rung}"] = {"words": words, **profile_steps(eng, state, steps=8)}
        if rung:
            n = by_words.get(words, {})
            steps.append((f"step_megakernel_guided_L{GUIDED_LANES}_Q32_W{words}", state, words,
                          n.get("step_megakernel", 0)))
            flushes.append((f"cov_flush_guided_L{GUIDED_LANES}_W{words}", state.cov, n.get("cov_flush", 0)))
    emit({"phase": "profile_guided", **profiles})
    small_top = max([r["escalation"] for r in small_trail])
    if small_top:
        eng = engine_for_escalation(_build_engine(_parser().parse_args(small_argv)), small_top)
        words = eng._rng_layout.total_words
        state = eng.run_segment(eng.init_batch(np.asarray(small_trail[-1]["seeds"], dtype=np.int64)),
                                GUIDED_STATE_STEPS)
        n = sum(b["launches"].get("step_megakernel", 0) for b in small["small_card"]["batches"] if b["words"] == words)
        steps.append((f"step_megakernel_guided_L{GUIDED_SMALL_LANES}_Q32_W{words}", state, words, n))
    d_state, w_state = built("diff", lambda: diff_states(np))
    return time_kernel_shapes(kernels, dev, "guided_kernels", steps, flushes, pops=(
        (f"pop_gather_differential_L{DIFF_LANES}_Q{DIFF['queue_capacity']}", d_state, diff_launches["pop_gather"]),
        (f"pop_gather_differential_L{DIFF_WHOLE_LANES}_Q{DIFF['queue_capacity']}", w_state,
         diff_whole["launches"]["pop_gather"])))


def nest(ranges, points):
    """{key: names of the ranges open at the point, outermost first} for
    properly nested `ranges` (start, end, name) on one thread and
    `points` (ts, key)."""
    ranges, out, stack, i = sorted(ranges), {}, [], 0
    for ts, key in sorted(points):
        while i < len(ranges) and ranges[i][0] <= ts:
            while stack and stack[-1][1] <= ranges[i][0]:
                stack.pop()
            stack.append(ranges[i])
            i += 1
        while stack and stack[-1][1] < ts:
            stack.pop()
        out[key] = tuple(r[2] for r in stack)
    return out


def device_phase_split(events):
    """The card's busy time in a capture, by device phase: each device
    event (kernel, memcpy, memset) is attributed to the innermost
    madsim.* range around the runtime call that launched it (kineto links
    the two by `correlation`). Returns {"busy_ms": {phase: ms}, "events":
    {phase: n}, "kernels_under": {kernel: {phase: n}} (every enclosing
    phase), "unlinked": n, "stream_ranges": the madsim.* ranges kineto
    drew on the card's streams (`gpu_user_annotation`)}."""
    prefix = "madsim."
    ranges = [(float(e["ts"]), float(e["ts"]) + float(e.get("dur") or 0.0), e["name"][len(prefix):])
              for e in events if e.get("cat") == "user_annotation" and e.get("ph") == "X"
              and str(e.get("name", "")).startswith(prefix) and not e["name"].startswith(prefix + "sync")]
    calls = [(float(e["ts"]), e["args"]["correlation"]) for e in events
             if e.get("cat") == "cuda_runtime" and "correlation" in (e.get("args") or {})]
    at_launch = nest(ranges, calls)
    out = {"busy_ms": {}, "events": {}, "kernels_under": {}, "unlinked": 0,
           "stream_ranges": sum(1 for e in events if e.get("cat") == "gpu_user_annotation")}
    for e in events:
        if e.get("cat") not in ("kernel", "gpu_memcpy", "gpu_memset") or e.get("ph") != "X":
            continue
        names = at_launch.get((e.get("args") or {}).get("correlation"))
        out["unlinked"] += names is None
        phase = names[-1] if names else "outside"
        out["busy_ms"][phase] = out["busy_ms"].get(phase, 0.0) + float(e.get("dur") or 0.0) / 1e3
        out["events"][phase] = out["events"].get(phase, 0) + 1
        if e.get("cat") == "kernel":
            for key in ("step_megakernel_kernel", "cov_flush_kernel", "pop_gather_kernel", "pop_earliest_kernel"):
                if key in str(e.get("name", "")):
                    under = out["kernels_under"].setdefault(key, {})
                    for name in set(names or ("outside",)):
                        under[name] = under.get(name, 0) + 1
    return out


def virtual_track(doc):
    """The virtual-time events of a merged plane, their pids numbered
    from 0 in order of first appearance."""
    pids = [e["pid"] for e in doc["traceEvents"]
            if e.get("ph") == "M" and "VIRTUAL" in (e.get("args") or {}).get("name", "")]
    return [dict(e, pid=pids.index(e["pid"])) for e in doc["traceEvents"] if e.get("pid") in pids]


def capture_holds_kernel(path, kernel):
    """Whether a gzipped kineto capture holds a `kernel` event whose name
    holds `kernel` (a streamed search: the v2 capture is ~1 M events)."""
    import gzip

    pat = re.compile(r'"cat":\s*"kernel",\s*"name":\s*"[^"]*' + re.escape(kernel))
    tail = ""
    with gzip.open(path, "rt") as f:
        while True:
            chunk = f.read(1 << 22)
            if not chunk:
                return False
            if pat.search(tail + chunk):
                return True
            tail = chunk[-4096:]


EXPORT_LOG = re.compile(r"device capture: (\d+) bytes of trace \((\d+) gzipped\) exported in ([0-9.]+)s")


class PerfChecks:
    """Phase 16's commands that time nothing, in subprocesses on the card:
    the v2 leg (`prof --rng-stream 2` of one 8192-lane segment) and
    `bench-ab --gate coverage-unbuffered` and `--gate rng-stream` at 256
    lanes, one rep pair each (a check that they run, not a gate's cost).
    The full run starts them with the other work that times nothing
    (window_phase) and reads them in phase 16."""

    def __init__(self):
        self.res = None
        self.futures = None

    def start(self):
        import tempfile
        from concurrent.futures import ThreadPoolExecutor

        self.tmp = tempfile.mkdtemp(prefix="madsim_perf_checks_")
        self.prof_dir = str(pathlib.Path(self.tmp) / "prof_v2")
        ab = [*PERF_ARGS, "--lanes", str(AB_LANES), "--seeds", str(AB_LANES), "--reps", "1", "--max-steps",
              str(AB_STEPS)]
        jobs = {
            "prof_v2": (["prof", *PERF_ARGS_V2, "--max-steps", str(PROF_STEPS), "--seeds", str(PERF_LANES), "--batch",
                         str(PERF_LANES), "--out", "v2_host.json", "--profile-dir", self.prof_dir,
                         "--log-level", "INFO"], 0),
            "ab_cov": (["bench-ab", "--gate", "coverage-unbuffered", *ab], 0),
            "ab_rng": (["bench-ab", "--gate", "rng-stream", *ab], 0),
        }
        self.t0 = time.perf_counter()
        self.pool = ThreadPoolExecutor(len(jobs))
        self.futures = {name: self.pool.submit(run_cli, self.tmp, name, *job) for name, job in jobs.items()}

    def join(self):
        if self.res is None:
            self.res = {name: f.result() for name, f in self.futures.items()}
            self.pool.shutdown()
            self.s = round(time.perf_counter() - self.t0, 3)
        return self.res

    def read(self):
        """Fails unless the v2 capture holds pop_gather_kernel and both
        bench-ab runs printed their line on the card with their kernels
        launched; returns the `perf` line's fields."""
        import shutil

        from madsim_tpu_torch.perf import xprof

        res = self.join()
        v2 = res["prof_v2"]
        v2_path = xprof.find_device_trace(self.prof_dir)
        if not v2_path or not capture_holds_kernel(v2_path, "pop_gather_kernel") or \
                v2["launches"].get("pop_gather", 0) <= 0:
            fail(f"prof --rng-stream 2: no pop_gather_kernel in the capture {v2_path}: {v2['launches']}")
        v2_export = EXPORT_LOG.search(v2["err"])
        ab = {}
        for name, gate in (("ab_cov", "coverage-unbuffered"), ("ab_rng", "rng-stream")):
            lines = [json.loads(ln) for ln in res[name]["out"].splitlines() if ln.startswith("{")]
            if not lines or lines[0]["gate"] != gate or lines[0]["platform"] != "cuda" or lines[0]["pairs"] != 1:
                fail(f"bench-ab --gate {gate}:\n{res[name]['out']}")
            ab[gate] = {**lines[0], "subprocess_s": res[name]["s"], "launches": res[name]["launches"]}
        if not (res["ab_rng"]["launches"].get("step_megakernel") and res["ab_rng"]["launches"].get("pop_gather")
                and res["ab_cov"]["launches"].get("cov_flush")):
            fail(f"bench-ab: a kernel of its engines never launched: {res['ab_rng']['launches']}, "
                 f"{res['ab_cov']['launches']}")
        shutil.rmtree(self.tmp, ignore_errors=True)
        return {"checks_s": self.s,
                "prof_v2": {"subprocess_s": v2["s"], "pop_gather_kernel": True, "launches": v2["launches"],
                            "trace_bytes": int(v2_export.group(1)) if v2_export else None,
                            "export_s": float(v2_export.group(3)) if v2_export else None},
                "bench_ab": ab}


def perf_phase(torch, np, kernels, dev, checks=None):
    """Phase 16: the perf tooling, `python -m madsim_tpu_torch` in
    subprocesses on the card. (1) `prof --merge` of one 256-step segment
    of 8192 lanes, alone on the card, with the CPU's `prof --merge` of 8
    lanes beside it: at least two sync points matched, the megakernel's
    and the flush's kernels launched inside madsim.step, the card's busy
    time by device phase, and a virtual track equal to the CPU's (`prof`
    line). (2) Once that capture has stopped, beside prof's host tail
    (its export, its JSON, its one-lane replay), `perf` of the flagship at
    one batch of 8192 lanes: the host timeline is written, its spans cover >= 90%
    of the wall and name every executor span (`perf_timeline` line: each
    span's seconds and share, the device wait, the dispatch gap, the
    verdict and the card's memory). (3) `PerfChecks` (the v2 leg and
    bench-ab), started here unless the run started them earlier (`perf`
    line). Returns the commands' launches for `perf_kernels`."""
    import tempfile
    from concurrent.futures import ThreadPoolExecutor

    with tempfile.TemporaryDirectory(prefix="madsim_perf_") as tmp:
        t = pathlib.Path(tmp)
        files = {k: str(t / f) for k, f in (("timeline", "host.json"), ("merged", "merged.json"),
                                             ("merged_cpu", "merged_cpu.json"))}
        dirs = {k: str(t / k) for k in ("prof", "prof_cpu")}
        prof_argv = ["prof", "--merge", "--max-steps", str(PROF_STEPS), "--trace-seed", str(PROF_TRACE_SEED),
                     "--log-level", "INFO"]
        t0 = time.perf_counter()
        with ThreadPoolExecutor(2) as pool:
            jobs = {
                "prof": pool.submit(run_cli, tmp, "prof", [
                    *prof_argv, *PERF_ARGS, "--seeds", str(PERF_LANES), "--batch", str(PERF_LANES), "--out",
                    files["merged"], "--profile-dir", dirs["prof"]], 0),
                "prof_cpu": pool.submit(run_cli, tmp, "prof_cpu", [
                    *prof_argv, *PERF_ARGS, "--seeds", str(PROF_CPU_LANES), "--batch", str(PROF_CPU_LANES), "--out",
                    files["merged_cpu"], "--profile-dir", dirs["prof_cpu"], "--device", "cpu"], 0, 2),
            }
            # the capture's directory appears when the profiler has stopped
            stopped = pathlib.Path(dirs["prof"]) / "plugins" / "profile"
            while not stopped.exists() and not jobs["prof"].done():
                time.sleep(0.2)
            capture_s = round(time.perf_counter() - t0, 3)

            # 2. the host timeline of a full-width run
            t1 = time.perf_counter()
            perf = run_cli(tmp, "perf", ["perf", files["timeline"], *PERF_ARGS, "--seeds", str(PERF_LANES),
                                         "--batch", str(PERF_LANES), "--log-level", "INFO"], 0)
            perf_s = round(time.perf_counter() - t1, 3)
            if checks is None:
                checks = PerfChecks()
                checks.start()
            res = {name: f.result() for name, f in jobs.items()}
        stage_s = round(time.perf_counter() - t0, 3)

        s = json.loads(pathlib.Path(files["timeline"]).read_text())["madsim_perf_summary"]
        missing = [n for n in PERF_SPANS if n not in s["spans"]]
        verdict = re.search(r"host verdict: (.*)", perf["out"])
        mem = re.search(r"device memory: (.*)", perf["out"])
        rate = re.search(r"streamed (\d+) seeds in ([0-9.]+)s \((\d+) seeds/s\)", perf["out"])
        if missing or s["span_coverage"] < 0.9 or not verdict or not mem or not rate:
            fail(f"perf: spans {missing} missing or coverage {s['span_coverage']} < 0.9:\n{perf['out']}")
        for name in ("step_megakernel", "cov_flush"):
            if perf["launches"].get(name, 0) <= 0:
                fail(f"perf never launched {name}: {perf['launches']}")
        emit({"phase": "perf_timeline", "lanes": PERF_LANES, "seeds": int(rate.group(1)),
              "seconds": float(rate.group(2)), "seeds_per_s": int(rate.group(3)), "subprocess_s": perf["s"],
              "wall_s": s["wall_s"], "span_coverage": s["span_coverage"],
              "spans": {k: {"s": v["total_s"], "count": v["count"], "share": round(v["pct_of_wall"] / 100, 4)}
                        for k, v in s["spans"].items()},
              "device_wait_s": s["device_wait_s"], "device_wait_share": round(s["device_wait_pct"] / 100, 4),
              "dispatch_gap_s": s["dispatch_gap_s"], "dispatch_gap_share": round(s["dispatch_gap_pct"] / 100, 4),
              "verdict": verdict.group(1),
              "device_memory": mem and {k: int(v) for k, v in (kv.split("=") for kv in mem.group(1).split(", "))},
              "counters": s["counters"], "launches": perf["launches"],
              **{key: [c[key] for c in perf["streams"]] for key in ("device_segments", "dispatches", "host_syncs")},
              "stage_s": perf_s})

        prof = res["prof"]
        merge = [json.loads(ln) for ln in prof["out"].splitlines() if ln.startswith('{"metric": "prof_merge"')]
        events_n = re.search(r"device profile: (\d+) events", prof["out"])
        export = EXPORT_LOG.search(prof["err"])
        if not merge or not events_n or not export:
            fail(f"prof --merge printed no merge line, event count or export:\n{prof['out']}\n{prof['err'][-3000:]}")
        merge = merge[0]
        if merge["sync_points"] < 2 or not all(merge["tracks"].values()):
            fail(f"prof --merge: {merge}")
        t1 = time.perf_counter()
        doc = json.loads(pathlib.Path(files["merged"]).read_text())
        cpu_doc = json.loads(pathlib.Path(files["merged_cpu"]).read_text())
        load_s = round(time.perf_counter() - t1, 3)
        vtrack = virtual_track(doc)
        if not vtrack or vtrack != virtual_track(cpu_doc):
            fail("prof --merge: the card's virtual track differs from the CPU's")
        split = device_phase_split(doc["traceEvents"])
        under = split["kernels_under"]
        if not under.get("step_megakernel_kernel", {}).get("step") or \
                not under.get("cov_flush_kernel", {}).get("step"):
            fail(f"prof: the capture holds no step_megakernel_kernel and cov_flush_kernel inside madsim.step: "
                 f"{under}, {split['unlinked']} device events unlinked")
        steps_wall_ms = sum(float(e["dur"]) for e in doc["traceEvents"] if e.get("cat") == "user_annotation"
                            and e.get("name") == "madsim.step") / 1e3
        busy = split["busy_ms"]
        emit({"phase": "prof", "lanes": PERF_LANES, "max_steps": PROF_STEPS, "capture_stopped_s": capture_s,
              "subprocess_s": prof["s"], "cpu_subprocess_s": res["prof_cpu"]["s"],
              "device_events": int(events_n.group(1)), "merged_events": len(doc["traceEvents"]),
              "export_s": float(export.group(3)), "trace_bytes": int(export.group(1)),
              "trace_gz_bytes": int(export.group(2)), "merged_bytes": pathlib.Path(files["merged"]).stat().st_size,
              "load_s": load_s, "merge": merge, "virtual_events": len(vtrack), "virtual_equal": True,
              "busy_ms_by_phase": {k: round(busy.get(k, 0.0), 3) for k in PROF_PHASES if k in busy},
              "events_by_phase": split["events"], "busy_ms": round(sum(busy.values()), 3),
              "step_ranges_ms": round(steps_wall_ms, 3),
              "step_idle_share": round(1 - busy.get("step", 0.0) / steps_wall_ms, 4) if steps_wall_ms else None,
              "kernels_under": under, "unlinked": split["unlinked"], "stream_ranges": split["stream_ranges"],
              "launches": prof["launches"]})
        del doc, cpu_doc

    # 3. the commands that time nothing
    emit({"phase": "perf", "stage_s": stage_s, **checks.read()})
    # the launches of the main path's kernels, for the kernels line; the
    # prof's single-lane replay's, its launches outside its stream
    stream_mega = sum(c["launches"].get("step_megakernel", 0) for c in prof["streams"])
    return {"perf": perf["launches"], "prof_v2": checks.res["prof_v2"]["launches"], "prof": prof["launches"],
            "replay_megakernel": prof["launches"].get("step_megakernel", 0) - stream_mega,
            "ab_cov": checks.res["ab_cov"]["launches"], "ab_rng": checks.res["ab_rng"]["launches"]}


def perf_kernels(kernels, np, dev, perf):
    """Each kernel shape phase 16 first launches, held against its twin
    and timed on a state of the engine the command builds (`perf_kernels`
    line): bench-ab's 256 lanes (the megakernel with the digest and the
    flush from both gates' engines, pop_gather from rng-stream's v2
    engine) and `prof --merge`'s single-lane replay (the megakernel with
    the digest at L = 1)."""
    ab_state, words = built("perf_ab", lambda: command_state(np, ["explore", *PERF_ARGS], AB_LANES))
    ab_v2, _ = built("perf_ab_v2", lambda: command_state(np, ["explore", *PERF_ARGS_V2], AB_LANES))
    replay_state, _ = built("perf_replay", lambda: command_state(np, ["explore", *PERF_ARGS], 1, PROF_TRACE_SEED))
    cov, rng = perf["ab_cov"], perf["ab_rng"]
    time_kernel_shapes(kernels, dev, "perf_kernels", (
        (f"step_megakernel_L{AB_LANES}_Q32_W{words}", ab_state, words,
         cov.get("step_megakernel", 0) + rng.get("step_megakernel", 0)),
        (f"step_megakernel_L1_Q32_W{words}", replay_state, words, perf["replay_megakernel"]),
    ), ((f"cov_flush_L{AB_LANES}", ab_state.cov, cov.get("cov_flush", 0) + rng.get("cov_flush", 0)),),
        pops=((f"pop_gather_L{AB_LANES}_Q32", ab_v2, rng.get("pop_gather", 0)),))


def fleet_flags(spec):
    """The `fleet submit` flags of a job spec."""
    out = []
    for key, value in spec.items():
        flag = "--" + key.replace("_", "-")
        if value is True:
            out.append(flag)
        elif value is not False:
            out += [flag, str(value)]
    return out


def fleet_job_line(store, job_id, workers):
    """A job's figures: its seconds from submit to its terminal state, each
    unit's (from the workers' unit lines and the store's batch_done
    events: seeds so far, seconds, the unit's seeds/s warm-up included,
    engine built or cached), the shrink's seconds and the finds."""
    job = store.get(job_id)
    events = store.read_events(job_id)
    units = []
    for w in workers:
        for m in FLEET_UNIT.finditer(w["out"]):
            if m.group(1) == job_id:
                units.append({"worker": w["name"], "batch": int(m.group(2)), "seeds_total": int(m.group(4)),
                              "unit_s": float(m.group(5)), "engine": m.group(6), "failing": int(m.group(7))})
    done = [e for e in events if e.get("type") == "batch_done"]
    for u, e in zip(units, done):
        u["unit_seeds_per_s"] = e.get("seeds_per_sec")
    shrink = {e["type"]: e["ts"] for e in events if e.get("type") in ("shrink_started", "shrink_done")}
    result = job.result or {}
    return {"id": job_id, "state": job.state, "seconds": round(job.history[-1][0] - job.ts_submit, 3),
            "units": units,
            "shrink_s": round(shrink["shrink_done"] - shrink["shrink_started"], 3) if len(shrink) == 2 else None,
            "failing": len((result.get("report") or {}).get("failing") or []),
            "completed": (result.get("report") or {}).get("completed"),
            "finds": len(result.get("finds") or []), "corpus_added": result.get("corpus_added")}


def fleet_worker_line(w):
    """A worker's seconds, its streamed batches' seconds and seeds/s (the
    heartbeats, warm-up excluded) and its warm-ups' seconds."""
    rates = cli_rates(w["err"])
    return {"s": w["s"], "batch_s": rates["batch_s"], "batch_seeds_per_s": rates["batch_seeds_per_s"],
            "warm_s": [float(x) for x in re.findall(r"warm-up run_stream\(1, batch=\d+\): ([0-9.]+)s", w["err"])]}


def fleet_jobs():
    """Phase 17: the hunt fleet, `python -m madsim_tpu_torch fleet` in
    subprocesses on the card (`fleet` line). Against one `fleet serve`:
    (1) the flagship job (two units of 8192 lanes) through `fleet worker
    --drain` to `filed`: one corpus entry with `filed_by`, a repro line
    and `why_kinds`; `regress` of the fleet corpus and the entry's repro
    line (a traced one-lane `replay`, failing with its code) on the card.
    (2) The same job without shrink on a second worker, SIGKILLed once the store shows its first batch done; a new
    worker process reclaims it and resumes one batch back at most, to a
    report equal to the first job's byte for byte. (3) The guided
    handover job: its first unit on the card, the rest on a `--device
    cpu` worker, equal to a CPU-only oracle run beside it in a store of
    its own, with failing seeds and an escalation. Against a second
    `fleet serve` over a store of its own: (4) the profile job's unit on
    the card under MADSIM_TPU_XPROF=1, whose capture holds kernel events
    and which `fleet profile` merges (its closing unit on a CPU worker).
    Then (5) `fleet fsck` of both
    stores finds nothing corrupt, and `fleet chaos --seed 3 --profile
    claims --workers 2` (host processes only, started with the oracle)
    passes. The calling thread only waits here, so the full run drives
    this from a thread (InThread) beside checks that time nothing.
    Returns the card workers' launches, all and the handover's card
    unit's."""
    import os
    import signal
    import tempfile

    from madsim_tpu_torch.fleet.store import JobStore
    from madsim_tpu_torch.perf import xprof

    spawned = []
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="madsim_fleet_") as tmp:
        t = pathlib.Path(tmp)
        root, oracle_root, profile_root = str(t / "farm"), str(t / "oracle"), str(t / "profile")
        pf, profile_pf = str(t / "farm.port"), str(t / "profile.port")

        def spawn(name, argv, **kw):
            job = spawn_cli(tmp, name, argv, **kw)
            spawned.append(job)
            return job

        def worker(name, wid, *extra, at=root, **kw):
            return spawn(name, ["fleet", "worker", "--root", at, "--worker-id", wid, "--poll", "0.2",
                                "--log-level", "INFO", *extra], **kw)

        def serve(name, at, port_file):
            return spawn(name, ["fleet", "serve", "--root", at, "--addr", "127.0.0.1:0", "--port-file", port_file,
                                "--sweep-interval", "0"])

        def submit(spec, *extra, port_file=pf):
            return run_cli(tmp, "submit", ["fleet", "submit", "--port-file", port_file, *fleet_flags(spec),
                                           *extra])["out"].strip()

        def until(cond, watched, what, timeout=600):
            deadline = time.perf_counter() + timeout
            while not cond():
                for w in watched:
                    if w["proc"].poll() is not None:
                        reap_cli(w, rc=None)
                        fail(f"fleet: {w['name']} exited {w['proc'].returncode} while waiting for {what}:\n"
                             f"{(w['tmp'] / (w['name'] + '.err')).read_text()[-3000:]}")
                if time.perf_counter() > deadline:
                    fail(f"fleet: no {what} in {timeout} s")
                time.sleep(0.1)

        try:
            servers = [serve("serve", root, pf), serve("serve_profile", profile_root, profile_pf)]
            until(lambda: os.path.exists(pf) and os.path.exists(profile_pf), servers, "port files", 60)
            store, pstore = JobStore(root), JobStore(profile_root)

            def lease_of(job_id):
                return (store.get(job_id).lease or {}).get("worker")

            def batches(job_id):
                return store.get(job_id).progress.get("batches_run") or 0

            # Each worker on the farm's store is started once the one
            # before holds its job, and priorities keep it there: the
            # flagship 1, the handover job 0, the replacement job -1. No
            # worker but the replacement runs the reclaim sweep
            # (--no-reclaim), so no one requeues job 2 while its short
            # lease has lapsed inside a unit (a worker renews at unit
            # ends); --max-units ends a worker with its job.
            # 1. the flagship job
            j1 = submit(FLEET_SPEC, "--priority", "1")
            w1 = worker("w1", "card-w1", "--drain", "--max-units", str(FLEET_UNITS + 1), "--lease-ttl", "900",
                        "--no-reclaim")
            until(lambda: lease_of(j1) == "card-w1", [w1], "w1's lease")
            # on the CPU: the handover job's oracle and the synthetic chaos run
            ostore = JobStore(oracle_root)
            oracle_id = ostore.submit(dict(FLEET_GUIDED)).id
            oracle = worker("oracle", "cpu-oracle", "--drain", "--device", "cpu", at=oracle_root, cpu_threads=2)
            chaos = spawn("chaos", ["fleet", "chaos", "--seed", "3", "--profile", "claims", "--workers", "2"])
            # 4. the profile job, alone on its store: its batch on the card
            #    under the capture; its closing unit (which launches no
            #    kernel, and whose capture would replace the batch's) on a
            #    CPU worker of the same identity, without it
            j4 = submit(FLEET_PROFILE, port_file=profile_pf)
            w5 = worker("w5", "card-profile", "--max-units", "1", "--no-reclaim", at=profile_root,
                        extra_env={"MADSIM_TPU_XPROF": "1"})
            # 2. the replacement job
            j2 = submit({**FLEET_SPEC, "shrink_limit": 0}, "--priority", "-1")
            w2 = worker("w2", "card-w2", "--drain", "--lease-ttl", str(FLEET_TTL), "--no-reclaim")
            until(lambda: lease_of(j2) == "card-w2", [w2], "w2's lease")
            # 3. the handover job's first unit on the card; then the CPU
            #    worker for its other batches and the closing unit. The two
            #    share one worker identity, so the job's lease never lapses
            #    between them, where a card worker could take it
            j3 = submit(FLEET_GUIDED)
            w3 = worker("w3", "handover", "--max-units", "1", "--no-reclaim")
            r3 = reap_cli(w3)
            w4 = worker("w4", "handover", "--max-units", str(FLEET_GUIDED_BATCHES), "--no-reclaim", "--device",
                        "cpu", cpu_threads=2)
            # 2. w2 killed after its first batch; the replacement, a new
            #    process (its own CUDA context), reclaims job 2 when w2's
            #    lease lapses
            until(lambda: batches(j2) >= 1, [w2], "job 2's first batch")
            os.kill(w2["proc"].pid, signal.SIGKILL)
            w2["proc"].wait()
            killed_ts = time.time()
            with open(store.ckpt_path(j2)) as f:
                ck_batch = json.load(f)["batch"]
            w2b = worker("w2b", "card-w2b", "--drain", "--backoff-base", "0")

            # 3. the handover job against its CPU oracle
            r4, ro = reap_cli(w4, timeout=600), reap_cli(oracle, timeout=600)
            job3, ojob = store.get(j3), ostore.get(oracle_id)

            def result_of(job):
                return json.dumps({**job.result, "corpus": os.path.basename(job.result.get("corpus") or "")},
                                  sort_keys=True)

            units3 = [len([m for m in FLEET_UNIT.finditer(w["out"]) if m.group(1) == j3]) for w in (r3, r4)]
            if not job3.terminal or result_of(job3) != result_of(ojob) or units3 != [1, FLEET_GUIDED_BATCHES]:
                fail(f"fleet: the guided job handed from the card to the CPU (units {units3}) differs from the CPU "
                     f"oracle:\n{result_of(job3)}\n{result_of(ojob)}")
            report3 = job3.result["report"]
            escalation3 = (report3.get("guided") or {}).get("escalation")
            escalated_at = [r["batch"] for r in (report3.get("guided") or {}).get("trail", []) if r["escalated_to"]]
            if not report3.get("failing") or not escalation3 or not escalated_at:
                fail(f"fleet: the handover job found {len(report3.get('failing') or [])} failing seeds and reached "
                     f"escalation step {escalation3}: its check needs both")
            emit({"phase": "fleet_stage", "stage": "handover", "s": round(time.perf_counter() - t_phase, 3),
                  "w3_s": r3["s"], "w4_s": r4["s"], "oracle_s": ro["s"]})

            # 4. the profile job's capture, merged by `fleet profile`
            r5 = reap_cli(w5)
            r6 = reap_cli(worker("w6", "card-profile", "--max-units", "1", "--no-reclaim", "--device", "cpu",
                                 at=profile_root, cpu_threads=2))
            job4 = pstore.get(j4)
            trace = pstore.device_trace_path(j4)
            if not job4.terminal or not os.path.exists(trace) or not xprof.has_kernel_events(trace):
                fail(f"fleet: the XPROF unit ({job4.state}) left no device capture with kernel events at {trace}")
            prof = run_cli(tmp, "profile", ["fleet", "profile", "--port-file", profile_pf, "--no-retry", j4, "--out",
                                            str(t / "p.json")])
            tracks = re.search(r"tracks present: ([a-z, ]+)", prof["out"])
            if not tracks or "device" not in tracks.group(1):
                fail(f"fleet profile merged no device track:\n{prof['out']}")

            # 1. job 1 filed: regress of the fleet corpus and the filed
            #    find's repro line (a traced one-lane replay, pop_earliest
            #    at L = 1) on the card, as a user runs them
            r1 = reap_cli(w1)
            job1 = store.get(j1)
            if job1.state != "filed" or job1.result["corpus_added"] != 1:
                fail(f"fleet: job 1 ended {job1.state} with {job1.result}:\n{r1['out'][-3000:]}")
            with open(os.path.join(root, "corpus.json")) as f:
                [entry] = json.load(f)["entries"]
            meta = entry["meta"]
            if meta["filed_by"]["job"] != j1 or "replay --machine" not in meta["repro"] or not meta.get("why_kinds"):
                fail(f"fleet: the filed entry's meta lacks filed_by, repro or why_kinds: {meta}")
            regress = spawn("regress", ["regress", "--corpus", os.path.join(root, "corpus.json")])
            repro_argv = meta["repro"].split()
            if repro_argv[:3] != ["python", "-m", "madsim_tpu_torch"]:
                fail(f"fleet: the filed repro line names another program: {meta['repro']}")
            repro = spawn("repro", [*repro_argv[3:], "--tail", "1"])

            # 2. the replaced job equals job 1, resumed one batch back at
            #    most by the new process
            r2b = reap_cli(w2b)
            job2 = store.get(j2)
            want, got = (json.dumps(j.result["report"], sort_keys=True) for j in (job1, job2))
            if job2.state != "filed" or got != want or job2.n_lease_reclaims != 1:
                fail(f"fleet: the replaced job 2 ({job2.state}, {job2.n_lease_reclaims} reclaims) differs from "
                     f"job 1:\n{got}\n{want}")
            events2 = store.read_events(j2)
            after = [e for e in events2 if e.get("type") == "batch_done" and e["ts"] > killed_ts]
            if not after or after[0]["batch"] != min(ck_batch + 1, FLEET_UNITS) or \
                    {e["worker"] for e in after} != {"card-w2b"}:
                fail(f"fleet: job 2 killed at checkpoint batch {ck_batch} resumed at {after[:1]}: "
                     f"{[(e.get('type'), e.get('batch'), e.get('worker'), e.get('gen')) for e in events2]}")
            emit({"phase": "fleet_stage", "stage": "flagship_and_replacement",
                  "s": round(time.perf_counter() - t_phase, 3), "w1_s": r1["s"], "w2b_s": r2b["s"]})

            # 5. store health
            fsck = {}
            fsck_jobs = {name: spawn(f"fsck_{name}", ["fleet", "fsck", "--root", at, "--json"])
                         for name, at in (("farm", root), ("profile", profile_root))}
            for name, job in fsck_jobs.items():
                doc = json.loads(reap_cli(job)["out"])
                if doc["corrupt"] or doc["stale_tmp"]:
                    fail(f"fleet fsck of the {name} store: {doc}")
                fsck[name] = {k: doc[k] for k in ("corrupt", "stale_tmp", "stale_claims", "queue_log_lag", "jobs")}
            rc_regress, rc_repro, rc_chaos = reap_cli(regress), reap_cli(repro, rc=1), reap_cli(chaos)
            if f"FAILED (code {entry['fail_code']})" not in rc_repro["out"]:
                fail(f"fleet: the filed repro line did not fail with code {entry['fail_code']}:\n{rc_repro['out']}")
            if not rc_chaos["out"].strip().endswith("fleet chaos: 1 seed(s) ok (profile claims, first seed 3)"):
                fail(f"fleet chaos:\n{rc_chaos['out'][-3000:]}")
            if "1/1 entries satisfied" not in rc_regress["out"]:
                fail(f"regress of the fleet corpus:\n{rc_regress['out'][-3000:]}")
        finally:
            for job in spawned:
                if job["proc"].poll() is None:
                    job["proc"].terminate() if job["name"].startswith("serve") else job["proc"].kill()
                    job["proc"].wait()
        phase_s = round(time.perf_counter() - t_phase, 3)

        card = {"w1": r1, "w2b": r2b, "w3": r3, "w5": r5, "repro": rc_repro}
        launches = {k: sum(w["launches"].get(k, 0) for w in card.values())
                    for k in ("step_megakernel", "cov_flush", "pop_gather", "pop_earliest")}
        missing = [k for k, n in launches.items() if n <= 0]
        if missing:
            fail(f"fleet: the card's workers never launched {missing}: "
                 f"{ {k: w['launches'] for k, w in card.items()} }")
        emit({"phase": "fleet", "seconds": phase_s, "lanes": FLEET_LANES,
              "flagship": fleet_job_line(store, j1, [r1]),
              "replaced": {**fleet_job_line(store, j2, [r2b]), "killed_at_batch": ck_batch,
                           "resumed_at_batch": after[0]["batch"], "resumed_by": after[0]["worker"],
                           "lease_ttl_s": FLEET_TTL, "report_equal": True},
              "handover": {**fleet_job_line(store, j3, [r3, r4]), "equal_to_cpu_oracle": True,
                           "max_steps": FLEET_GUIDED["max_steps"], "escalation": escalation3,
                           "escalated_after_batch": escalated_at},
              "profile": {**fleet_job_line(pstore, j4, [r5, r6]), "capture_bytes": os.path.getsize(trace),
                          "profile_tracks": tracks.group(1).strip(", "), "profile_s": prof["s"]},
              "corpus_entry": {"why_kinds": meta["why_kinds"], "repro": meta["repro"]},
              "fsck": fsck, "chaos_s": rc_chaos["s"], "regress_s": rc_regress["s"], "repro_s": rc_repro["s"],
              "workers": {k: fleet_worker_line(w) for k, w in {**card, "w4": r4, "oracle": ro}.items()},
              "launches": {k: w["launches"] for k, w in card.items()}})
    return launches, r3["launches"]


class InThread:
    """A phase that only waits on subprocesses (phase 17's `fleet_jobs`,
    phase 18's `examples_run`) driven from a thread, so in-process checks
    run beside it; `join` gives `fn()`'s result, or ends the script as the
    phase's failure did."""

    def __init__(self, fn):
        import threading

        self.fn, self.exc, self.res = fn, None, None
        self.thread = threading.Thread(target=self._run, name=fn.__name__, daemon=True)

    def _run(self):
        try:
            self.res = self.fn()
        except BaseException as exc:  # fail() raises SystemExit here; join re-raises it
            self.exc = exc

    def start(self):
        self.thread.start()

    def join(self):
        self.thread.join()
        if self.exc is not None:
            raise self.exc
        return self.res


def fleet_kernels(np, kernels, dev, w3_launches):
    """The handover job's shapes, held against their twins and timed on a
    state of its engine (`fleet_kernels` line): pop_gather and the flush
    at its 64 lanes of Q = 32, with the card unit's launches."""
    state = built("fleet", lambda: fleet_state(np))
    time_kernel_shapes(kernels, dev, "fleet_kernels", (),
                       ((f"cov_flush_L{FLEET_GUIDED['batch']}", state.cov, w3_launches.get("cov_flush", 0)),),
                       pops=((f"pop_gather_L{FLEET_GUIDED['batch']}_Q{FLEET_GUIDED['queue']}", state,
                              w3_launches.get("pop_gather", 0)),))


# phase 17b, lane sharding over torch.distributed: the flagship stream of
# phase 5 (2 x 8192 seeds from seed 8192, 384-step segments) meshed over
# one rank on NCCL and over two ranks sharing the card (gloo, 4096 lanes
# each), and `explore --multihost` over two processes; the card has one
# GPU, so no leg measures scaling
MESH_STREAM = dict(n_seeds=2 * LANES, batch=LANES, segment_steps=SEGMENT_STEPS, seed_start=LANES)
MESH_RANKS = 2
MESH_EXPLORE = ["explore", "--machine", "raft", "--seeds", str(LANES), "--max-steps", "384", *CLI_SHAPE,
                "--flight-recorder", "--coverage"]
MESH_REF_ENV = "MADSIM_SMOKE_MESH_REF"
MESH_RANK_CHILD = (
    "import sys\n"
    "sys.path.insert(0, sys.argv[1])\n"
    "import chip_smoke\n"
    "sys.exit(chip_smoke.mesh_rank_main(sys.argv[2]))\n"
)
# what a stream of either executor gives alike: every result and the stats
# that do not depend on the poll cadence
MESH_SAME_KEYS = ("completed", "failing", "infra", "abandoned", "seeds_consumed")


def flagship_engine(device=None):
    from madsim_tpu_torch.engine import Engine, EngineConfig, FaultPlan
    from madsim_tpu_torch.models import RaftMachine

    return Engine(RaftMachine(num_nodes=5, log_capacity=8), EngineConfig(**FLAGSHIP, faults=FaultPlan(**FLAGSHIP_FAULTS)),
                  device=device)


def mesh_rank_main(out):
    """One rank of the shared-card leg: joins the job from the
    MADSIM_TPU_* env (two processes, one card: gloo), runs its 4096 lanes
    of the flagship stream on the pipelined executor and pickles its dict,
    seconds and launch counts to `out`."""
    import pickle

    import torch
    import torch.distributed as dist

    from madsim_tpu_torch.ops import build, kernels
    from madsim_tpu_torch.parallel import multihost

    build.load()
    torch.set_num_threads(2)
    multihost.initialize()
    eng = flagship_engine()
    mesh = multihost.global_mesh()
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    res = multihost.run_stream_global(eng, **MESH_STREAM)
    torch.cuda.synchronize()
    s = time.perf_counter() - t0
    launches = dict(kernels.launches)
    dist.destroy_process_group()
    pathlib.Path(out).write_bytes(pickle.dumps({"res": res, "s": s, "launches": launches, "rank": mesh.rank,
                                                "backend": mesh.backend, "lanes": LANES // mesh.size}))
    return 0


def same_stream(a, b, full=True):
    """Two stream dicts equal: whole (`full`), or in what either executor
    gives alike (MESH_SAME_KEYS, the coverage map, the recorder's stats,
    the device segments and the coverage stats but their poll curve)."""
    import numpy as np

    if not np.array_equal(a.get("coverage_map"), b.get("coverage_map")):
        return False
    if full:
        return {k: v for k, v in a.items() if k != "coverage_map"} == {k: v for k, v in b.items() if k != "coverage_map"}
    sa, sb = a["stats"], b["stats"]
    return (all(a[k] == b[k] for k in MESH_SAME_KEYS) and sa["flight_recorder"] == sb["flight_recorder"]
            and sa["device_segments"] == sb["device_segments"]
            and {k: v for k, v in sa["coverage"].items() if k != "curve"}
            == {k: v for k, v in sb["coverage"].items() if k != "curve"})


def mesh_checks(torch, np, kernels):
    """Phase 17b (a CHECK_GROUPS group: a process of its own in the
    window): the flagship stream of phase 5 meshed, each leg equal to the
    unsharded stream of the same seeds (phase 5's, pickled by the main
    process; computed here when phase 5 did not run): one rank over NCCL
    (the per-segment executor, phase 5's: the whole dict, stats
    included), two ranks sharing the card (gloo, 4096 lanes each, the
    pipelined executor: every result, each rank's dict equal to the
    other's, the megakernel and the flush launched on both); `explore
    --multihost` over two processes, process 0's line the unsharded
    explore's with the process and device counts masked and nothing from
    process 1; `explore --stream --devices 2` refused with one line before
    any rank or stream starts. One `mesh` line; returns the launches."""
    import os
    import pickle
    import shutil
    import tempfile

    import torch.distributed as dist

    from madsim_tpu_torch.parallel import make_mesh
    from madsim_tpu_torch.parallel.ranks import devices_line

    tmp = pathlib.Path(tempfile.mkdtemp(prefix="madsim_mesh_"))
    eng = flagship_engine()
    ref_path = os.environ.get(MESH_REF_ENV)
    if ref_path:
        ref = pickle.loads(pathlib.Path(ref_path).read_bytes())
    else:
        ref = eng.run_stream(pipelined=False, **MESH_STREAM)
    legs, launches = {}, {}

    # one rank over NCCL: phase 5's executor, the whole dict
    dist.init_process_group("nccl", init_method=f"file://{tmp / 'world1'}", world_size=1, rank=0)
    mesh = make_mesh()
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    res = eng.run_stream(mesh=mesh, pipelined=False, **MESH_STREAM)
    torch.cuda.synchronize()
    legs["world1_nccl"] = {"s": round(time.perf_counter() - t0, 3), "lanes": LANES, "backend": mesh.backend,
                           "launches": dict(kernels.launches)}
    dist.destroy_process_group()
    if not same_stream(res, ref):
        fail(f"the 1-rank NCCL stream differs from the unsharded one: {res['stats']} vs {ref['stats']}")
    launches["world1_nccl"] = legs["world1_nccl"]["launches"]

    # two ranks sharing the card, from the MADSIM_TPU_* env
    repo = str(pathlib.Path(__file__).resolve().parent)
    procs = []
    for r in range(MESH_RANKS):
        env = dict(os.environ, MADSIM_TPU_COORDINATOR=f"file://{tmp / 'shared'}",
                   MADSIM_TPU_NUM_PROCS=str(MESH_RANKS), MADSIM_TPU_PROC_ID=str(r))
        with open(tmp / f"rank{r}.err", "w") as err:
            procs.append(subprocess.Popen([sys.executable, "-c", MESH_RANK_CHILD, repo, str(tmp / f"rank{r}.pkl")],
                                          env=env, stdout=err, stderr=err))
        _track(procs[-1])
    for r, p in enumerate(procs):
        if p.wait() != 0:
            fail(f"mesh rank {r} exited {p.returncode}:\n{(tmp / f'rank{r}.err').read_text()[-3000:]}")
    ranks = [pickle.loads((tmp / f"rank{r}.pkl").read_bytes()) for r in range(MESH_RANKS)]
    for r in ranks:
        if not same_stream(r["res"], ref, full=False):
            fail(f"rank {r['rank']} of the shared-card mesh differs from the unsharded stream")
        if not same_stream(r["res"], ranks[0]["res"]):
            fail(f"ranks 0 and {r['rank']} of the shared-card mesh give different dicts")
        for name in ("step_megakernel", "cov_flush"):
            if r["launches"].get(name, 0) <= 0:
                fail(f"rank {r['rank']} of the shared-card mesh never launched {name}")
        launches[f"shared_rank{r['rank']}"] = r["launches"]
    legs["shared_card"] = {"s": [round(r["s"], 3) for r in ranks], "lanes": ranks[0]["lanes"],
                           "backend": ranks[0]["backend"], "launches": [r["launches"] for r in ranks]}

    # explore --multihost: two processes against the unsharded explore
    jobs = [spawn_cli(tmp, f"multihost{r}", [*MESH_EXPLORE, "--multihost"], extra_env={
        "MADSIM_TPU_COORDINATOR": f"file://{tmp / 'explore'}", "MADSIM_TPU_NUM_PROCS": str(MESH_RANKS),
        "MADSIM_TPU_PROC_ID": str(r)}) for r in range(MESH_RANKS)]
    alone = spawn_cli(tmp, "explore", MESH_EXPLORE)
    multi = [reap_cli(j, rc=None) for j in jobs]
    single = reap_cli(alone, rc=None)
    head = re.sub(r" over \d+ processes / \d+ devices", "", multi[0]["out"].splitlines()[0])
    if head != single["out"].splitlines()[0] or multi[1]["out"] or multi[0]["rc"] != single["rc"]:
        fail(f"explore --multihost: {multi[0]['out']!r} (rank 1: {multi[1]['out']!r}) against the unsharded "
             f"{single['out']!r}")
    for r, m in enumerate(multi):
        launches[f"multihost_rank{r}"] = m["launches"]
    legs["explore_multihost"] = {"s": [m["s"] for m in multi], "unsharded_s": single["s"],
                                 "line": multi[0]["out"].splitlines()[0], "launches": [m["launches"] for m in multi]}

    # --devices 2 on a one-card machine: one line, no rank, no stream
    refused = run_cli(tmp, "devices2", ["explore", "--stream", "--machine", "raft", "--seeds", "64", "--batch",
                                        "64", "--max-steps", "64", "--devices", "2"], rc=None)
    err = refused["err"].strip().splitlines()
    want = devices_line(2, torch.cuda.device_count())
    if refused["rc"] == 0 or err != [want] or refused["streams"] or any(refused["launches"].values()):
        fail(f"--devices 2 on {torch.cuda.device_count()} card(s): rc {refused['rc']}, stderr {err}, "
             f"streams {refused['streams']}")
    legs["devices2_refused"] = {"s": refused["s"], "rc": refused["rc"], "line": err[0]}

    total = {}
    for counts in launches.values():
        for name, n in counts.items():
            total[name] = total.get(name, 0) + n
    emit({"phase": "mesh", "card": card_line(), "note": "ranks share one card; no scaling figure",
          "seeds": MESH_STREAM["n_seeds"], "legs": legs, "launches_mesh": total})
    shutil.rmtree(tmp, ignore_errors=True)
    return {"launches_mesh": total}


def mesh_kernels(np, kernels, dev, launches_mesh):
    """The mesh path's kernel shapes, held against their twins and timed
    (`mesh_kernels` line): the megakernel and the flush at a rank's 4096
    lanes of the flagship (Q = 32, W = 10), on a state of rank 0's first
    seeds a flush period past 96 steps, with the mesh path's launches."""
    lanes = LANES // MESH_RANKS
    state, words = built("mesh", lambda: mesh_state(np))
    time_kernel_shapes(kernels, dev, "mesh_kernels",
                       ((f"step_megakernel_L{lanes}", state, words, launches_mesh.get("step_megakernel", 0)),),
                       ((f"cov_flush_L{lanes}", state.cov, launches_mesh.get("cov_flush", 0)),))


# phase 18, the device examples (`examples`): examples/bug_hunt_torch.py
# and examples/delay_hunt_torch.py, each as a process of its own on the
# card at its own widths (bug_hunt: 2,048 seeds in batches of 512, 192-step
# segments, Q = 96; delay_hunt: three 256-lane batches of up to 3,000 steps
# at Q = 48, then a replay and a shrink), started at once in the window;
# their stdout checked as tests/test_examples.py checks the JAX examples'
EXAMPLES = ("bug_hunt_torch.py", "delay_hunt_torch.py")
EXAMPLE_CHECK_LANES, EXAMPLE_CHECK_STEPS = 256, 192
EXAMPLE_STATE_STEPS = {"bug": 192, "delay": 32, "bug_L1": 100, "delay_L1": 20}
# runs an example as `python examples/<script>` does, then prints, on its
# last line, its wall and the wrappers' launch counts of that process, and
# pop_gather's launches by the shape of the step that launched them
# (`L<lanes>_Q<queue>`; the megakernel's too, by shape)
EXAMPLE_LAUNCHER = (
    "import json, runpy, sys, time\n"
    "script = sys.argv.pop(1)\n"
    "from madsim_tpu_torch.engine.core import Engine\n"
    "from madsim_tpu_torch.ops import kernels\n"
    "by_shape, step_batch = {}, Engine.step_batch\n"
    "def counted(self, state, *args, **kwargs):\n"
    "    before = dict(kernels.launches)\n"
    "    out = step_batch(self, state, *args, **kwargs)\n"
    "    key = 'L%d_Q%d' % tuple(state.eq_time.shape)\n"
    "    for k in ('pop_gather', 'step_megakernel'):\n"
    "        if kernels.launches[k] != before[k]:\n"
    "            by_shape.setdefault(k, {})\n"
    "            by_shape[k][key] = by_shape[k].get(key, 0) + kernels.launches[k] - before[k]\n"
    "    return out\n"
    "Engine.step_batch = counted\n"
    "sys.argv[0] = script\n"
    "t0 = time.perf_counter()\n"
    "runpy.run_path(script, run_name='__main__')\n"
    "print('EXAMPLE ' + json.dumps({'wall_s': round(time.perf_counter() - t0, 3),\n"
    "                               'launches': dict(kernels.launches), 'by_shape': by_shape}), flush=True)\n"
)


def check_example_stdout(name, out):
    """tests/test_examples.py's checks of the JAX example's stdout, on the
    port example's: a list of the checks that failed."""
    if name == "bug_hunt_torch.py":
        checks = {"invariant violations": "invariant violations" in out, "failed=True": "failed=True" in out,
                  "diverge or no passing seed": "traces diverge at step" in out or "no passing seed" in out}
    else:
        checks = {"delay spikes": "delay spikes" in out, "codes {206}": "codes {206}" in out,
                  "replay + shrink: seed": "replay + shrink: seed" in out,
                  **{f"{vocab}: 0/256": bool(re.search(rf"{vocab}:\s*0/256 seeds flagged", out))
                     for vocab in ("loss storms", r"partitions \+ kills")}}
    return [k for k, ok in checks.items() if not ok]


def examples_run():
    """Phase 18: both examples on the card at once, each a process of its
    own (EXAMPLE_LAUNCHER); one `examples` line with each one's wall,
    launches (by shape for pop_gather) and the lines it printed that the
    engine decides. Fails if one exits non-zero, misses a stdout check, or
    never launched pop_gather (and bug_hunt's traced replays
    pop_earliest). Returns {script: its EXAMPLE record}."""
    import os
    import tempfile

    repo = pathlib.Path(__file__).resolve().parent
    env = dict(os.environ, PYTHONPATH=str(repo))
    tmp = pathlib.Path(tempfile.mkdtemp(prefix="madsim_examples_"))
    procs = {}
    for script in EXAMPLES:
        with open(tmp / f"{script}.out", "w") as out, open(tmp / f"{script}.err", "w") as err:
            procs[script] = subprocess.Popen(
                [sys.executable, "-c", EXAMPLE_LAUNCHER, str(repo / "examples" / script)],
                cwd=tmp, env=env, stdout=out, stderr=err)
        _track(procs[script])
    res, line = {}, {}
    for script, proc in procs.items():
        proc.wait()
        out, err = (tmp / f"{script}.out").read_text(), (tmp / f"{script}.err").read_text()
        if proc.returncode != 0:
            fail(f"example {script} exited {proc.returncode}:\n{out[-3000:]}\n{err[-3000:]}")
        missed = check_example_stdout(script, out)
        if missed:
            fail(f"example {script}: stdout lacks {missed}:\n{out[-3000:]}")
        rec = json.loads(out.strip().splitlines()[-1][len("EXAMPLE "):])
        needs = ("pop_gather", "pop_earliest") if script == "bug_hunt_torch.py" else ("pop_gather",)
        for k in needs:
            if rec["launches"].get(k, 0) <= 0:
                fail(f"example {script} never launched {k}: {rec['launches']}")
        res[script] = rec
        line[script] = {**rec, "lines": [s.strip() for s in out.splitlines()
                                         if re.search(r"simulations|flagged|replay|diverge|passing", s)][:12]}
    import shutil

    shutil.rmtree(tmp, ignore_errors=True)
    emit({"phase": "examples", "card": card_line(), **line})
    return res


def example_modules():
    """The two port examples as modules, by path (their main() not run)."""
    import importlib.util

    repo = pathlib.Path(__file__).resolve().parent
    mods = {}
    for key, script in zip(("bug", "delay"), EXAMPLES):
        spec = importlib.util.spec_from_file_location(f"example_{key}", repo / "examples" / script)
        mods[key] = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mods[key])
    return mods


def card_vs_cpu_examples(torch, np, kernels):
    """The two examples' engines (the DoubleVoteRaft hunt, the
    PrematureGiveup delay hunt) run_batch on the card and on the CPU at
    256 lanes and 192 steps: every BatchResult leaf and the failing seeds
    equal, some lane failing in each (a CHECK_GROUPS check)."""
    mods = example_modules()
    seeds = np.arange(EXAMPLE_CHECK_LANES, dtype=np.uint32)
    out = {}
    for key, make in (("bug", mods["bug"].make_engine),
                      ("delay", lambda d: mods["delay"].engine(d, allow_delay=True))):
        on_card, t_card, t_cpu = card_vs_cpu(make, seeds, EXAMPLE_CHECK_STEPS, f"the {key} example")
        failing = seeds[on_card["failed"]].tolist()
        if not failing:
            fail(f"the {key} example's engine failed no lane in {EXAMPLE_CHECK_STEPS} steps")
        codes = sorted({int(c) for c in on_card["fail_code"].tolist() if c})
        out[key] = {"equal": True, "n_failing": len(failing), "first_failing": failing[:4], "codes": codes,
                    "card_s": round(t_card, 3), "cpu_s": round(t_cpu, 3)}
    emit({"phase": "card_vs_cpu_examples", "lanes": EXAMPLE_CHECK_LANES, "max_steps": EXAMPLE_CHECK_STEPS, **out})
    return out


# the log records' simulation context (ROADMAP §3 fault 4): a node `a`
# that sleeps 1.5 s and logs, then the main task, under Runtime(seed=3)
FACADE_SIM_STRINGS = ["t=1.500000s node=a/2 task=2", "t=1.500000s node=madsim-main/1 task=1"]


def host_facades(torch, np, kernels):
    """The host facades, which run no kernel (a CHECK_GROUPS check): a
    `tokio.JoinSet` workload and the fake runtime in a simulation; the
    simulated gRPC round trip of all four call shapes with a hand-written
    service; a real-mode Endpoint's send/recv and RPC on 127.0.0.1:0
    (asyncio TCP); the log records' simulation context strings. Imports
    neither `grpc.real` nor grpcio and loads no .proto (the card's machine
    may lack grpcio, protobuf and protoc)."""
    import asyncio
    import logging

    import madsim_tpu_torch as m
    from madsim_tpu_torch import grpc, tokio, tracing
    from madsim_tpu_torch.real import Endpoint

    global FacadePing

    class FacadePing(m.net.Request):  # a global: real mode pickles it
        def __init__(self, v):
            self.v = v

    t0 = time.perf_counter()

    async def joinset():
        js = tokio.JoinSet()
        for d, tag in ((3.0, "c"), (1.0, "a"), (2.0, "b")):
            async def job(d=d, tag=tag):
                await m.time.sleep(d)
                return tag

            js.spawn(job())
        order = [await js.join_next() for _ in range(3)]
        drained = await js.join_next() is None
        rt = tokio.runtime.Builder.new_multi_thread().enable_all().build()

        async def fast():
            await m.time.sleep(1.0)
            return "fast"

        spawned = await rt.spawn(fast())
        coro = fast()
        try:
            rt.block_on(coro)
            refused = False
        except NotImplementedError:
            refused = True
        coro.close()
        return order, drained, spawned, refused, m.time.now_ns()

    order, drained, spawned, refused, jt = m.Runtime(seed=1).block_on(joinset())
    if (order, drained, spawned, refused) != (["a", "b", "c"], True, "fast", True):
        fail(f"host_facades: the JoinSet workload gave {order, drained, spawned, refused}")

    @grpc.service("helloworld.Greeter")
    class Greeter:
        @grpc.unary
        async def say_hello(self, request):
            return grpc.Response(f"Hello {request.into_inner()}!")

        @grpc.server_streaming
        async def lots_of_replies(self, request):
            for i in range(3):
                await m.time.sleep(0.1)
                yield f"{request.into_inner()} #{i}"

        @grpc.client_streaming
        async def lots_of_greetings(self, stream):
            names = []
            while (msg := await stream.message()) is not None:
                names.append(msg)
            return grpc.Response(f"Hello {', '.join(names)}!")

        @grpc.streaming
        async def bidi_hello(self, stream):
            while (msg := await stream.message()) is not None:
                yield f"Hello {msg}!"

    async def four_shapes():
        handle = m.Handle.current()

        async def serve():
            await grpc.Server.builder().add_service(Greeter()).serve("0.0.0.0:50051")

        handle.create_node().name("server").ip("10.5.0.1").init(serve).build()
        await m.time.sleep(0.2)
        client = handle.create_node().name("client").ip("10.5.0.2").build()

        async def go():
            ch = await grpc.connect("http://10.5.0.1:50051")
            r1 = await ch.unary("/helloworld.Greeter/SayHello", "world")
            r2 = [x async for x in await ch.server_streaming("/helloworld.Greeter/LotsOfReplies", "srv")]
            r3 = await ch.client_streaming("/helloworld.Greeter/LotsOfGreetings", ["a", "b", "c"])
            r4 = [x async for x in await ch.streaming("/helloworld.Greeter/BidiHello", ["x", "y"])]
            return r1, r2, r3, r4

        return await client.spawn(go())

    shapes = m.Runtime(seed=1).block_on(four_shapes())
    want = ("Hello world!", ["srv #0", "srv #1", "srv #2"], "Hello a, b, c!", ["Hello x!", "Hello y!"])
    if shapes != want:
        fail(f"host_facades: the gRPC round trip gave {shapes}")

    async def real_mode():
        server = await Endpoint.bind("127.0.0.1:0")
        client = await Endpoint.bind("127.0.0.1:0")
        await client.send_to(server.local_addr, 7, b"hello")
        data, frm = await server.recv_from(7)

        async def on_ping(req, payload):
            return req.v * 2, bytes(reversed(payload))

        server.add_rpc_handler(FacadePing, on_ping)
        rsp = await client.call_with_data(server.local_addr, FacadePing(21), b"abc")
        server.close()
        client.close()
        return data, tuple(frm) == tuple(client.local_addr), rsp

    real = asyncio.run(real_mode())
    if real != (b"hello", True, (42, b"cba")):
        fail(f"host_facades: the real-mode Endpoint gave {real}")

    class Capture(logging.Handler):
        def __init__(self):
            super().__init__()
            self.sims = []

        def emit(self, record):
            self.sims.append(record.sim)

    log = logging.getLogger("chip_smoke.facades")
    cap = Capture()
    cap.addFilter(tracing.SimContextFilter())
    log.addHandler(cap)
    log.setLevel(logging.INFO)
    log.propagate = False

    async def logged():
        node = m.Handle.current().create_node().name("a").build()

        async def task():
            await m.time.sleep(1.5)
            log.info("from a")

        await node.spawn(task())
        log.info("from main")

    m.Runtime(seed=3).block_on(logged())
    log.removeHandler(cap)
    if cap.sims != FACADE_SIM_STRINGS:
        fail(f"host_facades: the log records' sim context is {cap.sims}, not {FACADE_SIM_STRINGS}")
    loaded = sorted(k for k in sys.modules if k == "madsim_tpu_torch.grpc.real" or k == "grpc"
                    or k.startswith("grpc."))
    if "madsim_tpu_torch.grpc.real" in loaded:
        fail("host_facades imported madsim_tpu_torch.grpc.real")
    emit({"phase": "host_facades", "joinset": order, "joinset_virtual_ns": jt, "grpc_four_shapes": True,
          "real_endpoint": {"send_recv": real[0].decode(), "rpc": [real[2][0], real[2][1].decode()]},
          "sim_strings": cap.sims, "grpcio_loaded": loaded, "seconds": round(time.perf_counter() - t0, 3)})
    return {"ok": True}


def example_states(np, mods):
    """The states the examples' kernels are timed on, on the card:
    bug_hunt's stream batch (512 lanes, Q = 96) and delay_hunt's batch
    (256 lanes, Q = 48) some steps in, and single lanes of each (the
    replays' and shrink's L = 1)."""
    bug, delay = mods["bug"].make_engine(), mods["delay"].engine(allow_delay=True)
    steps = EXAMPLE_STATE_STEPS
    return {
        "bug": bug.run_segment(bug.init_batch(np.arange(512, dtype=np.uint32)), steps["bug"]),
        "delay": delay.run_segment(delay.init_batch(np.arange(256, dtype=np.uint32)), steps["delay"]),
        "bug_L1": bug.run_segment(bug.init_batch([0]), steps["bug_L1"]),
        "delay_L1": delay.run_segment(delay.init_batch([0]), steps["delay_L1"]),
    }


def examples_kernels(np, kernels, dev, examples):
    """The examples' kernel shapes, held against their twins on the
    states of their paths and timed there (`examples_kernels` line):
    pop_gather at bug_hunt's 512 lanes of Q = 96, at delay_hunt's 256 of
    Q = 48 and at its replays' and shrink's L = 1, Q = 48; pop_earliest at
    bug_hunt's traced replays' L = 1, Q = 96; each with the launches the
    examples' processes counted for its shape."""
    states = built("examples", lambda: example_states(np, example_modules()))
    bug, delay = (examples[s]["by_shape"].get("pop_gather", {}) for s in EXAMPLES)
    bug_earliest = examples[EXAMPLES[0]]["launches"]["pop_earliest"]
    return time_kernel_shapes(kernels, dev, "examples_kernels", (), (), pops=(
        ("pop_gather_L512_Q96", states["bug"], bug.get("L512_Q96", 0)),
        ("pop_gather_L256_Q48", states["delay"], delay.get("L256_Q48", 0)),
        ("pop_gather_L1_Q48", states["delay_L1"], delay.get("L1_Q48", 0)),
        ("pop_gather_L1_Q96", states["bug_L1"], bug.get("L1_Q96", 0)),
    ), earliest=(("pop_earliest_L1_Q96", states["bug_L1"], bug_earliest),))


# 18b. the host services and the service differentials. The service
# machines' configurations of tests/test_differential_services.py, none
# cut: (engine config, fault plan) by name
SVC_PLANS = {
    "etcd": (dict(horizon_us=5_000_000, queue_capacity=48), {}),
    "etcd_chaos": (dict(horizon_us=8_000_000, queue_capacity=48),
                   dict(n_faults=3, allow_dir_clog=True, allow_storm=True, t_max_us=3_000_000, dur_min_us=200_000,
                        dur_max_us=800_000)),
    "etcd_nodedup": (dict(horizon_us=8_000_000, queue_capacity=48),
                     dict(n_faults=2, allow_partition=False, allow_kill=False, allow_storm=True, storm_loss_u16=55000,
                          t_max_us=2_000_000, dur_min_us=400_000, dur_max_us=900_000)),
    "kafka": (dict(horizon_us=8_000_000, queue_capacity=96), dict(n_faults=0)),
    "kafka_kill": (dict(horizon_us=8_000_000, queue_capacity=96),
                   dict(n_faults=2, allow_partition=False, allow_kill=True, t_max_us=800_000, dur_min_us=250_000,
                        dur_max_us=700_000)),
    "kafka_nofencing": (dict(horizon_us=8_000_000, queue_capacity=96),
                        dict(n_faults=3, t_max_us=1_500_000, dur_min_us=250_000, dur_max_us=700_000)),
    "s3": (dict(horizon_us=8_000_000, queue_capacity=48), dict(n_faults=0)),
    "s3_chaos": (dict(horizon_us=8_000_000, queue_capacity=48),
                 dict(n_faults=3, allow_dir_clog=True, allow_group=True, allow_storm=True, t_max_us=3_000_000,
                      dur_min_us=200_000, dur_max_us=800_000)),
    "s3_arrival": (dict(horizon_us=8_000_000, queue_capacity=48), dict(n_faults=0)),
}
# the tier-1 cases' faithful seed sets: (engine, seeds, the differential's max_steps)
SVC_SETS = (("etcd", range(8), 3000), ("etcd_chaos", range(16, 28), 3000), ("kafka", range(6), 4000),
            ("kafka_kill", range(8), 12000), ("s3", range(6), 4000), ("s3_chaos", range(6), 4000))
# the tier-1 drift cases' bugged variants: (engine, max_steps, the fail code
# the case filters on, or None)
SVC_BUGS = (("etcd_nodedup", 3000, None), ("kafka_nofencing", 12000, "COMMIT_REGRESS"), ("s3_arrival", 4000, None))
SVC_LANES = 1024  # seeds in each bugged batch
SVC_BUG_SEEDS = 8  # each batch's first failing seeds, through the differential
SVC_CPU_SEEDS = 4  # each set's first seeds, also on the CPU
SVC_LEASE_SEEDS = range(16, 28)  # the service-side lease bug, on the etcd chaos engine
SVC_STATE_STEPS = 32  # the batches' states their pops are timed on: this far in (lanes live)


def service_engine(name, device=None):
    """The service machine engine `name` of SVC_PLANS (the card unless
    `device`)."""
    from madsim_tpu_torch.engine import Engine, EngineConfig, FaultPlan
    from madsim_tpu_torch.models import etcd_mvcc, kafka_group, s3

    bugged = {"etcd_nodedup": lambda: etcd_mvcc.NoDedupMvcc(4),
              "kafka_nofencing": lambda: kafka_group.NoFencingGroupMachine(4, 2, 12),
              "s3_arrival": lambda: s3.ArrivalOrderS3(num_nodes=4)}
    faithful = {"etcd": lambda: etcd_mvcc.EtcdMvccMachine(4),
                "kafka": lambda: kafka_group.KafkaGroupMachine(num_nodes=4, partitions=2, log_len=12),
                "s3": lambda: s3.S3Machine(num_nodes=4)}
    machine = bugged.get(name) or faithful[name.split("_")[0]]
    plan, faults = SVC_PLANS[name]
    return Engine(machine(), EngineConfig(**plan, faults=FaultPlan(**faults)), device=device)


def lease_bug_service(rng):
    """The service-side drift of the tier-1 case: an EtcdService whose
    expiry sweep leaks the first attached key of every expired lease."""
    from madsim_tpu_torch.services.etcd.service import EtcdService

    return EtcdService(rng, lease_expiry_off_by_one=True)


def service_reports(eng, kind, seeds, max_steps, factory=None, fencing=False):
    """The port's own differential of `kind` (etcd, kafka, s3) on each
    seed, on `eng`'s device; with `fencing` (the no-fencing machine) also
    each seed's replay code and the commits the broker's fencing
    rejected."""
    from madsim_tpu_torch.differential_services import (differential_etcd_mvcc, differential_kafka_group,
                                                         differential_s3, drive_kafka_coordinator)
    from madsim_tpu_torch.engine import replay

    check = {"etcd": differential_etcd_mvcc, "kafka": differential_kafka_group, "s3": differential_s3}[kind]
    out = []
    for seed in seeds:
        rep = check(eng, seed, max_steps, service_factory=factory) if factory else check(eng, seed, max_steps)
        if fencing:
            rp = replay(eng, seed, max_steps=max_steps)
            _b, _members, accept_log = drive_kafka_coordinator(eng.machine, rp.trace)
            rep = {**rep, "replay_code": int(rp.fail_code), "fenced": sum(1 for r in accept_log if r[5] is False)}
        out.append(rep)
    return out


def services_checks(torch, np, kernels, part):
    """Phase 18b's device half, in two CHECK_GROUPS groups (each a
    process of its own in the window; one alone would be the window's
    longest). `part` "drift": on the card, one make_runner batch of
    1,024 seeds of each bugged variant of the tier-1 drift cases under
    its fault plan (NoDedupMvcc, NoFencingGroupMachine, ArrivalOrderS3),
    then the port's service differentials on the port's own services
    over each batch's first 8 failing seeds and over the lease-bug
    service on seeds 16-27; "faithful": the differentials over the
    tier-1 seed sets. Fails unless every faithful seed is `ok`, every
    bugged seed is caught (a mismatch; for the no-fencing machine, whose
    later commits can mask the regressed offset in the final state, the
    tier-1 case's own catch: the replay fails COMMIT_REGRESS and the
    broker fences the zombie commits), the lease bug is flagged on some
    seed, and each set's first 4 reports on the card equal the port's on
    the CPU. The launch counts are set to 0 before and read after;
    pop_gather's and pop_earliest's by shape."""
    from madsim_tpu_torch.models import kafka_group

    engines = {name: service_engine(name) for name in SVC_PLANS}
    by_shape, seconds = {}, {}

    def counted(key, fn):
        before = dict(kernels.launches)
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        seconds[key] = seconds.get(key, 0.0) + time.perf_counter() - t0
        for k, n in kernels.launches.items():
            if n != before[k]:
                by_shape.setdefault(k, {})
                by_shape[k][key] = by_shape[k].get(key, 0) + n - before[k]
        return out

    torch.cuda.synchronize()
    kernels.reset_launches()
    t_phase = time.perf_counter()
    batches = {}
    sets = [(name, name, seeds, max_steps, None) for name, seeds, max_steps in SVC_SETS] if part == "faithful" else []
    for name, max_steps, code in SVC_BUGS if part == "drift" else ():
        eng, q = engines[name], SVC_PLANS[name][0]["queue_capacity"]
        seeds = np.arange(SVC_LANES, dtype=np.uint32)
        key = f"L{SVC_LANES}_Q{q}_{name.split('_')[0]}"
        res = counted(key, lambda: eng.make_runner(max_steps=max_steps)(seeds))
        want = getattr(kafka_group, code) if code else None
        failing = [int(s) for s, c, f in zip(seeds.tolist(), res.fail_code.tolist(), res.failed.tolist())
                   if f and want in (None, c)]
        if len(failing) < SVC_BUG_SEEDS:
            fail(f"services: the {name} batch of {SVC_LANES} seeds failed only {failing}")
        batches[name] = {"lanes": SVC_LANES, "q": q, "max_steps": max_steps, "steps": int(res.steps.max()),
                         "n_failing": len(failing), "codes": sorted({int(c) for c, f in zip(
                             res.fail_code.tolist(), res.failed.tolist()) if f}), "seconds": round(seconds[key], 3)}
        sets.append((f"{name}_first", name, failing[:SVC_BUG_SEEDS], max_steps, None))
    if part == "drift":
        sets.append(("etcd_lease_bug", "etcd_chaos", list(SVC_LEASE_SEEDS), 3000, lease_bug_service))

    out, replays = {}, 0
    replay_s = 0.0
    for set_name, name, seeds, max_steps, factory in sets:
        eng, kind = engines[name], name.split("_")[0]
        key = f"L1_Q{SVC_PLANS[name][0]['queue_capacity']}"
        t0 = time.perf_counter()
        fencing = name == "kafka_nofencing"
        reports = counted(key, lambda: service_reports(eng, kind, seeds, max_steps, factory, fencing))
        replay_s += time.perf_counter() - t0
        replays += len(seeds)
        cpu = service_reports(service_engine(name, device="cpu"), kind, seeds[:SVC_CPU_SEEDS], max_steps, factory,
                              fencing)
        if cpu != reports[:SVC_CPU_SEEDS]:
            fail(f"services {set_name}: the card's reports of seeds {list(seeds[:SVC_CPU_SEEDS])} differ from the "
                 f"CPU's:\n{reports[:SVC_CPU_SEEDS]}\n{cpu}")
        ok = [r["ok"] for r in reports]
        row = {"seeds": list(seeds), "ok": sum(ok), "card_equals_cpu": list(seeds[:SVC_CPU_SEEDS])}
        if set_name == "etcd_lease_bug":
            flagged = [s for s, good in zip(seeds, ok) if not good]
            if not flagged:
                fail("services: the service-side lease bug was flagged on no seed of 16-27")
            row["flagged"] = flagged
            row["drift"] = [r["mismatches"][0] for r in reports if r["mismatches"]][:4]
        elif set_name.endswith("_first"):
            if kind == "kafka":
                caught = [r["replay_code"] == kafka_group.COMMIT_REGRESS and r["fenced"] > 0 for r in reports]
                row["fenced"] = [r["fenced"] for r in reports]
            else:
                caught = [not good for good in ok]
            if not all(caught):
                fail(f"services {set_name}: the drift went uncaught on seeds "
                     f"{[s for s, c in zip(seeds, caught) if not c]}: {reports}")
            row["caught"] = sum(caught)
            row["drift"] = [r["mismatches"][0] for r in reports if r["mismatches"]][:4]
        elif not all(ok):
            bad = {s: r["mismatches"][:3] for s, r in zip(seeds, reports) if not r["ok"]}
            fail(f"services {set_name}: the differential disagrees on faithful seeds: {bad}")
        out[set_name] = row
    launches = dict(kernels.launches)
    for k in ("pop_gather", "pop_earliest"):
        if launches[k] <= 0:
            fail(f"services: the service differentials never launched {k}: {launches}")
    emit({"phase": "services", "part": part, "card": card_line(), "batches": batches, "sets": out, "replays": replays,
          "replay_s": round(replay_s, 3), "replays_per_s": round(replays / replay_s, 3),
          "seconds": round(time.perf_counter() - t_phase, 3), "launches": launches, "by_shape": by_shape})
    return {"launches": launches, "by_shape": by_shape}


SVC_SERVE = (("etcd", ()), ("kafka", ("--wire",)), ("s3", ("--http",)))
SVC_KAFKA_CLIENT = """
import asyncio, json, sys
from madsim_tpu_torch.services import kafka
async def main(addr):
    cfg = kafka.ClientConfig({"bootstrap.servers": addr})
    admin = await cfg.create_admin()
    real_wire = admin._conn._real is not None
    created = await admin.create_topics([kafka.NewTopic("smoke", 2)])
    prod = await cfg.create_future_producer()
    sent = [list(await prod.send_and_wait(kafka.BaseRecord("smoke", key=b"k", payload=b"m%d" % i, partition=i % 2)))
            for i in range(4)]
    ccfg = kafka.ClientConfig({"bootstrap.servers": addr, "group.id": "smoke", "enable.auto.commit": "false"})
    cons = await ccfg.create_base_consumer()
    await cons.subscribe(["smoke"])
    got = []
    for _ in range(400):
        msg = await cons.poll(0.05)
        if msg is not None:
            got.append([msg.partition, msg.offset, msg.payload.decode()])
        if len(got) == 4:
            break
    await cons.commit()
    committed = [await cons.committed("smoke", p) for p in range(2)]
    await cons.close()
    prod.close()
    admin.close()
    print(json.dumps({"real_wire": real_wire, "created": [list(c) for c in created], "sent": sent,
                      "got": sorted(got), "committed": committed}))
asyncio.run(main(sys.argv[1]))
"""
SVC_KAFKA_WANT = {"real_wire": True, "created": [["smoke", None]], "sent": [[0, 0], [1, 0], [0, 1], [1, 1]],
                  "got": [[0, 0, "m0"], [0, 1, "m2"], [1, 0, "m1"], [1, 1, "m3"]], "committed": [2, 2]}
SVC_S3_CLIENT = """
import asyncio, json, sys
from madsim_tpu_torch.services import s3
async def main(addr):
    cli = s3.Client.from_conf(s3.Config(endpoint_url="http://" + addr))
    await cli.create_bucket().bucket("smoke").send()
    put = await cli.put_object().bucket("smoke").key("logs/a").body(b"payload").send()
    await cli.put_object().bucket("smoke").key("logs/b").body(b"x").send()
    got = await cli.get_object().bucket("smoke").key("logs/a").send()
    listed = await cli.list_objects_v2().bucket("smoke").prefix("logs/").send()
    real_wire = cli._real is not None
    await cli.close()
    print(json.dumps({"real_wire": real_wire, "etag_matches": put["e_tag"] == got["e_tag"],
                      "body": bytes(got["body"]).decode(), "keys": [o["key"] for o in listed["contents"]]}))
asyncio.run(main(sys.argv[1]))
"""
SVC_S3_WANT = {"real_wire": True, "etag_matches": True, "body": "payload", "keys": ["logs/a", "logs/b"]}


def serve_service(service, flags, env, cwd):
    """`python -m madsim_tpu_torch serve --service ... --addr 127.0.0.1:0`
    in real mode: (process, the address its ready line names)."""
    import threading

    proc = subprocess.Popen([sys.executable, "-m", "madsim_tpu_torch", "serve", "--service", service, *flags,
                             "--addr", "127.0.0.1:0"], env=env, cwd=cwd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    _track(proc)
    box = [""]
    reader = threading.Thread(target=lambda: box.__setitem__(0, proc.stdout.readline()), daemon=True)
    reader.start()
    reader.join(timeout=60)
    m = re.search(r"serving on (\S+)", box[0])
    if not m:
        proc.kill()
        fail(f"services: `serve --service {service} {' '.join(flags)}` printed no ready line: {box[0]!r}")
    return proc, m.group(1)


def services_host():
    """Phase 18b's host half, in subprocesses (driven from a thread in
    the window): `MADSIM_TPU_MODE=real python -m madsim_tpu_torch serve`
    of etcd (sim protocol over TCP), kafka --wire and s3 --http, each on
    127.0.0.1:0; examples/etcd_dual_torch.py against the etcd server in
    real mode, its result equal to its sim-mode run; one round trip of
    the port's Kafka and S3 real clients (produce, then a group's fetch
    and commit; put, then get and list); chaos_pipeline_torch.py and
    group_consumers_torch.py twice each in sim mode, identical. Where
    grpcio, protobuf and protoc are installed, `serve --service etcd
    --grpc` and the example's passthrough over the genuine etcd wire
    too ("grpc_gateway": "absent" otherwise). Every server is stopped."""
    import importlib.util
    import os
    import shutil
    import tempfile
    from concurrent.futures import ThreadPoolExecutor

    repo = pathlib.Path(__file__).resolve().parent
    examples = repo / "examples"
    sim_env = {k: v for k, v in os.environ.items() if k != "MADSIM_TPU_MODE"}
    sim_env["PYTHONPATH"] = str(repo)
    real_env = dict(sim_env, MADSIM_TPU_MODE="real")
    has_grpc = all(importlib.util.find_spec(m) is not None for m in ("grpc", "google.protobuf")) and bool(
        shutil.which("protoc"))
    tmp = tempfile.mkdtemp(prefix="madsim_services_")
    t0 = time.perf_counter()
    servers = {}
    try:
        for service, flags in SVC_SERVE + ((("etcd_grpc", ("--grpc",)),) if has_grpc else ()):
            servers[service] = serve_service(service.split("_")[0], flags, real_env, tmp)
        up_s = time.perf_counter() - t0

        def run(argv, env):
            r = subprocess.run([sys.executable, *argv], env=env, cwd=tmp, capture_output=True, text=True,
                               timeout=300)
            if r.returncode != 0:
                fail(f"services: `{' '.join(map(str, argv))}` exited {r.returncode}:\n{r.stdout[-2000:]}\n"
                     f"{r.stderr[-2000:]}")
            return r.stdout

        jobs = {
            "etcd_dual_sim": ([examples / "etcd_dual_torch.py"], sim_env),
            "etcd_dual_real": ([examples / "etcd_dual_torch.py", servers["etcd"][1]], real_env),
            "kafka_client": (["-c", SVC_KAFKA_CLIENT, servers["kafka"][1]], real_env),
            "s3_client": (["-c", SVC_S3_CLIENT, servers["s3"][1]], real_env),
            **{f"{script}_{i}": ([examples / f"{script}_torch.py", "7"], sim_env)
               for script in ("chaos_pipeline", "group_consumers") for i in (1, 2)},
        }
        if has_grpc:
            jobs["etcd_dual_grpc"] = ([examples / "etcd_dual_torch.py", servers["etcd_grpc"][1]], real_env)
        with ThreadPoolExecutor(len(jobs)) as pool:
            futures = {name: pool.submit(run, *job) for name, job in jobs.items()}
            outs = {name: f.result() for name, f in futures.items()}
    finally:
        for proc, _addr in servers.values():
            proc.kill()
            proc.wait()
        shutil.rmtree(tmp, ignore_errors=True)
    sim = outs["etcd_dual_sim"].strip()
    if not sim.startswith("[sim] ") or "'txn_succeeded': True" not in sim:
        fail(f"services: etcd_dual_torch.py in sim mode printed {sim!r}")
    for name in ("etcd_dual_real", "etcd_dual_grpc"):
        if name in outs and outs[name].strip() != "[real] " + sim[len("[sim] "):]:
            fail(f"services: {name} printed {outs[name].strip()!r}, not the sim run's result {sim!r}")
    kafka, s3 = json.loads(outs["kafka_client"]), json.loads(outs["s3_client"])
    if kafka != SVC_KAFKA_WANT or s3 != SVC_S3_WANT:
        fail(f"services: the real clients' round trips gave {kafka} and {s3}")
    for script, marker in (("chaos_pipeline", "evt-after-crash"), ("group_consumers", "at-least-once holds")):
        a, b = outs[f"{script}_1"], outs[f"{script}_2"]
        if a != b or marker not in a:
            fail(f"services: {script}_torch.py printed {a!r} then {b!r}")
    emit({"phase": "services_host", "card": card_line(), "servers": {k: v[1] for k, v in servers.items()},
          "servers_up_s": round(up_s, 3), "etcd_dual": sim[len("[sim] "):], "etcd_dual_real_equals_sim": True,
          "grpc_gateway": "ran" if has_grpc else "absent", "kafka_client": kafka, "s3_client": s3,
          "examples_identical": ["chaos_pipeline_torch.py", "group_consumers_torch.py"],
          "seconds": round(time.perf_counter() - t0, 3)})
    return {"grpc_gateway": has_grpc}


def services_launches(checks):
    """The two device-half processes' launch counts, summed: {"launches":
    by kernel, "by_shape": by kernel and shape}."""
    parts = [checks["services_drift"], checks["services_faithful"]]
    by_shape = {}
    for part in parts:
        for k, shapes in part["by_shape"].items():
            for shape, n in shapes.items():
                by_shape.setdefault(k, {})
                by_shape[k][shape] = by_shape[k].get(shape, 0) + n
    return {"launches": {k: sum(p["launches"][k] for p in parts) for k in parts[0]["launches"]},
            "by_shape": by_shape}


def services_kernels(np, kernels, dev, services):
    """The service differentials' kernel shapes, held against their
    twins on the states of their paths and timed there
    (`services_kernels` line): pop_gather at the bugged batches' 1,024
    lanes of Q = 48 (MVCC, S3) and Q = 96 (the consumer group) and at
    the replays' L = 1 of Q = 48 and 96; pop_earliest at the replays'
    L = 1 of Q = 48 and 96; each with the launches the services process
    counted for its shape."""
    states = built("services", lambda: service_states(np))
    gather, earliest = (services["by_shape"].get(k, {}) for k in ("pop_gather", "pop_earliest"))
    big = [(f"pop_gather_L{SVC_LANES}_Q{SVC_PLANS[name][0]['queue_capacity']}_{name.split('_')[0]}", states[name])
           for name in ("etcd_nodedup", "kafka_nofencing", "s3_arrival")]
    return time_kernel_shapes(kernels, dev, "services_kernels", (), (), pops=(
        *((shape, state, gather.get(shape[len("pop_gather_"):], 0)) for shape, state in big),
        ("pop_gather_L1_Q48", states["L1_Q48"], gather.get("L1_Q48", 0)),
        ("pop_gather_L1_Q96", states["L1_Q96"], gather.get("L1_Q96", 0)),
    ), earliest=(("pop_earliest_L1_Q48", states["L1_Q48"], earliest.get("L1_Q48", 0)),
                 ("pop_earliest_L1_Q96", states["L1_Q96"], earliest.get("L1_Q96", 0))))


# phase 18d, the bench command: the flagship (no --machine) at its full
# width, 8192 lanes, one timed rep; `--machine echo` on the command line's
# defaults (the split chain, Q = 96) at 8192 lanes over 8192 seeds a rep
# (echo, whose lanes end soonest, keeps the phase short);
# then `bench report` of the history both wrote, run as LINT_PROBE runs
# lint, saying at its exit whether the process imported torch
BENCH_MACHINE = ["--machine", "echo", "--seeds", str(LANES)]
BENCH_STATE_STEPS = 32  # the machine bench's state pop_gather is timed on: this far in (lanes live)
BENCH_PROBE = """
import runpy, sys
try:
    runpy.run_module("madsim_tpu_torch", run_name="__main__")
except SystemExit as exc:
    code = exc.code
else:
    code = 0
print("probe", "torch" in sys.modules, file=sys.stderr)
sys.exit(code)
"""


def bench_phase():
    """Phase 18d: the three forms of `bench` in subprocesses, one at a
    time and nothing beside them, writing one history in a temporary
    directory (`bench` line). Fails unless each line names the card,
    each form launched its kernels (the flagship the megakernel and the
    flush and no pop_gather, the machine bench pop_gather), the history
    holds the two rows and the report renders both without torch.
    Returns the launches, the machine's and both summed."""
    import os
    import tempfile

    from madsim_tpu_torch.perf.history import card as card_of

    repo = pathlib.Path(__file__).resolve().parent
    card = card_of()
    with tempfile.TemporaryDirectory(prefix="madsim_bench_") as tmp:
        hist = str(pathlib.Path(tmp) / "bench_history.jsonl")
        runs = {name: run_cli(tmp, f"bench_{name}", [*argv, "--reps", "1", "--history", hist], 0)
                for name, argv in (("flagship", ["bench"]), ("machine", ["bench", *BENCH_MACHINE]))}
        lines = {}
        for name, r in runs.items():
            found = [json.loads(ln) for ln in r["out"].splitlines() if ln.startswith("{")]
            if len(found) != 1 or found[0].get("platform") != "cuda" or found[0].get("card") != card or \
                    found[0]["diagnostics"]["lanes"] != LANES or not found[0]["value"] > 0:
                fail(f"bench {name}: want one line on the card ({card}) at {LANES} lanes:\n{r['out'][-3000:]}\n"
                     f"{r['err'][-3000:]}")
            lines[name] = found[0]
        flag, mach = lines["flagship"], lines["machine"]
        if flag["metric"] != "madraft5_seeds_per_sec_per_chip" or len(flag["diagnostics"]["reps"]) != 1 or \
                not flag["gates"]["pallas_megakernel"] or flag["gates"]["rng_stream"] != 3 or \
                not flag["diagnostics"]["coverage"]["slots_hit"] or not flag["compile_s_warm"] > 0:
            fail(f"bench (the flagship): {flag}")
        if mach["metric"] != f"{BENCH_MACHINE[1]}_seeds_per_sec" or mach["diagnostics"]["queue_capacity"] != 96 or \
                len(mach["diagnostics"]["reps"]) != 1:
            fail(f"bench {' '.join(BENCH_MACHINE)}: {mach}")
        fl, ml = runs["flagship"]["launches"], runs["machine"]["launches"]
        if not (fl.get("step_megakernel") and fl.get("cov_flush")) or fl.get("pop_gather") or \
                not ml.get("pop_gather") or ml.get("step_megakernel"):
            fail(f"bench: the flagship launched {fl}, the machine bench {ml}")
        rows = [json.loads(ln) for ln in pathlib.Path(hist).read_text().splitlines() if ln.strip()]
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-c", BENCH_PROBE, "bench", "report", "--history", hist], cwd=tmp,
                              env=dict(os.environ, PYTHONPATH=str(repo)), capture_output=True, text=True,
                              timeout=300)
        report_s = round(time.perf_counter() - t0, 3)
        report = [ln for ln in proc.stdout.splitlines() if ln[:1] == "r"]
        if [r.get("source") for r in rows] != ["bench", "bench --machine"] or proc.returncode != 0 or \
                [ln.split()[0] for ln in report] != ["r01", "r02"] or \
                proc.stderr.strip().splitlines()[-1:] != ["probe False"]:
            fail(f"bench report of {len(rows)} rows exited {proc.returncode}:\n{proc.stdout}\n{proc.stderr[-3000:]}")
    launches = {k: fl.get(k, 0) + ml.get(k, 0) for k in set(fl) | set(ml)}

    def summary(name, line, row):
        r = runs[name]
        return {"value": line["value"], "compile_s": row["compile_s"], "compile_s_warm": row["compile_s_warm"],
                "card": line["card"], "reps": line["diagnostics"]["reps"], "lanes": line["diagnostics"]["lanes"],
                "subprocess_s": r["s"], "launches": r["launches"],
                **{key: [c[key] for c in r["streams"]] for key in ("device_segments", "dispatches", "host_syncs")}}

    emit({"phase": "bench", "card": card_line(), "flagship": {
        **summary("flagship", flag, rows[0]), "flight_recorder": flag["diagnostics"]["flight_recorder"],
        "slots_hit": flag["diagnostics"]["coverage"]["slots_hit"]},
        "machine": {**summary("machine", mach, rows[1]), "failing_total": mach["diagnostics"]["failing_total"],
                    "queue_capacity": mach["diagnostics"]["queue_capacity"]},
        "history_rows": len(rows), "report": {"rc": proc.returncode, "s": report_s, "torch_imported": False,
                                              "rows": report}, "launches": launches})
    return {"machine": ml, "all": launches}


def bench_kernels(np, kernels, dev, bench):
    """The shape phase 18d first launches, held against its twin and
    timed on a state of the engine the command builds (`bench_kernels`
    line): pop_gather at the machine bench's 8192 lanes of Q = 96."""
    state = built("bench", lambda: bench_state(np))
    q = state.eq_time.shape[1]
    return time_kernel_shapes(kernels, dev, "bench_kernels", (), (), pops=(
        (f"pop_gather_L{LANES}_Q{q}", state, bench["machine"].get("pop_gather", 0)),))


# phase 18e, the repo-root bench scripts' port copies (benches/*_torch.py),
# each a process of its own as a user runs it: rpc_bench_torch.py native
# and pure (the host engine: no device), tpu_sweep_torch.py at the sweep
# grid's widest point (SWEEP_POINT, alone on the serial tail; the whole
# grid under `--only sweep`) and its --mesh form at its own defaults (in
# the window), and guided_compare_torch.py's raft coverage row through
# its own run_unguided / run_guided (in the window, on the card and in a
# niced --device cpu process), at the script's shapes with the budget cut
# to 4 batches a mode
SWEEP_POINT = (32768, 192)
SWEEP_STATE_STEPS = 96  # the sweep's states its kernels are timed on: this far in (lanes live)
SWEEP_KERNEL_LANES = (16384, 32768)  # the grid's widths no other phase reaches
RPC_KEYS = ["empty_rpc_us", "throughput_16B_MBps", "throughput_256B_MBps", "throughput_4KiB_MBps",
            "throughput_64KiB_MBps", "throughput_1MiB_MBps"]
GUIDED_COMPARE_ROW = ("raft", 3, 3, 2.0, 1200, "pair,kill", 256, 64, 0, False, 1)
# runs a script as `python <script> args...` does, then writes to the path
# given first the wrappers' launch counts of that process, whether it made
# a CUDA context (and its peak device memory) and whether the host
# engine's native core was loaded
SCRIPT_LAUNCHER = (
    "import atexit, json, runpy, sys\n"
    "out = sys.argv.pop(1)\n"
    "def counts():\n"
    "    kernels = sys.modules.get('madsim_tpu_torch.ops.kernels')\n"
    "    native = sys.modules.get('madsim_tpu_torch._native')\n"
    "    torch = sys.modules.get('torch')\n"
    "    cuda = bool(torch and torch.cuda.is_initialized())\n"
    "    json.dump({'launches': dict(kernels.launches) if kernels else {},\n"
    "               'native': bool(native and native.available()), 'cuda': cuda,\n"
    "               'peak_bytes': torch.cuda.max_memory_allocated() if cuda else 0}, open(out, 'w'))\n"
    "atexit.register(counts)\n"
    "sys.argv = sys.argv[1:]\n"
    "runpy.run_path(sys.argv[0], run_name='__main__')\n"
)
# guided_compare's row on the CPU, niced, in a process of its own: the
# deterministic columns as JSON
GUIDED_COMPARE_CPU = (
    "import json, os, sys\n"
    "os.nice(5)\n"
    "sys.path.insert(0, sys.argv[1])\n"
    "import torch\n"
    "torch.set_num_threads(2)\n"
    "import chip_smoke\n"
    "import time\n"
    "row = chip_smoke.guided_compare_row('cpu')\n"
    "json.dump({**row, 'end_wall': time.time()}, open(sys.argv[2], 'w'))\n"
)


def bench_script(name):
    """A port copy under benches/ as a module, by path (its main() not run)."""
    import importlib.util

    path = pathlib.Path(__file__).resolve().parent / "benches" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run_script(tmp, name, script, args=(), extra_env=None, timeout=900, nice=0):
    """`python benches/<script> args...` in `tmp` through SCRIPT_LAUNCHER
    (niced by `nice`, its children with it): {"rc", "out", "err", "s",
    "launches", "native", "cuda", "peak_bytes"}."""
    import os

    repo = pathlib.Path(__file__).resolve().parent
    env = dict(os.environ, PYTHONPATH=str(repo), **(extra_env or {}))
    t = pathlib.Path(tmp)
    t0 = time.perf_counter()
    with open(t / f"{name}.out", "w") as out, open(t / f"{name}.err", "w") as err:
        proc = subprocess.Popen([sys.executable, "-c", SCRIPT_LAUNCHER, str(t / f"{name}.json"),
                                 str(repo / "benches" / script), *args], cwd=tmp, env=env, stdout=out, stderr=err,
                                preexec_fn=(lambda: os.nice(nice)) if nice else None)
    _track(proc)
    try:
        proc.wait(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
    s = round(time.perf_counter() - t0, 3)
    counts = t / f"{name}.json"
    res = {"rc": proc.returncode, "out": (t / f"{name}.out").read_text(), "err": (t / f"{name}.err").read_text(),
           "s": s, **(json.loads(counts.read_text()) if counts.exists() else
                      {"launches": {}, "native": None, "cuda": None, "peak_bytes": 0})}
    if proc.returncode != 0:
        fail(f"{script} {' '.join(args)} exited {proc.returncode}:\n{res['out'][-3000:]}\n{res['err'][-3000:]}")
    return res


def rpc_bench_phase():
    """Phase 18e's rpc leg: benches/rpc_bench_torch.py, native and under
    MADSIM_TPU_NO_NATIVE=1, one process each and nothing beside them
    (`rpc_bench` line: each run's JSON, its seconds, which path ran).
    Fails unless each prints the JAX script's six lines and keys with
    every figure > 0, the native run loaded the core, the pure run did
    not, and neither made a CUDA context (the host engine runs no
    kernel: the figures are the host's)."""
    import tempfile

    runs = {}
    with tempfile.TemporaryDirectory(prefix="madsim_rpc_") as tmp:
        for path, env in (("native", {}), ("pure", {"MADSIM_TPU_NO_NATIVE": "1"})):
            r = run_script(tmp, f"rpc_{path}", "rpc_bench_torch.py", extra_env=env, timeout=600)
            lines = r["out"].strip().splitlines()
            doc = json.loads(lines[-1]) if lines and lines[-1].startswith("{") else {}
            if len(lines) != 7 or list(doc) != RPC_KEYS or not all(v > 0 for v in doc.values()) or \
                    r["native"] != (path == "native") or r["cuda"]:
                fail(f"rpc_bench_torch.py ({path}): native {r['native']}, CUDA context {r['cuda']}:\n{r['out']}\n"
                     f"{r['err'][-3000:]}")
            runs[path] = {**doc, "s": r["s"], "native": r["native"], "cuda_context": r["cuda"]}
    emit({"phase": "rpc_bench", "card": card_line(), "note": "host figures: the host engine runs no kernel", **runs})
    return runs


def sweep_phase(points):
    """Phase 18e's sweep leg: `python benches/tpu_sweep_torch.py BATCH SEG`
    of each of `points`, one process each and nothing beside them
    (`sweep` line: each point's line, its process's seconds, peak device
    memory and launches). Fails unless each line is on the card (the
    card's name and power limit, `pallas_megakernel` on, rng_stream 3),
    completed at least 3 x batch seeds with coverage, and its process
    launched the megakernel and the flush and no pop kernel. Returns the
    launches, summed."""
    import tempfile

    from madsim_tpu_torch.perf.history import card as card_of

    card = card_of()
    out, total = [], {}
    with tempfile.TemporaryDirectory(prefix="madsim_sweep_") as tmp:
        for batch, seg in points:
            r = run_script(tmp, f"sweep_{batch}_{seg}", "tpu_sweep_torch.py", (str(batch), str(seg)))
            found = [json.loads(ln) for ln in r["out"].splitlines() if ln.startswith("{")]
            p = found[0] if len(found) == 1 else {}
            if p.get("platform") != "cuda" or p.get("card") != card or not p.get("pallas_megakernel") or \
                    p.get("rng_stream") != 3 or (p.get("batch"), p.get("segment_steps")) != (batch, seg) or \
                    p.get("completed", 0) < 3 * batch or not p.get("coverage", {}).get("slots_hit"):
                fail(f"tpu_sweep_torch.py {batch} {seg}: want one line on the card ({card}):\n{r['out'][-3000:]}\n"
                     f"{r['err'][-3000:]}")
            ln = r["launches"]
            if not (ln.get("step_megakernel") and ln.get("cov_flush")) or ln.get("pop_gather") or \
                    ln.get("pop_earliest"):
                fail(f"tpu_sweep_torch.py {batch} {seg} launched {ln}")
            for k, n in ln.items():
                total[k] = total.get(k, 0) + n
            out.append({**p, "subprocess_s": r["s"], "peak_bytes": r["peak_bytes"], "launches": ln})
    emit({"phase": "sweep", "card": card_line(), "points": out, "launches": total})
    return total, out


def sweep_kernels(np, kernels, dev, points):
    """The sweep's new shapes, held against their twins and timed on a
    state of the sweep's own engine (`sweep_kernels` line): the
    megakernel with the digest (Q = 96, W = 10) and the flush (C = 16) at
    each width of SWEEP_KERNEL_LANES, the state SWEEP_STATE_STEPS in and a
    flush period past it, where one of the sweep's `points` ran; each
    shape's launches those of the points at its width."""
    steps, flushes = [], []
    for lanes in [w for w in SWEEP_KERNEL_LANES if any(p["batch"] == w for p in points)]:
        n = {k: sum(p["launches"].get(k, 0) for p in points if p["batch"] == lanes)
             for k in ("step_megakernel", "cov_flush")}
        state, words, q = built(f"sweep_{lanes}", lambda: sweep_state(np, lanes))
        steps.append((f"step_megakernel_L{lanes}_Q{q}_W{words}", state, words, n["step_megakernel"]))
        flushes.append((f"cov_flush_L{lanes}", state.cov, n["cov_flush"]))
    return time_kernel_shapes(kernels, dev, "sweep_kernels", steps, flushes)


def sweep_mesh_run():
    """Phase 18e's mesh leg (from a thread in the window; it times
    nothing): `python benches/tpu_sweep_torch.py --mesh OUT` at its own
    defaults (1,024 lanes, 192-step segments) in a temporary directory,
    its history there. Fails unless the 1-rank point ran NCCL and the
    2-rank point gloo on the shared card, each point completed the 1-rank
    point's seeds with its coverage, the document says the card is
    shared and the history holds a row for each point (`sweep_mesh`)."""
    import os
    import tempfile

    from madsim_tpu_torch.perf.history import card as card_of

    card = card_of()
    with tempfile.TemporaryDirectory(prefix="madsim_sweep_mesh_") as tmp:
        out = pathlib.Path(tmp) / "mesh.json"
        hist = pathlib.Path(tmp) / "history.jsonl"
        r = run_script(tmp, "sweep_mesh", "tpu_sweep_torch.py", ("--mesh", str(out)),
                       extra_env={"MADSIM_TPU_BENCH_HISTORY": str(hist)}, nice=10)
        doc = json.loads(out.read_text())
        rows = [json.loads(ln) for ln in hist.read_text().splitlines() if ln.strip()]
        listed = os.listdir(tmp)
    pts = doc["points"]
    first = pts[0]
    if [p["devices"] for p in pts] != [1, 2] or [p["backend"] for p in pts] != ["nccl", "gloo"] or \
            any((p["completed"], p["coverage"]) != (first["completed"], first["coverage"]) for p in pts) or \
            first["completed"] < 3 * doc["batch"] or not doc["shared_card"] or doc["card"] != card or \
            [(w["tag"], w["fingerprint"]["device_count"]) for w in rows] != [("mesh_d1", 1), ("mesh_d2", 2)] or \
            "TORCH_MULTICHIP.json" in listed:
        fail(f"tpu_sweep_torch.py --mesh: {json.dumps(doc)[:3000]}\nhistory {rows}\n{r['err'][-3000:]}")
    emit({"phase": "sweep_mesh", "card": card_line(), "batch": doc["batch"], "segment_steps": doc["segment_steps"],
          "points": pts, "scaling_vs_1dev": doc["scaling_vs_1dev"], "shared_card": doc["shared_card"],
          "reason": doc.get("shared_card_reason"), "s": r["s"], "equal": True})


def guided_compare_row(device=None):
    """benches/guided_compare_torch.py's raft coverage row at
    GUIDED_COMPARE_ROW through its own run_unguided and run_guided on
    `device` (None: the card): its deterministic columns (JSON's types),
    each mode's seconds and the launches."""
    mod = bench_script("guided_compare_torch")
    ns = mod._args_ns(*GUIDED_COMPARE_ROW, "cpu" if device == "cpu" else "cuda")
    eng = mod._build_engine(ns)
    from madsim_tpu_torch.ops import kernels

    before = dict(kernels.launches)
    ug, g = mod.run_unguided(eng, ns), mod.run_guided(eng, ns)
    det = {"unguided": {k: ug[k] for k in ("slots", "failing", "first_find")},
           "guided": {k: g[k] for k in ("slots", "failing", "first_find", "escalation", "trail", "bias")}}
    return {**json.loads(json.dumps(det)), "s": {"unguided": ug["elapsed_s"], "guided": g["elapsed_s"]},
            "launches": {k: v - before.get(k, 0) for k, v in kernels.launches.items()}}


def guided_compare_checks(torch, np, kernels):
    """Phase 18e's guided_compare leg (a CHECK_GROUPS group: a process of
    its own in the window; it times nothing): raft's coverage row of
    benches/guided_compare_torch.py on the card, and the same row in a
    niced --device cpu process beside it. Fails unless every
    deterministic column (slots, failing seeds, first finds, escalation,
    the trail and the bias) is equal on the two devices, guided strictly
    beats unguided (the script's raft verdict) and the card's row
    launched pop_gather and the flush (`guided_compare` line)."""
    import os
    import tempfile

    repo = str(pathlib.Path(__file__).resolve().parent)
    with tempfile.TemporaryDirectory(prefix="madsim_guided_compare_") as tmp:
        out = pathlib.Path(tmp) / "cpu.json"
        t0_wall = time.time()
        with open(pathlib.Path(tmp) / "cpu.err", "w") as err:
            proc = subprocess.Popen([sys.executable, "-c", GUIDED_COMPARE_CPU, repo, str(out)],
                                    env=dict(os.environ, OMP_NUM_THREADS="2"), stdout=err, stderr=err)
        _track(proc)
        t0 = time.perf_counter()
        card = guided_compare_row()
        card_s = round(time.perf_counter() - t0, 3)
        if proc.wait() != 0:
            fail(f"guided_compare on the CPU exited {proc.returncode}:\n"
                 f"{(pathlib.Path(tmp) / 'cpu.err').read_text()[-3000:]}")
        cpu = json.loads(out.read_text())
        # the CPU process's seconds, from its start here to the end it wrote
        cpu_s = round(cpu.pop("end_wall") - t0_wall, 3)
    for mode in ("unguided", "guided"):
        if card[mode] != cpu[mode]:
            diff = [k for k in card[mode] if card[mode][k] != cpu[mode][k]]
            fail(f"guided_compare ({mode}): the card and the CPU differ in {diff}")
    ug, g = card["unguided"], card["guided"]
    verdict = "PASS" if g["slots"] > ug["slots"] else "FAIL"
    if verdict != "PASS" or not card["launches"].get("pop_gather") or not card["launches"].get("cov_flush"):
        fail(f"guided_compare: raft guided {g['slots']} against unguided {ug['slots']} slots (the script's "
             f"verdict: guided must strictly beat unguided); launches {card['launches']}")
    emit({"phase": "guided_compare", "card": card_line(), "model": GUIDED_COMPARE_ROW[0],
          "budget": GUIDED_COMPARE_ROW[6], "batch": GUIDED_COMPARE_ROW[7], "max_steps": GUIDED_COMPARE_ROW[4],
          "unguided_slots": ug["slots"], "guided_slots": g["slots"], "escalation": g["escalation"],
          "first_find": [ug["first_find"], g["first_find"]], "finds": [len(ug["failing"]), len(g["failing"])],
          "verdict": verdict, "equal": True, "card_s": card_s, "card_modes_s": card["s"],
          "cpu_process_s": cpu_s, "cpu_modes_s": cpu["s"], "launches": card["launches"]})
    return {"launches": card["launches"]}


# Phase 4b and the card-against-CPU checks of phases 6-9, 12 and 13 time
# nothing: each group (~2 minutes on its own) runs in a process of its own (`python -c`, niced so
# that the fleet's workers and the main process come first) beside the
# others and phase 17, and returns a JSON object; the states the timed
# phases need are rebuilt in the main process from it
CHECKS_CHILD = (
    "import os, sys\n"
    "os.nice(10)\n"
    "sys.path.insert(0, sys.argv[1])\n"
    "import chip_smoke\n"
    "sys.exit(chip_smoke.child_main(sys.argv[2], sys.argv[3]))\n"
)


# {group: ((name, check), ...)}: each check(torch, np, kernels) gives a
# JSON object
CHECK_GROUPS = {
    "failing_delay_models": (("failing", card_vs_cpu_failing), ("delay", delay_checks),
                             ("models", card_vs_cpu_models)),
    "palette_storage": (("palette", palette_checks), ("storage", storage_checks)),
    "split_prov_clog": (("split", split_chain_checks), ("prov_legs", lambda torch, np, kernels: provenance_legs(np)),
                        ("clog", clog_checks)),
    "mesh": (("mesh", mesh_checks),),
    "differential": (("native", native_checks), ("differential", differential_checks)),
    "examples": (("card_vs_cpu_examples", card_vs_cpu_examples), ("host_facades", host_facades)),
    "services_drift": (("services_drift", lambda torch, np, kernels: services_checks(torch, np, kernels, "drift")),),
    "services_faithful": (("services_faithful",
                           lambda torch, np, kernels: services_checks(torch, np, kernels, "faithful")),),
    "guided_compare": (("guided_compare", guided_compare_checks),),
    "tail_replays": (("triage", triage_checks), ("hunt_replays", hunt_replays_cpu)),
}


def child_main(group, out):
    """One group of CHECK_GROUPS in this process (ChildChecks' child),
    on two intra-op threads: its phase lines on stdout, timed on the
    parent's clock, its results as one JSON object in `out`."""
    import os

    import numpy as np
    import torch

    from madsim_tpu_torch.ops import build, kernels

    global STARTED
    STARTED = time.perf_counter() - (time.time() - float(os.environ["MADSIM_SMOKE_T0"]))
    build.load()
    torch.set_num_threads(2)
    res = {name: check(torch, np, kernels) for name, check in CHECK_GROUPS[group]}
    pathlib.Path(out).write_text(json.dumps(res))
    return 0


class ChildChecks:
    """A group of CHECK_GROUPS in a process of its own (child_main);
    `join` relays its phase lines and gives its results, or ends the
    script with its failure."""

    def __init__(self, group):
        self.group = group

    def start(self):
        import os
        import tempfile

        self.tmp = pathlib.Path(tempfile.mkdtemp(prefix=f"madsim_checks_{self.group}_"))
        env = dict(os.environ, MADSIM_SMOKE_T0=repr(STARTED_WALL))
        repo = str(pathlib.Path(__file__).resolve().parent)
        with open(self.tmp / "out", "w") as out, open(self.tmp / "err", "w") as err:
            self.proc = subprocess.Popen([sys.executable, "-c", CHECKS_CHILD, repo, self.group,
                                          str(self.tmp / "res.json")], env=env, stdout=out, stderr=err)
        _track(self.proc)

    def join(self):
        import shutil

        self.proc.wait()
        sys.stdout.write((self.tmp / "out").read_text())
        sys.stdout.flush()
        if self.proc.returncode != 0:
            fail(f"the {self.group} checks exited {self.proc.returncode}:\n{(self.tmp / 'err').read_text()[-3000:]}")
        res = json.loads((self.tmp / "res.json").read_text())
        shutil.rmtree(self.tmp, ignore_errors=True)
        return res


# phase 18c's drift: shrink's ablation table loses `dup`, in a scratch
# copy of the files the G-pass reads
LINT_G_FILES = (
    "madsim_tpu_torch/kinds.py", "madsim_tpu_torch/__main__.py", "madsim_tpu_torch/engine/core.py",
    "madsim_tpu_torch/engine/shrink.py", "madsim_tpu_torch/runtime/metrics.py", "madsim_tpu_torch/runtime/coverage.py",
    "madsim_tpu_torch/ops/coverage.py", "madsim_tpu_torch/ops/step_rng.py", "madsim_tpu_torch/ops/rng_layout.manifest",
    "madsim_tpu_torch/search/bias.py", "tests/test_torch_gates.py", "tests/test_torch_rng.py",
)
LINT_DRIFT = ("madsim_tpu_torch/engine/shrink.py", '"pause", "skew", "dup",', '"pause", "skew",', "G003")
# run as `python -m madsim_tpu_torch lint ...`, then report on stderr
# whether the process made a CUDA context or loaded a kernel library
LINT_PROBE = """
import runpy, sys
try:
    runpy.run_module("madsim_tpu_torch", run_name="__main__")
except SystemExit as exc:
    code = exc.code
else:
    code = 0
torch = sys.modules.get("torch")
kernels = sys.modules.get("madsim_tpu_torch.ops.build")
print("probe", bool(torch and torch.cuda.is_initialized()), bool(kernels and kernels.load.cache_info().currsize),
      file=sys.stderr)
sys.exit(code)
"""


def lint_phase():
    """Phase 18c: the port's `lint` on this checkout, then on a scratch
    copy with one G-rule drift; one phase line."""
    import os
    import shutil
    import tempfile

    repo = pathlib.Path(__file__).resolve().parent
    env = dict(os.environ, PYTHONPATH=str(repo))

    def lint(argv, cwd, probe=False):
        head = ["-c", LINT_PROBE] if probe else ["-m", "madsim_tpu_torch"]
        t0 = time.perf_counter()
        proc = subprocess.Popen([sys.executable, *head, "lint", *argv], cwd=cwd, env=env, stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True)
        _track(proc)
        out, err = proc.communicate(timeout=600)
        return proc.returncode, out, err, round(time.perf_counter() - t0, 3)

    rc, out, err, secs = lint([], repo)
    if rc != 0 or out.strip().splitlines()[-1:] != ["lint: clean"]:
        fail(f"lint of the checkout exited {rc}:\n{out[-3000:]}\n{err[-3000:]}")
    rc_j, out_j, err_j, secs_j = lint(["--json"], repo, probe=True)
    if rc_j != 0:
        fail(f"lint --json exited {rc_j}:\n{out_j[-3000:]}\n{err_j[-3000:]}")
    counts = json.loads(out_j)["counts"]
    probe = err_j.strip().splitlines()[-1].split()
    if counts != {"baselined": 0, "error": 0, "warning": 0} or probe != ["probe", "False", "False"]:
        fail(f"lint --json: counts {counts}, CUDA context / kernels loaded {probe[1:]}")
    tmp = pathlib.Path(tempfile.mkdtemp(prefix="madsim_lint_"))
    try:
        for rel in LINT_G_FILES:
            (tmp / rel).parent.mkdir(parents=True, exist_ok=True)
            shutil.copy(repo / rel, tmp / rel)
        rel, old, new, rule = LINT_DRIFT
        src = (tmp / rel).read_text()
        if old not in src:
            fail(f"lint drift anchor not found in {rel}: {old!r}")
        (tmp / rel).write_text(src.replace(old, new))
        rc_d, out_d, err_d, secs_d = lint(["--rules", "G", "--repo-root", str(tmp),
                                           str(tmp / "madsim_tpu_torch" / "kinds.py")], tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    named = [line for line in out_d.splitlines() if f" {rule} " in line]
    if rc_d != 1 or not named or "dup" not in named[0]:
        fail(f"lint of the drifted copy exited {rc_d}, expected 1 naming {rule}:\n{out_d[-3000:]}\n{err_d[-3000:]}")
    emit({"phase": "lint", "seconds": secs, "rc": rc, "clean": True,
          "json": {"seconds": secs_j, "counts": counts, "cuda_context": False, "kernels_loaded": False},
          "drift": {"rule": rule, "rc": rc_d, "seconds": secs_d, "finding": named[0].split(": ", 1)[-1][:160]},
          "card": card_line()})


# The states the serial tail's kernel phases time their kernels on, where
# they depend on nothing the tail runs: built in the window (prebuild_states
# and, once their groups have joined, the check groups' model, palette,
# clog and triage states), where the main process otherwise only waits;
# each phase takes its state from here (built there when absent: `--only` runs)
STATES = {}


def built(key, build):
    """The state the window built for `key` (taken once), else `build()`."""
    return STATES.pop(key) if key in STATES else build()


def flushed_state(eng, seeds, steps):
    """`eng`'s batch of `seeds` `steps` in, then a coverage flush period
    (its buffers full as at a cadence flush)."""
    state = eng.run_segment(eng.init_batch(seeds), steps)
    for _ in range(eng._cov_flush_every):
        state = eng.step_batch(state)
    return state


def command_state(np, argv, lanes, seed0=0):
    """A state of the engine the command line builds for `argv`: `lanes`
    seeds from `seed0`, 64 steps and a flush period in; with its word
    block."""
    from madsim_tpu_torch.__main__ import _build_engine, _parser

    eng = _build_engine(_parser().parse_args(argv))
    return flushed_state(eng, np.arange(seed0, seed0 + lanes, dtype=np.uint32), 64), eng._rng_layout.total_words


def mesh_state(np):
    """Rank 0's share of the mesh path's lanes (4096 of the flagship) 96
    steps and a flush period in; with its word block."""
    eng = flagship_engine()
    lanes = LANES // MESH_RANKS
    return flushed_state(eng, np.arange(LANES, LANES + lanes, dtype=np.uint32), 96), eng._rng_layout.total_words


def delay_state(np):
    """The delay engine's v3 batch at the hunt's width, 96 steps in."""
    eng = delay_engine(3)
    return eng.run_segment(eng.init_batch(np.arange(LANES, dtype=np.uint32)), 96), eng._rng_layout.total_words


def service_states(np):
    """The services' bugged batches SVC_STATE_STEPS in and single lanes of
    the replays' engines."""
    seeds = np.arange(SVC_LANES, dtype=np.uint32)
    states = {}
    for name in ("etcd_nodedup", "kafka_nofencing", "s3_arrival"):
        eng = service_engine(name)
        states[name] = eng.run_segment(eng.init_batch(seeds), SVC_STATE_STEPS)
    for key, name, seed in (("L1_Q48", "etcd_chaos", 16), ("L1_Q96", "kafka_kill", 0)):
        eng = service_engine(name)
        states[key] = eng.run_segment(eng.init_batch([seed]), SVC_STATE_STEPS)
    return states


def fleet_state(np):
    """The handover job's engine's 64 lanes, 64 steps and a flush period in."""
    from madsim_tpu_torch.__main__ import _build_engine
    from madsim_tpu_torch.fleet.store import normalize_spec, spec_to_args

    eng = _build_engine(spec_to_args(normalize_spec(FLEET_GUIDED)))
    return flushed_state(eng, np.arange(FLEET_GUIDED["batch"], dtype=np.uint32), 64)


def diff_states(np):
    """The differential's engine's 64 and 256 lanes, DIFF_STATE_STEPS in."""
    from madsim_tpu_torch.engine import Engine, EngineConfig, FaultPlan
    from madsim_tpu_torch.models import RaftMachine

    eng = Engine(RaftMachine(num_nodes=5, log_capacity=8), EngineConfig(**DIFF, faults=FaultPlan(**DIFF_FAULTS)))
    return tuple(eng.run_segment(eng.init_batch(np.arange(lanes, dtype=np.uint32)), DIFF_STATE_STEPS)
                 for lanes in (DIFF_LANES, DIFF_WHOLE_LANES))


def bench_state(np):
    """The machine bench's engine's 8192 lanes, BENCH_STATE_STEPS in."""
    from madsim_tpu_torch.__main__ import _build_engine, _parser

    eng = _build_engine(_parser().parse_args(["bench", *BENCH_MACHINE]))
    return eng.run_segment(eng.init_batch(np.arange(LANES, dtype=np.uint32)), BENCH_STATE_STEPS)


def sweep_state(np, lanes):
    """The sweep's engine's `lanes` lanes, SWEEP_STATE_STEPS and a flush
    period in; with its word block and queue."""
    eng = bench_script("tpu_sweep_torch").sweep_engine()
    return (flushed_state(eng, np.arange(lanes, dtype=np.uint32), SWEEP_STATE_STEPS), eng._rng_layout.total_words,
            eng.config.queue_capacity)


def prebuild_states(np):
    """The tail's states that depend on nothing it runs, into STATES."""
    builders = {
        "mesh": lambda: mesh_state(np),
        "delay": lambda: delay_state(np),
        "soak": lambda: soak_state_of(np),
        "examples": lambda: example_states(np, example_modules()),
        "services": lambda: service_states(np),
        "fleet": lambda: fleet_state(np),
        "cli_check": lambda: command_state(np, ["explore", *CLI_HUNT], 256),
        "cli_small": lambda: command_state(np, CLI_SMALL, 64),
        "diff": lambda: diff_states(np),
        "perf_ab": lambda: command_state(np, ["explore", *PERF_ARGS], AB_LANES),
        "perf_ab_v2": lambda: command_state(np, ["explore", *PERF_ARGS_V2], AB_LANES),
        "perf_replay": lambda: command_state(np, ["explore", *PERF_ARGS], 1, PROF_TRACE_SEED),
        "bench": lambda: bench_state(np),
        f"sweep_{SWEEP_POINT[0]}": lambda: sweep_state(np, SWEEP_POINT[0]),
    }
    t0 = time.perf_counter()
    for key, build in builders.items():
        STATES[key] = build()
    return round(time.perf_counter() - t0, 3)


def window_phase(torch, np, kernels):
    """The work that times nothing, all at once, with phase 11's first
    two stages, whose hunt rates and command seconds are taken beside it:
    phase 17 (the fleet,
    driven from a thread), phase 18 (the examples' two processes, driven
    from a thread), phase 18b's host half (its servers and clients,
    driven from a thread), phase 18c (lint, from a thread), phase 16's
    checks (PerfChecks), each group of
    CHECK_GROUPS in a process of its own (phase 18b's device half among
    them, and tail_replays: phase 10's checks, triage_checks, and the CPU's
    replays of phases 7-9's hunts, hunt_replays_cpu), phase 11's first two
    stages (cli_stages, from a thread; they launch nothing in this
    process) and in this process phase 6's replays, then the tail's
    states that depend on nothing it runs (prebuild_states) and, as each check group ends, the states the tail
    takes from its results. Returns the groups' results, the replays'
    launches and states (replay_and_corpus), the fleet's launches
    (fleet_jobs), the PerfChecks, joined, the examples' records
    (examples_run) and phase 11's first two stages."""
    fleet, examples, perf_checks = InThread(fleet_jobs), InThread(examples_run), PerfChecks()
    host, lint, sweep_mesh = InThread(services_host), InThread(lint_phase), InThread(sweep_mesh_run)
    cli = InThread(lambda: cli_stages(torch, np))
    groups = [ChildChecks(g) for g in CHECK_GROUPS]
    lint.start()
    fleet.start()
    examples.start()
    host.start()
    sweep_mesh.start()
    for g in groups:
        g.start()
    perf_checks.start()
    cli.start()
    replays = replay_and_corpus(torch, np, kernels)
    prebuilt_s = prebuild_states(np)
    # the groups joined as they end, each state the tail takes from a
    # group's results built as soon as it is there, while the rest of the
    # window runs
    from_checks = {"models": lambda: model_states_of(np, checks["models"]),
                   "palette": lambda: palette_states_of(np, checks["palette"]),
                   "clog": lambda: clog_states_of(np, checks["clog"]),
                   "triage": lambda: triage_states_of(np, checks["triage"])}
    checks, pending, from_checks_s = {}, list(groups), 0.0
    while pending:
        ended = [g for g in pending if g.proc.poll() is not None]
        if not ended:
            time.sleep(0.5)
        for g in ended:
            pending.remove(g)
            checks.update(g.join())
            for key in [k for k in from_checks if k in checks]:
                t0 = time.perf_counter()
                STATES[key] = from_checks.pop(key)()
                from_checks_s += time.perf_counter() - t0
    emit({"phase": "window_states", "prebuilt_s": prebuilt_s, "from_checks_s": round(from_checks_s, 3),
          "states": sorted(STATES)})
    fleet_res = fleet.join()
    perf_checks.join()
    host.join()
    lint.join()
    sweep_mesh.join()
    return checks, replays, fleet_res, perf_checks, examples.join(), cli.join()


def main(argv=None):
    import torch

    args = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    args.add_argument("--against", action="append", default=[],
                      help="another csrc tree to time the lane-group kernels against (repeatable)")
    args.add_argument("--only", choices=("cli", "prov", "guided", "perf", "fleet", "mesh", "examples", "services",
                                         "bench", "sweep", "window"),
                      default=None,
                      help="build, then run phase 11 alone (cli), phases 11-13 (prov), phases 14-15 (guided), "
                      "phase 16 (perf), phase 17 (fleet), phase 17b (mesh), phase 18 (examples), phase 18b "
                      "(services), phase 18d (bench), phase 18e over the sweep's whole grid (sweep) or the work "
                      "that times nothing, at once (window): a short check that prints no result line")
    args = args.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke runs on the card", file=sys.stderr)
        return 2
    import numpy as np

    from madsim_tpu_torch.engine import Engine, EngineConfig, FaultPlan
    from madsim_tpu_torch.models import RaftMachine
    from madsim_tpu_torch.ops import build, kernels

    # the triage phase's engine, built before any phase runs
    triage_eng = triage_engine()

    # 1. device
    started = time.perf_counter()
    print(card_line(), flush=True)
    emit({"phase": "device", "torch": torch.__version__, "cuda": torch.version.cuda,
          "python": sys.version.split()[0], "kind": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count()})

    # 2. build
    t0 = time.perf_counter()
    libs = build.build(verbose=True)
    build.load()
    emit({"phase": "build", "seconds": round(time.perf_counter() - t0, 3), "libraries": sorted(libs),
          "ptxas": ptxas_line(build, libs)})
    if args.only == "guided":
        group = ChildChecks("differential")
        group.start()
        guided_phase(torch, np, kernels, torch.device("cuda"), group.join()["differential"])
        emit({"phase": "total", "seconds": round(time.perf_counter() - started, 3)})
        return 0
    if args.only == "perf":
        perf = perf_phase(torch, np, kernels, torch.device("cuda"))
        perf_kernels(kernels, np, torch.device("cuda"), perf)
        emit({"phase": "total", "seconds": round(time.perf_counter() - started, 3)})
        return 0
    if args.only == "fleet":
        _, w3_launches = fleet_jobs()
        fleet_kernels(np, kernels, torch.device("cuda"), w3_launches)
        emit({"phase": "total", "seconds": round(time.perf_counter() - started, 3)})
        return 0
    if args.only == "mesh":
        group = ChildChecks("mesh")
        group.start()
        mesh_kernels(np, kernels, torch.device("cuda"), group.join()["mesh"]["launches_mesh"])
        emit({"phase": "total", "seconds": round(time.perf_counter() - started, 3)})
        return 0
    if args.only == "examples":
        examples, group = InThread(examples_run), ChildChecks("examples")
        examples.start()
        group.start()
        group.join()
        examples_kernels(np, kernels, torch.device("cuda"), examples.join())
        emit({"phase": "total", "seconds": round(time.perf_counter() - started, 3)})
        return 0
    if args.only == "services":
        host, groups = InThread(services_host), [ChildChecks("services_drift"), ChildChecks("services_faithful")]
        host.start()
        for g in groups:
            g.start()
        services = {}
        for g in groups:
            services.update(g.join())
        host.join()
        services_kernels(np, kernels, torch.device("cuda"), services_launches(services))
        emit({"phase": "total", "seconds": round(time.perf_counter() - started, 3)})
        return 0
    if args.only == "bench":
        bench_kernels(np, kernels, torch.device("cuda"), bench_phase())
        emit({"phase": "total", "seconds": round(time.perf_counter() - started, 3)})
        return 0
    if args.only == "sweep":
        rpc_bench_phase()
        _, points = sweep_phase(bench_script("tpu_sweep_torch").DEFAULT_GRID)
        sweep_kernels(np, kernels, torch.device("cuda"), points)
        sweep_mesh, group = InThread(sweep_mesh_run), ChildChecks("guided_compare")
        sweep_mesh.start()
        group.start()
        group.join()
        sweep_mesh.join()
        emit({"phase": "total", "seconds": round(time.perf_counter() - started, 3)})
        return 0
    if args.only == "window":
        checks, _, (_, w3_launches), perf_checks, examples, _ = window_phase(torch, np, kernels)
        examples_kernels(np, kernels, torch.device("cuda"), examples)
        services_kernels(np, kernels, torch.device("cuda"), services_launches(checks))
        mesh_kernels(np, kernels, torch.device("cuda"), checks["mesh"]["launches_mesh"])
        # the states the timed phases take from it
        built("models", lambda: model_states_of(np, checks["models"]))
        built("palette", lambda: palette_states_of(np, checks["palette"]))
        built("soak", lambda: soak_state_of(np))
        clog_kernels(kernels, torch.device("cuda"), built("clog", lambda: clog_states_of(np, checks["clog"])))
        fleet_kernels(np, kernels, torch.device("cuda"), w3_launches)
        emit({"phase": "perf_checks", **perf_checks.read()})
        emit({"phase": "total", "seconds": round(time.perf_counter() - started, 3)})
        return 0
    if args.only:
        cli = cli_phase(torch, np)
        cli_kernels(kernels, np, torch.device("cuda"), cli)
        if args.only == "prov":
            provenance_phase(np, cli, provenance_legs(np))
            clog_kernels(kernels, torch.device("cuda"), clog_states_of(np, clog_checks(torch, np, kernels)))
        emit({"phase": "total", "seconds": round(time.perf_counter() - started, 3)})
        return 0
    designs = [(f"against {d}", build.load(pathlib.Path(d).resolve())) for d in args.against]
    if designs:
        designs.append(("this checkout", build.load()))

    cfg = EngineConfig(**FLAGSHIP, faults=FaultPlan(**FLAGSHIP_FAULTS))
    eng = Engine(RaftMachine(num_nodes=5, log_capacity=8), cfg)  # on the card
    dev = eng.device

    # 3. kernels against their twins, on the main path's inputs (a
    #    flagship batch 112 steps in, its coverage buffers full as at a
    #    cadence flush) and on edge shapes
    g = np.random.default_rng(0)
    state = eng.run_segment(eng.init_batch(np.arange(LANES, dtype=np.uint32)), 96)
    for _ in range(eng.config.cov_buffer):
        state = eng.step_batch(state)
    total_words = eng._rng_layout.total_words
    s_err, s_ms, s_plain, s_bytes, s_ops, s_floor = check_step_kernel(kernels, g, dev, state, total_words)
    head_to_head = {}
    if designs:
        main_ins, (d0, d1) = step_kernel_ins(state)
        check_designs(kernels, designs, lambda: flat_prefix(kernels.step_megakernel(*main_ins, total_words, d0, d1)),
                      lambda: flat_prefix(kernels.step_prefix_plain(*main_ins, total_words, d0, d1)),
                      "step_megakernel")
        head_to_head["step_megakernel"] = time_in_turns(
            kernels, designs, lambda: kernels.step_megakernel(*main_ins, total_words, d0, d1))
        # past W = 2 * GROUP a lane-group thread holds more than one pair and
        # the digest re-reads the words: the flagship's queues at wider blocks
        for w in WIDE_WORDS:
            check_designs(kernels, designs, lambda: flat_prefix(kernels.step_megakernel(*main_ins, w, d0, d1)),
                          lambda: flat_prefix(kernels.step_prefix_plain(*main_ins, w, d0, d1)),
                          f"step_megakernel W={w}")
            head_to_head[f"step_megakernel_w{w}"] = time_in_turns(
                kernels, designs, lambda: kernels.step_megakernel(*main_ins, w, d0, d1))
    c_err, c_ms, c_plain, c_bytes, c_ops, c_live, c_sectors, c_floor = check_cov_flush(kernels, g, dev, state)
    # the palette hunt's shapes: 8192 lanes at Q = 96, W = 18, and its
    # buffers a flush period in (two entries a step, flushed every 8 steps)
    p_eng = palette_hunt_engine()
    p_state = p_eng.run_segment(p_eng.init_batch(np.arange(LANES, dtype=np.uint32)), 96)
    for _ in range(p_eng._cov_flush_every):
        p_state = p_eng.step_batch(p_state)
    p_words = p_eng._rng_layout.total_words
    _, ps_ms, ps_plain, ps_bytes, ps_ops, ps_floor = time_step_kernel(kernels, dev, p_state, p_words)
    _, pc_ms, pc_plain, pc_bytes, pc_ops, pc_live, pc_sectors, pc_floor = time_cov_flush(kernels, dev, p_state.cov)
    if designs:
        cov = state.cov
        check_designs(kernels, designs, lambda: [kernels.cov_flush_batch(cov["map"].clone(), cov["buf"], cov["buf_n"])],
                      lambda: [kernels.cov_flush_plain(cov["map"], cov["buf"], cov["buf_n"])], "cov_flush")
        scratch = cov["map"].clone()  # the flush is idempotent: the map stays valid across reps
        head_to_head["cov_flush"] = time_in_turns(
            kernels, designs, lambda: kernels.cov_flush_batch(scratch, cov["buf"], cov["buf_n"]))

    s_bound, c_bound = bound(s_bytes, s_ops), bound(c_bytes, c_ops)
    ps_bound, pc_bound = bound(ps_bytes, ps_ops), bound(pc_bytes, pc_ops)
    emit({"phase": "kernels", "step_megakernel": {"ms": s_ms, "plain_ms": s_plain, "bound_ms": s_bound[0],
                                                  "floor_ms": s_floor, "bytes": s_bytes, "ops": s_ops},
          "cov_flush": {"ms": c_ms, "plain_ms": c_plain, "bound_ms": c_bound[0], "floor_ms": c_floor,
                        "bytes": c_bytes, "ops": c_ops, "live_entries": c_live, "live_sectors": c_sectors},
          "step_megakernel_palette": {"q": PALETTE_Q, "words": p_words, "ms": ps_ms, "plain_ms": ps_plain,
                                      "bound_ms": ps_bound[0], "bound_by": ps_bound[1], "floor_ms": ps_floor,
                                      "bytes": ps_bytes, "ops": ps_ops},
          "cov_flush_palette": {"flush_every": p_eng._cov_flush_every, "ms": pc_ms, "plain_ms": pc_plain,
                                "bound_ms": pc_bound[0], "bound_by": pc_bound[1], "floor_ms": pc_floor,
                                "bytes": pc_bytes, "ops": pc_ops, "live_entries": pc_live,
                                "live_sectors": pc_sectors}})
    del p_state

    # 4. the card against the CPU: 256 flagship seeds, whole results
    seeds = np.arange(CHECK_LANES, dtype=np.uint32) + 10_000
    cpu_eng = Engine(RaftMachine(num_nodes=5, log_capacity=8), cfg, device="cpu")
    on_card, t_card, t_cpu = card_vs_cpu(lambda d: eng if d is None else cpu_eng, seeds, CHECK_STEPS,
                                         "flagship")
    emit({"phase": "card_vs_cpu", "lanes": CHECK_LANES, "equal": True, "card_s": round(t_card, 3),
          "cpu_s": round(t_cpu, 3), "max_steps": int(on_card["steps"].max())})
    # the CPU legs from here on run on two intra-op threads (the check
    # groups' processes too): their tensors are a few hundred lanes wide,
    # where more threads only add the cost of waking them (this phase's
    # CPU seconds, the host's gauge, keep the default)
    torch.set_num_threads(2)

    # 5. the flagship stream, through the entry points a user calls
    run = eng.make_stream_runner(batch=LANES, segment_steps=SEGMENT_STEPS, pipelined=False)
    # no warm stream run: the state run above warmed the batch's shapes
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    res = run(2 * LANES, seed_start=LANES)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = dict(kernels.launches)
    for name in ("step_megakernel", "cov_flush"):
        if launches[name] <= 0:
            fail(f"the flagship stream never launched {name}")
    segments = res["stats"]["device_segments"]
    emit({"phase": "stream", "completed": res["completed"], "failing": res["failing"][:8],
          "n_failing": len(res["failing"]), "infra": res["infra"][:8], "n_abandoned": len(res["abandoned"]),
          "seeds_consumed": res["seeds_consumed"], "seconds": round(elapsed, 3),
          "seeds_per_s": round(res["completed"] / elapsed, 2), "segments": segments,
          "ms_per_step": round(elapsed * 1e3 / (segments * SEGMENT_STEPS), 3),
          "slots_hit": res["stats"]["coverage"]["slots_hit"], "launches": launches,
          "flight_recorder": res["stats"]["flight_recorder"]})
    if res["completed"] < 2 * LANES:
        fail(f"the stream completed {res['completed']} < {2 * LANES} seeds")
    found = (res["failing"] + res["infra"])[:4]
    if found:
        replay = cpu_eng.run_batch(np.array([s for s, _ in found], dtype=np.uint32), 10_000)
        codes = [int(c) if f else 0 for f, c in zip(replay.failed.tolist(), replay.fail_code.tolist())]
        if codes != [c for _, c in found]:
            fail(f"failing seeds {found} replayed on the CPU with codes {codes}")
    emit({"phase": "replay_on_cpu", "seeds": [s for s, _ in found], "same_codes": True})
    # phase 17b's meshed legs are held against this stream: its dict, for
    # the window's processes
    import os
    import pickle
    import tempfile

    ref_fd, ref_path = tempfile.mkstemp(prefix="madsim_mesh_ref_")
    with os.fdopen(ref_fd, "wb") as f:
        pickle.dump(res, f)
    os.environ[MESH_REF_ENV] = ref_path

    # where a flagship step's time goes: a short profiler window
    emit({"phase": "profile", **profile_steps(eng, state, steps=8)})

    # 6. the split-chain stream, and the pop kernels on its inputs and the replay's
    v2_launches, v2_state, v2_eng = stream_v2_phase(torch, np, kernels)

    # what times nothing, at once: 4b. the card against the CPU where lanes
    # fail; 6. the split chain's checks and its single-lane replays; the
    # card-against-CPU checks of 7. the delay-spike kind and the MVCC, S3,
    # gossip and other models, 8. the chaos palette (pause, skew, dup and strict restarts), 9. the
    # storage kinds, 12. causal provenance and 13. the unpacked clog
    # matrix; 16.'s commands that time nothing; 17. the hunt fleet
    checks, (replay_launches, replay_state, corpus_states), (fleet_launches, w3_launches), perf_checks, examples, \
        cli_first = window_phase(torch, np, kernels)
    model_states = built("models", lambda: model_states_of(np, checks["models"]))
    palette_states = built("palette", lambda: palette_states_of(np, checks["palette"]))
    storage = {**checks["storage"], "soak_state": built("soak", lambda: soak_state_of(np))}

    os.unlink(ref_path)
    # 17b. the mesh path's kernel shapes (a rank's 4096 lanes)
    launches_mesh = checks["mesh"]["launches_mesh"]
    mesh_kernels(np, kernels, dev, launches_mesh)

    # 7. the delay-spike kind's megakernel at 8192 lanes
    delay_kernels(np, kernels, dev)

    # 7-9. the MVCC, palette and torn hunts at full width
    hunt_cpu = checks["hunt_replays"]
    _, hunt_state = stream_mvcc_phase(torch, np, kernels, hunt_cpu["mvcc"])
    stream_palette_phase(torch, np, kernels, palette_states, hunt_cpu)
    stream_torn_phase(torch, np, kernels, storage, hunt_cpu["torn"])
    storage_kernels(kernels, dev, storage, palette_states)
    fleet_kernels(np, kernels, dev, w3_launches)
    # 18. the examples' kernel shapes; 18b. the service differentials'
    ex_kernels = examples_kernels(np, kernels, dev, examples)
    launches_examples = {name: sum(rec["launches"].get(name, 0) for rec in examples.values())
                         for name in kernels.launches}
    services = services_launches(checks)
    svc_kernels = services_kernels(np, kernels, dev, services)
    launches_services = services["launches"]

    # 10. the triage path: the double-grant hunt, its post-mortem, shrink,
    #     corpus entry and export
    triage = triage_phase(torch, np, kernels, triage_eng, checks["triage"], STATES.pop("triage"))
    triage_kernels(kernels, dev, triage, model_states)
    models_v2_state, models_v2_launches = model_states["v2"]
    pops = check_pop_kernels(kernels, g, dev, v2_state, replay_state, hunt_state, corpus_states, palette_states,
                             storage["replay_state"], models_v2_state, triage["replay_state"])
    pops["pop_earliest_L1_Q64"]["launches"] = storage["replay_launches"]["pop_earliest"]
    pops["pop_gather_models_v2"]["launches"] = models_v2_launches
    pops["pop_earliest_L1_Q96_triage"]["launches"] = triage["replay_launches"]["pop_earliest"]
    for name, k in pops.items():
        k["bound_ms"], k["bound_by"] = bound(k["bytes"], k["ops"])
    emit({"phase": "pop_kernels", "max_abs_err": max(k["err"] for k in pops.values()),
          **{name: {key: k[key] for key in ("lanes", "q", "ms", "plain_ms", "bound_ms", "floor_ms", "bytes", "ops",
                                            "launches") if key in k}
             for name, k in pops.items()}})
    if designs:
        pop_ins = pop_planes(v2_state)

        def flat_pop(r):
            return [r[0], r[1], *r[2], r[3]]

        check_designs(kernels, designs, lambda: flat_pop(kernels.pop_gather_batch(*pop_ins)),
                      lambda: flat_pop(kernels.pop_gather_plain(*pop_ins)), "pop_gather")
        head_to_head["pop_gather"] = time_in_turns(kernels, designs, lambda: kernels.pop_gather_batch(*pop_ins))
        lanes = v2_state.eq_time.shape[0]
        for key, ins in (("L1", pop_planes(replay_state, gather=False)), (f"L{lanes}", pop_ins[:3])):
            check_designs(kernels, designs, lambda: kernels.pop_earliest_batch(*ins),
                          lambda: kernels.pop_earliest_plain(*ins), f"pop_earliest {key}")
            head_to_head[f"pop_earliest_{key}"] = time_in_turns(
                kernels, designs, lambda: kernels.pop_earliest_batch(*ins))
        # the floors: this checkout's grids and blocks, and those of other
        # designs: one warp per lane (8 warps a block) for the first pops,
        # 4 threads a lane (64 lanes a block) for a flush that merges a
        # lane's entries by shuffles
        c = state.cov["buf"].shape[1]
        earlier = {f"one warp per lane L{lanes}": ((lanes + 7) // 8, 256),
                   f"4 threads a lane L{lanes}": ((lanes + 63) // 64, 256)}
        head_to_head["floor_ms"] = {
            f"pop_gather L{lanes}": floor_ms(kernels, "pop_gather", lanes, dev),
            f"pop_earliest L{lanes}": floor_ms(kernels, "pop_earliest", lanes, dev),
            "pop_earliest L1": floor_ms(kernels, "pop_earliest", 1, dev),
            f"cov_flush L{lanes} C{c}": floor_ms(kernels, "cov_flush", lanes, dev, c),
            **{name: device_time_ms(lambda: kernels.launch_floor(grid, block, dev))
               for name, (grid, block) in earlier.items()},
        }
        emit({"phase": "head_to_head", "order": [n for n, _ in designs + designs[::-1]], "lanes": lanes,
              **head_to_head})
    emit({"phase": "profile_v2", **profile_steps(v2_eng, v2_state, steps=8)})

    # 11. the command line, in subprocesses on the card (its first two
    #     stages ran in the window)
    cli = cli_phase(torch, np, cli_first)
    cli_kernels(kernels, np, dev, cli)

    # 12. the provenance gate's cost; 13. the clog matrix's kernel shapes
    provenance_phase(np, cli, checks["prov_legs"])
    clog_kernels(kernels, dev, built("clog", lambda: clog_states_of(np, checks["clog"])))

    # 14. guided search at full width; 15. the Raft differential's device
    # side (the whole differential ran in the window)
    guided = guided_phase(torch, np, kernels, dev, checks["differential"])
    diff_pop = guided[f"pop_gather_differential_L{DIFF_WHOLE_LANES}_Q{DIFF['queue_capacity']}"]
    launches_differential = checks["differential"]["launches"]

    # 16. the perf tooling: the host timeline, the three clocks, bench-ab
    perf = perf_phase(torch, np, kernels, dev, perf_checks)
    perf_kernels(kernels, np, dev, perf)
    # each kernel's launches on the perf path: perf's stream, the v2
    # prof's stream, the prof replay's pops
    perf_launches = {"step_megakernel": perf["perf"].get("step_megakernel", 0),
                     "cov_flush": perf["perf"].get("cov_flush", 0),
                     "pop_gather": perf["prof_v2"].get("pop_gather", 0),
                     "pop_earliest": perf["prof"].get("pop_earliest", 0)}

    # 18d. the bench command, its three forms, with nothing beside it
    bench = bench_phase()
    bench_pop = bench_kernels(np, kernels, dev, bench)[f"pop_gather_L{LANES}_Q96"]
    launches_bench = bench["all"]

    # 18e. the bench scripts' port copies: rpc_bench on the host, the
    # sweep's widest point alone, then its kernels at that width
    rpc_bench_phase()
    launches_sweep, sweep_points = sweep_phase([SWEEP_POINT])
    sweep_kernels(np, kernels, dev, sweep_points)

    emit({"phase": "total", "seconds": round(time.perf_counter() - started, 3)})

    # 19. the kernels line
    emit({"kernels": [
        {"name": "step_megakernel", "route": "cuda", "source": "madsim_tpu_torch/ops/csrc/step_megakernel.cu",
         "replaces": "madsim_tpu/ops/pallas_pop.py:310", "launches": launches["step_megakernel"],
         "max_abs_err": s_err, "ms": s_ms, "plain_ms": s_plain, "bound_ms": s_bound[0],
         "bound_by": s_bound[1], "library_ms": None, "floor_ms": s_floor,
         "launches_perf": perf_launches["step_megakernel"], "launches_fleet": fleet_launches["step_megakernel"],
         "launches_mesh": launches_mesh.get("step_megakernel", 0),
         "launches_differential": launches_differential.get("step_megakernel", 0),
         "launches_examples": launches_examples["step_megakernel"],
         "launches_services": launches_services["step_megakernel"],
         "launches_bench": launches_bench.get("step_megakernel", 0),
         "launches_sweep": launches_sweep.get("step_megakernel", 0)},
        {"name": "cov_flush", "route": "cuda", "source": "madsim_tpu_torch/ops/csrc/cov_flush.cu",
         "replaces": "madsim_tpu/ops/pallas_pop.py:408", "launches": launches["cov_flush"],
         "max_abs_err": c_err, "ms": c_ms, "plain_ms": c_plain, "bound_ms": c_bound[0],
         "bound_by": c_bound[1], "library_ms": None, "floor_ms": c_floor,
         "launches_perf": perf_launches["cov_flush"], "launches_fleet": fleet_launches["cov_flush"],
         "launches_mesh": launches_mesh.get("cov_flush", 0),
         "launches_differential": launches_differential.get("cov_flush", 0),
         "launches_examples": launches_examples["cov_flush"],
         "launches_services": launches_services["cov_flush"],
         "launches_bench": launches_bench.get("cov_flush", 0),
         "launches_sweep": launches_sweep.get("cov_flush", 0)},
        # each at the shape where its launches run: pop_earliest's are the
        # single-lane replay's
        *({"name": name, "route": "cuda", "source": "madsim_tpu_torch/ops/csrc/pop_gather.cu",
           "replaces": replaces, "launches": n, "max_abs_err": k["err"], "ms": k["ms"],
           "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"], "bound_by": k["bound_by"], "library_ms": None,
           "floor_ms": k["floor_ms"], "lanes": k["lanes"], "launches_perf": perf_launches[name],
           "launches_fleet": fleet_launches[name], "launches_mesh": launches_mesh.get(name, 0),
           "launches_differential": launches_differential.get(name, 0),
           "launches_examples": launches_examples[name], "launches_services": launches_services[name],
           "launches_bench": launches_bench.get(name, 0), "launches_sweep": launches_sweep.get(name, 0),
           # the examples' shapes (phase 18), held and timed in examples_kernels
           "examples": {shape: {key: k_ex[key] for key in (
               "lanes", "q", "launches", "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "floor_ms")}
               for shape, k_ex in ex_kernels.items() if shape.startswith(name)},
           # the service differentials' shapes (phase 18b), held and timed in services_kernels
           "services": {shape: {key: k_svc[key] for key in (
               "lanes", "q", "launches", "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "floor_ms")}
               for shape, k_svc in svc_kernels.items() if shape.startswith(name)},
           # the whole differential's shape (phase 15), held and timed there
           **({"differential": {key: diff_pop[key] for key in (
               "lanes", "q", "launches", "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "floor_ms")}}
              if name == "pop_gather" else {}),
           # the bench command's machine shape (phase 18d), held and timed in bench_kernels
           **({"bench": {key: bench_pop[key] for key in (
               "lanes", "q", "launches", "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "floor_ms")}}
              if name == "pop_gather" else {})}
          for name, replaces, n, k in (
              ("pop_gather", "madsim_tpu/ops/pallas_pop.py:172", v2_launches["pop_gather"], pops["pop_gather"]),
              ("pop_earliest", "madsim_tpu/ops/pallas_pop.py:143", replay_launches["pop_earliest"],
               pops["pop_earliest_L1"]))),
    ]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
