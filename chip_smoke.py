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
     make_stream_runner(batch=8192, segment_steps=384), one warm run
     and one timed run of 2*8192 seeds, with each kernel's launch count
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
     corpus.json (corpus: codes 150 x5, 206, 160, 212 and the recorded
     digest trails, the pop kernel launched); and the 8192-lane flagship
     stream under rng_stream=2 (stream_v2);
  7. the delay-spike kind and the etcd-MVCC, S3 and gossip models:
     run_batch of 256 flagship seeds with delay faults on both streams
     equal to the CPU, with the sends that took a spike counted and the
     megakernel held against its twin at W = 18 (card_vs_cpu_delay); each
     model and its corpus demo on the card against the CPU, the demo
     failing with its code (card_vs_cpu_models: mvcc and s3 at Q = 48,
     gossip at 33 nodes and Q = 256); the MVCC give-up hunt at 8192 lanes
     under delay spikes (stream_mvcc), whose first ABANDONED_WRITE seed
     replays equal on the card and the CPU; then the pop kernels against
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
     whose first ELECTION_SAFETY seed replays equal on the card and the
     CPU, and whose seeds failing with another code are replayed on the
     CPU and listed; the megakernel at Q = 96, W = 18 and the flush at two
     entries a step in `kernels`, the pops at Q = 96 in `pop_kernels`;
  9. the storage kinds (torn restarts, asymmetric heals) and the models
     raft-compact, paxos, etcd and group: run_batch on the card against
     the CPU on both streams (card_vs_cpu_storage): the torn-snapshot
     plan on TornSnapshotRaftCompact (LOG_MATCHING only), heal-asym on
     honest Raft at Q = 48, and honest raft-compact under every kind at
     once with 1% loss (no failure; the megakernel at W = 31); the
     torn-snapshot hunt at 8192 lanes (stream_torn), failing 102 only,
     whose first find replays equal on the card and the CPU; then the
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
     the ring on and off), holds the first failing lanes' rings against
     the tails of their replays on the card and those replays against
     the CPU's, shrinks the first seed on the card and on the CPU (equal
     results), records the shrunk entry on the card, adds it to a corpus
     file and checks and audits it on the CPU (and audits one recorded
     on the CPU on the card), and exports the card's and the CPU's traces
     byte for byte; `triage_kernels` holds and times the megakernel at
     the hunt's Q = 96 / W = 10 (8192 lanes and the replays' L = 1) and
     at the model leg's shapes, and the flush on the hunt's buffers;
     pop_kernels adds pop_gather at the model leg's batch and
     pop_earliest at the triage replays' L = 1;
 11. a `kernels` JSON line; the last line is {"ok": true, "device": ...}.

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
exits non-zero and prints no result.
"""

import argparse
import json
import pathlib
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
# phases 4 and 6: lanes and run_batch's step budget (flagship lanes run
# it out); small enough that the script fits half its time limit
CHECK_LANES, CHECK_STEPS = 256, 384
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
DELAY_LANES, DELAY_STEPS, DELAY_SPIKE_STEPS = 256, 256, 128
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
# the honest etcd and group lanes are cut at 320 and 256 events)
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
TORN_CHECK_STEPS, HASYM_STEPS, SOAK_STEPS = 256, 160, 160
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
STARTED = time.perf_counter()


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
    print(json.dumps(obj), flush=True)


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
            # bytes: time, seq and valid planes whole (9 B a slot); one
            # 32-byte sector for each gathered field (kind, node, src, the
            # payload row); idx, any, the four fields and the payload row out
            nbytes = lanes * (9 * q + 4 * 32 + 4 + 1 + 16 + 4 * ins[6].shape[2])
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


def split_chain_phases(torch, np, kernels):
    """Phase 6: the default split-chain stream on the card. Returns the
    timed v2 stream's launch counts, the replay's, the v2 flagship state
    the pop kernels are checked on, its engine, the replay's state of
    seed 66531 REPLAY_STATE_STEPS events in, where the pop is timed, and
    the mvcc and gossip corpus replays' states (CORPUS_STATE_STEPS)."""
    from madsim_tpu_torch.engine import Engine, EngineConfig, FaultPlan
    from madsim_tpu_torch.engine import audit, corpus
    from madsim_tpu_torch.engine.replay import replay
    from madsim_tpu_torch.interop import tree_to_numpy
    from madsim_tpu_torch.models import MultiPaxosMachine, RaftMachine, build_machine
    from madsim_tpu_torch.models.multipaxos import AGREEMENT_MULTI
    from madsim_tpu_torch.models.raft import LOG_MATCHING

    raft = RaftMachine(num_nodes=5, log_capacity=8)
    faults = FaultPlan(**FLAGSHIP_FAULTS)

    def v2(recorder, device=None):
        cfg = EngineConfig(**{**FLAGSHIP, "rng_stream": 2, "flight_recorder": recorder, "coverage": recorder},
                           faults=faults)
        return Engine(raft, cfg, device=device)

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

    # replay_66531: the single-lane replay on the card, against the CPU's
    rp_cfg = EngineConfig(**REPLAY_CONFIG, faults=faults)
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

    # corpus: every entry, with its code and digest trail, replayed on the
    #   card (multi-Paxos, the MVCC give-up under delay spikes, 33-node
    #   gossip at Q = 256, the S3 abort leak); then the single-lane states
    #   pop_earliest is timed at, Q = 48 and 256
    entries = corpus.load(str(pathlib.Path(__file__).resolve().parent / "corpus.json"))
    kernels.reset_launches()
    t0 = time.perf_counter()
    found = []
    for entry in entries:
        out = corpus.check(entry, build_machine)
        trail = audit.audit_entry(entry, build_machine).trail
        digests, final = trail.to_lists()
        if not (out.ok and out.fail_code == entry.fail_code) or digests != entry.digests \
                or final != entry.digest_final:
            fail(f"corpus entry {entry.machine} seed {entry.seed}: {out.verdict}; trail {digests} {final} vs "
                 f"{entry.digests} {entry.digest_final}")
        found.append([entry.machine, entry.seed, out.fail_code, final[0], entry.config.queue_capacity])
    corpus_launches = dict(kernels.launches)
    if len(found) != 8 or sorted({f[2] for f in found}) != [AGREEMENT_MULTI, 160, 206, 212]:
        fail(f"corpus.json holds {len(found)} entries with codes {sorted({f[2] for f in found})}, not the 8 "
             f"with codes 150, 160, 206 and 212")
    if corpus_launches["pop_gather"] <= 0:
        fail("the corpus replays never launched pop_gather")
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
    emit({"phase": "corpus", "entries": found, "digest_trails_equal": True,
          "seconds": round(time.perf_counter() - t0, 3), "launches": corpus_launches,
          "traced": traced, "traces_equal": True, "traced_launches": trace_launches})
    corpus_states = {}
    for entry in entries:
        if entry.machine in CORPUS_STATE_STEPS:
            c_eng = Engine(build_machine(entry.machine, entry.nodes), entry.config)
            corpus_states[entry.machine] = c_eng.run_segment(c_eng.init_batch([entry.seed]),
                                                             CORPUS_STATE_STEPS[entry.machine])

    # stream_v2: the flagship hunt on the split-chain stream
    eng = v2(True)
    state = eng.run_segment(eng.init_batch(np.arange(LANES, dtype=np.uint32)), 96)
    run = eng.make_stream_runner(batch=LANES, segment_steps=SEGMENT_STEPS)
    run(1)  # warm: one segment
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    res = run(2 * LANES, seed_start=LANES)
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
    if res["completed"] < 2 * LANES:
        fail(f"the v2 stream completed {res['completed']} < {2 * LANES} seeds")
    return launches, replay_launches, state, eng, replay_state, corpus_states


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


def delay_and_model_phases(torch, np, kernels, dev):
    """Phase 7: the delay-spike kind and the MVCC, S3 and gossip models.
    card_vs_cpu_delay (the flagship Raft with delay faults on both
    streams, the megakernel at W = 18 held against its twin), then
    card_vs_cpu_models, then stream_mvcc (the give-up hunt at 8192 lanes,
    its first ABANDONED_WRITE seed replayed on the card and the CPU).
    Returns the hunt's launch counts and its batch state (8192 lanes,
    Q = 48, P = 5), where pop + gather is timed."""
    from collections import Counter

    from madsim_tpu_torch.engine import Engine, EngineConfig, FaultPlan
    from madsim_tpu_torch.engine.replay import replay
    from madsim_tpu_torch.interop import tree_to_numpy
    from madsim_tpu_torch.models import RaftMachine, build_machine
    from madsim_tpu_torch.models.etcd_mvcc import ABANDONED_WRITE

    # card_vs_cpu_delay: both streams; v3 launches the megakernel at W = 18
    raft, out = RaftMachine(num_nodes=5, log_capacity=8), {}
    seeds = np.arange(DELAY_LANES, dtype=np.uint32) + 30_000
    for stream, kernel in ((3, "step_megakernel"), (2, "pop_gather")):
        cfg = EngineConfig(**{**FLAGSHIP, "rng_stream": stream},
                           faults=FaultPlan(**FLAGSHIP_FAULTS, allow_delay=True))
        card = Engine(raft, cfg)
        kernels.reset_launches()
        res, t_card, t_cpu = card_vs_cpu(lambda d: card if d is None else Engine(raft, cfg, device="cpu"), seeds,
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
            # timed at the hunt's width: 8192 lanes of the same config
            big = card.run_segment(card.init_batch(np.arange(LANES, dtype=np.uint32)), 96)
            big_ins, big_d = step_kernel_ins(big)
            err = max(err, max_abs_err(flat_prefix(kernels.step_megakernel(*big_ins, w, *big_d)),
                                       flat_prefix(kernels.step_prefix_plain(*big_ins, w, *big_d))))
            nbytes, ops = step_kernel_cost(LANES, big.eq_time.shape[1], big.eq_payload.shape[2], w)
            timing = {"lanes": LANES, "ms": device_time_ms(lambda: kernels.step_megakernel(*big_ins, w, *big_d)),
                      "floor_ms": floor_ms(kernels, "step_megakernel", LANES, dev),
                      "bound_ms": bound(nbytes, ops)[0], "bytes": nbytes, "ops": ops}
        else:
            planes = pop_planes(state)
            got, want = kernels.pop_gather_batch(*planes), kernels.pop_gather_plain(*planes)
            err, timing = max_abs_err([got[0], got[1], *got[2], got[3]], [want[0], want[1], *want[2], want[3]]), {}
        if err:
            fail(f"{kernel} disagrees with its twin on the delay state (rng_stream={stream}): max abs err {err}")
        out[f"rng_stream={stream}"] = {
            "lanes": DELAY_LANES, "equal": True, "card_s": round(t_card, 3), "cpu_s": round(t_cpu, 3),
            "max_steps": int(res["steps"].max()), "n_failed": int(res["failed"].sum()),
            "delay_windows": int(res["fr"]["inj"][:, 5].sum()), "sends": sends, "spiked_sends": spiked,
            "launches": launches, "words": w, kernel: {"max_abs_err": err, **timing}}
    emit({"phase": "card_vs_cpu_delay", **out})

    model_states = card_vs_cpu_models(torch, np, kernels)

    # stream_mvcc: the give-up hunt at full width, through the entry points
    machine = build_machine("demo-giveup-mvcc")
    cfg = EngineConfig(**MVCC_HUNT, faults=FaultPlan(**MVCC_HUNT_FAULTS))
    eng = Engine(machine, cfg)
    state = eng.run_segment(eng.init_batch(np.arange(LANES, dtype=np.uint32)), 24)
    run = eng.make_stream_runner(batch=LANES, segment_steps=SEGMENT_STEPS)
    run(1)  # warm: one segment
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    res = run(2 * LANES, seed_start=LANES)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = dict(kernels.launches)
    for name in ("pop_gather", "cov_flush"):
        if launches[name] <= 0:
            fail(f"the mvcc hunt never launched {name}")
    by_code = Counter(code for _, code in res["failing"])
    first = next((seed for seed, code in res["failing"] if code == ABANDONED_WRITE), None)
    if first is None or res["completed"] < 2 * LANES:
        fail(f"the mvcc hunt completed {res['completed']} seeds, failing by code {dict(by_code)}: no "
             f"ABANDONED_WRITE seed")
    t1 = time.perf_counter()
    before = kernels.launches["pop_earliest"]
    on_card = replay(Engine(machine, cfg), first)
    t_replay = time.perf_counter() - t1
    pops = kernels.launches["pop_earliest"] - before
    on_cpu = replay(Engine(machine, cfg, device="cpu"), first)
    bad = tree_diff(tree_to_numpy(on_card.state), tree_to_numpy(on_cpu.state))
    if on_card.fail_code != ABANDONED_WRITE or on_card.trace != on_cpu.trace or bad:
        fail(f"mvcc seed {first}: the card replay gave {on_card.fail_code} and differs from the CPU's in "
             f"{bad[:8] or 'the trace'}")
    segments = res["stats"]["device_segments"]
    emit({"phase": "stream_mvcc", "completed": res["completed"], "failing_by_code": dict(by_code),
          "n_infra": len(res["infra"]), "n_abandoned": len(res["abandoned"]), "seconds": round(elapsed, 3),
          "seeds_per_s": round(res["completed"] / elapsed, 2), "segments": segments,
          "ms_per_step": round(elapsed * 1e3 / (segments * SEGMENT_STEPS), 3),
          "slots_hit": res["stats"]["coverage"]["slots_hit"], "launches": launches,
          "replay": {"seed": first, "fail_code": on_card.fail_code, "events": len(on_card.trace),
                     "pop_earliest": pops, "card_s": round(t_replay, 3), "equal": True},
          "profile": profile_steps(eng, state, steps=8)})
    return launches, state, model_states


def card_vs_cpu_models(torch, np, kernels):
    """card_vs_cpu_models: run_batch of each model and its corpus demo or
    bug variant on the card against the CPU. Returns the states the model
    leg's prefix kernels are timed on: the counter-stream models' (with
    their word blocks and launches) and mq's on the split chain."""
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
    out, model_states = {}, {"v3": [], "v2": None}
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
        ("etcd", ETCD_PLAN, ETCD_FAULTS, range(64), 320, None),
        ("demo-doublegrant-etcd", DOUBLEGRANT_PLAN, DOUBLEGRANT_FAULTS, range(100, 164), 200, 120),
        ("group", GROUP_PLAN, GROUP_FAULTS, range(64), 256, None),
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
        if name in ("kv", "mq", "twopc"):
            # the state its prefix kernel is held and timed on, a third of its budget in
            card = Engine(machine, cfg)
            state = card.run_segment(card.init_batch(np.array(model_seeds, dtype=np.uint32)), steps // 3)
            if kernel == "pop_gather":
                model_states["v2"] = (state, launches[kernel])
            else:
                model_states["v3"].append((name, state, card._rng_layout.total_words, launches[kernel]))
    emit({"phase": "card_vs_cpu_models", **out})
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


def palette_phases(torch, np, kernels):
    """Phase 8: the chaos palette. card_vs_cpu_palette (the flagship Raft
    at Q = 96 under pause, skew, dup and strict restarts, both streams),
    card_vs_cpu_demos (VolatileCommit under strict restarts, the
    dup-vote tally under dup, with a traced replay), then stream_palette
    (the dup-vote hunt at 8192 lanes). Returns the hunt's launch counts
    and the states the pops are timed on: the palette's v2 batch (256
    lanes, Q = 96), the dup-vote demo replay's lane (v2) and the hunt
    replay's lane (v3), each at Q = 96."""
    from collections import Counter

    from madsim_tpu_torch.engine import Engine, EngineConfig, FaultPlan
    from madsim_tpu_torch.engine.core import K_PAUSE, K_SKEW
    from madsim_tpu_torch.engine.replay import replay
    from madsim_tpu_torch.interop import tree_to_numpy
    from madsim_tpu_torch.models import RaftMachine, build_machine
    from madsim_tpu_torch.models.raft import ELECTION_SAFETY, LOG_MATCHING

    # card_vs_cpu_palette: both streams; v3 launches the megakernel at W = 18
    raft, out, states = RaftMachine(num_nodes=5, log_capacity=8), {}, {}
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
        if stream == 2:
            states["palette_v2"] = card.run_segment(card.init_batch(seeds), 96)
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
    d_eng = Engine(machine, dupvote_cfg)
    states["dupvote_replay"] = d_eng.run_segment(d_eng.init_batch(DUPVOTE_SEEDS[:1]), len(on_card.trace) // 2)

    # stream_palette: the dup-vote hunt at full width, through the entry points
    eng = palette_hunt_engine()
    machine = eng.machine
    state = eng.run_segment(eng.init_batch(np.arange(LANES, dtype=np.uint32)), 96)
    run = eng.make_stream_runner(batch=LANES, segment_steps=SEGMENT_STEPS)
    run(1)  # warm: one segment
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    res = run(2 * LANES, seed_start=LANES)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = dict(kernels.launches)
    for name in ("step_megakernel", "cov_flush"):
        if launches[name] <= 0:
            fail(f"the palette hunt never launched {name}")
    by_code = Counter(code for _, code in res["failing"])
    first = next((seed for seed, code in res["failing"] if code == ELECTION_SAFETY), None)
    if first is None or res["completed"] < 2 * LANES:
        fail(f"the palette hunt completed {res['completed']} seeds, failing by code {dict(by_code)}: no "
             f"ELECTION_SAFETY seed")
    t1 = time.perf_counter()
    before = dict(kernels.launches)
    on_card = replay(eng, first)
    t_replay = time.perf_counter() - t1
    pops = kernels.launches["pop_earliest"] - before["pop_earliest"]
    replay_steps = kernels.launches["step_megakernel"] - before["step_megakernel"]
    cpu_eng = palette_hunt_engine("cpu")
    on_cpu = replay(cpu_eng, first)
    bad = tree_diff(tree_to_numpy(on_card.state), tree_to_numpy(on_cpu.state))
    if on_card.fail_code != ELECTION_SAFETY or on_card.trace != on_cpu.trace or bad:
        fail(f"palette hunt seed {first}: the card replay gave {on_card.fail_code} and differs from the CPU's in "
             f"{bad[:8] or 'the trace'}")
    # seeds failing with another code are findings: each replays on the CPU
    # with the code the card gave
    others = [(seed, code) for seed, code in res["failing"] if code != ELECTION_SAFETY][:4]
    for seed, code in others:
        got = replay(cpu_eng, seed, trace=False)
        if got.fail_code != code:
            fail(f"palette hunt seed {seed} failed {code} on the card and {got.fail_code} on the CPU")
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
    return launches, states


def torn_hunt_engine(device=None):
    """The torn-snapshot hunt's engine: demo-tornsnapshot-raft under torn restarts."""
    from madsim_tpu_torch.engine import Engine, EngineConfig, FaultPlan
    from madsim_tpu_torch.models import build_machine

    return Engine(build_machine("demo-tornsnapshot-raft"),
                  EngineConfig(**TORN_HUNT, faults=FaultPlan(**TORN_FAULTS)), device=device)


def storage_phases(torch, np, kernels):
    """Phase 9: the storage kinds. card_vs_cpu_storage (the torn plan on
    TornSnapshotRaftCompact, heal-asym on honest Raft at Q = 48, honest
    raft-compact under every kind, each on both streams), then
    stream_torn (the torn-snapshot hunt at 8192 lanes). Returns the
    states and launch counts the new kernel shapes are timed at: the
    hunt's batch (8192 lanes, Q = 64, W = 11) with its buffers a flush
    period in, the soak's v3 batch (256 lanes, Q = 96, W = 31) and the
    hunt replay's lane (Q = 64)."""
    from collections import Counter

    from madsim_tpu_torch.engine import Engine, EngineConfig, FaultPlan
    from madsim_tpu_torch.engine.core import K_HEAL_ASYM, K_TORN
    from madsim_tpu_torch.engine.replay import replay
    from madsim_tpu_torch.interop import tree_to_numpy
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
                found["soak_state"] = card.run_segment(card.init_batch(seeds), 96)
                found["soak_launches"] = launches["step_megakernel"]
                found["soak_words"] = card._rng_layout.total_words
    emit({"phase": "card_vs_cpu_storage", **out})

    # stream_torn: the torn-snapshot hunt at full width, through the entry points
    eng = torn_hunt_engine()
    state = eng.run_segment(eng.init_batch(np.arange(LANES, dtype=np.uint32)), 96)
    run = eng.make_stream_runner(batch=LANES, segment_steps=SEGMENT_STEPS)
    run(1)  # warm: one segment
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    res = run(2 * LANES, seed_start=LANES)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = dict(kernels.launches)
    for name in ("step_megakernel", "cov_flush"):
        if launches[name] <= 0:
            fail(f"the torn hunt never launched {name}")
    by_code = Counter(code for _, code in res["failing"])
    if set(by_code) != {LOG_MATCHING} or res["completed"] < 2 * LANES:
        fail(f"the torn hunt completed {res['completed']} seeds, failing by code {dict(by_code)}: not "
             f"LOG_MATCHING alone")
    first = res["failing"][0][0]
    t1 = time.perf_counter()
    before = dict(kernels.launches)
    on_card = replay(eng, first)
    t_replay = time.perf_counter() - t1
    replay_launches = {k: kernels.launches[k] - before[k] for k in ("pop_earliest", "step_megakernel")}
    on_cpu = replay(torn_hunt_engine("cpu"), first)
    bad = tree_diff(tree_to_numpy(on_card.state), tree_to_numpy(on_cpu.state))
    if on_card.fail_code != LOG_MATCHING or on_cpu.fail_code != LOG_MATCHING or on_card.trace != on_cpu.trace or bad:
        fail(f"torn hunt seed {first}: the card replay gave {on_card.fail_code}, the CPU's {on_cpu.fail_code}, "
             f"differing in {bad[:8] or 'the trace'}")
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


def triage_phase(torch, np, kernels, eng):
    """Phase 10: what a user does with a found bug, on the card. The hunt
    (make_runner at 8192 lanes, TRIAGE_STEPS events, with 8 steps profiled
    with the ring on and off), the post-mortem (the first failing lanes'
    rings against the tails of their replays on the card, those replays
    against the CPU's), the shrink of the first failing seed on the card
    and on the CPU, the shrunk entry recorded on the card, added to a
    corpus file and checked and audited on the CPU (and one recorded on
    the CPU audited on the card), and the exports of the card's and the
    CPU's traces, byte for byte. Returns what `triage_kernels` and
    `pop_kernels` time: the hunt's state and launches, a replay's state
    and the post-mortem's launches."""
    import dataclasses
    import tempfile
    from collections import Counter

    from madsim_tpu_torch.engine import Engine, audit, corpus, trace_export
    from madsim_tpu_torch.engine.replay import replay
    from madsim_tpu_torch.engine.shrink import shrink
    from madsim_tpu_torch.models import build_machine
    from madsim_tpu_torch.models.etcd import LEASE_SAFETY

    cpu = triage_engine("cpu")
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
    emit({"phase": "triage", "hunt": hunt, "postmortem": postmortem, "shrink": shrunk, "corpus": corpus_line,
          "export": {"seed": seed, "bytes": sizes, "equal": True}})
    for _ in range(eng._cov_flush_every):
        state = eng.step_batch(state)  # a flush period of entries in the buffers
    shrunk_eng = Engine(eng.machine, dataclasses.replace(sr.shrunk, trace_ring=0, flight_recorder=True,
                                                         fr_digest_every=TRIAGE_DIGEST_EVERY))
    return {"hunt_state": state, "hunt_launches": hunt_launches, "words": eng._rng_layout.total_words,
            "replay_state": eng.run_segment(eng.init_batch([seed]), TRIAGE_STATE_STEPS),
            "replay_launches": postmortem_launches,
            # the corpus replays' shape: the shrunk config's lane, the recorder on
            "entry_state": shrunk_eng.run_segment(shrunk_eng.init_batch([seed]), TRIAGE_STATE_STEPS),
            "entry_words": shrunk_eng._rng_layout.total_words, "entry_launches": corpus_launches}


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


def time_kernel_shapes(kernels, dev, phase, steps, flushes):
    """Each megakernel shape (name, state, words, launches) and each
    flush (name, the coverage leaves, launches) against its twin on the
    state of the path that launches it, then timed there with its floor
    and bound; one `phase` line."""
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
    for k in out.values():
        k["bound_ms"], k["bound_by"] = bound(k["bytes"], k["ops"])
        k["launches_x_excess_ms"] = k["launches"] * (k["ms"] - k["bound_ms"])
    emit({"phase": phase, **out})


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


def main(argv=None):
    import torch

    args = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    args.add_argument("--against", action="append", default=[],
                      help="another csrc tree to time the lane-group kernels against (repeatable)")
    args = args.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke runs on the card", file=sys.stderr)
        return 2
    import numpy as np

    from madsim_tpu_torch.engine import Engine, EngineConfig, FaultPlan
    from madsim_tpu_torch.models import RaftMachine
    from madsim_tpu_torch.models.raft import LOG_MATCHING
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

    # 4b. the card against the CPU where lanes fail: the overcommit bug
    #     (COMMIT_TO_LOG_LEN) on seeds that hold its known failures, through
    #     run_batch (fail codes, digest trail) and a short stream (fail ring)
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
    kw = dict(batch=32, segment_steps=64, seed_start=OVERCOMMIT_SEEDS[0] - 40, max_steps=384)
    s_card, s_cpu = over_card.run_stream(64, **kw), over_cpu.run_stream(64, **kw)
    keys = ("completed", "failing", "infra", "abandoned", "seeds_consumed")
    bad = [k for k in keys if s_card[k] != s_cpu[k]]
    bad += [k for k in ("coverage", "flight_recorder") if s_card["stats"][k] != s_cpu["stats"][k]]
    if bad or (OVERCOMMIT_SEEDS[0], LOG_MATCHING) not in s_card["failing"]:
        fail(f"overcommit stream: card and CPU differ in {bad}, or seed {OVERCOMMIT_SEEDS[0]} was missed: "
             f"{s_card['failing']}")
    emit({"phase": "card_vs_cpu_failing", "lanes": len(seeds), "equal": True,
          "n_failed": int(on_card["failed"].sum()), "stream_failing": s_card["failing"]})

    # 5. the flagship stream, through the entry points a user calls
    run = eng.make_stream_runner(batch=LANES, segment_steps=SEGMENT_STEPS)
    run(1)  # warm: one segment
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

    # where a flagship step's time goes: a short profiler window
    emit({"phase": "profile", **profile_steps(eng, state, steps=8)})

    # 6. the split-chain stream, and the pop kernels on its inputs and the replay's
    v2_launches, replay_launches, v2_state, v2_eng, replay_state, corpus_states = split_chain_phases(
        torch, np, kernels)

    # 7. the delay-spike kind and the MVCC, S3 and gossip models
    _, hunt_state, model_states = delay_and_model_phases(torch, np, kernels, dev)

    # 8. the chaos palette: pause, skew, dup and strict restarts
    _, palette_states = palette_phases(torch, np, kernels)

    # 9. the storage kinds and the models raft-compact, paxos, etcd and group
    storage = storage_phases(torch, np, kernels)
    storage_kernels(kernels, dev, storage, palette_states)

    # 10. the triage path: the double-grant hunt, its post-mortem, shrink,
    #     corpus entry and export
    triage = triage_phase(torch, np, kernels, triage_eng)
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

    emit({"phase": "total", "seconds": round(time.perf_counter() - started, 3)})

    # 9. the kernels line
    emit({"kernels": [
        {"name": "step_megakernel", "route": "cuda", "source": "madsim_tpu_torch/ops/csrc/step_megakernel.cu",
         "replaces": "madsim_tpu/ops/pallas_pop.py:310", "launches": launches["step_megakernel"],
         "max_abs_err": s_err, "ms": s_ms, "plain_ms": s_plain, "bound_ms": s_bound[0],
         "bound_by": s_bound[1], "library_ms": None, "floor_ms": s_floor},
        {"name": "cov_flush", "route": "cuda", "source": "madsim_tpu_torch/ops/csrc/cov_flush.cu",
         "replaces": "madsim_tpu/ops/pallas_pop.py:408", "launches": launches["cov_flush"],
         "max_abs_err": c_err, "ms": c_ms, "plain_ms": c_plain, "bound_ms": c_bound[0],
         "bound_by": c_bound[1], "library_ms": None, "floor_ms": c_floor},
        # each at the shape where its launches run: pop_earliest's are the
        # single-lane replay's
        *({"name": name, "route": "cuda", "source": "madsim_tpu_torch/ops/csrc/pop_gather.cu",
           "replaces": replaces, "launches": n, "max_abs_err": k["err"], "ms": k["ms"],
           "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"], "bound_by": k["bound_by"], "library_ms": None,
           "floor_ms": k["floor_ms"], "lanes": k["lanes"]}
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
