"""The engine: the discrete-event loop as batched PyTorch code.

The port of `madsim_tpu/engine/core.py`. Thousands of independent seed
lanes advance in lockstep; every state tensor carries the lane dimension
first. Each event step runs a step-prefix kernel (`ops/kernels.py`) and
then the lane step below, in which the timer, message and fault
branches are computed for every lane and selected by event kind, and
every write is a masked select, so a frozen lane writes back its old
value and does not advance `step`. The prefix kernel is the step
megakernel (pop + gather + v3 RNG block + digest) on the counter-based
stream, and otherwise the pop + gather kernel, with the step's words
drawn (and the digest folded) in PyTorch: always so on the default
split-chain stream (`rng_stream=2`), whose key chain no kernel computes.

Design rules shared with the reference (the determinism contract):
  * integer virtual time (int32 microseconds), no float latency math;
  * Threefry RNG under the partitionable lowering (`ops/step_rng.py`);
  * fixed-shape everything; overflow = lane failure (code OVERFLOW).

The chaos palette's window, delivery and storage kinds run too: pause
windows defer a frozen node's events to its resume time (a time rewrite
of the popped slot after the prefix kernel, which knows nothing of
pauses), skew windows scale the node's timers, duplicates ride beside
their messages in the push order, strict restarts wipe what the
machine's `durable_spec` calls volatile, torn restarts damage durable
leaves as its `torn_spec` allows, and an asymmetric partition heals its
two directions at two times.

With `trace_ring > 0` each lane also keeps its last R popped events on
the device, for a post-mortem with no replay (`Engine.ring_trace`).

Configurations outside this slice raise NotImplementedError naming the
gate; nothing is silently ignored. The entry points run under
`torch.inference_mode()`: the engine is integer code with no gradients,
and the mode trims PyTorch's per-op dispatch cost, which is what an
eager step of a few thousand small ops pays for.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np
import torch

from .. import kinds as _kinds
from ..ops import u32
from ..ops.coverage import (
    COV_BAND_AMNESIA,
    COV_BAND_DUP,
    COV_BUFFER_DEFAULT,
    COV_SLOTS_LOG2_DEFAULT,
    cov_band,
    cov_fold_words,
    cov_push,
    cov_slot,
    empty_cov_map,
)
from ..ops.kernels import cov_flush_batch, pop_gather_batch, step_megakernel
from ..ops.step_rng import (
    RNG_STREAM_COUNTER, RNG_STREAM_LEGACY, RNG_STREAM_VERSIONS, layout_for, restart_key, step_words,
)
from ..ops.threefry import bits32, prng_key, split
from ..utils import take, tree_where
from .machine import TORN_CLASSES, Machine, state_leaf_names

# Event kinds
EV_TIMER = 0
EV_MSG = 1
EV_FAULT = 2

# Fault ops (payload[0]): apply = 2*kind, undo = apply + 1
F_CLOG_PAIR = 0
F_UNCLOG_PAIR = 1
F_KILL = 2
F_RESTART = 3
F_CLOG_DIR = 4
F_UNCLOG_DIR = 5
F_CLOG_GROUP = 6
F_UNCLOG_GROUP = 7
F_LOSS_STORM = 8
F_LOSS_END = 9
F_DELAY_SPIKE = 10
F_DELAY_END = 11
F_PAUSE = 12
F_RESUME = 13
F_SKEW = 14
F_SKEW_END = 15
F_TORN = 16
F_TORN_RESTART = 17
F_HASYM = 18
F_HASYM_HEAL = 19

# FaultPlan kind indices (op_apply = 2*kind)
K_PAIR = 0
K_KILL = 1
K_DIR = 2
K_GROUP = 3
K_STORM = 4
K_DELAY = 5
K_PAUSE = 6
K_SKEW = 7
K_TORN = 8
K_HEAL_ASYM = 9

# delay-spike windows: while one is active, DELAY_PROB_U32 / 2^32 (~10%)
# of sends take 1 to 5 virtual seconds more (the reference's numbers)
DELAY_PROB_U32 = int(0.1 * 0xFFFFFFFF)
DELAY_EXTRA_MIN_US = 1_000_000
DELAY_EXTRA_SPAN_US = 4_000_001

# message duplication (FaultPlan.allow_dup): ~10% of the messages pushed
# get a second copy with its own latency draw
DUP_PROB_U32 = int(0.1 * 0xFFFFFFFF)

# clock-skew factor: a q10 fixed-point timer multiplier drawn uniform in
# [SKEW_Q10_MIN, SKEW_Q10_MIN + SKEW_Q10_SPAN), 0.5x to 2.0x
SKEW_Q10_MIN = 512
SKEW_Q10_SPAN = 1536


def skew_scale_us(delay_us, q10):
    """Scale int32 delays by q10 factors exactly, in int32 as the
    reference does: (d >> 10) * q + (((d & 1023) * q) >> 10)."""
    d, q = delay_us.to(torch.int32), q10.to(torch.int32)
    return (d >> 10) * q + (((d & 1023) * q) >> 10)


# Failure codes
OK = 0
OVERFLOW = 1  # event queue full: lane aborts (an infrastructure artifact)

# Flight-recorder digest: IVs are pi's fractional bits, multipliers the
# golden-ratio Weyl constant and murmur3's fmix constant.
DIGEST_IV0 = 0x243F6A88
DIGEST_IV1 = 0x85A308D3
_DIGEST_M0 = 0x9E3779B1
_DIGEST_M1 = 0x85EBCA6B

FAULT_KIND_NAMES = _kinds.FAULT_KIND_NAMES
FR_EXTRA_NAMES = _kinds.FR_EXTRA_NAMES
FR_METRICS_LEN = len(FAULT_KIND_NAMES) + len(FR_EXTRA_NAMES) + 3

# Bit-packed clog rows: node j of row i lives in word j // 30, bit j % 30.
CLOG_WORD_BITS = 30
CLOG_WORDS = 2
CLOG_MAX_NODES = CLOG_WORD_BITS * CLOG_WORDS


def digest_fold(d0, d1, words):
    """One digest round per word (any int tensors [L], taken as their
    uint32 bit patterns): d0 takes an xor-multiply-xorshift, d1 a rotated
    xor-multiply and absorbs d0. Returns (d0, d1) as int64 uint32
    values. The two halves ride one [L, 2] tensor, so each round is one
    xor, one multiply and one xorshift for both, then d1 ^= d0."""
    w = u32.from_i32(torch.stack(list(words), dim=1))
    wr = torch.stack([w, u32.rotl(w, 13)], dim=2)  # [L, K, 2]
    m_lo = torch.tensor([_DIGEST_M0 & 0xFFFF, _DIGEST_M1 & 0xFFFF], device=w.device)
    m_hi = torch.tensor([_DIGEST_M0 >> 16, _DIGEST_M1 >> 16], device=w.device)
    shift = torch.tensor([16, 15], device=w.device)
    into_d1 = torch.tensor([0, u32.MASK], device=w.device)
    d = torch.stack([u32.from_i32(d0), u32.from_i32(d1)], dim=1)
    for x in wr.unbind(1):
        x = d ^ x
        d = (x * m_lo + (((x * m_hi) & 0xFFFF) << 16)) & u32.MASK  # u32.mul
        d = d ^ (d >> shift)
        d = d ^ (d[:, :1] & into_d1)
    return d[:, 0], d[:, 1]


def _clog_bit_words(j):
    """One-hot (lo, hi) int32 words for node indices j [L]."""
    one = torch.ones_like(j, dtype=torch.int32)
    lo = torch.where(j < CLOG_WORD_BITS,
                     torch.bitwise_left_shift(one, j.clamp(0, CLOG_WORD_BITS - 1).to(torch.int32)), 0)
    hi = torch.where(j >= CLOG_WORD_BITS,
                     torch.bitwise_left_shift(one, (j - CLOG_WORD_BITS).clamp(0, CLOG_WORD_BITS - 1).to(torch.int32)), 0)
    return lo, hi


def _clog_row_bools(row, n):
    """Expand packed rows int32[L, CLOG_WORDS] to bool[L, n] link flags."""
    ii = torch.arange(n, device=row.device)
    bits = torch.where(
        ii < CLOG_WORD_BITS,
        row[:, :1] >> ii.clamp(0, CLOG_WORD_BITS - 1),
        row[:, 1:] >> (ii - CLOG_WORD_BITS).clamp(0, CLOG_WORD_BITS - 1),
    )
    return (bits & 1).to(torch.bool)


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """Per-lane randomized fault schedule (drawn from the lane seed); the
    reference's fields and defaults. The port runs every kind: the
    partition (pair clog), kill/restart, directional clog, group
    partition, loss storm, delay-spike, pause, skew, torn-restart and
    asymmetric-heal kinds, under the v1 derivation (pair and kill only)
    or the v2 one (any other kind enabled; pause or skew take one more
    draw a fault, torn or heal_asym one more after it, and heal_asym a
    third slot a fault), and the two unscheduled gates: `allow_dup`
    (message duplication) and `strict_restart` (restarts wipe what
    `Machine.durable_spec` calls volatile)."""

    n_faults: int = 0
    allow_partition: bool = True
    allow_kill: bool = True
    allow_dir_clog: bool = False
    allow_group: bool = False
    allow_storm: bool = False
    allow_delay: bool = False
    allow_pause: bool = False
    allow_skew: bool = False
    allow_dup: bool = False
    allow_torn: bool = False
    allow_heal_asym: bool = False
    strict_restart: bool = False
    storm_loss_u16: int = 52428
    t_min_us: int = 0
    t_max_us: int = 1_000_000
    dur_min_us: int = 100_000
    dur_max_us: int = 1_000_000

    def enabled_kinds(self) -> tuple:
        flags = (
            self.allow_partition, self.allow_kill, self.allow_dir_clog, self.allow_group,
            self.allow_storm, self.allow_delay, self.allow_pause, self.allow_skew,
            self.allow_torn, self.allow_heal_asym,
        )
        return tuple(k for k, on in enumerate(flags) if on)

    @property
    def uses_v2_kinds(self) -> bool:
        return (
            self.allow_dir_clog or self.allow_group or self.allow_storm
            or self.allow_delay or self.uses_window_kinds or self.uses_storage_kinds
        )

    @property
    def uses_window_kinds(self) -> bool:
        return self.allow_pause or self.allow_skew

    @property
    def uses_storage_kinds(self) -> bool:
        return self.allow_torn or self.allow_heal_asym

    @property
    def slots_per_fault(self) -> int:
        return 3 if self.allow_heal_asym else 2


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Static engine parameters: the reference's fields and defaults."""

    horizon_us: int = 10_000_000
    queue_capacity: int = 64
    latency_min_us: int = 1_000
    latency_max_us: int = 10_000
    packet_loss_rate: float = 0.0
    handler_rand_words: int = 4
    faults: FaultPlan = dataclasses.field(default_factory=FaultPlan)
    trace_ring: int = 0
    rng_stream: int = RNG_STREAM_LEGACY
    clog_packed: bool = True
    flight_recorder: bool = False
    fr_digest_every: int = 64
    fr_digest_ring: int = 32
    coverage: bool = False
    cov_slots_log2: int = COV_SLOTS_LOG2_DEFAULT
    cov_band_bits_min: int = 0
    cov_buffer: int = COV_BUFFER_DEFAULT
    provenance: bool = False
    pallas_megakernel: Optional[bool] = None
    compile_cache_dir: Optional[str] = None


@dataclasses.dataclass
class LaneState:
    """Every leaf has the lane dimension first. uint32 words (rng_key,
    the digests, provenance words) are int32 bit patterns. `fr` and
    `cov` are {} when their gate is off, as in the reference."""

    now_us: torch.Tensor
    next_seq: torch.Tensor
    step: torch.Tensor
    rng_key: torch.Tensor  # [L, 2]
    done: torch.Tensor
    failed: torch.Tensor
    fail_code: torch.Tensor
    horizon_hit: torch.Tensor
    msg_count: torch.Tensor
    storm_loss: torch.Tensor
    delay_spike: torch.Tensor
    eq_time: torch.Tensor  # int32[L, Q]
    eq_seq: torch.Tensor
    eq_kind: torch.Tensor
    eq_node: torch.Tensor
    eq_src: torch.Tensor
    eq_payload: torch.Tensor  # int32[L, Q, P]
    eq_valid: torch.Tensor  # bool[L, Q]
    clogged: torch.Tensor  # int32[L, N, CLOG_WORDS]
    killed: torch.Tensor  # bool[L, N]
    paused_until: torch.Tensor  # int32[L, N] resume times ([L, 0] with the pause kind off)
    skew_q10: torch.Tensor  # int32[L, N] q10 timer factors ([L, 0] with the skew kind off)
    node_prov: torch.Tensor  # [L, 0] (provenance off)
    eq_prov: torch.Tensor  # [L, 0]
    fail_prov: torch.Tensor  # [L, 0]
    nodes: Any
    ring: Any  # the trace ring: step, time, kind, node, src [L, R], payload [L, R, P] ({} when off)
    fr: Any  # flight recorder: digest, checkpoint ring, metrics ({} when off)
    cov: Any  # coverage: {"map", "buf", "buf_n"} ({} when off)


@dataclasses.dataclass
class BatchResult:
    seeds: torch.Tensor  # int32 bit patterns of the uint32 seeds
    done: torch.Tensor
    failed: torch.Tensor
    fail_code: torch.Tensor
    fail_prov: torch.Tensor
    now_us: torch.Tensor
    steps: torch.Tensor
    msg_count: torch.Tensor
    summary: Any
    ring: Any
    fr: Any
    cov: Any


@dataclasses.dataclass
class StreamCarry:
    """Device-resident streaming state: lanes, seed counter, result rings.
    Seeds are int64 uint32 values; counts are int64."""

    state: LaneState
    seeds: torch.Tensor  # [L]
    done: torch.Tensor  # bool[L]: harvested, refilled at next segment start
    next_seed: torch.Tensor  # scalar
    completed: torch.Tensor
    segments: torch.Tensor
    fail_seeds: torch.Tensor  # [C]
    fail_codes: torch.Tensor  # [C]
    fail_count: torch.Tensor
    ab_seeds: torch.Tensor  # [C]
    ab_count: torch.Tensor
    counters: torch.Tensor  # [7]: completed, fail_count, ab_count, next_seed, over, segments, cov_slots_hit
    fr_metrics: torch.Tensor  # [FR_METRICS_LEN] ([0] with the recorder off)
    cov_map: torch.Tensor  # int32[W]: global OR of lane maps ([0] with coverage off)


def _unported(gate: str) -> NotImplementedError:
    return NotImplementedError(
        f"{gate} is not ported to madsim_tpu_torch yet (the port runs both "
        f"RNG streams, packed clogs, every fault kind, packet loss, "
        f"duplication, strict restarts, the trace ring, and the flight "
        f"recorder and buffered coverage on or off)"
    )


def resolve_device(device=None) -> torch.device:
    """The port runs on the card unless the caller asks for the CPU."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: madsim_tpu_torch runs on the card by default; "
                "pass device='cpu' to run on the CPU"
            )
        device = "cuda"
    return torch.device(device)


class Engine:
    """Bind a Machine + EngineConfig into batch and stream runners on one
    device (`device=None` means the CUDA card)."""

    def __init__(self, machine: Machine, config: EngineConfig = EngineConfig(), device=None):
        self.machine = machine
        self.config = config
        self._check_slice(config)
        self.device = resolve_device(device)
        n, q = machine.NUM_NODES, config.queue_capacity
        fp = config.faults
        if q < n + fp.slots_per_fault * fp.n_faults + machine.MAX_MSGS + machine.MAX_TIMERS:
            raise ValueError(
                f"queue_capacity={q} too small for {n} nodes + "
                f"{fp.n_faults} faults + outbox headroom"
            )
        if fp.n_faults > 0 and not fp.enabled_kinds():
            raise ValueError("FaultPlan has n_faults > 0 but every kind disabled")
        if fp.allow_group and not 2 <= n <= 60:
            raise ValueError("group partitions need 2 <= NUM_NODES <= 60 (two 30-bit mask words)")
        if not 0 <= fp.storm_loss_u16 <= 65535:
            raise ValueError("storm_loss_u16 must be in [0, 65535]")
        if n > CLOG_MAX_NODES:
            raise ValueError(f"clog_packed needs NUM_NODES <= {CLOG_MAX_NODES}")
        if config.flight_recorder and (config.fr_digest_every < 1 or config.fr_digest_ring < 1):
            raise ValueError("flight_recorder needs fr_digest_every >= 1 and fr_digest_ring >= 1")
        if fp.strict_restart and fp.allow_kill and machine.durable_spec() is None:
            raise ValueError(
                f"strict_restart (crash-with-amnesia) needs {type(machine).__name__}.durable_spec() "
                f"to declare the durable-state contract (which leaves survive restart)"
            )
        if fp.allow_torn:
            self._check_torn_contract(machine)
        if config.cov_band_bits_min not in (0, 3, 4):
            raise ValueError(f"cov_band_bits_min={config.cov_band_bits_min!r}: 0, 3 or 4")
        # the band field is 4 bits wide whenever a chaos-palette kind can
        # occur (the reference's layout v2), else 3
        palette = (fp.allow_pause or fp.allow_skew or fp.allow_dup or fp.strict_restart
                   or fp.allow_torn or fp.allow_heal_asym)
        self.cov_band_bits = max(config.cov_band_bits_min, 4 if palette else 3)
        if config.coverage and not self.cov_band_bits + 4 <= config.cov_slots_log2 <= 20:
            raise ValueError(f"coverage needs {self.cov_band_bits + 4} <= cov_slots_log2 <= 20")
        # the step-prefix kernel: the megakernel computes the v3 word
        # block, so it serves the counter-based stream only; None means
        # "whenever it can", as the reference's auto setting on its chip
        mk = config.pallas_megakernel
        if mk and config.rng_stream != RNG_STREAM_COUNTER:
            raise ValueError(
                "pallas_megakernel requires rng_stream=3 (the kernel computes the "
                "counter-based word block; v2's per-step key split-chain is not a counter)"
            )
        self.use_megakernel = config.rng_stream == RNG_STREAM_COUNTER and mk is not False
        self._rng_layout = layout_for(
            config.rng_stream,
            config.handler_rand_words,
            machine.MAX_MSGS,
            loss_possible=config.packet_loss_rate > 0 or fp.allow_storm,
            spike_possible=fp.allow_delay,
            delay_enabled=fp.allow_delay,
            # a torn restart re-inits through the machine as a kill
            # restart does, so it needs the restart key too
            restart_possible=fp.allow_kill or fp.allow_torn,
            dup_possible=fp.allow_dup,
            torn_possible=fp.allow_torn,
        )
        # a step appends the popped event's slot, and under dup the
        # synthetic dup-band slot, so flushing every cov_buffer //
        # slots_per_step iterations can never overflow the buffer
        slots_per_step = 2 if self._rng_layout.dup_active else 1
        if config.cov_buffer < 1 or config.cov_buffer > 1024:
            raise ValueError(f"cov_buffer={config.cov_buffer!r}: a depth in [{slots_per_step}, 1024]")
        if config.coverage and config.cov_buffer < slots_per_step:
            raise ValueError(
                f"cov_buffer={config.cov_buffer} is shallower than the {slots_per_step} slots one "
                f"step can append under this config (dup events add a synthetic band slot)"
            )
        self._cov_flush_every = config.cov_buffer // slots_per_step
        # the event kind of each of a step's pushes: messages (each
        # followed by its duplicate under dup), timers, the restart boot
        # (made once: a per-step host list would be a host-to-device
        # copy, and so a sync, inside the segment)
        self._push_kinds = torch.tensor(
            [EV_MSG] * (machine.MAX_MSGS * slots_per_step) + [EV_TIMER] * (machine.MAX_TIMERS + 1),
            dtype=torch.int32, device=self.device,
        )
        # the v2 fault derivation's kind table, made once for the same reason
        self._fault_kinds = torch.tensor(fp.enabled_kinds(), dtype=torch.int32, device=self.device)

    @staticmethod
    def _check_torn_contract(machine: Machine) -> None:
        """allow_torn needs the durable-state contract, and a torn_spec,
        when declared, of the same shape with a known class per leaf."""
        spec = machine.durable_spec()
        if spec is None:
            raise ValueError(
                f"allow_torn (torn/lost-write storage faults) needs {type(machine).__name__}.durable_spec() "
                f"to declare the durable-state contract the torn restart damages"
            )
        tspec = machine.torn_spec()
        if tspec is not None and (
            type(tspec) is not type(spec)
            or any(getattr(tspec, name) not in TORN_CLASSES for name in state_leaf_names(tspec))
        ):
            raise ValueError(
                f"{type(machine).__name__}.torn_spec() must be congruent to durable_spec() with every "
                f"leaf in {{TORN_ATOMIC, TORN_LOSE, TORN_PREFIX}}"
            )

    @staticmethod
    def _check_slice(cfg: EngineConfig) -> None:
        if cfg.rng_stream not in RNG_STREAM_VERSIONS:
            raise ValueError(f"rng_stream={cfg.rng_stream!r} unknown; supported: {RNG_STREAM_VERSIONS}")
        gates = [
            ("clog_packed=False", not cfg.clog_packed),
            ("provenance", cfg.provenance),
            ("cov_buffer=0", cfg.cov_buffer == 0),
            ("compile_cache_dir (a JAX compile cache)", cfg.compile_cache_dir is not None),
        ]
        for gate, hit in gates:
            if hit:
                raise _unported(gate)

    # -- lane init -----------------------------------------------------------

    def _seed_values(self, seeds) -> torch.Tensor:
        """Seeds as int64 uint32 values on the engine's device (an int32
        tensor is taken as bit patterns)."""
        if not isinstance(seeds, torch.Tensor):
            seeds = torch.as_tensor(np.asarray(seeds, dtype=np.uint32).astype(np.int64))
        return u32.from_i32(seeds.to(self.device))

    @torch.inference_mode()
    def init_batch(self, seeds) -> LaneState:
        """One fresh lane per uint32 seed: the reference's `init_lane`
        (v1 or v2 fault derivation), batched. With pause or skew on, each
        v2 fault takes one more split, after the high-mask split, for
        the skew factor: a pause's arg2 is its resume time, a skew's the
        factor. With torn or heal_asym on, one more split follows: a torn
        fault's arg2 is its damage mask, and under heal_asym every fault
        takes a third slot, the one-way heal b -> a at t + dur2, valid
        only for heal_asym faults."""
        m, cfg, dev = self.machine, self.config, self.device
        seeds = self._seed_values(seeds)
        lanes = seeds.shape[0]
        n, q, p = m.NUM_NODES, cfg.queue_capacity, m.PAYLOAD_WIDTH
        keys = split(prng_key(seeds), 3)
        key, k_init, k_faults = keys[:, 0], keys[:, 1], keys[:, 2]
        nodes = m.init(k_init)

        i32 = {"dtype": torch.int32, "device": dev}
        slots = torch.arange(q, **i32)
        is_boot = (slots < n).expand(lanes, q)
        eq_time = torch.zeros((lanes, q), **i32)
        eq_seq = torch.where(is_boot, slots, 0)
        eq_kind = torch.zeros((lanes, q), **i32)  # EV_TIMER
        eq_node = torch.where(is_boot, slots, 0)
        eq_src = torch.full((lanes, q), -1, **i32)
        eq_payload = torch.zeros((lanes, q, p), **i32)  # timer id BOOT
        eq_valid = is_boot.clone(memory_format=torch.contiguous_format)
        next_seq = n

        fp = cfg.faults
        for f in range(fp.n_faults):
            if not fp.uses_v2_kinds:
                # v1 derivation (partition/kill), byte-stable with the reference
                ks = split(k_faults, 6)
            else:
                # v2 derivation: uniform over the enabled kinds, every
                # argument drawn whatever the kind (a fixed draw count)
                ks = split(k_faults, 7)
            k_faults = ks[:, 0]
            draw = [bits32(ks[:, j]) for j in range(1, ks.shape[1])]
            t = (fp.t_min_us + draw[0] % (fp.t_max_us - fp.t_min_us)).to(torch.int32)
            dur = (fp.dur_min_us + draw[1] % (fp.dur_max_us - fp.dur_min_us)).to(torch.int32)
            a = (draw[2] % n).to(torch.int32)
            b = (a + 1 + (draw[3] % (n - 1)).to(torch.int32)) % n
            if not fp.uses_v2_kinds:
                if fp.allow_partition and fp.allow_kill:
                    is_part = draw[4] % 2 == 0
                else:
                    is_part = torch.full((lanes,), fp.allow_partition, dtype=torch.bool, device=dev)
                op_apply = torch.where(is_part, F_CLOG_PAIR, F_KILL).to(torch.int32)
                op_undo = torch.where(is_part, F_UNCLOG_PAIR, F_RESTART).to(torch.int32)
                arg1, arg2 = a, b
            else:
                kind = self._fault_kinds[draw[4] % self._fault_kinds.numel()]
                # group masks: arg1 carries node bits [0, 30), arg2 bits
                # [30, 60); the high word takes its own split, only for
                # machines of more than 30 nodes
                lo_bits = min(n, CLOG_WORD_BITS)
                mask_lo = 1 + (draw[5] % (2**lo_bits - 2)).to(torch.int32)
                if n > CLOG_WORD_BITS:
                    ks = split(k_faults, 2)
                    k_faults = ks[:, 0]
                    mask_hi = (bits32(ks[:, 1]) % 2 ** (n - CLOG_WORD_BITS)).to(torch.int32)
                else:
                    mask_hi = torch.zeros_like(mask_lo)
                op_apply = 2 * kind
                op_undo = op_apply + 1
                arg1 = torch.where(kind == K_GROUP, mask_lo,
                                   torch.where(kind == K_STORM, fp.storm_loss_u16, a)).to(torch.int32)
                arg2 = torch.where(kind == K_GROUP, mask_hi, b).to(torch.int32)
                if fp.uses_window_kinds:
                    ks = split(k_faults, 2)
                    k_faults = ks[:, 0]
                    skew_q10 = (SKEW_Q10_MIN + bits32(ks[:, 1]) % SKEW_Q10_SPAN).to(torch.int32)
                    arg2 = torch.where(kind == K_PAUSE, t + dur, torch.where(kind == K_SKEW, skew_q10, arg2))
                if fp.uses_storage_kinds:
                    # one word: a torn fault's damage mask (31 bits), and
                    # the second heal's duration of a heal_asym fault
                    ks = split(k_faults, 2)
                    k_faults = ks[:, 0]
                    storage_word = bits32(ks[:, 1])
                    arg2 = torch.where(kind == K_TORN, (storage_word & 0x7FFFFFFF).to(torch.int32), arg2)
                    dur2 = (fp.dur_min_us + storage_word % (fp.dur_max_us - fp.dur_min_us)).to(torch.int32)
            slot_events = [(t, op_apply, arg1, arg2, None), (t + dur, op_undo, arg1, arg2, None)]
            if fp.allow_heal_asym:
                heal = torch.full_like(a, F_HASYM_HEAL)
                slot_events.append((t + dur2, heal, b, a, kind == K_HEAL_ASYM))
            for slot_off, (tt, op, p1, p2, valid) in enumerate(slot_events):
                msk = (slots == n + fp.slots_per_fault * f + slot_off).expand(lanes, q)
                eq_time = torch.where(msk, tt[:, None], eq_time)
                eq_seq = torch.where(msk, next_seq + slot_off, eq_seq)
                eq_kind = torch.where(msk, EV_FAULT, eq_kind)
                eq_node = torch.where(msk, a[:, None], eq_node)
                pay = torch.stack([op, p1, p2] + [torch.zeros_like(a)] * (p - 3), dim=1)
                eq_payload = torch.where(msk[:, :, None], pay[:, None, :], eq_payload)
                eq_valid = eq_valid | (msk if valid is None else msk & valid[:, None])
            next_seq += fp.slots_per_fault

        def full(value, dtype=torch.int32):
            return torch.full((lanes,), value, dtype=dtype, device=dev)

        empty = torch.zeros((lanes, 0), **i32)
        per_node = torch.zeros((lanes, n), **i32)
        return LaneState(
            now_us=full(0),
            next_seq=full(next_seq),
            step=full(0),
            rng_key=u32.to_i32(key),
            done=full(False, torch.bool),
            failed=full(False, torch.bool),
            fail_code=full(OK),
            horizon_hit=full(False, torch.bool),
            msg_count=full(0),
            storm_loss=full(0),
            delay_spike=full(0),
            eq_time=eq_time,
            eq_seq=eq_seq,
            eq_kind=eq_kind,
            eq_node=eq_node,
            eq_src=eq_src,
            eq_payload=eq_payload,
            eq_valid=eq_valid,
            clogged=torch.zeros((lanes, n, CLOG_WORDS), **i32),
            killed=torch.zeros((lanes, n), dtype=torch.bool, device=dev),
            paused_until=per_node if fp.allow_pause else empty,
            skew_q10=per_node.clone() if fp.allow_skew else empty,
            node_prov=empty,
            eq_prov=empty,
            fail_prov=empty,
            nodes=nodes,
            ring=self._empty_ring(lanes),
            fr=self._empty_fr(eq_valid),
            cov=self._empty_cov(lanes),
        )

    def _empty_fr(self, eq_valid):
        """Digest at its IV, empty checkpoint ring (step -1), zeroed
        metrics; `eq_n` starts at the initial queue occupancy. {} with
        the recorder off."""
        if not self.config.flight_recorder:
            return {}
        lanes, dev, r = eq_valid.shape[0], self.device, self.config.fr_digest_ring
        i32 = {"dtype": torch.int32, "device": dev}
        zero = torch.zeros(lanes, **i32)

        def word(value):
            return u32.to_i32(torch.full((lanes,), value, dtype=torch.int64, device=dev))

        return {
            "d0": word(DIGEST_IV0),
            "d1": word(DIGEST_IV1),
            "eq_n": eq_valid.sum(dim=1, dtype=torch.int32),
            "ck_step": torch.full((lanes, r), -1, **i32),
            "ck_d0": torch.zeros((lanes, r), **i32),
            "ck_d1": torch.zeros((lanes, r), **i32),
            "inj": torch.zeros((lanes, len(FAULT_KIND_NAMES)), **i32),
            "dup": zero,
            "amnesia": zero,
            "q_hwm": zero,
            "clog_hwm": zero,
            "kill_hwm": zero,
        }

    def _empty_ring(self, lanes: int):
        """The on-device trace ring of the last `trace_ring` popped events
        (step -1 marks an unused slot); {} with the ring off."""
        r = self.config.trace_ring
        if not r:
            return {}
        i32 = {"dtype": torch.int32, "device": self.device}
        zero = torch.zeros((lanes, r), **i32)
        return {
            "step": torch.full((lanes, r), -1, **i32),
            "time": zero,
            "kind": zero,
            "node": zero,
            "src": zero,
            "payload": torch.zeros((lanes, r, self.machine.PAYLOAD_WIDTH), **i32),
        }

    def _empty_cov(self, lanes: int):
        """Zeroed hit map plus the per-lane slot buffer and its count; {}
        with coverage off."""
        cfg = self.config
        if not cfg.coverage:
            return {}
        return {
            "map": empty_cov_map(lanes, cfg.cov_slots_log2, self.device),
            "buf": torch.zeros((lanes, cfg.cov_buffer), dtype=torch.int32, device=self.device),
            "buf_n": torch.zeros(lanes, dtype=torch.int32, device=self.device),
        }

    # -- one event per lane --------------------------------------------------

    def _lane_step_popped(self, s: LaneState, idx, any_valid, popped, payload, words, k_restart,
                          new_key, digest, active, running=None) -> LaneState:
        """The step after the step-prefix kernel, for every lane at once.
        `popped` is (time, kind, node, src)[L] and `payload` [L, P] from
        the kernel; `words` [L, W], `k_restart` [L, 2] and `new_key`
        [L, 2] are the step's draw (int64 uint32 values); `digest` is
        the folded (nd0, nd1) [L] as int32 bit patterns, or None with
        the recorder off. `active` [L] folds the per-lane freeze into
        every write mask; `running` (a scalar bool tensor) gates the
        coverage buffer write the way the reference's early-exit loop
        does."""
        m, cfg, layout = self.machine, self.config, self._rng_layout
        fp = cfg.faults
        lanes, q = s.eq_valid.shape
        n = m.NUM_NODES
        dev = s.eq_valid.device
        ev_time, ev_kind, ev_node, ev_src = popped
        op = payload[:, 0]

        new_now = torch.maximum(s.now_us, ev_time)
        live = any_valid & active
        horizon_hit = live & (new_now >= cfg.horizon_us)
        process = live & ~horizon_hit
        node_alive = ~take(s.killed, ev_node)
        # pause windows: a handler event whose (alive) target is paused
        # past now is deferred: its slot stays valid and only its time
        # moves to the resume point, below. Kill still dominates. The
        # deferred pop is still a popped event (digest, coverage, trace).
        at_idx = torch.arange(q, device=dev) == idx.to(torch.int64)[:, None]
        popped_slot = at_idx & live[:, None]
        defer = None
        if fp.allow_pause:
            node_resume_us = take(s.paused_until, ev_node)
            defer = process & (ev_kind != EV_FAULT) & node_alive & (node_resume_us > new_now)
            popped_slot = popped_slot & ~defer[:, None]
        eq_valid = s.eq_valid & ~popped_slot

        # the on-device trace ring: every popped event, processed or not
        # (the replay trace's condition), at slot step % R. It takes the
        # gathered time: a pause deferral rewrites only the queue slot.
        ring = s.ring
        if cfg.trace_ring:
            at = (torch.arange(cfg.trace_ring, device=dev) == (s.step % cfg.trace_ring)[:, None]) & live[:, None]
            ring = {
                "step": torch.where(at, s.step[:, None], ring["step"]),
                "time": torch.where(at, ev_time[:, None], ring["time"]),
                "kind": torch.where(at, ev_kind[:, None], ring["kind"]),
                "node": torch.where(at, ev_node[:, None], ring["node"]),
                "src": torch.where(at, ev_src[:, None], ring["src"]),
                "payload": torch.where(at[:, :, None], payload[:, None, :], ring["payload"]),
            }
        rand_u32 = words[:, : layout.handler_words]
        rng_key = s.rng_key
        if layout.version == RNG_STREAM_LEGACY:
            # v2's key evolves every step: a frozen lane keeps its own
            rng_key = torch.where(active[:, None], u32.to_i32(new_key), s.rng_key)

        # the three branches, for every lane; selected by event kind
        t_nodes, t_out = m.on_timer(s.nodes, ev_node, op, new_now, rand_u32)
        m_nodes, m_out = m.on_message(s.nodes, ev_node, ev_src, payload, new_now, rand_u32)
        f_nodes, f_clogged, f_killed, f_storm, f_delay, f_paused, f_skew, f_boot = self._fault_branch(
            s, payload, words, k_restart)
        branch = ev_kind.clamp(0, 2)
        is_fault = branch == EV_FAULT
        nodes = tree_where(branch == EV_TIMER, t_nodes, tree_where(is_fault, f_nodes, m_nodes))
        outbox = tree_where(branch == EV_TIMER, t_out, tree_where(is_fault, m.empty_outbox(lanes, dev), m_out))

        # killed nodes process nothing; fault events always apply;
        # deferred events re-deliver at their node's resume time
        effective = process & (node_alive | (ev_kind == EV_FAULT))
        if defer is not None:
            effective = effective & ~defer
        nodes = tree_where(effective, nodes, s.nodes)
        fault_applies = is_fault & effective
        clogged = torch.where(fault_applies[:, None, None], f_clogged, s.clogged)
        killed = torch.where(fault_applies[:, None], f_killed, s.killed)
        storm_loss = torch.where(fault_applies, f_storm, s.storm_loss)
        delay_spike = torch.where(fault_applies, f_delay, s.delay_spike) if layout.spike_active else s.delay_spike
        paused_until = torch.where(fault_applies[:, None], f_paused, s.paused_until) if fp.allow_pause \
            else s.paused_until
        skew_q10 = torch.where(fault_applies[:, None], f_skew, s.skew_q10) if fp.allow_skew else s.skew_q10
        boot_node = torch.where(is_fault, f_boot, -1)
        msg_valid = outbox.msg_valid & effective[:, None]
        timer_valid = outbox.timer_valid & effective[:, None]

        # -- push messages (latency / loss / clog), timers, the restart boot
        lat_span = max(1, cfg.latency_max_us - cfg.latency_min_us)
        lat_bits = words[:, layout.lat_off : layout.lat_off + m.MAX_MSGS]
        # the handling node's outbound clog row (pre-fault state)
        blocked = take(_clog_row_bools(take(s.clogged, ev_node), n), outbox.msg_dst)
        if layout.loss_active:
            # static loss rate plus the active storm's (rate 65535 ~ drop
            # all), the sum saturating at the top of the uint32 range
            drop_bits = words[:, layout.drop_off : layout.drop_off + m.MAX_MSGS]
            storm_threshold = u32.mul(storm_loss.to(torch.int64), 65537)
            summed = (int(cfg.packet_loss_rate * 0xFFFFFFFF) + storm_threshold) & u32.MASK
            loss_threshold = torch.where(summed < storm_threshold, u32.MASK, summed)
            blocked = blocked | (drop_bits < loss_threshold[:, None])
        latency = cfg.latency_min_us + (lat_bits % lat_span).to(torch.int32)
        if layout.spike_active:
            # in a delay-spike window ~10% of sends take +1-5 virtual s; the
            # gate and magnitude are independent words, drawn every step
            spike_bits = words[:, layout.spike_off : layout.spike_off + m.MAX_MSGS]
            mag_bits = words[:, layout.spike_off + m.MAX_MSGS : layout.spike_off + 2 * m.MAX_MSGS]
            spiked = (delay_spike > 0)[:, None] & (spike_bits < DELAY_PROB_U32)
            extra = DELAY_EXTRA_MIN_US + (mag_bits % DELAY_EXTRA_SPAN_US).to(torch.int32)
            latency = latency + torch.where(spiked, extra, 0)
        node_col = ev_node[:, None]
        msg_want = msg_valid & ~blocked
        msg_time = new_now[:, None] + latency
        msg_dst, msg_src, msg_pay = outbox.msg_dst, node_col.expand(-1, m.MAX_MSGS), outbox.msg_payload
        if layout.dup_active:
            # each pushed message has a ~10% chance of a second copy with
            # its own latency draw (no delay spike). The reference pushes
            # message i, then its copy, then message i + 1, so the copies'
            # columns interleave: [m0, d0, m1, d1, ...]. Ranks are
            # monotone, so a copy of a message that did not fit does not
            # fit either, and the lane's overflow is the reference's.
            dup_bits = words[:, layout.dup_off : layout.dup_off + m.MAX_MSGS]
            dup_lat_bits = words[:, layout.dup_off + m.MAX_MSGS : layout.dup_off + 2 * m.MAX_MSGS]
            dup_want = msg_want & (dup_bits < DUP_PROB_U32)
            dup_time = new_now[:, None] + cfg.latency_min_us + (dup_lat_bits % lat_span).to(torch.int32)

            def pair(x, y):
                return torch.stack([x, y], dim=2).flatten(1, 2)

            msg_want, msg_time = pair(msg_want, dup_want), pair(msg_time, dup_time)
            msg_dst, msg_src = pair(msg_dst, msg_dst), pair(msg_src, msg_src)
            msg_pay = pair(msg_pay, msg_pay)
        timer_delay = outbox.timer_delay_us
        if fp.allow_skew:
            # a skew window scales every timer the handling node arms by
            # its factor (pre-step: handler events never change skew, and
            # fault events arm no timers)
            node_skew = take(s.skew_q10, ev_node)[:, None]
            timer_delay = torch.where(node_skew > 0, skew_scale_us(timer_delay, node_skew), timer_delay)
        timer_pay = torch.zeros((lanes, m.MAX_TIMERS, payload.shape[1]), dtype=torch.int32, device=dev)
        timer_pay[:, :, 0] = outbox.timer_id
        n_msg_cols = msg_want.shape[1]
        pushes = {
            "want": torch.cat([msg_want, timer_valid, (effective & (boot_node >= 0))[:, None]], 1),
            "time": torch.cat([msg_time, new_now[:, None] + timer_delay, new_now[:, None]], 1),
            "kind": self._push_kinds,
            "node": torch.cat([msg_dst, node_col.expand(-1, m.MAX_TIMERS), boot_node[:, None]], 1),
            "src": torch.cat([msg_src, torch.full((lanes, m.MAX_TIMERS + 1), -1, dtype=torch.int32, device=dev)], 1),
            "payload": torch.cat([msg_pay, timer_pay, torch.zeros_like(timer_pay[:, :1])], 1),
        }
        eq_time = s.eq_time
        if defer is not None:
            # the deferred slot stays valid with its seq; its time becomes
            # the node's resume time, where it races the resume event only
            # by (time, seq), as in the reference. It takes no free slot.
            eq_time = torch.where(at_idx & defer[:, None], node_resume_us[:, None], eq_time)
        eq, pushed, overflow = _push_all(
            {"time": eq_time, "seq": s.eq_seq, "kind": s.eq_kind, "node": s.eq_node,
             "src": s.eq_src, "payload": s.eq_payload, "valid": eq_valid},
            s.next_seq, pushes,
        )
        next_seq = s.next_seq + pushed.sum(dim=1, dtype=torch.int32)
        msg_count = s.msg_count + pushed[:, :n_msg_cols].sum(dim=1, dtype=torch.int32)
        n_dups = pushed[:, 1:n_msg_cols:2].sum(dim=1, dtype=torch.int32) if layout.dup_active else None
        failed = s.failed | overflow
        fail_code = torch.where(overflow, OVERFLOW, s.fail_code)
        new_step = s.step + active.to(torch.int32)

        # -- flight recorder ------------------------------------------------
        fr = s.fr
        if cfg.flight_recorder:
            nd0, nd1 = digest
            d0 = torch.where(live, nd0, fr["d0"])
            d1 = torch.where(live, nd1, fr["d1"])
            every, rr = cfg.fr_digest_every, cfg.fr_digest_ring
            want_ck = active & (new_step % every == 0)
            ring_at = (torch.div(new_step, every, rounding_mode="floor") - 1) % rr
            ck_slot = (ring_at[:, None] == torch.arange(rr, device=dev)) & want_ck[:, None]
            is_inj = process & (ev_kind == EV_FAULT) & (op % 2 == 0)
            kind_idx = torch.div(op, 2, rounding_mode="floor")
            inj = fr["inj"] + (
                (torch.arange(len(FAULT_KIND_NAMES), device=dev) == kind_idx[:, None]) & is_inj[:, None]
            ).to(torch.int32)
            # unscheduled chaos: duplicates pushed, strict restarts processed
            fr_dup = fr["dup"] + n_dups if n_dups is not None else fr["dup"]
            fr_amnesia = fr["amnesia"]
            if fp.strict_restart:
                fr_amnesia = fr_amnesia + (process & (ev_kind == EV_FAULT) & (op == F_RESTART)).to(torch.int32)
            # occupancy: a deferred pop leaves its slot valid
            popped_one = live if defer is None else live & ~defer
            eq_n = fr["eq_n"] - popped_one.to(torch.int32) + (next_seq - s.next_seq)
            n_clog = u32.popcount(clogged).sum(dim=(1, 2), dtype=torch.int32)
            fr = {
                "d0": d0,
                "d1": d1,
                "eq_n": eq_n,
                "ck_step": torch.where(ck_slot, new_step[:, None], fr["ck_step"]),
                "ck_d0": torch.where(ck_slot, d0[:, None], fr["ck_d0"]),
                "ck_d1": torch.where(ck_slot, d1[:, None], fr["ck_d1"]),
                "inj": inj,
                "dup": fr_dup,
                "amnesia": fr_amnesia,
                "q_hwm": torch.maximum(fr["q_hwm"], eq_n),
                "clog_hwm": torch.maximum(fr["clog_hwm"], n_clog),
                "kill_hwm": torch.maximum(fr["kill_hwm"], killed.sum(dim=1, dtype=torch.int32)),
            }

        # -- scenario coverage (buffered) -----------------------------------
        cov = s.cov
        if cfg.coverage:
            abs_word = m.coverage_projection(nodes, new_now)
            ctx = (
                killed.sum(dim=1, dtype=torch.int32).clamp(0, 7)
                | ((clogged != 0).flatten(1).any(dim=1).to(torch.int32) << 3)
                | ((storm_loss > 0).to(torch.int32) << 4)
                | ((delay_spike > 0).to(torch.int32) << 5)
            )
            # the window kinds' context bits, only when their kind is on
            if fp.allow_pause:
                ctx = ctx | ((paused_until > 0).any(dim=1).to(torch.int32) << 6)
            if fp.allow_skew:
                ctx = ctx | ((skew_q10 > 0).any(dim=1).to(torch.int32) << 7)
            op_word = torch.where(ev_kind == EV_TIMER, 0, op)
            band = cov_band(ev_kind, op_word, self.cov_band_bits)
            if fp.strict_restart:
                band = torch.where((ev_kind == EV_FAULT) & (op == F_RESTART), COV_BAND_AMNESIA, band)
            slot = cov_slot(abs_word, ev_kind, ev_node, op_word, ctx, cfg.cov_slots_log2,
                            band_bits=self.cov_band_bits, band=band)
            buf, buf_n = cov_push(cov["buf"], cov["buf_n"], slot, live, write=running)
            if n_dups is not None:
                # the synthetic dup band: a step that pushed a duplicate
                dup_slot = cov_slot(abs_word, ev_kind, ev_node, n_dups, ctx, cfg.cov_slots_log2,
                                    band_bits=self.cov_band_bits,
                                    band=torch.full_like(band, COV_BAND_DUP))
                buf, buf_n = cov_push(buf, buf_n, dup_slot, live & (n_dups > 0), write=running)
            cov = dict(cov, buf=buf, buf_n=buf_n)

        # -- invariants / termination ---------------------------------------
        ok, code = m.invariant(nodes, new_now)
        inv_fail = process & ~ok
        failed = failed | inv_fail
        fail_code = torch.where(inv_fail, code, fail_code)
        done = s.done | (active & ~any_valid) | horizon_hit | (active & m.is_done(nodes, new_now))

        return LaneState(
            now_us=torch.where(active, new_now, s.now_us),
            next_seq=next_seq,
            step=new_step,
            rng_key=rng_key,
            done=done,
            failed=failed,
            fail_code=fail_code,
            horizon_hit=s.horizon_hit | horizon_hit,
            msg_count=msg_count,
            storm_loss=storm_loss,
            delay_spike=delay_spike,
            eq_time=eq["time"],
            eq_seq=eq["seq"],
            eq_kind=eq["kind"],
            eq_node=eq["node"],
            eq_src=eq["src"],
            eq_payload=eq["payload"],
            eq_valid=eq["valid"],
            clogged=clogged,
            killed=killed,
            paused_until=paused_until,
            skew_q10=skew_q10,
            node_prov=s.node_prov,
            eq_prov=s.eq_prov,
            fail_prov=s.fail_prov,
            nodes=nodes,
            ring=ring,
            fr=fr,
            cov=cov,
        )

    def _fault_branch(self, s: LaneState, payload, words, k_restart):
        """The fault ops on the packed clog rows (pair, directional and
        group clogs and their undos, the asymmetric partition's clog and
        its two one-way heals), kill and restart (strict under
        `strict_restart`), the torn kill and restart, the loss storm, the
        delay-spike window and the pause and skew windows of node `a`,
        for every lane (the caller selects fault lanes). Returns (nodes,
        clogged, killed, storm_loss, delay_spike, paused_until, skew_q10,
        boot_node)."""
        fp = self.config.faults
        n = self.machine.NUM_NODES
        op, a, b = payload[:, 0], payload[:, 1], payload[:, 2]
        col = lambda x: x[:, None]  # noqa: E731
        idxs = torch.arange(n, device=op.device)
        w0, w1 = s.clogged[:, :, 0], s.clogged[:, :, 1]

        def apply_bit(w0, w1, row_mask, bit_lo, bit_hi, val, touch):
            msk = col(touch) & row_mask
            nw0 = torch.where(col(val), w0 | col(bit_lo), w0 & ~col(bit_lo))
            nw1 = torch.where(col(val), w1 | col(bit_hi), w1 & ~col(bit_hi))
            return torch.where(msk, nw0, w0), torch.where(msk, nw1, w1)

        a_lo, a_hi = _clog_bit_words(a)
        b_lo, b_hi = _clog_bit_words(b)
        a_row, b_row = idxs == col(a), idxs == col(b)
        # pair partition: both directions
        pair_val = op == F_CLOG_PAIR
        touch_pair = pair_val | (op == F_UNCLOG_PAIR)
        dir_val = op == F_CLOG_DIR
        touch_dir = dir_val | (op == F_UNCLOG_DIR)
        if fp.allow_heal_asym:
            # the asymmetric partition clogs the pair both ways; each heal
            # unclogs the one direction a -> b as a directional undo
            pair_val = pair_val | (op == F_HASYM)
            touch_pair = touch_pair | (op == F_HASYM)
            touch_dir = touch_dir | (op == F_HASYM_HEAL)
        w0, w1 = apply_bit(w0, w1, a_row, b_lo, b_hi, pair_val, touch_pair)
        w0, w1 = apply_bit(w0, w1, b_row, a_lo, a_hi, pair_val, touch_pair)
        # directional clog: a -> b only
        w0, w1 = apply_bit(w0, w1, a_row, b_lo, b_hi, dir_val, touch_dir)
        # group partition: `a` holds member bits [0, 30), `b` bits [30, 60);
        # a member's cross links are the group's complement, an outsider's
        # the group (a node's own bit lands on neither side)
        in_g = torch.where(
            idxs < CLOG_WORD_BITS,
            col(a) >> idxs.clamp(0, CLOG_WORD_BITS - 1),
            col(b) >> (idxs - CLOG_WORD_BITS).clamp(0, CLOG_WORD_BITS - 1),
        ) & 1 == 1
        full_lo = (1 << min(n, CLOG_WORD_BITS)) - 1
        full_hi = (1 << max(n - CLOG_WORD_BITS, 0)) - 1
        cross_lo = torch.where(in_g, ~col(a) & full_lo, col(a) & full_lo)
        cross_hi = torch.where(in_g, ~col(b) & full_hi, col(b) & full_hi)
        g_on = col(op == F_CLOG_GROUP)
        touch_group = col((op == F_CLOG_GROUP) | (op == F_UNCLOG_GROUP))
        w0 = torch.where(touch_group, torch.where(g_on, w0 | cross_lo, w0 & ~cross_lo), w0)
        w1 = torch.where(touch_group, torch.where(g_on, w1 | cross_hi, w1 & ~cross_hi), w1)
        clogged = torch.stack([w0, w1], dim=2)
        kill_op, restart_op = op == F_KILL, op == F_RESTART
        if fp.allow_torn:
            # a torn fault is a kill whose restart damages storage
            kill_op = kill_op | (op == F_TORN)
            restart_op = restart_op | (op == F_TORN_RESTART)
        killed = torch.where(
            col(kill_op), s.killed | a_row,
            torch.where(col(restart_op), s.killed & ~a_row, s.killed),
        )
        # loss storm: `a` is the storm's loss rate in 1/65536
        storm = torch.where(op == F_LOSS_STORM, a, torch.where(op == F_LOSS_END, 0, s.storm_loss))
        # delay-spike window; with the kind off the flag stays 0, and the
        # eager step skips its kernels
        delay = s.delay_spike
        if self._rng_layout.spike_active:
            delay = torch.where(op == F_DELAY_SPIKE, 1, torch.where(op == F_DELAY_END, 0, delay)).to(torch.int32)
        # pause window: arg2 (`b`) is the resume time; skew: the factor
        paused = s.paused_until
        if fp.allow_pause:
            paused = torch.where(col(op == F_PAUSE) & a_row, col(b),
                                 torch.where(col(op == F_RESUME) & a_row, 0, paused))
        skew = s.skew_q10
        if fp.allow_skew:
            skew = torch.where(col(op == F_SKEW) & a_row, col(b),
                               torch.where(col(op == F_SKEW_END) & a_row, 0, skew))
        nodes = self.machine.restart_node_if(s.nodes, a, op == F_RESTART, k_restart, strict=fp.strict_restart)
        if fp.allow_torn:
            # the damage seed: the schedule's mask salted by the step's torn word
            torn_seed = u32.from_i32(b) ^ words[:, self._rng_layout.torn_off]
            nodes = self.machine.torn_restart_if(nodes, a, op == F_TORN_RESTART, k_restart, torn_seed)
        boot_node = torch.where(restart_op, a, -1)
        return nodes, clogged, killed, storm.to(torch.int32), delay, paused, skew, boot_node

    # -- batch runners -------------------------------------------------------

    @torch.inference_mode()
    def step_batch(self, state: LaneState, running=None) -> LaneState:
        """One event step for every lane: the step-prefix kernel, then
        the lane step. Frozen lanes (done or failed) write back their
        state. The megakernel computes pop, gather, the v3 words and the
        digest in one pass; otherwise the pop + gather kernel runs and
        the words are drawn, and the digest folded, here."""
        active = ~(state.done | state.failed)
        fr_on, layout = self.config.flight_recorder, self._rng_layout
        queue = (state.eq_time, state.eq_seq, state.eq_valid, state.eq_kind, state.eq_node,
                 state.eq_src, state.eq_payload)
        if self.use_megakernel:
            idx, any_valid, popped, payload, words, digest = step_megakernel(
                *queue, state.rng_key, state.step, layout.total_words,
                d0=state.fr["d0"] if fr_on else None, d1=state.fr["d1"] if fr_on else None,
            )
            words = u32.from_i32(words)
            k_restart = restart_key(words, layout)
            new_key = None  # the v3 lane key is immutable
        else:
            idx, any_valid, popped, payload = pop_gather_batch(*queue)
            new_key, words, k_restart = step_words(state.rng_key, state.step, layout)
            digest = ()
            if fr_on:
                folded = list(popped) + list(payload.unbind(1)) + list(words.unbind(1))
                digest = tuple(u32.to_i32(d) for d in digest_fold(state.fr["d0"], state.fr["d1"], folded))
        return self._lane_step_popped(state, idx, any_valid, popped, payload, words, k_restart,
                                      new_key, digest or None, active, running)

    def _cov_flush_batch(self, state: LaneState) -> LaneState:
        """Fold every lane's buffered slots into its map and reset the
        live counts; stale buffer entries stay, as in the reference. The
        map is updated in place: `run_segment` hands it a map the segment
        owns."""
        cov = state.cov
        new_map = cov_flush_batch(cov["map"], cov["buf"], cov["buf_n"])
        return dataclasses.replace(state, cov=dict(cov, map=new_map, buf_n=torch.zeros_like(cov["buf_n"])))

    @torch.inference_mode()
    def run_segment(self, state: LaneState, segment_steps: int) -> LaneState:
        """Advance the batch `segment_steps` event steps, with no host
        sync inside. The reference stops early once every lane is frozen;
        here the loop runs its full length, which changes nothing: a
        frozen lane writes back every field and does not advance `step`,
        and `running` stops the one write a frozen lane still makes (its
        coverage-buffer tail). With coverage on, the buffer folds into
        the map every `cov_buffer` iterations and, unconditionally, at
        exit.

        The flush updates the coverage map in place, so the segment first
        takes its own copy: the caller's `state` is left as it was, and
        running twice from one kept state gives equal results."""
        if not self.config.coverage:
            for _ in range(segment_steps):
                state = self.step_batch(state)
            return state
        state = dataclasses.replace(state, cov=dict(state.cov, map=state.cov["map"].clone()))
        for it in range(1, segment_steps + 1):
            running = (~(state.done | state.failed)).any()
            state = self.step_batch(state, running)
            if it % self._cov_flush_every == 0:
                state = self._cov_flush_batch(state)
        return self._cov_flush_batch(state)

    @torch.inference_mode()
    def run_batch(self, seeds, max_steps: int = 10_000) -> BatchResult:
        """Run every seed lane to completion (or max_steps events/lane).
        Between chunks of whole flush periods the host checks whether any
        lane is still live and stops when none is: the chunk boundaries
        fall on the flush cadence, so the result equals one
        `run_segment(state, max_steps)`."""
        state = self.init_batch(seeds)
        every = self._cov_flush_every if self.config.coverage else 1
        chunk = every * max(1, 128 // every)
        done_steps = 0
        while done_steps < max_steps:
            k = min(chunk, max_steps - done_steps)
            state = self.run_segment(state, k)
            done_steps += k
            if not bool((~(state.done | state.failed)).any()):
                break
        return BatchResult(
            seeds=u32.to_i32(self._seed_values(seeds)),
            done=state.done,
            failed=state.failed,
            fail_code=state.fail_code,
            fail_prov=state.fail_prov,
            now_us=state.now_us,
            steps=state.step,
            msg_count=state.msg_count,
            summary=self.machine.summary(state.nodes),
            ring=state.ring,
            fr=state.fr,
            cov=state.cov,
        )

    # -- the stream executor --------------------------------------------------

    def _init_carry(self, seeds: torch.Tensor, cap: int) -> StreamCarry:
        dev, cfg = self.device, self.config
        i64 = {"dtype": torch.int64, "device": dev}
        zero = torch.zeros((), **i64)
        c = StreamCarry(
            state=self.init_batch(seeds),
            seeds=seeds,
            done=torch.zeros(seeds.shape[0], dtype=torch.bool, device=dev),
            next_seed=(seeds[-1] + 1) & u32.MASK,
            completed=zero,
            segments=zero,
            fail_seeds=torch.zeros(cap, **i64),
            fail_codes=torch.zeros(cap, **i64),
            fail_count=zero,
            ab_seeds=torch.zeros(cap, **i64),
            ab_count=zero,
            counters=torch.zeros(7, **i64),
            # gate off: a zero-length leaf, as in the reference
            fr_metrics=torch.zeros(FR_METRICS_LEN if cfg.flight_recorder else 0, **i64),
            cov_map=(empty_cov_map(1, cfg.cov_slots_log2, dev)[0] if cfg.coverage
                     else torch.zeros(0, dtype=torch.int32, device=dev)),
        )
        return _with_counters(c, cap)

    def _segment(self, c: StreamCarry, segment_steps: int, max_steps: int, cap: int) -> StreamCarry:
        """Refill harvested lanes, advance one segment, harvest: all on
        the device, no host sync."""
        # 1. refill lanes harvested at the end of the previous segment
        #    (cumsum ranks + the device seed counter: gapless, in lane order)
        ranks = torch.cumsum(c.done.to(torch.int64), dim=0) - 1
        fresh_seeds = (c.next_seed + ranks) & u32.MASK
        state = tree_where(c.done, self.init_batch(fresh_seeds), c.state)
        seeds = torch.where(c.done, fresh_seeds, c.seeds)
        next_seed = (c.next_seed + c.done.sum()) & u32.MASK

        # 2. advance the batch one segment
        state = self.run_segment(state, segment_steps)

        # 3. harvest: count completions, ring-append failing seeds/codes
        #    and abandoned (over-cap) seeds
        over_cap = state.step >= max_steps
        done = state.done | state.failed | over_cap
        fail_mask = done & state.failed
        fail_seeds, fail_count = _append_ring(c.fail_seeds, c.fail_count, fail_mask, seeds, cap)
        fail_codes, _ = _append_ring(c.fail_codes, c.fail_count, fail_mask, state.fail_code.to(torch.int64), cap)
        ab_mask = done & ~state.failed & over_cap
        ab_seeds, ab_count = _append_ring(c.ab_seeds, c.ab_count, ab_mask, seeds, cap)

        # flight-recorder totals of the lanes finishing this segment
        fr_metrics = c.fr_metrics
        if self.config.flight_recorder:
            frs, nk, ne = state.fr, len(FAULT_KIND_NAMES), len(FR_EXTRA_NAMES)
            done_i = done.to(torch.int64)
            inj_tot = fr_metrics[:nk] + (frs["inj"].to(torch.int64) * done_i[:, None]).sum(dim=0)
            extra_tot = torch.stack([
                fr_metrics[nk + i] + (frs[k].to(torch.int64) * done_i).sum()
                for i, k in enumerate(FR_EXTRA_NAMES)
            ])
            hwm = torch.stack([
                torch.maximum(fr_metrics[nk + ne + i], torch.where(done, frs[k], 0).amax().to(torch.int64))
                for i, k in enumerate(("q_hwm", "clog_hwm", "kill_hwm"))
            ])
            fr_metrics = torch.cat([inj_tot, extra_tot, hwm])
        # every lane's map, done or not: maps only gain bits
        cov_map = c.cov_map
        if self.config.coverage:
            cov_map = cov_map | cov_fold_words(state.cov["map"])
        new = StreamCarry(
            state=state,
            seeds=seeds,
            done=done,
            next_seed=next_seed,
            completed=c.completed + done.sum(),
            segments=c.segments + 1,
            fail_seeds=fail_seeds,
            fail_codes=fail_codes,
            fail_count=fail_count,
            ab_seeds=ab_seeds,
            ab_count=ab_count,
            counters=c.counters,
            fr_metrics=fr_metrics,
            cov_map=cov_map,
        )
        return _with_counters(new, cap)

    @torch.inference_mode()
    def run_stream(
        self,
        n_seeds: int,
        batch: int = 1024,
        segment_steps: int = 256,
        seed_start: int = 0,
        max_steps: int = 10_000,
        mesh=None,
        pipelined: bool = False,
    ) -> dict:
        """Continuous seed streaming: run at least n_seeds simulations,
        keeping every lane busy. Each segment (refill, advance, harvest)
        is device work; the host reads one small `counters` tensor per
        segment and drains the failing/abandoned rings when they near
        capacity. Seeds [seed_start, seed_start + seeds_consumed) enter
        lanes in order; lanes past `max_steps` events are abandoned.

        Returns the reference's dict: {"completed", "failing": [(seed,
        code)...], "infra": [(seed, code)...] (OVERFLOW lanes),
        "abandoned": [seed...], "seeds_consumed", "stats": {host_syncs,
        drains, dispatches, device_segments, ..., "flight_recorder" (with
        the recorder on), "coverage" (with coverage on)}, "coverage_map"
        (with coverage on)}."""
        from ..runtime.coverage import coverage_dict, unpack_map
        from ..runtime.metrics import fr_metrics_dict

        if mesh is not None:
            raise _unported("run_stream(mesh=...)")
        if pipelined:
            raise _unported("run_stream(pipelined=True)")
        cap = 2 * batch
        drain_mark = cap - batch
        seeds = torch.arange(seed_start, seed_start + batch, dtype=torch.int64, device=self.device) & u32.MASK
        carry = self._init_carry(seeds, cap)
        failing, infra, abandoned, cov_curve = [], [], [], []
        stats = {"host_syncs": 0, "drains": 0, "dispatches": 0, "dispatch_retries": 0}

        def poll(c):
            counters = c.counters.cpu().numpy()  # the one blocking read per segment
            stats["host_syncs"] += 1
            if counters[4]:
                raise RuntimeError("run_stream result ring overflowed (drain policy bug)")
            cov_curve.append((int(counters[0]), int(counters[6])))
            return counters

        def drain(c):
            rings = torch.cat([
                c.fail_seeds, c.fail_codes, c.ab_seeds, c.fail_count[None], c.ab_count[None],
            ]).cpu().numpy()
            stats["drains"] += 1
            stats["host_syncs"] += 1
            f_n, a_n = int(rings[-2]), int(rings[-1])
            for s_, code in zip(rings[:f_n], rings[cap : cap + f_n]):
                (infra if int(code) == OVERFLOW else failing).append((int(s_), int(code)))
            abandoned.extend(int(s_) for s_ in rings[2 * cap : 2 * cap + a_n])
            zero = torch.zeros_like(c.fail_count)
            return _with_counters(dataclasses.replace(c, fail_count=zero, ab_count=zero), cap)

        completed = 0
        max_segments = (max_steps // segment_steps + 2) * (n_seeds // batch + 2)
        while completed < n_seeds and stats["dispatches"] < max_segments:
            carry = self._segment(carry, segment_steps, max_steps, cap)
            stats["dispatches"] += 1
            counters = poll(carry)
            completed = int(counters[0])
            if int(counters[1]) > drain_mark or int(counters[2]) > drain_mark:
                carry = drain(carry)
        counters = poll(carry)
        carry = drain(carry)
        out = {
            "completed": int(counters[0]),
            "failing": failing,
            "infra": infra,
            "abandoned": abandoned,
            "seeds_consumed": int(counters[3]) - seed_start,
            "stats": {
                **stats,
                "device_segments": int(counters[5]),
                "dispatch_depth": 1,
                "segments_per_dispatch": 1,
                "pipelined": False,
            },
        }
        if self.config.flight_recorder:
            out["stats"]["flight_recorder"] = fr_metrics_dict(carry.fr_metrics.cpu().numpy())
        if self.config.coverage:
            cov_map = unpack_map(carry.cov_map.cpu().numpy(), self.config.cov_slots_log2)
            out["stats"]["coverage"] = {
                **coverage_dict(cov_map, self.config.cov_slots_log2, band_bits=self.cov_band_bits),
                "curve": cov_curve,
            }
            out["coverage_map"] = cov_map
        return out

    def make_stream_runner(self, batch: int = 1024, segment_steps: int = 256,
                           max_steps: int = 10_000, **stream_kwargs):
        """A configured `(n_seeds, seed_start=0) -> run_stream dict`."""

        def run(n_seeds: int, seed_start: int = 0):
            return self.run_stream(
                n_seeds, batch=batch, segment_steps=segment_steps,
                seed_start=seed_start, max_steps=max_steps, **stream_kwargs,
            )

        return run

    # -- triage: what a user does with a found bug ---------------------------

    def make_runner(self, max_steps: int = 10_000, mesh=None):
        """A `seeds -> BatchResult` callable over `run_batch`."""
        if mesh is not None:
            raise _unported("make_runner(mesh=...)")

        def run(seeds):
            return self.run_batch(seeds, max_steps=max_steps)

        return run

    @staticmethod
    def failing_seeds(result: BatchResult) -> torch.Tensor:
        """The failing lanes' seeds, as uint32 values (int64)."""
        return u32.from_i32(result.seeds[result.failed])

    def ring_trace(self, result: BatchResult, lane: int):
        """Lane `lane`'s on-device event ring as TraceEvents, oldest first
        (its last `config.trace_ring` popped events): a post-mortem with
        no replay. Needs `trace_ring > 0`."""
        from .replay import decode_ring

        if not self.config.trace_ring:
            raise ValueError("engine built with trace_ring=0: no ring recorded")
        return decode_ring({k: v[lane] for k, v in result.ring.items()})

    def digest_checkpoints(self, result: BatchResult, lane: int):
        """Lane `lane`'s digest checkpoint ring as (step, d0, d1) tuples,
        oldest first. Needs `flight_recorder=True`."""
        from .audit import decode_checkpoint_ring

        if not self.config.flight_recorder:
            raise ValueError("engine built with flight_recorder=False: no digests recorded")
        return decode_checkpoint_ring({k: v[lane] for k, v in result.fr.items()})

    def check_determinism(self, seeds, max_steps: int = 10_000) -> BatchResult:
        """Run the batch twice and require equal results leaf by leaf:
        the engine's counterpart of `Runtime.check_determinism`
        (madsim/src/sim/runtime/mod.rs:178-203). It catches a machine
        that smuggles host state (a Python counter, a host RNG) into its
        handlers. Raises NonDeterminism naming the leaves that differ."""
        from ..errors import NonDeterminism

        r1 = self.run_batch(seeds, max_steps=max_steps)
        r2 = self.run_batch(seeds, max_steps=max_steps)
        mismatches = [path for (path, a), (_, b) in zip(_leaves(r1), _leaves(r2))
                      if a.shape != b.shape or not bool((a == b).all())]
        if mismatches:
            raise NonDeterminism(
                f"the engine gave different results for identical seed batches; "
                f"diverging leaves: {mismatches}"
            )
        return r1


def _leaves(tree, path=""):
    """(path, tensor) of every leaf of a result tree, the path written as
    `jax.tree_util.keystr` writes it (`.field`, `['key']`)."""
    if dataclasses.is_dataclass(tree):
        for f in dataclasses.fields(tree):
            yield from _leaves(getattr(tree, f.name), f"{path}.{f.name}")
    elif isinstance(tree, dict):
        for k, v in sorted(tree.items()):
            yield from _leaves(v, f"{path}[{k!r}]")
    else:
        yield path, tree


def _push_all(eq, next_seq, pushes):
    """All of a step's event pushes at once. The reference pushes one
    event at a time into the first free slot, counting a push that finds
    no free slot as an overflow; so push k, if it fits, lands in the
    free slot of rank prior_k (the number of wanted pushes before it),
    gets seq next_seq + prior_k, and fits iff prior_k < the number of
    free slots. `pushes` holds [L, K] columns want/time/node/src, the
    [K] event kinds and payload [L, K, P]. Returns (eq, pushed [L, K],
    overflow [L])."""
    want = pushes["want"]
    free = ~eq["valid"]
    prior = torch.cumsum(want.to(torch.int32), dim=1) - want.to(torch.int32)
    fits = prior < free.sum(dim=1, dtype=torch.int32)[:, None]
    pushed = want & fits
    free_rank = torch.cumsum(free.to(torch.int32), dim=1) - 1
    lands = pushed[:, :, None] & free[:, None, :] & (free_rank[:, None, :] == prior[:, :, None])  # [L, K, Q]
    hit = lands.any(dim=1)
    k_at = (lands.to(torch.int64) * torch.arange(want.shape[1], device=want.device)[None, :, None]).sum(dim=1)
    kinds = pushes["kind"].expand_as(prior)
    cols = torch.stack([pushes["time"], next_seq[:, None] + prior, kinds, pushes["node"], pushes["src"]], dim=2)
    at = k_at[:, :, None]
    vals = torch.take_along_dim(cols.to(torch.int32), at, dim=1)  # [L, Q, 5]
    pay = torch.take_along_dim(pushes["payload"], at, dim=1)  # [L, Q, P]
    out = {k: torch.where(hit, vals[:, :, i], eq[k]) for i, k in enumerate(("time", "seq", "kind", "node", "src"))}
    out["payload"] = torch.where(hit[:, :, None], pay.to(torch.int32), eq["payload"])
    out["valid"] = eq["valid"] | hit
    return out, pushed, (want & ~fits).any(dim=1)


def _append_ring(buf, count, mask, values, cap: int):
    """Scatter-free ordered append: the masked lane of rank r (in lane
    order) lands at ring slot count + r; slot j's source lane is found
    with searchsorted on the mask's inclusive cumsum. Entries past
    capacity are dropped (the host's drain policy keeps that
    unreachable)."""
    csum = torch.cumsum(mask.to(torch.int64), dim=0)
    n_new = csum[-1]
    want_rank = torch.arange(cap, device=buf.device, dtype=torch.int64) - count + 1
    src = torch.searchsorted(csum, want_rank, side="left")
    fills = (want_rank >= 1) & (want_rank <= n_new)
    vals = values[src.clamp(0, mask.shape[0] - 1)]
    return torch.where(fills, vals, buf), count + n_new


def _with_counters(c: StreamCarry, cap: int) -> StreamCarry:
    over = (c.fail_count > cap) | (c.ab_count > cap)
    cov_hit = u32.popcount(c.cov_map).sum()
    counters = torch.stack([
        c.completed, c.fail_count, c.ab_count, c.next_seed, over.to(torch.int64),
        c.segments, cov_hit.to(torch.int64),
    ])
    return dataclasses.replace(c, counters=counters)

