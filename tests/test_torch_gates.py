"""The configuration gates the port has lifted, each held against the
JAX package: `run_batch` of the flagship hunt with one override (the
split-chain stream, packet loss, the recorder or coverage off, the step
megakernel off, the on-device trace ring, the dir, group, storm, delay, pause, skew, torn and
heal-asym fault kinds, message duplication and strict restarts) must give the reference's whole
`BatchResult`. The ids are the gates' names, as
`test_unported_gates_raise` named them while they were closed. Then the
chaos palette's own checks (tests/test_step_gates.py): strict restarts
leave honest Raft bit for bit as it was, every palette capability is
live and observable in its own 4-bit coverage band on both streams with
the megakernel on and off, the 4-bit band needs one more slot bit, and
the coverage buffer under dup holds two slots a step."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from madsim_tpu.models import raft as jax_raft
from madsim_tpu_torch.interop import tree_to_numpy
from madsim_tpu_torch.models import raft

from torch_port_util import FLAGSHIP, FLAGSHIP_FAULTS, engines, jax_to_numpy, tree_diff

LIFTED = [
    ("rng_stream=2", dict(rng_stream=2)),
    ("packet_loss_rate>0", dict(packet_loss_rate=0.01)),
    ("coverage=False", dict(coverage=False)),
    ("flight_recorder=False", dict(flight_recorder=False)),
    ("pallas_megakernel=False", dict(pallas_megakernel=False)),
    ("trace_ring>0", dict(trace_ring=16)),
    ("strict_restart", dict(faults={**FLAGSHIP_FAULTS, "strict_restart": True})),
] + [
    (f"FaultPlan.{flag}", dict(faults={**FLAGSHIP_FAULTS, flag: True}))
    for flag in ("allow_dir_clog", "allow_group", "allow_storm", "allow_delay", "allow_pause", "allow_skew",
                 "allow_dup", "allow_torn", "allow_heal_asym")
]
# the recorder counter each chaos gate must move: a kind's injections
# (its index in `fr["inj"]`), or the dup / amnesia counter
MOVES = {"FaultPlan.allow_dir_clog": 2, "FaultPlan.allow_group": 3, "FaultPlan.allow_storm": 4,
         "FaultPlan.allow_delay": 5, "FaultPlan.allow_pause": 6, "FaultPlan.allow_skew": 7,
         "FaultPlan.allow_dup": "dup", "strict_restart": "amnesia", "FaultPlan.allow_torn": 8,
         "FaultPlan.allow_heal_asym": 9}


@pytest.mark.parametrize("gate,overrides", LIFTED, ids=[g for g, _ in LIFTED])
def test_lifted_gates_match_jax(gate, overrides):
    jax_eng, port = engines(jax_raft.RaftMachine(5, 8), raft.RaftMachine(5, 8), **overrides)
    seeds = np.arange(24, dtype=np.uint32) + 77
    want = jax.jit(jax_eng.run_batch, static_argnums=1)(jnp.asarray(seeds), 256)
    got = port.run_batch(seeds, 256)
    diff = tree_diff(jax_to_numpy(want), tree_to_numpy(got))
    assert not diff, diff[:5]
    if gate in MOVES:
        moved = MOVES[gate]
        count = np.asarray(want.fr["inj"])[:, moved] if isinstance(moved, int) else np.asarray(want.fr[moved])
        assert count.sum() > 0, gate  # the chaos happened
        assert port.cov_band_bits == (4 if moved in (6, 7, 8, 9, "dup", "amnesia") else 3)
    assert port.use_megakernel == (gate not in ("rng_stream=2", "pallas_megakernel=False"))


def test_megakernel_is_refused_on_the_split_chain_stream():
    from madsim_tpu_torch.engine import Engine, EngineConfig

    with pytest.raises(ValueError, match="rng_stream=3"):
        Engine(raft.RaftMachine(5, 8), EngineConfig(rng_stream=2, pallas_megakernel=True), device="cpu")
    assert Engine(raft.RaftMachine(5, 8), EngineConfig(rng_stream=3), device="cpu").use_megakernel


def _port(**overrides):
    from madsim_tpu_torch.engine import Engine, EngineConfig, FaultPlan

    kw = {**FLAGSHIP, **overrides}
    faults = kw.pop("faults", FLAGSHIP_FAULTS)
    return Engine(raft.RaftMachine(5, 8), EngineConfig(faults=FaultPlan(**faults), **kw), device="cpu")


def test_strict_restart_gate_bit_identical():
    """Honest Raft's durable_spec is its restart hook's own contract, so
    strict restarts on or off give the same lanes bit for bit under kill
    and restart chaos; only the recorder's amnesia counter (strict
    restarts processed) tells them apart."""
    bench_like = dict(horizon_us=2_000_000, queue_capacity=32, coverage=False,
                      faults=dict(n_faults=2, t_max_us=1_500_000, dur_min_us=100_000, dur_max_us=600_000))
    seeds = np.arange(32, dtype=np.uint32)
    off = tree_to_numpy(_port(**bench_like).run_batch(seeds, 600))
    on = tree_to_numpy(_port(**{**bench_like, "faults": {**bench_like["faults"], "strict_restart": True}})
                       .run_batch(seeds, 600))
    assert on["fr"].pop("amnesia").sum() > 0 and off["fr"].pop("amnesia").sum() == 0
    assert not tree_diff(off, on)


# FULL_CHAOS of tests/test_step_gates.py (every fault kind the port runs,
# packet loss) with the palette on: queue headroom for the deliveries a
# pause parks in their slots, a small digest ring, a 2^12-slot map
PALETTE = dict(
    horizon_us=2_000_000, queue_capacity=96, packet_loss_rate=0.01, fr_digest_every=64, fr_digest_ring=4,
    cov_slots_log2=12,
    faults=dict(n_faults=3, t_max_us=1_500_000, dur_min_us=100_000, dur_max_us=600_000, allow_dir_clog=True,
                allow_group=True, allow_storm=True, allow_delay=True, allow_pause=True, allow_skew=True,
                allow_dup=True, strict_restart=True),
)


@pytest.fixture(scope="module")
def palette_jax():
    """The JAX package's run of the palette on each stream."""
    out = {}
    for stream in (2, 3):
        jax_eng, _ = engines(jax_raft.RaftMachine(5, 8), raft.RaftMachine(5, 8), rng_stream=stream, **PALETTE)
        assert jax_eng.cov_band_bits == 4
        out[stream] = jax.jit(jax_eng.run_batch, static_argnums=1)(jnp.arange(24, dtype=jnp.uint32) + 900, 400)
    return out


@pytest.mark.parametrize("stream,megakernel", [(2, None), (3, True), (3, False)],
                         ids=["rng_stream=2", "rng_stream=3-megakernel", "rng_stream=3-no-megakernel"])
def test_new_chaos_kinds_live_and_observable(palette_jax, stream, megakernel):
    """The palette on at once over every kind the port runs, recorder and
    coverage on: the port equals the JAX package, honest Raft stays
    clean, and pause, skew, dup and strict restarts each show in their
    counters and in their own band of the 4-bit coverage layout."""
    from madsim_tpu_torch.engine.core import K_PAUSE, K_SKEW
    from madsim_tpu_torch.runtime.coverage import coverage_dict, unpack_map

    want = palette_jax[stream]
    port = _port(rng_stream=stream, pallas_megakernel=megakernel, **PALETTE)
    assert port.cov_band_bits == 4 and port.use_megakernel == bool(megakernel)
    got = port.run_batch(np.arange(24, dtype=np.uint32) + 900, 400)
    diff = tree_diff(jax_to_numpy(want), tree_to_numpy(got))
    assert not diff, diff[:5]
    assert not bool(got.failed.any()), set(got.fail_code.tolist())
    inj = got.fr["inj"].sum(dim=0).tolist()
    assert inj[K_PAUSE] > 0 and inj[K_SKEW] > 0, inj
    assert int(got.fr["dup"].sum()) > 0 and int(got.fr["amnesia"].sum()) > 0
    lane_maps = unpack_map(got.cov["map"].numpy(), 12)
    bands = coverage_dict(lane_maps.any(axis=0), 12, band_bits=4)["by_band"]
    for band in ("pause", "skew", "dup", "amnesia"):
        assert bands[band] > 0, (band, bands)


def test_coverage_band4_needs_one_more_slot_bit():
    """Any palette gate widens the band to 4 bits, so the smallest map
    grows from 2^7 to 2^8 slots; the band names are the reference's."""
    from madsim_tpu.runtime.coverage import band_names as jax_band_names
    from madsim_tpu_torch.runtime.coverage import band_names

    for gate in ("allow_pause", "allow_skew", "allow_dup", "strict_restart", "allow_torn", "allow_heal_asym"):
        faults = {**FLAGSHIP_FAULTS, gate: True}
        with pytest.raises(ValueError, match="cov_slots_log2"):
            _port(cov_slots_log2=7, faults=faults)
        assert _port(cov_slots_log2=8, faults=faults).cov_band_bits == 4
    assert _port(cov_slots_log2=7).cov_band_bits == 3
    assert band_names(3) == jax_band_names(3) and band_names(4) == jax_band_names(4)


@pytest.mark.parametrize("cov_buffer", [1, 2, 3, 16])
def test_cov_buffer_under_dup(cov_buffer):
    """A step under dup appends up to two slots, so a one-slot buffer is
    refused and the flush runs every cov_buffer // 2 steps; run_batch,
    which cuts its chunks on that cadence, equals the JAX package's at
    each depth."""
    faults = {**FLAGSHIP_FAULTS, "allow_dup": True}
    if cov_buffer == 1:
        with pytest.raises(ValueError, match="cov_buffer"):
            _port(cov_buffer=1, faults=faults)
        return
    jax_eng, port = engines(jax_raft.RaftMachine(5, 8), raft.RaftMachine(5, 8), cov_buffer=cov_buffer,
                            faults=faults)
    assert port._cov_flush_every == cov_buffer // 2 == jax_eng._cov_flush_every
    seeds = np.arange(12, dtype=np.uint32) + 40
    want = jax.jit(jax_eng.run_batch, static_argnums=1)(jnp.asarray(seeds), 200)
    got = port.run_batch(seeds, 200)
    diff = tree_diff(jax_to_numpy(want), tree_to_numpy(got))
    assert not diff, diff[:5]
    assert int(got.fr["dup"].sum()) > 0
