"""The port's guided search (`madsim_tpu_torch/search`,
`Engine.run_seed_batch`) held against the JAX package's, mirroring
tests/test_search.py case by case:

 1. the deterministic mutator — the pinned avalanche constants, equal
    to the JAX package's values;
 2. the bias state — the hand-computed weight updates, exact
    persistence round trips and the escalation ladder, each equal to
    the JAX package's;
 3. selection — `_select_batch` pure over stubbed features, and the
    seed vector it picks with the real features equal to the JAX
    package's on the same (bias, parents, seen, cursor);
 4. the engine half on the CPU — schedule features equal to the
    provenance derivation and to the JAX package's (child seeds past
    2**31 included), `run_seed_batch` equal to `run_stream` and, dict
    for dict, to the JAX package's (the per-lane int32 coverage words
    and the dup-bit provenance words included), the escalated engines.

Then the guided loop's cell-grid plateau climbing the escalation
ladder, trail for trail the JAX package's; its resume and refusals are
in tests/test_torch_search_guided.py. The fleet worker replacement of
tests/test_search.py:465 is in tests/test_torch_fleet_workers.py, where
the job moves between the JAX package's worker and the port's.
"""

import json
from types import SimpleNamespace

import numpy as np
import pytest

import madsim_tpu.search.bias as jax_bias
import madsim_tpu.search.mutate as jax_mutate
from madsim_tpu_torch.kinds import CLI_KIND_TO_FLAG, FAULT_KIND_NAMES
from madsim_tpu_torch.search import mutate
from madsim_tpu_torch.search.bias import (
    ESCALATION_LADDER,
    THIN_GAIN,
    BiasState,
    band_fractions_from_coverage,
    next_escalation,
    vocabulary_for,
)

from torch_port_util import guided_engines

CLI_NAMES = tuple(n for n, _f in CLI_KIND_TO_FLAG)


# -- mutator: pinned avalanche constants --------------------------------------


def test_mix32_pinned_constants():
    """Golden: these values key every recorded guided seed schedule."""
    assert mutate.mix32(0, 0) == 2462723854
    assert mutate.mix32(1, 0) == 2527132011
    assert mutate.mix32(1234, 0) == 1889054206
    assert mutate.mix32(0xFFFFFFFF, 7) == 1650816001
    for x, salt in ((0, 0), (5, 3), (0xDEADBEEF, 11), (0xFFFFFFFF, 0)):
        assert mutate.mix32(x, salt) == jax_mutate.mix32(x, salt)


def test_child_seed_pinned_and_nonzero():
    assert mutate.child_seed(42, 0, 1, 0, 0) == 2911220862
    assert mutate.child_seed(42, 1, 1, 0, 0) == 3470864384
    assert mutate.child_seed(42, 2, 3, 5, 1) == 3353176113
    # the full coordinate tuple matters: op / batch / slot / candidate
    # all fork the stream
    base = mutate.child_seed(7, 0, 1, 0, 0)
    assert mutate.child_seed(7, 1, 1, 0, 0) != base
    assert mutate.child_seed(7, 0, 2, 0, 0) != base
    assert mutate.child_seed(7, 0, 1, 1, 0) != base
    assert mutate.child_seed(7, 0, 1, 0, 1) != base
    # never 0 (the sequential-scan origin), always uint32
    for p in (0, 1, 42, 0xFFFFFFFF):
        for op in (0, 1, 2):
            s = mutate.child_seed(p, op, 0, 0, 0)
            assert 1 <= s <= 0xFFFFFFFF
            assert s == jax_mutate.child_seed(p, op, 0, 0, 0)


def test_children_deterministic_operator_major():
    got = mutate.children(42, 2, 1)
    assert got == [(0, 3815504888), (1, 3647677267), (2, 58310815)]
    assert got == mutate.children(42, 2, 1)  # pure
    assert mutate.children(9, 4, 3, per_op=2) == jax_mutate.children(9, 4, 3, per_op=2)


def test_classify_child_labels():
    p = {"kinds": [0, 1], "t_apply": [10, 20], "targets": [1, 2]}
    assert mutate.classify_child(p, {**p, "kinds": [1, 1]}) == "kind-flip"
    assert mutate.classify_child(p, {**p, "t_apply": [11, 20]}) == "delay-nudge"
    assert mutate.classify_child(p, {**p, "targets": [2, 2]}) == "target-rotate"
    assert mutate.classify_child(p, dict(p)) == "target-rotate"
    assert mutate.OP_NAMES == jax_mutate.OP_NAMES


# -- escalation ladder --------------------------------------------------------


def test_ladder_binds_kinds_and_widens():
    assert ESCALATION_LADDER[0] == FAULT_KIND_NAMES[:6]
    assert ESCALATION_LADDER[1] == FAULT_KIND_NAMES[:8]
    assert ESCALATION_LADDER[2] == FAULT_KIND_NAMES[:10]
    assert ESCALATION_LADDER[3] == FAULT_KIND_NAMES + ("dup",)
    prev = set()
    for rung in ESCALATION_LADDER:
        assert prev < set(rung)
        prev = set(rung)
    assert prev == set(CLI_NAMES)
    assert ESCALATION_LADDER == jax_bias.ESCALATION_LADDER and THIN_GAIN == jax_bias.THIN_GAIN


def test_vocabulary_for_steps():
    assert vocabulary_for(("pair", "kill"), 0) == ("pair", "kill")
    assert vocabulary_for(("pair", "kill"), 1) == (
        "pair", "kill", "dir", "group", "storm", "delay"
    )
    # the base vocabulary is always unioned in, and output follows the
    # CLI print order (dup between skew and torn)
    assert vocabulary_for(("torn",), 1) == (
        "pair", "kill", "dir", "group", "storm", "delay", "torn"
    )
    assert vocabulary_for(("pair",), 4) == CLI_NAMES
    with pytest.raises(ValueError):
        vocabulary_for(("pair",), 5)
    for base in (("pair", "kill"), ("torn",), ("dup", "skew")):
        for step in range(5):
            assert vocabulary_for(base, step) == jax_bias.vocabulary_for(base, step)


def test_next_escalation_skips_nonwidening_rungs():
    assert next_escalation(("pair", "kill"), 0) == 1
    # a base already covering rung 1 skips straight to rung 2
    assert next_escalation(FAULT_KIND_NAMES[:6], 0) == 2
    # the full palette has nowhere to go
    assert next_escalation(CLI_NAMES, 0) is None
    assert next_escalation(("pair", "kill"), 4) is None


# -- bias state ---------------------------------------------------------------


def test_bias_fresh_uniform_and_dup_excluded():
    b = BiasState.fresh(("pair", "kill", "dup"))
    assert b.weights == {"pair": 0.5, "kill": 0.5}  # dup: not scheduled
    assert b.escalation == 0 and b.updates == 0


def test_bias_update_hand_computed():
    """The exact arithmetic, by hand: raw_k = (1 + prov_k) *
    (1 + (1 - frac_k)); weights = raw / sum(raw)."""
    b = BiasState.fresh(("pair", "kill"))
    b.update({"pair": 0.5, "kill": 0.0}, {"kill": 3})
    raw_pair = (1.0 + 0) * (1.0 + (1.0 - 0.5))   # 1.5
    raw_kill = (1.0 + 3) * (1.0 + (1.0 - 0.0))   # 8.0
    total = raw_pair + raw_kill
    assert b.weights == {"pair": raw_pair / total, "kill": raw_kill / total}
    assert b.updates == 1
    # a second identical update is idempotent on the weights
    w = dict(b.weights)
    b.update({"pair": 0.5, "kill": 0.0}, {"kill": 3})
    assert b.weights == w and b.updates == 2
    # kinds absent from the band table count as empty (thin) bands,
    # fractions clamp into [0, 1]
    b2 = BiasState.fresh(("pair", "kill"))
    b2.update({"pair": 2.0}, {})
    assert b2.weights["kill"] == 2.0 / 3.0  # kill: 1*(1+1)=2; pair: 1*(1+0)=1


def test_bias_roundtrip_exact():
    b = BiasState.fresh(("pair", "kill", "torn"))
    b.update({"pair": 0.123456789, "kill": 0.5}, {"torn": 7})
    d1 = b.to_dict()
    b2 = BiasState.from_dict(json.loads(json.dumps(d1)))
    assert b2.to_dict() == d1
    assert b2.weights == b.weights  # exact float round-trip via JSON repr
    jb = jax_bias.BiasState.fresh(("pair", "kill", "torn"))
    jb.update({"pair": 0.123456789, "kill": 0.5}, {"torn": 7})
    assert json.dumps(jb.to_dict()) == json.dumps(d1)


def test_bias_escalate_carries_learned_mass():
    b = BiasState.fresh(("pair", "kill"))
    b.update({"pair": 1.0, "kill": 0.0}, {})  # kill becomes heavy
    w_kill = b.weights["kill"]
    vocab = b.escalate(("pair", "kill"))
    assert vocab == vocabulary_for(("pair", "kill"), 1)
    assert b.escalation == 1
    assert set(b.weights) == set(FAULT_KIND_NAMES[:6])
    # carried mass keeps kill ahead of the fresh uniform kinds
    assert b.weights["kill"] > b.weights["dir"]
    assert abs(sum(b.weights.values()) - 1.0) < 1e-12
    # learned ordering survives the renormalization
    assert b.weights["kill"] / b.weights["pair"] == pytest.approx(
        w_kill / (1 - w_kill)
    )
    jb = jax_bias.BiasState.fresh(("pair", "kill"))
    jb.update({"pair": 1.0, "kill": 0.0}, {})
    jb.escalate(("pair", "kill"))
    assert jb.to_dict() == b.to_dict()


def test_score_kinds():
    b = BiasState(kinds=("pair", "kill"), weights={"pair": 0.25, "kill": 0.75})
    assert b.score_kinds(("pair", "pair")) == 0.5
    assert b.score_kinds(("kill",)) == 0.75
    assert b.score_kinds(()) == 0.0


def test_band_fractions_from_coverage():
    cov = {"by_band": {"pair": 64, "kill": 0, "timer": 128}}
    # slots_log2=10, band_bits=3 -> 128 slots per band
    fr = band_fractions_from_coverage(cov, 10, 3)
    assert fr == {"pair": 0.5, "kill": 0.0, "timer": 1.0}


# -- selection (pure, stubbed features) ---------------------------------------


def _stub_features(kind_of_seed):
    """schedule_features stand-in: every seed draws ONE fault whose
    kind index is kind_of_seed(seed)."""

    def feats(_eng, seeds):
        kinds = np.asarray([[kind_of_seed(int(s))] for s in seeds], np.int32)
        return {
            "kinds": kinds,
            "t_apply": np.zeros_like(kinds),
            "targets": np.zeros_like(kinds),
        }

    return feats


def test_select_batch_pure_and_deterministic(monkeypatch):
    from madsim_tpu_torch.search import guided

    monkeypatch.setattr(
        guided, "schedule_features", _stub_features(lambda s: s % 2)
    )
    b = BiasState(kinds=("pair", "kill"),
                  weights={"pair": 0.1, "kill": 0.9})
    eng = SimpleNamespace()  # features are stubbed; engine unused
    args = (b, eng, [11, 22], {1, 2, 3}, 100, 2, 8)
    seeds1, cur1, nmut1, ops1 = guided._select_batch(*args)
    seeds2, cur2, nmut2, ops2 = guided._select_batch(*args)
    assert (seeds1, cur1, nmut1, ops1) == (seeds2, cur2, nmut2, ops2)
    assert len(seeds1) == 8 and len(set(seeds1)) == 8
    assert nmut1 == 4  # MUTANT_FRAC of 8
    # fresh tail is sequential from the cursor, skipping nothing here
    assert seeds1[nmut1:] == [100, 101, 102, 103]
    assert cur1 == 104
    # every mutant is the kill-heavy (odd) candidate when one exists
    # among its three streams — the bias drives selection
    for j, s in enumerate(seeds1[:nmut1]):
        parent = [11, 22][j % 2]
        cands = [c for _op, c in mutate.children(parent, 2, j)]
        assert s in cands
        best = max(cands, key=lambda c: (0.1, 0.9)[c % 2])
        assert (s % 2) == (best % 2)


def test_select_batch_respects_seen_and_budget(monkeypatch):
    from madsim_tpu_torch.search import guided

    monkeypatch.setattr(
        guided, "schedule_features", _stub_features(lambda s: 0)
    )
    b = BiasState.fresh(("pair", "kill"))
    # mark every candidate of parent 5's slots as seen: selection must
    # fall back to fresh seeds and never emit a duplicate
    seen = set()
    for j in range(4):
        seen.update(c for _op, c in mutate.children(5, 1, j))
    seen.update({200, 202})
    seeds, cursor, nmut, _ops = guided._select_batch(
        b, SimpleNamespace(), [5], seen, 200, 1, 6
    )
    assert nmut == 0
    assert seeds == [201, 203, 204, 205, 206, 207]  # seen skipped
    assert cursor == 208
    assert not (set(seeds) & seen)


def test_select_batch_bootstrap_is_sequential():
    from madsim_tpu_torch.search import guided

    seeds, cursor, nmut, ops = guided._select_batch(
        BiasState.fresh(("pair",)), SimpleNamespace(), [], set(), 0, 0, 5
    )
    assert seeds == [0, 1, 2, 3, 4] and cursor == 5 and nmut == 0


# -- engine half: features, run_seed_batch, escalation -------------------------


@pytest.fixture(scope="module")
def raft_engines():
    return guided_engines()


def test_schedule_features_match_provenance_derivation(raft_engines):
    """The feature slice re-derives exactly the schedule the provenance
    decoder (and the lanes) see, and the JAX package's features, child
    seeds past 2**31 included."""
    from madsim_tpu.search.features import schedule_features as jax_features
    from madsim_tpu_torch.engine.provenance import fault_schedule
    from madsim_tpu_torch.search.features import kind_name_rows, schedule_features

    jax_eng, eng = raft_engines
    seeds = [0, 7, 1234, 1_987_654_321, 2_911_220_862, 0xFFFFFFFF]
    feats = schedule_features(eng, seeds)
    assert feats["kinds"].shape == (6, 2)
    for i, seed in enumerate(seeds):
        sched = fault_schedule(eng, seed)
        assert [int(k) for k in feats["kinds"][i]] == [f.kind for f in sched]
        assert [int(t) for t in feats["t_apply"][i]] == [f.t_apply_us for f in sched]
        assert [int(a) for a in feats["targets"][i]] == [f.arg1 for f in sched]
    want = jax_features(jax_eng, seeds)
    for key in ("kinds", "t_apply", "targets"):
        assert feats[key].dtype == want[key].dtype == np.int32
        assert np.array_equal(feats[key], want[key]), key
    assert kind_name_rows(eng, feats["kinds"]) == [tuple(FAULT_KIND_NAMES[k] for k in row) for row in want["kinds"]]


def test_select_batch_matches_jax(raft_engines):
    """With the real features, the port picks the JAX package's seed
    vector, mutant count and operator labels on the same (bias,
    parents, seen, cursor)."""
    from madsim_tpu.search import guided as jax_guided
    from madsim_tpu_torch.search import guided

    jax_eng, eng = raft_engines
    weights = {"pair": 0.3, "kill": 0.7}
    parents = [3, 17, 2_911_220_862, 40]
    seen = {0, 1, 2, 3, 5, 17, 40}
    got = guided._select_batch(BiasState(("pair", "kill"), dict(weights)), eng, parents, seen, 4, 2, 16)
    want = jax_guided._select_batch(jax_bias.BiasState(("pair", "kill"), dict(weights)), jax_eng, parents, seen,
                                    4, 2, 16)
    assert got == want
    assert got[2] == 8 and sum(got[3].values()) == 8


def _assert_seed_batch_equal(got, want):
    assert set(got) == set(want)
    for key in want:
        if isinstance(want[key], np.ndarray):
            assert got[key].dtype == want[key].dtype and np.array_equal(got[key], want[key]), key
        else:
            assert got[key] == want[key], key


def test_run_seed_batch_matches_jax(raft_engines):
    """Every key of the dict, the per-lane int32 coverage words (what
    parent detection diffs) among them, equal to the JAX package's."""
    jax_eng, eng = raft_engines
    seeds = list(range(24)) + [2_911_220_862, 0xFFFFFFFF]
    got = eng.run_seed_batch(seeds, max_steps=600)
    _assert_seed_batch_equal(got, jax_eng.run_seed_batch(seeds, max_steps=600))
    assert got["cov_lane_words"].shape == (26, (1 << 10) // 32)
    assert got["cov_lane_words"].any(axis=1).all()


def test_run_seed_batch_dup_provenance_matches_jax():
    """Dup finds carry bit 31: `run_seed_batch` gives the word as the
    reference does, its uint32 value, though the port's planes hold it
    as a negative int32 bit pattern."""
    from madsim_tpu.engine import Engine as JaxEngine
    from madsim_tpu.engine import EngineConfig as JaxConfig
    from madsim_tpu.engine import FaultPlan as JaxFaultPlan
    from madsim_tpu.__main__ import build_machine as jax_build
    from madsim_tpu_torch.engine import Engine, EngineConfig, FaultPlan
    from madsim_tpu_torch.models import build_machine

    cfg = dict(horizon_us=1_000_000, queue_capacity=96, coverage=True, provenance=True)
    faults = dict(n_faults=2, t_max_us=600_000, dur_min_us=100_000, dur_max_us=800_000, allow_dup=True)
    jax_eng = JaxEngine(jax_build("demo-dupvote-raft", 0), JaxConfig(faults=JaxFaultPlan(**faults), **cfg))
    eng = Engine(build_machine("demo-dupvote-raft"), EngineConfig(faults=FaultPlan(**faults), **cfg), device="cpu")
    seeds = [24, 91, 140, 150] + list(range(8))
    got = eng.run_seed_batch(seeds, max_steps=96)
    _assert_seed_batch_equal(got, jax_eng.run_seed_batch(seeds, max_steps=96))
    assert sorted(got["provenance"]) == [24, 91, 140, 150]
    assert all(w >> 31 for w in got["provenance"].values())
    assert int(eng.run_batch(seeds, max_steps=96).fail_prov[0]) < 0  # seed 24's word, as its int32 plane holds it


def test_run_seed_batch_agrees_with_stream(raft_engines):
    """The guided batch runner and the streaming executor report the
    same verdict set and the same coverage bits for the same seed range
    (both are the same per-lane simulation by the determinism
    contract)."""
    _, eng = raft_engines
    out_b = eng.run_seed_batch(range(0, 64), max_steps=600)
    out_s = eng.run_stream(64, batch=64, segment_steps=128, seed_start=0, max_steps=600)
    assert sorted(out_b["failing"]) == sorted(out_s["failing"])
    assert sorted(out_b["infra"]) == sorted(out_s["infra"])
    assert sorted(out_b["abandoned"]) == sorted(out_s["abandoned"])
    assert (out_b["coverage_map"] == out_s["coverage_map"]).all()


def test_guided_cell_plateau_escalates(raft_engines):
    """The coarse cell grid saturating climbs the ladder (recorded in
    the trail) instead of stopping the hunt; the escalated batches run
    on the port's escalated engine, trail for trail the JAX package's."""
    from madsim_tpu.search.guided import run_guided as jax_run_guided
    from madsim_tpu_torch.search.guided import run_guided
    from torch_port_util import guided_args as _guided_args
    from torch_port_util import trail_key as _trail_key

    jax_eng, eng = raft_engines
    args = dict(seeds=320, batch=32, stop_on_plateau=1)
    agg = run_guided(eng, _guided_args(**args), purpose="hunt")
    trail = agg["guided"]["trail"]
    esc_events = [r for r in trail if r["escalated_to"]]
    assert esc_events, "expected at least one escalation in 10 batches"
    first = esc_events[0]
    assert first["escalated_to"] == 1
    # batches after the event run the widened vocabulary
    later = [r for r in trail if r["batch"] > first["batch"]]
    for r in later[:1]:
        assert r["escalation"] >= 1
        assert "storm" in r["kinds"]
    assert agg["plateau"] is False  # escalation, not stop
    # cells_hit is recorded (the escalation trigger's own signal)
    assert all(isinstance(r["cells_hit"], int) for r in trail)
    assert _trail_key(agg) == _trail_key(jax_run_guided(jax_eng, _guided_args(**args), purpose="hunt"))


def test_engine_for_escalation_cache_and_step0(raft_engines):
    from madsim_tpu_torch.search.guided import engine_for_escalation

    _, eng = raft_engines
    assert engine_for_escalation(eng, 0) is eng
    e1 = engine_for_escalation(eng, 1)
    assert e1 is engine_for_escalation(eng, 1)  # cached
    assert e1.config.faults.allow_storm and e1.config.faults.allow_delay
    assert not e1.config.faults.allow_torn
    # the coverage layout never moves across escalations
    assert e1.cov_band_bits == eng.cov_band_bits == 4
    # a CPU hunt escalates on the CPU, never onto the card
    assert e1.device == eng.device and e1.device.type == "cpu"
    e4 = engine_for_escalation(eng, 4)
    assert e4.device.type == "cpu" and e4.config.faults.allow_dup and e4.config.faults.allow_heal_asym


def test_cov_band_bits_min_validation_and_default():
    from madsim_tpu_torch.engine import Engine, EngineConfig, FaultPlan
    from madsim_tpu_torch.models.echo import EchoMachine

    m = EchoMachine(rounds=3)
    # default 0 = derived (3-bit for the legacy vocabulary): unguided
    # engines are untouched by the knob
    e = Engine(m, EngineConfig(horizon_us=100_000, queue_capacity=32,
                               faults=FaultPlan(n_faults=0)), device="cpu")
    assert e.config.cov_band_bits_min == 0 and e.cov_band_bits == 3
    with pytest.raises(ValueError, match="cov_band_bits_min"):
        Engine(m, EngineConfig(horizon_us=100_000, queue_capacity=32,
                               cov_band_bits_min=2,
                               faults=FaultPlan(n_faults=0)), device="cpu")
