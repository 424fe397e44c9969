"""The port's CUDA kernels against their plain twins on the card, and
short engine runs on the card against the CPU (both streams, delay
spikes, the chaos palette at Q = 96, the single-lane replay and the
corpus). These need an NVIDIA card with nvcc (they build the
kernels); without one they skip. On the card:

    python -m pytest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from chip_smoke import (EDGE_SHAPES, FLUSH_C, FLUSH_W, REPLAY_CONFIG, REPLAY_SEED, REPLAY_STATE_STEPS,
                        flush_inputs, misaligned_copy)

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode (their twins are tested on the CPU)")
    return torch.device("cuda")


def _flat(r):
    idx, any_v, popped, payload, words, digest = r
    return [idx, any_v, *popped, payload, words, *digest]


# (8192, 32, 6, 18): the flagship Raft with delay spikes on rng_stream=3;
# (8192, 96, 6, 18): the dup-vote hunt under the chaos palette
@pytest.mark.parametrize("lanes,q,p,w,digest", [(8192, 32, 6, 10, True), (8192, 32, 6, 18, True),
                                                 (8192, 96, 6, 18, True), (256, 96, 6, 18, True),
                                                 (1000, 64, 4, 7, True), (37, 32, 6, 7, False),
                                                 (5, 40, 3, 1, True)])
def test_step_megakernel_matches_twin(dev, lanes, q, p, w, digest):
    from madsim_tpu_torch.ops import kernels

    g = np.random.default_rng(lanes)

    def t(a):
        return torch.as_tensor(a).to(dev)

    time_ = g.integers(0, 40, (lanes, q)).astype(np.int32)
    seq = g.integers(0, 2**31 - 1, (lanes, q)).astype(np.int32)
    valid = g.random((lanes, q)) < 0.5
    valid[::7] = False
    planes = [t(g.integers(-2**31, 2**31, (lanes, q)).astype(np.int32)) for _ in range(3)]
    ins = [t(time_), t(seq), t(valid), *planes,
           t(g.integers(-2**31, 2**31, (lanes, q, p)).astype(np.int32)),
           t(g.integers(-2**31, 2**31, (lanes, 2)).astype(np.int32)),
           t(g.integers(0, 2**31, lanes).astype(np.int32))]
    d = [t(g.integers(-2**31, 2**31, lanes).astype(np.int32)) for _ in range(2)] if digest else [None, None]
    before = kernels.launches["step_megakernel"]
    got = _flat(kernels.step_megakernel(*ins, w, *d))
    want = _flat(kernels.step_prefix_plain(*ins, w, *d))
    torch.cuda.synchronize()
    assert kernels.launches["step_megakernel"] == before + 1
    for a, b in zip(got, want):
        assert torch.equal(a, b)


# the flush's edge grid (chip_smoke.flush_inputs says what its lanes hold),
# rows aligned and one element off 16-byte alignment
_FLUSH_GRID = [(70, c, w, mis) for c in FLUSH_C for w in FLUSH_W for mis in (False, True)]


@pytest.mark.parametrize("lanes,c,w,misaligned", [(8192, 16, 512, False), (33, 5, 64, False)] + _FLUSH_GRID)
def test_cov_flush_matches_twin(dev, lanes, c, w, misaligned):
    from madsim_tpu_torch.ops import kernels

    g = np.random.default_rng(c * 1000 + w)
    if lanes == 70:
        cov_map, buf, n = (torch.as_tensor(a).to(dev) for a in flush_inputs(g, lanes, c, w))
    else:
        cov_map = torch.as_tensor(g.integers(-2**31, 2**31, (lanes, w)).astype(np.int32)).to(dev)
        buf = torch.as_tensor(g.integers(0, 32 * w, (lanes, c)).astype(np.int32)).to(dev)
        n = torch.as_tensor(g.integers(0, c + 1, lanes).astype(np.int32)).to(dev)
    if misaligned:
        buf = misaligned_copy(buf)
        assert buf.data_ptr() % 16 and buf.is_contiguous()
    want = kernels.cov_flush_plain(cov_map, buf, n)
    before = kernels.launches["cov_flush"]
    got = kernels.cov_flush_batch(cov_map.clone(), buf, n)
    torch.cuda.synchronize()
    assert kernels.launches["cov_flush"] == before + 1
    assert torch.equal(got, want)


def _replay_state_planes(dev):
    """The queue planes of the single-lane replay's state: seed 66531,
    REPLAY_STATE_STEPS events in, on the card."""
    from madsim_tpu_torch.engine import Engine, EngineConfig, FaultPlan
    from madsim_tpu_torch.models import build_machine

    cfg = EngineConfig(**REPLAY_CONFIG, faults=FaultPlan(n_faults=2, t_max_us=3_000_000, dur_min_us=200_000,
                                                         dur_max_us=800_000))
    eng = Engine(build_machine("raft"), cfg)
    s = eng.run_segment(eng.init_batch([REPLAY_SEED]), REPLAY_STATE_STEPS)
    assert s.eq_time.device.type == "cuda" and tuple(s.eq_time.shape) == (1, 32) and bool(s.eq_valid.any())
    return [s.eq_time, s.eq_seq, s.eq_valid, s.eq_kind, s.eq_node, s.eq_src, s.eq_payload]


# Q = 48 (P = 5): the mvcc and s3 hunts and replays; Q = 256 (P = 4): gossip's;
# Q = 96 (P = 6): the chaos palette's batches and the dup-vote replay
@pytest.mark.parametrize("lanes,q,p", [(8192, 32, 6), (8191, 96, 6), (1, 32, 6), (13, 40, 4), ("replay", 32, 6),
                                       (8192, 48, 5), (8192, 256, 4), (1, 48, 5), (1, 256, 4), (256, 96, 6),
                                       (1, 96, 6)])
def test_pop_kernels_match_twins(dev, lanes, q, p):
    from madsim_tpu_torch.ops import kernels

    g = np.random.default_rng(q + p)

    def t(a):
        return torch.as_tensor(a).to(dev)

    if lanes == "replay":  # the replay's own shape, L = 1 and Q = 32, on a real state
        ins = _replay_state_planes(dev)
    else:
        time_ = g.integers(0, 30, (lanes, q)).astype(np.int32)
        time_[g.random((lanes, q)) < 0.1] = 2**31 - 1  # INT32_MAX is a legal time
        seq = g.integers(0, 2**31 - 1, (lanes, q)).astype(np.int32)
        valid = g.random((lanes, q)) < 0.5
        valid[::3] = False  # empty lanes
        ins = [t(time_), t(seq), t(valid), *(t(g.integers(-2**31, 2**31, (lanes, q)).astype(np.int32))
                                             for _ in range(3)),
               t(g.integers(-2**31, 2**31, (lanes, q, p)).astype(np.int32))]
    before = dict(kernels.launches)
    got = kernels.pop_gather_batch(*ins)
    want = kernels.pop_gather_plain(*ins)
    got_pop, want_pop = kernels.pop_earliest_batch(*ins[:3]), kernels.pop_earliest_plain(*ins[:3])
    torch.cuda.synchronize()
    assert kernels.launches["pop_gather"] == before["pop_gather"] + 1
    assert kernels.launches["pop_earliest"] == before["pop_earliest"] + 1
    for a, b in zip([got[0], got[1], *got[2], got[3], *got_pop], [want[0], want[1], *want[2], want[3], *want_pop]):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_run_batch_on_the_card_matches_the_cpu_under_the_default_stream(dev):
    from madsim_tpu_torch.engine import Engine, EngineConfig, FaultPlan
    from madsim_tpu_torch.interop import tree_to_numpy
    from madsim_tpu_torch.models import RaftMachine

    for recorder in (False, True):
        cfg = EngineConfig(horizon_us=5_000_000, queue_capacity=32, flight_recorder=recorder, coverage=recorder,
                           faults=FaultPlan(n_faults=2, t_max_us=3_000_000, allow_storm=True,
                                            dur_min_us=200_000, dur_max_us=800_000))
        seeds = np.arange(64, dtype=np.uint32)
        on_card = tree_to_numpy(Engine(RaftMachine(5, 8), cfg).run_batch(seeds, 256))
        on_cpu = tree_to_numpy(Engine(RaftMachine(5, 8), cfg, device="cpu").run_batch(seeds, 256))
        assert _same(on_card, on_cpu)


def test_replay_on_the_card_matches_the_cpu(dev):
    from madsim_tpu_torch.engine import Engine, EngineConfig, FaultPlan
    from madsim_tpu_torch.engine.replay import replay
    from madsim_tpu_torch.interop import tree_to_numpy
    from madsim_tpu_torch.models import build_machine
    from madsim_tpu_torch.ops import kernels

    cfg = EngineConfig(horizon_us=5_000_000, queue_capacity=32,
                       faults=FaultPlan(n_faults=2, t_max_us=3_000_000, dur_min_us=200_000, dur_max_us=800_000))
    machine = build_machine("demo-overcommit-raft")
    before = kernels.launches["pop_earliest"]
    on_card = replay(Engine(machine, cfg), 66531, max_steps=2000)
    assert kernels.launches["pop_earliest"] > before
    on_cpu = replay(Engine(machine, cfg, device="cpu"), 66531, max_steps=2000)
    assert on_card.failed and on_card.fail_code == 102 and on_card.trace == on_cpu.trace
    assert _same(tree_to_numpy(on_card.state), tree_to_numpy(on_cpu.state))


def _same(a, b):
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    return a.dtype == b.dtype and np.array_equal(a, b)


def test_run_batch_on_the_card_matches_the_cpu(dev):
    from madsim_tpu_torch.engine import Engine, EngineConfig, FaultPlan
    from madsim_tpu_torch.interop import tree_to_numpy
    from madsim_tpu_torch.models import RaftMachine

    cfg = EngineConfig(horizon_us=5_000_000, queue_capacity=32, rng_stream=3, flight_recorder=True,
                       coverage=True, faults=FaultPlan(n_faults=2, t_max_us=3_000_000,
                                                       dur_min_us=200_000, dur_max_us=800_000))
    seeds = np.arange(64, dtype=np.uint32)
    on_card = tree_to_numpy(Engine(RaftMachine(5, 8), cfg).run_batch(seeds, 256))
    on_cpu = tree_to_numpy(Engine(RaftMachine(5, 8), cfg, device="cpu").run_batch(seeds, 256))

    def same(a, b):
        if isinstance(a, dict):
            return all(same(a[k], b[k]) for k in a)
        return a.dtype == b.dtype and np.array_equal(a, b)

    assert same(on_card, on_cpu)


# -- edge shapes of the lane-group mapping (pop_gather, step_megakernel) -------
#
# The smoke's list (chip_smoke.EDGE_SHAPES says what each shape takes);
# misaligned planes are contiguous views one element into their storage.


def _edge_inputs(dev, lanes, q, p, misaligned):
    g = np.random.default_rng(lanes * 1000 + q * 10 + p)

    def t(a):
        return torch.as_tensor(a).to(dev)

    time_ = g.integers(0, 4, (lanes, q)).astype(np.int32)  # dense: many ties
    time_[g.random((lanes, q)) < 0.1] = 2**31 - 1  # INT32_MAX is a legal time
    seq = g.integers(0, 3, (lanes, q)).astype(np.int32)  # equal (time, seq) in different slots
    valid = g.random((lanes, q)) < 0.5
    valid[::3] = False  # empty lanes
    planes = [t(time_), t(seq), t(valid)]
    if misaligned:
        planes = [misaligned_copy(x) for x in planes]
        assert planes[0].data_ptr() % 16 and planes[0].is_contiguous()
    return planes + [t(g.integers(-2**31, 2**31, (lanes, q)).astype(np.int32)) for _ in range(3)] + [
        t(g.integers(-2**31, 2**31, (lanes, q, p)).astype(np.int32))]


@pytest.mark.parametrize("lanes,q,p,w,misaligned", EDGE_SHAPES)
def test_lane_group_kernels_match_twins_on_edge_shapes(dev, lanes, q, p, w, misaligned):
    from madsim_tpu_torch.ops import kernels

    ins = _edge_inputs(dev, lanes, q, p, misaligned)
    got, want = kernels.pop_gather_batch(*ins), kernels.pop_gather_plain(*ins)
    g = np.random.default_rng(w)
    key = torch.as_tensor(g.integers(-2**31, 2**31, (lanes, 2)).astype(np.int32)).to(dev)
    step = torch.as_tensor(g.integers(0, 2**31, lanes).astype(np.int32)).to(dev)
    d = [torch.as_tensor(g.integers(-2**31, 2**31, lanes).astype(np.int32)).to(dev) for _ in range(2)]
    got_s = _flat(kernels.step_megakernel(*ins, key, step, w, *d))
    want_s = _flat(kernels.step_prefix_plain(*ins, key, step, w, *d))
    torch.cuda.synchronize()
    for a, b in zip([got[0], got[1], *got[2], got[3], *got_s], [want[0], want[1], *want[2], want[3], *want_s]):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_delay_spikes_on_the_card_match_the_cpu(dev):
    """The flagship Raft with delay faults on both streams: the v3 path
    launches the megakernel at W = 18, the v2 path pop + gather."""
    from madsim_tpu_torch.engine import Engine, EngineConfig, FaultPlan
    from madsim_tpu_torch.interop import tree_to_numpy
    from madsim_tpu_torch.models import RaftMachine
    from madsim_tpu_torch.ops import kernels

    for stream, kernel in ((3, "step_megakernel"), (2, "pop_gather")):
        cfg = EngineConfig(horizon_us=5_000_000, queue_capacity=32, rng_stream=stream, flight_recorder=True,
                           coverage=True, faults=FaultPlan(n_faults=2, allow_delay=True, t_max_us=3_000_000,
                                                           dur_min_us=200_000, dur_max_us=800_000))
        seeds = np.arange(64, dtype=np.uint32)
        before = kernels.launches[kernel]
        on_card = tree_to_numpy(Engine(RaftMachine(5, 8), cfg).run_batch(seeds, 256))
        assert kernels.launches[kernel] > before
        on_cpu = tree_to_numpy(Engine(RaftMachine(5, 8), cfg, device="cpu").run_batch(seeds, 256))
        assert _same(on_card, on_cpu)


def test_corpus_reproduces_on_the_card(dev):
    """Every corpus.json entry, replayed as one lane on the card: its
    code and recorded digest trail."""
    import pathlib

    from madsim_tpu_torch.engine import audit, corpus
    from madsim_tpu_torch.models import build_machine

    entries = corpus.load(str(pathlib.Path(__file__).resolve().parents[1] / "corpus.json"))
    assert len(entries) == 8
    for entry in entries:
        out = corpus.check(entry, build_machine)
        assert out.ok and out.fail_code == entry.fail_code, out.verdict
        assert audit.audit_entry(entry, build_machine).trail.to_lists() == (entry.digests, entry.digest_final)


def test_chaos_palette_on_the_card_matches_the_cpu(dev):
    """The flagship Raft at Q = 96 under pause, skew, dup and strict
    restarts, on both streams: the megakernel at W = 18 (v3) and pop +
    gather (v2) launch, and the card's results equal the CPU's."""
    from madsim_tpu_torch.engine import Engine, EngineConfig, FaultPlan
    from madsim_tpu_torch.interop import tree_to_numpy
    from madsim_tpu_torch.models import RaftMachine
    from madsim_tpu_torch.ops import kernels

    faults = FaultPlan(n_faults=2, t_max_us=3_000_000, dur_min_us=200_000, dur_max_us=800_000, allow_pause=True,
                       allow_skew=True, allow_dup=True, strict_restart=True)
    for stream, kernel in ((3, "step_megakernel"), (2, "pop_gather")):
        cfg = EngineConfig(horizon_us=5_000_000, queue_capacity=96, rng_stream=stream, flight_recorder=True,
                           coverage=True, faults=faults)
        seeds = np.arange(64, dtype=np.uint32)
        before = kernels.launches[kernel]
        on_card = tree_to_numpy(Engine(RaftMachine(5, 8), cfg).run_batch(seeds, 256))
        assert kernels.launches[kernel] > before
        on_cpu = tree_to_numpy(Engine(RaftMachine(5, 8), cfg, device="cpu").run_batch(seeds, 256))
        assert _same(on_card, on_cpu) and on_card["fr"]["dup"].sum() > 0
