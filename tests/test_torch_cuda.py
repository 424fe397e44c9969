"""The port's CUDA kernels against their plain twins on the card, and a
short engine run on the card against the CPU. These need an NVIDIA card
with nvcc (they build the kernels); without one they skip. On the card:

    python -m pytest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode (their twins are tested on the CPU)")
    return torch.device("cuda")


def _flat(r):
    idx, any_v, popped, payload, words, digest = r
    return [idx, any_v, *popped, payload, words, *digest]


@pytest.mark.parametrize("lanes,q,p,w,digest", [(8192, 32, 6, 10, True), (1000, 64, 4, 7, True),
                                                 (37, 32, 6, 7, False), (5, 40, 3, 1, True)])
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


@pytest.mark.parametrize("lanes,c,w", [(8192, 16, 512), (33, 5, 64)])
def test_cov_flush_matches_twin(dev, lanes, c, w):
    from madsim_tpu_torch.ops import kernels

    g = np.random.default_rng(c)
    cov_map = torch.as_tensor(g.integers(-2**31, 2**31, (lanes, w)).astype(np.int32)).to(dev)
    buf = torch.as_tensor(g.integers(0, 32 * w, (lanes, c)).astype(np.int32)).to(dev)
    n = torch.as_tensor(g.integers(0, c + 1, lanes).astype(np.int32)).to(dev)
    want = kernels.cov_flush_plain(cov_map, buf, n)
    got = kernels.cov_flush_batch(cov_map.clone(), buf, n)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


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
