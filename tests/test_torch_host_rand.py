"""The port's determinism substrate (`madsim_tpu_torch.rand`), mirroring
tests/test_rand.py case for case. Each workload runs on the port and on
the JAX package (`torch_host_util.both`): the values, or the
exceptions' types and messages, are equal."""

import pytest

from madsim_tpu_torch.errors import NonDeterminism
from madsim_tpu_torch.rand import GlobalRng
from madsim_tpu_torch.rand.philox import philox4x32, splitmix64

from torch_host_util import both


def test_philox_known_deterministic():
    a = philox4x32((1, 2), (3, 4, 5, 6))
    b = philox4x32((1, 2), (3, 4, 5, 6))
    assert a == b
    assert all(0 <= w <= 0xFFFFFFFF for w in a)
    assert philox4x32((1, 2), (3, 4, 5, 7)) != a
    assert philox4x32((9, 2), (3, 4, 5, 6)) != a
    assert both(lambda m: m.rand.philox4x32((1, 2), (3, 4, 5, 6))) == a


def test_global_rng_same_seed_same_stream():
    a = GlobalRng(42)
    b = GlobalRng(42)
    assert [a.next_u64() for _ in range(100)] == [b.next_u64() for _ in range(100)]
    c = GlobalRng(43)
    assert [GlobalRng(42).next_u64() for _ in range(4)] != [c.next_u64() for _ in range(4)]
    both(lambda m: [m.rand.GlobalRng(42).next_u64() for _ in range(100)])


def test_gen_range_and_float_bounds():
    def work(m):
        rng = m.rand.GlobalRng(7)
        out = []
        for _ in range(1000):
            out.append((rng.gen_range(10, 20), rng.random()))
        return out

    for v, f in both(work):
        assert 10 <= v < 20
        assert 0.0 <= f < 1.0


def test_shuffle_choice_deterministic():
    rng1, rng2 = GlobalRng(5), GlobalRng(5)
    xs1, xs2 = list(range(50)), list(range(50))
    rng1.shuffle(xs1)
    rng2.shuffle(xs2)
    assert xs1 == xs2
    assert xs1 != list(range(50))
    assert rng1.choice([1, 2, 3]) == rng2.choice([1, 2, 3])

    def work(m):
        rng = m.rand.GlobalRng(5)
        xs = list(range(50))
        rng.shuffle(xs)
        return xs, rng.choice([1, 2, 3])

    assert both(work)[0] == xs1


def test_sim_random_three_distinct_outcomes():
    # 9 simulations with seeds i//3 must yield exactly 3 distinct outcomes
    # (reference: sim/rand.rs:295-310).
    def work(m):
        async def workload():
            return m.rand.thread_rng().next_u64()

        return [m.Runtime(seed=i // 3).block_on(workload()) for i in range(9)]

    assert len(set(both(work))) == 3


def test_determinism_check_passes_for_clean_workload():
    def work(m):
        async def workload():
            total = 0
            for _ in range(10):
                total += m.rand.thread_rng().gen_range(0, 100)
                await m.time.sleep(0.001)
            return total

        return m.Runtime.check_determinism(1, workload)

    assert isinstance(both(work), int)


def test_determinism_check_detects_outside_randomness():
    # A workload that consults an outside RNG diverges between runs; the
    # message names the same draw and virtual time on both packages.
    def work(m):
        state = {"runs": 0}

        async def workload():
            state["runs"] += 1
            rng = m.rand.thread_rng()
            if state["runs"] == 2:
                rng.next_u32()  # extra draw on the second run only
            n = rng.gen_range(1, 5)
            for _ in range(n):
                await m.time.sleep(0.001)
                rng.next_u32()

        m.Runtime.check_determinism(1, workload)

    with pytest.raises(NonDeterminism):
        both(work)


def test_buggify_disabled_by_default_and_prob():
    def work(m):
        async def workload():
            buggify = m.buggify
            assert not buggify.is_enabled()
            assert not buggify.buggify()
            buggify.enable()
            assert buggify.is_enabled()
            hits = sum(1 for _ in range(1000) if buggify.buggify())
            buggify.disable()
            assert not buggify.buggify()
            return hits

        return m.Runtime(seed=3).block_on(workload())

    # ~25% +- noise (reference: sim/buggify.rs 25% default)
    assert 150 < both(work) < 400


def test_splitmix64_stable():
    assert splitmix64(0) == splitmix64(0)
    assert splitmix64(1) != splitmix64(2)
    assert 0 <= splitmix64(12345) < 2**64
    assert both(lambda m: [m.rand.splitmix64(x) for x in (0, 1, 2, 12345, 2**64 - 1)])
