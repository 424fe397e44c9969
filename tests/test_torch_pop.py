"""The plain twins of the pop kernels against the JAX package:
`pop_gather_plain` against `pop_gather_batch` and `pop_earliest_plain`
against `pop_earliest_batch`, each both through the Pallas kernel in
interpreter mode (as tests/test_pallas.py runs it) and through the XLA
path. On CPU tensors the wrappers run the twins and launch nothing.
Inputs come from numpy with a fixed seed: time ties, all-invalid lanes,
INT32_MAX in valid and invalid slots. Every comparison is exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_util  # noqa: F401  (one test thread; pins the Threefry lowering)
from madsim_tpu.ops.pallas_pop import pop_earliest_batch as jax_pop_earliest
from madsim_tpu.ops.pallas_pop import pop_gather_batch as jax_pop_gather
from madsim_tpu_torch.ops import kernels

INT32_MAX = 2**31 - 1


def _queues(seed, lanes, q, p):
    """Random [L, Q] queue planes: dense times (many ties), FIFO seqs,
    all-invalid lanes (they pop slot 0) and INT32_MAX times, which are
    both the masking sentinel and a legal time."""
    g = np.random.default_rng(seed)
    time = g.integers(0, 20, (lanes, q)).astype(np.int32)
    seq = np.stack([g.permutation(q) for _ in range(lanes)]).astype(np.int32) * 5 + 1
    valid = g.random((lanes, q)) < 0.4
    valid[::4] = False
    time[g.random((lanes, q)) < 0.2] = INT32_MAX
    if lanes > 2:
        # a lane whose only valid slots sit at INT32_MAX, tied on time:
        # the lower seq wins
        valid[2] = False
        valid[2, [q // 3, q - 1]] = True
        time[2, [q // 3, q - 1]] = INT32_MAX
        seq[2, q // 3] = 0
    kind, node, src = (g.integers(-2**31, 2**31, (lanes, q)).astype(np.int32) for _ in range(3))
    payload = g.integers(-2**31, 2**31, (lanes, q, p)).astype(np.int32)
    return time, seq, valid, kind, node, src, payload


def _lists(*arrays):
    return [np.asarray(a).tolist() for a in arrays]


@pytest.mark.parametrize("use_pallas", [True, False], ids=["pallas-interpret", "xla"])
@pytest.mark.parametrize("p", [4, 6])
@pytest.mark.parametrize("q", [32, 40, 96])
def test_pop_twins_match_jax(q, p, use_pallas):
    kernels.reset_launches()
    for lanes in (1, 8, 13):
        arrs = _queues(q * 100 + p * 10 + lanes, lanes, q, p)
        t_arrs = [torch.from_numpy(a) for a in arrs]
        idx, any_v, popped = jax_pop_gather(*(jnp.asarray(a) for a in arrs),
                                            use_pallas=use_pallas, interpret=True)
        g_idx, g_any, g_popped, g_payload = kernels.pop_gather_batch(*t_arrs)
        assert g_idx.dtype == torch.int32 and g_any.dtype == torch.bool
        assert _lists(g_idx, g_any, *g_popped, g_payload) == _lists(idx, any_v, *popped), (lanes,)
        assert _lists(*kernels.pop_gather_plain(*t_arrs)[:2]) == _lists(idx, any_v)

        e_idx, e_any = jax_pop_earliest(*(jnp.asarray(a) for a in arrs[:3]),
                                        use_pallas=use_pallas, interpret=True)
        got = kernels.pop_earliest_batch(*t_arrs[:3])
        assert _lists(*got) == _lists(e_idx, e_any), (lanes,)
        assert _lists(*kernels.pop_earliest_plain(*t_arrs[:3])) == _lists(e_idx, e_any)
        if lanes > 2:
            assert int(g_idx[2]) == q // 3 and bool(g_any[2])  # INT32_MAX is a legal time
        assert int(g_idx[0]) == 0 and not bool(g_any[0])  # an all-invalid lane pops slot 0
    assert set(kernels.launches.values()) == {0}  # CPU: the twins ran


def test_pop_wrappers_refuse_other_devices():
    z = lambda *s, dtype=torch.int32: torch.zeros(s, dtype=dtype, device="meta")  # noqa: E731
    with pytest.raises(ValueError, match="cuda or cpu"):
        kernels.pop_earliest_batch(z(2, 4), z(2, 4), z(2, 4, dtype=torch.bool))
    with pytest.raises(ValueError, match="cuda or cpu"):
        kernels.pop_gather_batch(z(2, 4), z(2, 4), z(2, 4, dtype=torch.bool), z(2, 4), z(2, 4),
                                 z(2, 4), z(2, 4, 3))
