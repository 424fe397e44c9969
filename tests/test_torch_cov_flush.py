"""The coverage flush's CUDA kernel (ops/csrc/cov_flush.cu), mirrored in
numpy, against the JAX package's Pallas flush in interpret mode and the
plain twin `cov_flush_plain`.

The card is the only place the kernel runs; this is where an ownership
or range bug shows first. The mirror follows the kernel line for line:
one thread per (lane, entry) over a grid of FLUSH_BLOCK-thread blocks,
the threads past L * C doing nothing; a thread loads its entry and its
lane's count together, drops an entry that is not live (index >= n) or
off the map (a negative slot, or a word >= W), and ORs the entry's bit
into its lane's word with an atomic. Atomics land in any order, so the
mirror applies them in order, reversed and shuffled. It asserts that
every live entry on the map is applied exactly once, by the thread of
its own (lane, entry), and nothing else. Inputs come from numpy with a
fixed seed (chip_smoke.flush_inputs, as the card's checks use them);
every comparison is exact."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_util  # noqa: F401  (one test thread)
from chip_smoke import FLUSH_C, FLUSH_W, flush_inputs
from madsim_tpu.ops.pallas_pop import cov_flush_pallas
from madsim_tpu_torch.ops import kernels

FLUSH_BLOCK = 256  # cov_flush.cu
LANES = 70
M32 = 0xFFFFFFFF


def _thread(g, cov_map, buf, n):
    """Thread g of `cov_flush_kernel`: the atomic it issues, as (lane, word,
    bit, entry), or None."""
    lanes, w = cov_map.shape
    c = buf.shape[1]
    if g >= lanes * c:
        return None
    lane = g // c
    i = g - lane * c
    slot, count = int(buf.reshape(-1)[g]), int(n[lane])  # both loads issued together
    word = slot >> 5
    if i >= count or word < 0 or word >= w:
        return None
    return lane, word, 1 << (slot & 31), (lane, i)


def _emulate_cov_flush(cov_map, buf, n, order):
    """The kernel over its grid, its atomics applied in `order` ("in
    order", "reversed" or "shuffled"). Returns the new map and the entries
    applied."""
    lanes, c = buf.shape
    grid = (lanes * c + FLUSH_BLOCK - 1) // FLUSH_BLOCK
    atomics = [a for g in range(grid * FLUSH_BLOCK) if (a := _thread(g, cov_map, buf, n)) is not None]
    if order == "reversed":
        atomics = atomics[::-1]
    elif order == "shuffled":
        atomics = [atomics[k] for k in np.random.default_rng(len(atomics)).permutation(len(atomics))]
    out = cov_map.view(np.uint32).astype(np.int64)
    for lane, word, bit, _ in atomics:
        out[lane, word] = (out[lane, word] | bit) & M32  # atomicOr
    return out.astype(np.uint32).view(np.int32), [entry for *_, entry in atomics]


@functools.lru_cache(maxsize=None)
def _case(c, w):
    """The inputs of one (C, W) cell and the JAX package's Pallas flush of
    them in interpret mode."""
    cov_map, buf, n = flush_inputs(np.random.default_rng(c * 1000 + w), LANES, c, w)
    want = cov_flush_pallas(jnp.asarray(cov_map), jnp.asarray(buf), jnp.asarray(n), interpret=True)
    return cov_map, buf, n, np.asarray(want)


@pytest.mark.parametrize("order", ["in order", "shuffled"])
@pytest.mark.parametrize("w", FLUSH_W)
@pytest.mark.parametrize("c", FLUSH_C)
def test_cov_flush_emulation_matches_jax(c, w, order):
    cov_map, buf, n, want = _case(c, w)
    got, applied = _emulate_cov_flush(cov_map, buf, n, order)
    assert got.tolist() == want.tolist()
    twin = kernels.cov_flush_plain(*(torch.from_numpy(a) for a in (cov_map, buf, n)))
    assert twin.tolist() == want.tolist()
    # every live entry on the map once, by its own thread, and nothing else
    live = [(lane, i) for lane in range(LANES) for i in range(c)
            if i < n[lane] and 0 <= buf[lane, i] >> 5 < w]
    assert sorted(applied) == live
    # the edge lanes: n = 0 and all-off-map (lane 3) apply nothing; n = C
    # with every entry on one word (lane 2) applies them all to that word
    assert not any(lane in (0, 3) for lane, _ in applied)
    assert (got[[0, 3]] == cov_map[[0, 3]]).all()
    assert sum(lane == 2 for lane, _ in applied) == c


def test_cov_flush_emulation_with_every_entry_on_one_word():
    """C = 64, every entry of every lane on one word, n in {0, 1, 17, 63,
    64}: up to 64 atomics on one word, in any order, give the Pallas
    kernel's map."""
    g = np.random.default_rng(7)
    lanes, c, w = 5, 64, 8
    cov_map = np.zeros((lanes, w), np.int32)
    buf = (32 * 3 + g.integers(0, 32, (lanes, c))).astype(np.int32)
    n = np.array([0, 1, 17, 63, 64], np.int32)
    want = np.asarray(cov_flush_pallas(jnp.asarray(cov_map), jnp.asarray(buf), jnp.asarray(n), interpret=True))
    for order in ("in order", "reversed", "shuffled"):
        got, applied = _emulate_cov_flush(cov_map, buf, n, order)
        assert got.tolist() == want.tolist(), order
        assert sorted(applied) == [(lane, i) for lane in range(lanes) for i in range(int(n[lane]))]
    assert (got[:, [0, 1, 2, 4, 5, 6, 7]] == 0).all() and got[0, 3] == 0 and got[4, 3] != 0
