"""The port's queue and coverage primitives and both kernels' plain
twins against the JAX package: `pop_earliest`, `find_free_slot`, the
`cov_*` functions, `step_prefix_plain` against the Pallas step
megakernel and `cov_flush_plain` against the Pallas coverage flush,
both run in interpreter mode as tests/test_pallas.py runs them. Inputs
come from numpy with a fixed seed; every comparison is exact."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_util  # noqa: F401  (pins the partitionable lowering)
from madsim_tpu import ops as jax_ops
from madsim_tpu.engine.core import digest_fold as jax_digest_fold
from madsim_tpu.ops import coverage as jax_cov
from madsim_tpu.ops.pallas_pop import cov_flush_pallas, step_megakernel as jax_megakernel
from madsim_tpu_torch import ops
from madsim_tpu_torch.ops import coverage, kernels

INT32_MAX = 2**31 - 1


def _queues(seed, lanes, q, p):
    """Random [L, Q] queue planes with time ties, all-invalid rows and
    the INT32_MAX sentinel in invalid slots."""
    g = np.random.default_rng(seed)
    time = g.integers(0, 50, (lanes, q)).astype(np.int32)  # dense: many ties
    seq = np.stack([g.permutation(q) for _ in range(lanes)]).astype(np.int32) * 3
    valid = g.random((lanes, q)) < 0.5
    valid[::5] = False  # all-invalid lanes pop slot 0
    valid[1::7] = True
    time[~valid & (g.random((lanes, q)) < 0.3)] = INT32_MAX
    kind, node, src = (g.integers(-2**31, 2**31, (lanes, q)).astype(np.int32) for _ in range(3))
    payload = g.integers(-2**31, 2**31, (lanes, q, p)).astype(np.int32)
    return time, seq, valid, kind, node, src, payload


@pytest.mark.parametrize("lanes", [1, 13, 64])
def test_pop_earliest_and_find_free_slot_match_jax(lanes):
    time, seq, valid, *_ = _queues(lanes, lanes, 32, 1)
    idx, any_v = jax.vmap(jax_ops.pop_earliest)(time, seq, valid)
    got_idx, got_any = ops.pop_earliest(torch.from_numpy(time), torch.from_numpy(seq), torch.from_numpy(valid))
    assert got_idx.tolist() == np.asarray(idx).tolist()
    assert got_any.tolist() == np.asarray(any_v).tolist()
    valid[0] = True  # a full lane: no free slot
    fidx, fany = jax.vmap(jax_ops.find_free_slot)(valid)
    got_fidx, got_fany = ops.find_free_slot(torch.from_numpy(valid))
    assert got_fidx.tolist() == np.asarray(fidx).tolist()
    assert got_fany.tolist() == np.asarray(fany).tolist()


def test_cov_functions_match_jax():
    g = np.random.default_rng(3)
    lanes = 61
    abstract = g.integers(0, 2**32, lanes, dtype=np.uint32)
    ev_kind = g.integers(0, 3, lanes).astype(np.int32)
    ev_node = g.integers(-1, 5, lanes).astype(np.int32)
    op_word = g.integers(0, 20, lanes).astype(np.int32)
    ctx = g.integers(0, 256, lanes).astype(np.int32)
    t = lambda a: torch.from_numpy(np.asarray(a).astype(np.int64) if a.dtype == np.uint32 else a)  # noqa: E731
    words = [abstract, ev_kind, ev_node, op_word, ctx]
    want = jax.vmap(lambda *w: jax_cov.cov_mix(list(w)))(*words)
    assert coverage.cov_mix([t(w) for w in words]).tolist() == np.asarray(want).tolist()
    for band_bits in (3, 4):
        want = jax.vmap(lambda k, o: jax_cov.cov_band(k, o, band_bits))(ev_kind, op_word)
        assert coverage.cov_band(t(ev_kind), t(op_word), band_bits).tolist() == np.asarray(want).tolist()
        for slots_log2 in (band_bits + 4, 14):
            want = jax.vmap(lambda *a: jax_cov.cov_slot(*a, slots_log2, band_bits=band_bits))(*words)
            got = coverage.cov_slot(*(t(w) for w in words), slots_log2, band_bits=band_bits)
            assert got.tolist() == np.asarray(want).tolist()

    c = 16
    buf = g.integers(0, 2**14, (lanes, c)).astype(np.int32)
    n = g.integers(0, c, lanes).astype(np.int32)
    slot = g.integers(0, 2**14, lanes).astype(np.int32)
    hit = g.random(lanes) < 0.5
    wbuf, wn = jax.vmap(jax_cov.cov_push)(buf, n, slot, hit)
    gbuf, gn = coverage.cov_push(t(buf), t(n), t(slot), torch.from_numpy(hit))
    assert gbuf.tolist() == np.asarray(wbuf).tolist() and gn.tolist() == np.asarray(wn).tolist()
    same_buf, _ = coverage.cov_push(t(buf), t(n), t(slot), torch.from_numpy(hit), write=torch.tensor(False))
    assert same_buf.tolist() == buf.tolist()

    cov_map = g.integers(-2**31, 2**31, (lanes, 512)).astype(np.int32)
    buf[:, :4] = buf[:, :1]  # duplicate slots within one buffer
    want = jax.vmap(jax_cov.cov_flush)(cov_map, buf, n)
    assert coverage.cov_flush(t(cov_map), t(buf), t(n)).tolist() == np.asarray(want).tolist()
    want = jax_cov.cov_fold_words(jnp.asarray(cov_map))
    assert coverage.cov_fold_words(t(cov_map), chunk=16).tolist() == np.asarray(want).tolist()
    assert coverage.empty_cov_map(3, 14).shape == (3, 512)


def _jax_prefix(arrs, keys, steps, w, d0, d1):
    with_digest = d0 is not None
    return jax_megakernel(
        *(jnp.asarray(a) for a in arrs), jnp.asarray(keys), jnp.asarray(steps), w,
        d0=jnp.asarray(d0) if with_digest else None, d1=jnp.asarray(d1) if with_digest else None,
        digest_fold=jax_digest_fold if with_digest else None, interpret=True,
    )


@pytest.mark.parametrize("digest", [True, False], ids=["digest", "no-digest"])
@pytest.mark.parametrize("w", [7, 10])
@pytest.mark.parametrize("p", [4, 6])
@pytest.mark.parametrize("q", [32, 64])
def test_step_prefix_plain_matches_pallas_megakernel(q, p, w, digest):
    lanes = 13  # not a multiple of the kernel's 8-lane block
    arrs = _queues(q * p + w, lanes, q, p)
    g = np.random.default_rng(w)
    keys = g.integers(0, 2**32, (lanes, 2), dtype=np.uint32)
    steps = g.integers(0, 2**31, lanes).astype(np.int32)
    d0, d1 = (g.integers(0, 2**32, lanes, dtype=np.uint32) for _ in range(2))
    if not digest:
        d0 = d1 = None
    idx, any_v, popped, words, dig = _jax_prefix(arrs, keys, steps, w, d0, d1)

    i32 = lambda a: torch.from_numpy(np.asarray(a).view(np.int32) if a.dtype == np.uint32 else a)  # noqa: E731
    got = kernels.step_megakernel(
        *(torch.from_numpy(a) for a in arrs), i32(keys), torch.from_numpy(steps), w,
        d0=i32(d0) if digest else None, d1=i32(d1) if digest else None,
    )
    g_idx, g_any, g_popped, g_payload, g_words, g_dig = got
    assert g_idx.tolist() == np.asarray(idx).tolist()
    assert g_any.tolist() == np.asarray(any_v).tolist()
    for want, have in zip(popped[:4], g_popped):
        assert have.tolist() == np.asarray(want).tolist()
    assert g_payload.tolist() == np.asarray(popped[4]).tolist()
    assert np.array_equal(g_words.numpy().view(np.uint32), np.asarray(words))
    assert len(g_dig) == len(dig)
    for want, have in zip(dig, g_dig):
        assert np.array_equal(have.numpy().view(np.uint32), np.asarray(want))
    assert set(kernels.launches.values()) == {0}  # CPU: the twin ran


@pytest.mark.parametrize("c", [4, 16])
def test_cov_flush_plain_matches_pallas_kernel(c):
    g = np.random.default_rng(c)
    lanes, w = 37, 512
    cov_map = g.integers(-2**31, 2**31, (lanes, w)).astype(np.int32)
    buf = g.integers(0, w * 32, (lanes, c)).astype(np.int32)
    buf[:, : c // 2] = buf[:, :1]
    n = g.integers(0, c + 1, lanes).astype(np.int32)
    n[0], n[1] = 0, c
    want = cov_flush_pallas(jnp.asarray(cov_map), jnp.asarray(buf), jnp.asarray(n), interpret=True)
    t_map = torch.from_numpy(cov_map.copy())
    out = kernels.cov_flush_batch(t_map, torch.from_numpy(buf), torch.from_numpy(n))
    assert out is t_map  # updated in place on either device
    assert out.tolist() == np.asarray(want).tolist()
    assert kernels.cov_flush_plain(torch.from_numpy(cov_map), torch.from_numpy(buf), torch.from_numpy(n)).tolist() \
        == np.asarray(want).tolist()


def test_wrappers_refuse_other_devices():
    """A wrapper takes the twin only for CPU tensors; anything else that
    is not CUDA is refused, never silently computed elsewhere."""
    z = lambda *s, dtype=torch.int32: torch.zeros(s, dtype=dtype, device="meta")  # noqa: E731
    with pytest.raises(ValueError, match="cuda or cpu"):
        kernels.step_megakernel(
            z(2, 4), z(2, 4), z(2, 4, dtype=torch.bool), z(2, 4), z(2, 4), z(2, 4), z(2, 4, 3),
            z(2, 2), z(2), 10,
        )
    with pytest.raises(ValueError, match="cuda or cpu"):
        kernels.cov_flush_batch(z(2, 8), z(2, 4), z(2))


def test_machine_write_helpers_match_jax():
    """The lane-batched Machine authoring helpers against the reference's
    per-lane ones, vmapped: set_at, update_node, set2d, send_if,
    set_timer_if and make_payload."""
    from madsim_tpu.engine import machine as jax_machine
    from madsim_tpu.utils import set2d as jax_set2d
    from madsim_tpu_torch.engine import machine
    from madsim_tpu_torch.models.raft import RaftState
    from madsim_tpu_torch.utils import set2d

    g = np.random.default_rng(11)
    lanes, n = 17, 5
    arr = g.integers(-9, 9, (lanes, n, 3)).astype(np.int32)
    mat = g.integers(-9, 9, (lanes, n, n)).astype(np.int32)
    i, j = g.integers(-1, n + 1, lanes).astype(np.int32), g.integers(0, n, lanes).astype(np.int32)
    row = g.integers(-9, 9, (lanes, 3)).astype(np.int32)
    val = g.integers(-9, 9, lanes).astype(np.int32)
    cond = g.random(lanes) < 0.6
    t = torch.from_numpy

    want = jax.vmap(jax_machine.set_at)(arr, i, row, cond)
    assert machine.set_at(t(arr), t(i), t(row), t(cond)).tolist() == np.asarray(want).tolist()
    want = jax.vmap(jax_set2d)(mat, i, j, val)
    assert set2d(t(mat), t(i), t(j), t(val)).tolist() == np.asarray(want).tolist()

    state = RaftState(*(t(g.integers(-9, 9, (lanes, n)).astype(np.int32)) for _ in range(11)))
    got = machine.update_node(state, t(i), term=t(val), votes=7)
    assert got.term.tolist() == np.asarray(jax.vmap(jax_machine.set_at)(state.term.numpy(), i, val)).tolist()
    assert got.votes.tolist() == np.asarray(jax.vmap(lambda a, k: jax_machine.set_at(a, k, 7))(state.votes.numpy(), i)).tolist()

    def jax_out(cond, dst, pay, delay, tid):
        out = jax_machine.empty_outbox(4, 2, 6)
        out = jax_machine.send_if(out, 1, cond, dst, pay)
        out = jax_machine.set_timer_if(out, 0, cond, delay, tid)
        return out

    pay_vals = g.integers(-9, 9, (lanes, 3)).astype(np.int32)
    pay = jax.vmap(lambda a: jax_machine.make_payload(6, a[0], a[1], a[2]))(pay_vals)
    t_pay = machine.make_payload(6, *(t(pay_vals[:, k]) for k in range(3)))
    assert t_pay.tolist() == np.asarray(pay).tolist()
    want = jax.vmap(jax_out)(cond, j, pay, val, i)
    out = machine.empty_outbox(lanes, 4, 2, 6, "cpu")
    out = machine.send_if(out, 1, t(cond), t(j), t_pay)
    out = machine.set_timer_if(out, 0, t(cond), t(val), t(i))
    for name in ("msg_dst", "msg_payload", "msg_valid", "timer_delay_us", "timer_id", "timer_valid"):
        assert getattr(out, name).tolist() == np.asarray(getattr(want, name)).tolist(), name
