"""The plain twins of the pop kernels against the JAX package:
`pop_gather_plain` against `pop_gather_batch` and `pop_earliest_plain`
against `pop_earliest_batch`, each both through the Pallas kernel in
interpreter mode (as tests/test_pallas.py runs it) and through the XLA
path. On CPU tensors the wrappers run the twins and launch nothing.
Inputs come from numpy with a fixed seed: time ties, all-invalid lanes,
INT32_MAX in valid and invalid slots. Every comparison is exact."""

import functools
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_util  # noqa: F401  (one test thread; pins the Threefry lowering)
from madsim_tpu.engine.core import digest_fold as jax_digest_fold
from madsim_tpu.ops.pallas_pop import pop_earliest_batch as jax_pop_earliest
from madsim_tpu.ops.pallas_pop import pop_gather_batch as jax_pop_gather
from madsim_tpu.ops.pallas_pop import step_megakernel as jax_megakernel
from madsim_tpu.ops.step_rng import step_words_v3 as jax_step_words_v3
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


# -- the lane-group kernels, emulated ------------------------------------------
#
# A numpy/Python mirror of the lane-group mapping of ops/csrc/common.cuh,
# pop_gather.cu and step_megakernel.cu, line for line: which slots and
# fields each thread of a group owns, the local pass, the int4 / scalar
# split, the xor butterfly over (time, seq, index) triples, the gather
# rounds, the word block's pairs and the digest's shuffle order. The card
# is the only place the kernels run; this is where an ownership or tie bug
# shows first.

GATHER_ROUNDS = 2  # common.cuh
NO_SLOT = INT32_MAX


def _lex_less(a, b):
    """`lex_less` on (time, seq, index) triples."""
    return a < b  # Python compares tuples lexicographically


def _local_pass(time, seq, valid, g, group, vec):
    """One thread's pass over the slots it owns (`LexBest::take`): its
    lexicographic best (t, s, j), (INT32_MAX, INT32_MAX, NO_SLOT) when it
    owns no valid slot; and the slots it read."""
    q = len(time)
    if vec:  # int4 / uchar4 loads of slots 4g..4g+3, then + 4 * GROUP
        slots = [j + k for j in range(4 * g, q, 4 * group) for k in range(4)]
    else:
        slots = list(range(g, q, group))
    best = (INT32_MAX, INT32_MAX, NO_SLOT)
    for jj in slots:
        cand = (int(time[jj]), int(seq[jj]), jj)
        if bool(valid[jj]) and _lex_less(cand, best):
            best = cand
    return best, slots


def _group_argmin(time, seq, valid, group, vec):
    """`madsim::group_lex_argmin` over one row: (best, any), and the slots
    each thread read."""
    passes = [_local_pass(time, seq, valid, g, group, vec) for g in range(group)]
    b = [best for best, _ in passes]
    o = group // 2
    while o > 0:  # __shfl_xor_sync: every thread takes its partner's triple at once
        b = [min(b[g], b[g ^ o]) for g in range(group)]  # lex_less keeps the smaller
        o //= 2
    assert len(set(b)) == 1  # every thread of the group ends with the same triple
    j = b[0][2]
    return (j if j != NO_SLOT else 0), j != NO_SLOT, [slots for _, slots in passes]


def _field_ref(planes, outs, p, f):
    """`field_ref`: where field f of a slot lives, as (source, its offset,
    destination, its offset, stride, on). `planes` and `outs` are the flat
    (time, kind, node, src, payload) arrays in and out."""
    if f >= 4:
        return planes[4], f - 4, outs[4], f - 4, p, f < 4 + p
    return planes[f], 0, outs[f], 0, 1, True


def _gather(planes, outs, p, lane, at, group, written):
    """The gather of one lane by its group (`field_load` / `field_store`
    at `src[at * stride]` and `dst[lane * stride]`): the GATHER_ROUNDS
    register rounds, then the tail of fields past them. `written` collects
    (output, address) pairs to check each is written once."""
    nf = 4 + p
    for g in range(group):
        fields = [r * group + g for r in range(GATHER_ROUNDS)]
        fields += range(GATHER_ROUNDS * group + g, nf, group)
        for f in fields:
            src, so, dst, do, stride, on = _field_ref(planes, outs, p, f)
            if on:
                assert (f, lane) not in written
                written.add((f, lane))
                dst[do + lane * stride] = src[so + at * stride]


def _emulate_pop_gather(time, seq, valid, kind, node, src, payload, group, aligned):
    """`pop_gather_kernel` over every lane; `aligned` says whether the
    planes' rows are 16-byte aligned (the launcher's `rows_vectorizable`).
    Returns idx, any and the popped fields [L, 4 + P]."""
    lanes, q = time.shape
    p = payload.shape[2]
    vec = q % 4 == 0 and aligned
    planes = [a.ravel() for a in (time, kind, node, src, payload)]
    outs = [np.zeros(lanes, np.int32) for _ in range(4)] + [np.zeros(lanes * p, np.int32)]
    idx, anys, written = np.zeros(lanes, np.int32), np.zeros(lanes, bool), set()
    for lane in range(lanes):
        best, any_valid, slots = _group_argmin(time[lane], seq[lane], valid[lane], group, vec)
        assert sorted(j for s in slots for j in s) == list(range(q))  # every slot read once
        idx[lane], anys[lane] = best, any_valid
        _gather(planes, outs, p, lane, lane * q + best, group, written)
    assert len(written) == lanes * (4 + p)  # every field of every lane
    return idx, anys, np.concatenate([np.stack(outs[:4], 1), outs[4].reshape(lanes, p)], 1)


def _tie_heavy_queues(seed, lanes, q, p):
    """Tie-heavy random queues: times in [0, 3) and at INT32_MAX, seqs in
    [0, 3) (equal (time, seq) in different slots), all-invalid lanes, a
    lane valid only at INT32_MAX, and a lane of one valid slot at its end."""
    g = np.random.default_rng(seed)
    time = g.integers(0, 3, (lanes, q)).astype(np.int32)
    time[g.random((lanes, q)) < 0.25] = INT32_MAX
    seq = g.integers(0, 3, (lanes, q)).astype(np.int32)
    valid = g.random((lanes, q)) < 0.5
    valid[::4] = False
    valid[1] = time[1] == INT32_MAX
    valid[2] = False
    valid[2, q - 1] = True
    kind, node, src = (g.integers(-2**31, 2**31, (lanes, q)).astype(np.int32) for _ in range(3))
    payload = g.integers(-2**31, 2**31, (lanes, q, p)).astype(np.int32)
    return time, seq, valid, kind, node, src, payload


@functools.lru_cache(maxsize=None)
def _jax_pop(q, p):
    arrs = _tie_heavy_queues(q * 7 + p, 16, q, p)
    idx, any_v = jax_pop_earliest(*(jnp.asarray(a) for a in arrs[:3]), use_pallas=True, interpret=True)
    return arrs, np.asarray(idx), np.asarray(any_v)


@pytest.mark.parametrize("aligned", [True, False], ids=["int4", "scalar"])
@pytest.mark.parametrize("group", [4, 8])
@pytest.mark.parametrize("q", [1, 3, 5, 32, 33, 40, 48, 96, 256])
def test_lane_group_pop_gather_emulation_matches_jax(q, group, aligned):
    arrs, want_idx, want_any = _jax_pop(q, 6)
    idx, anys, fields = _emulate_pop_gather(*arrs, group, aligned)
    assert idx.tolist() == want_idx.tolist() and anys.tolist() == want_any.tolist()
    t_idx, t_any, t_popped, t_payload = kernels.pop_gather_plain(*(torch.from_numpy(a) for a in arrs))
    assert idx.tolist() == t_idx.tolist() and anys.tolist() == t_any.tolist()
    assert fields.tolist() == torch.cat([torch.stack(t_popped, 1), t_payload], 1).tolist()
    assert idx[0] == 0 and not anys[0]  # an all-invalid lane pops slot 0
    assert anys[1] == bool(arrs[2][1].any()) and (not anys[1] or arrs[0][1, idx[1]] == INT32_MAX)


# `pop_earliest_kernel` (pop_gather.cu) over its whole grid: blocks of
# GROUP_BLOCK threads, GROUP threads a lane, a group past the last lane
# computing the last lane again and storing nothing (at the replay's L = 1,
# 31 of the block's 32 groups), each live group's first thread storing
# (idx, any).

GROUP, GROUP_BLOCK = 8, 256  # common.cuh


def _emulate_pop_earliest(time, seq, valid, aligned):
    lanes, q = time.shape
    vec = q % 4 == 0 and aligned
    block, per_block = GROUP_BLOCK, GROUP_BLOCK // GROUP
    idx, anys, stores = np.zeros(lanes, np.int32), np.zeros(lanes, bool), np.zeros(lanes, int)
    for b in range((lanes + per_block - 1) // per_block):
        for t in range(0, block, GROUP):
            mine = b * per_block + t // GROUP
            lane = min(mine, lanes - 1)
            best, any_valid, slots = _group_argmin(time[lane], seq[lane], valid[lane], GROUP, vec)
            assert sorted(j for s in slots for j in s) == list(range(q))  # every slot read once
            if mine < lanes:
                idx[lane], anys[lane] = best, any_valid
                stores[lane] += 1
    assert stores.tolist() == [1] * lanes  # every lane stored, by one group
    return idx, anys


@pytest.mark.parametrize("aligned", [True, False], ids=["int4", "scalar"])
@pytest.mark.parametrize("q", [1, 3, 32, 33, 48, 256])
@pytest.mark.parametrize("lanes", [1, 4, 5, 37])
def test_lane_group_pop_earliest_emulation_matches_jax(lanes, q, aligned):
    """At the replay's L = 1 and small batches, against the JAX package's
    Pallas pop in interpret mode and the twin; Q = 48 (the mvcc and s3
    replays: 12 int4 loads over 8 threads) and 256 (gossip's: 32 slots a
    thread) are the corpus replays' widths."""
    arrs = _tie_heavy_queues(lanes * 100 + q, lanes + 4, q, 1)
    rows = slice(1, 1 + lanes) if lanes <= 4 else slice(0, lanes)  # L <= 4: no all-invalid lane 0
    time, seq, valid = (a[rows] for a in arrs[:3])
    want_idx, want_any = jax_pop_earliest(jnp.asarray(time), jnp.asarray(seq), jnp.asarray(valid),
                                          use_pallas=True, interpret=True)
    t_idx, t_any = kernels.pop_earliest_plain(*(torch.from_numpy(a) for a in (time, seq, valid)))
    idx, anys = _emulate_pop_earliest(time, seq, valid, aligned)
    assert idx.tolist() == np.asarray(want_idx).tolist() == t_idx.tolist()
    assert anys.tolist() == np.asarray(want_any).tolist() == t_any.tolist()


def test_lane_group_pop_earliest_emulation_on_a_replay_state():
    """The replay's own input: seed 66531's single lane REPLAY_STATE_STEPS
    events in (the port on the CPU), popped by the emulated kernel, the
    JAX package's Pallas pop in interpret mode and the twin."""
    from chip_smoke import REPLAY_CONFIG, REPLAY_SEED, REPLAY_STATE_STEPS
    from madsim_tpu_torch.engine import Engine, EngineConfig, FaultPlan
    from madsim_tpu_torch.models import build_machine

    faults = FaultPlan(n_faults=2, t_max_us=3_000_000, dur_min_us=200_000, dur_max_us=800_000)
    eng = Engine(build_machine("raft"), EngineConfig(**REPLAY_CONFIG, faults=faults), device="cpu")
    state = eng.run_segment(eng.init_batch([REPLAY_SEED]), REPLAY_STATE_STEPS)
    time, seq, valid = (x.numpy() for x in (state.eq_time, state.eq_seq, state.eq_valid))
    assert time.shape == (1, 32) and valid.sum() > 1
    want_idx, want_any = jax_pop_earliest(jnp.asarray(time), jnp.asarray(seq), jnp.asarray(valid),
                                          use_pallas=True, interpret=True)
    idx, anys = _emulate_pop_earliest(time, seq, valid, aligned=True)
    t_idx, t_any = kernels.pop_earliest_batch(state.eq_time, state.eq_seq, state.eq_valid)
    assert idx.tolist() == np.asarray(want_idx).tolist() == t_idx.tolist()
    assert anys.tolist() == np.asarray(want_any).tolist() == t_any.tolist() == [True]


# The megakernel's word block and digest (step_megakernel.cu), in uint32
# arithmetic mirroring the .cu's `threefry2x32` and `digest_word`.

M32 = 0xFFFFFFFF


def _rotl(x, r):
    return ((x << r) | (x >> (32 - r))) & M32


def _threefry2x32(k0, k1, x0, x1):
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    rot = ((13, 15, 26, 6), (17, 29, 16, 24))
    x0, x1 = (x0 + ks[0]) & M32, (x1 + ks[1]) & M32
    for i in range(5):
        for r in rot[i & 1]:
            x0 = (x0 + x1) & M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & M32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & M32
    return x0, x1


def _digest_word(d0, d1, w):
    d0 = ((d0 ^ w) * 0x9E3779B1) & M32
    d0 ^= d0 >> 16
    d1 = ((d1 ^ _rotl(w, 13)) * 0x85EBCA6B) & M32
    return d0, d1 ^ (d1 >> 15) ^ d0


def _emulate_step_words_and_digest(key, step, w, row_fields, d, group):
    """One lane of `step_megakernel_kernel` past the argmin: the pairs
    each thread computes, the words they write, and the digest in the
    order the group's shuffles feed it."""
    k0, k1 = (int(k) & M32 for k in key)
    base = (int(step) & M32) * w & M32
    half = (w + 1) // 2
    words, first = [None] * w, {}
    for g in range(group):
        for i in range(g, half, group):
            i1 = i + half
            y0, y1 = _threefry2x32(k0, k1, (base + i) & M32, (base + i1) & M32 if i1 < w else 0)
            assert words[i] is None
            words[i] = y0
            if i1 < w:
                assert words[i1] is None
                words[i1] = y1
            first.setdefault(g, (y0, y1))  # x0 / x1
    assert None not in words
    if d is None:
        return words, None
    d0, d1 = (int(x) & M32 for x in d)
    nf = len(row_fields)
    v = {}  # (round, thread) -> field value held in a register
    for r in range((nf + group - 1) // group):
        for g in range(group):
            f = r * group + g
            v[r, g] = int(row_fields[f]) & M32 if f < nf else 0
    for r in range((nf + group - 1) // group):  # the register rounds, then the tail
        for j in range(min(group, nf - r * group)):
            d0, d1 = _digest_word(d0, d1, v[r, j])  # __shfl_sync(mask, x, j, GROUP)
    if half <= group:
        for i in range(half):
            d0, d1 = _digest_word(d0, d1, first[i][0])
        for i in range(w - half):
            d0, d1 = _digest_word(d0, d1, first[i][1])
    else:  # re-read from global memory after __syncwarp
        for i in range(w):
            d0, d1 = _digest_word(d0, d1, words[i])
    return words, (d0, d1)


def _megakernel_inputs(w, p):
    lanes, q = 6, 33
    arrs = _tie_heavy_queues(w * 31 + p, lanes, q, p)
    g = np.random.default_rng(w + p)
    keys = g.integers(-2**31, 2**31, (lanes, 2)).astype(np.int32)
    steps = g.integers(0, 2**31, lanes).astype(np.int32)
    d = g.integers(-2**31, 2**31, (2, lanes)).astype(np.int32)
    return arrs, keys, steps, d


@functools.lru_cache(maxsize=None)
def _jax_megakernel(w, p):
    """The JAX package's step prefix, digest on: its Pallas megakernel in
    interpret mode, or at P = 0, which that kernel does not take (it
    stacks at least one payload column), the XLA path the kernel is
    bit-identical to (pop + gather, `step_words_v3`, `digest_fold`).
    Returns (idx, any, popped [L, 4 + P], words [L, W], (d0, d1)) as
    numpy."""
    arrs, keys, steps, d = _megakernel_inputs(w, p)
    u32 = lambda a: jnp.asarray(a.view(np.uint32))  # noqa: E731
    ins = [jnp.asarray(a) for a in arrs]
    if p:
        idx, any_v, popped, words, (d0, d1) = jax_megakernel(
            *ins, u32(keys), jnp.asarray(steps), w,
            d0=u32(d[0]), d1=u32(d[1]), digest_fold=jax_digest_fold, interpret=True)
    else:
        idx, any_v, popped = jax_pop_gather(*ins)
        layout = SimpleNamespace(total_words=w, restart_off=None)
        words = jax.vmap(lambda k, s: jax_step_words_v3(k, s, layout)[1])(u32(keys), jnp.asarray(steps))
        d0, d1 = jax_digest_fold(u32(d[0]), u32(d[1]), [*popped[:4], *(words[:, i] for i in range(w))])
    fields = np.concatenate([np.stack([np.asarray(x) for x in popped[:4]], 1), np.asarray(popped[4])], 1)
    return np.asarray(idx), np.asarray(any_v), fields, np.asarray(words), (np.asarray(d0), np.asarray(d1))


@pytest.mark.parametrize("group", [4, 8])
@pytest.mark.parametrize("p", [0, 6, 13])
@pytest.mark.parametrize("w", [1, 10, 11, 256])
def test_lane_group_megakernel_emulation_matches_twin(w, p, group):
    """The emulated megakernel at Q = 33 against the twin and against the
    JAX package's Pallas megakernel (interpret mode), on the same inputs."""
    arrs, keys, steps, d = _megakernel_inputs(w, p)
    t = torch.from_numpy
    t_idx, t_any, t_popped, t_payload, t_words, (t_d0, t_d1) = kernels.step_prefix_plain(
        *(t(a) for a in arrs), t(keys), t(steps), w, t(d[0]), t(d[1]))
    j_idx, j_any, j_fields, j_words, (j_d0, j_d1) = _jax_megakernel(w, p)
    idx, anys, fields = _emulate_pop_gather(*arrs, group, aligned=True)
    assert idx.tolist() == t_idx.tolist() == j_idx.tolist()
    assert anys.tolist() == t_any.tolist() == j_any.tolist()
    assert fields.tolist() == torch.cat([torch.stack(t_popped, 1), t_payload], 1).tolist() == j_fields.tolist()
    for lane in range(len(idx)):
        words, (d0, d1) = _emulate_step_words_and_digest(keys[lane], steps[lane], w, fields[lane],
                                                         d[:, lane], group)
        assert words == (t_words[lane].numpy().view(np.uint32)).tolist() == j_words[lane].tolist(), lane
        assert [d0, d1] == [int(t_d0[lane]) & M32, int(t_d1[lane]) & M32] == [int(j_d0[lane]), int(j_d1[lane])], lane
