"""The port's kv, mq and twopc machines against the JAX models: the
batched handlers against the vmapped ones on reachable node states (JAX
runs of each model's bug variant), for the honest machine and the bug,
then the invariant (every fail code), termination, summary, coverage
projection and restart hooks; `run_batch` of each honest model and of
the three bug variants of tests/test_engine.py (`DurabilityBugKv`,
`NoDedupBroker`, `EagerCommitTwoPc`) under their plans on both streams,
each bug failing with its code on the same seeds as JAX; the legacy
`init_node` restart bridge on the port's KvMachine, as
tests/test_engine.py:251-335 runs it; and the registry, which builds
every name the reference's CLI registry knows. Every comparison is
exact."""

import ast
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from madsim_tpu.models import kv as jax_kv
from madsim_tpu.models import mq as jax_mq
from madsim_tpu.models import twopc as jax_twopc
from madsim_tpu_torch.engine.machine import Machine
from madsim_tpu_torch.models import build_machine, kv, mq, twopc

from torch_port_util import check_handlers, check_hooks, check_projection, engines, jax_snapshots, same, torch_nodes

# the plans of tests/test_engine.py:238-434 (Q = 64), each cut to a step
# budget past its lanes' end or its bug's first failures
KV = dict(horizon_us=3_000_000, queue_capacity=64)
KV_FAULTS = dict(n_faults=2, t_max_us=2_000_000, dur_min_us=100_000, dur_max_us=400_000)
KV_KILL_FAULTS = dict(n_faults=3, allow_partition=False, allow_kill=True, t_max_us=2_000_000, dur_min_us=50_000,
                      dur_max_us=200_000)
MQ = dict(horizon_us=6_000_000, queue_capacity=64, packet_loss_rate=0.1)
MQ_FAULTS = dict(n_faults=1, t_max_us=3_000_000, dur_min_us=100_000, dur_max_us=400_000)
NODEDUP = dict(horizon_us=6_000_000, queue_capacity=64, packet_loss_rate=0.3)
TWOPC = dict(horizon_us=5_000_000, queue_capacity=64, packet_loss_rate=0.1)
TWOPC_FAULTS = dict(n_faults=2, t_max_us=3_000_000, dur_min_us=100_000, dur_max_us=400_000)
EAGER = dict(horizon_us=5_000_000, queue_capacity=64)
NO_FAULTS = dict(n_faults=0)


class JaxDurabilityBugKv(jax_kv.KvMachine):
    def restart_if(self, nodes, i, cond, rng_key):
        return self._wipe_node_if(nodes, i, cond, rng_key)  # BUG: the server's store too


class DurabilityBugKv(kv.KvMachine):
    def restart_if(self, nodes, i, cond, rng_key):
        return self._wipe_node_if(nodes, i, cond, rng_key)


class JaxNoDedupBroker(jax_mq.MqMachine):
    def _accepts(self, nodes, producer, seq):
        return jnp.bool_(True)  # BUG: retried duplicates append too


class NoDedupBroker(mq.MqMachine):
    def _accepts(self, nodes, producer, seq):
        return torch.ones_like(seq, dtype=torch.bool)


class JaxEagerCommitTwoPc(jax_twopc.TwoPcMachine):
    def _all_votes_in(self, votes_recv):
        return votes_recv != 0  # BUG: decide as soon as any vote arrives


class EagerCommitTwoPc(twopc.TwoPcMachine):
    def _all_votes_in(self, votes_recv):
        return votes_recv != 0


def _rows(np_nodes, field, node):
    return np.asarray(getattr(np_nodes, field))[np.arange(len(node)), node]


def _base(g, now, n, n_tids):
    lanes = len(now)
    node = g.integers(0, n, lanes).astype(np.int32)
    tid = g.integers(0, n_tids + 1, lanes).astype(np.int32)
    t_now = (now + g.integers(0, 300_000, lanes)).astype(np.int32)
    rand = g.integers(0, 2**32, (lanes, 4), dtype=np.uint32)
    return lanes, node, tid, t_now, rand


# -- kv ------------------------------------------------------------------------


def _kv_inputs(seed, np_nodes, now):
    """The server and clients, every timer (and a stray id), every
    message type with reqids and versions at and around the node's, and
    client ids past the range."""
    g = np.random.default_rng(seed)
    lanes, node, tid, t_now, rand = _base(g, now, 4, 3)
    node[::3] = 0
    src = g.integers(0, 4, lanes).astype(np.int32)
    payload = np.zeros((lanes, 5), np.int32)
    payload[:, 0] = np.where(node == 0, g.choice([1, 3], lanes), g.integers(0, 6, lanes))
    payload[:, 1] = g.integers(1, 4, lanes)
    payload[::7, 1] = g.choice([-1, 4, 9], len(payload[::7]))
    reqid = _rows(np_nodes, "reqid", node) + g.integers(-1, 2, lanes)
    payload[:, 2] = np.where(node == 0, g.integers(0, 9, lanes), reqid)
    payload[:, 3] = _rows(np_nodes, "acked_version", node) + g.integers(-2, 3, lanes)
    payload[:, 4] = g.integers(0, 400_000, lanes)
    return node, tid, t_now, rand, src, payload


@pytest.fixture(scope="module")
def kv_snapshots():
    jax_eng, _ = engines(JaxDurabilityBugKv(4), DurabilityBugKv(4), rng_stream=2, flight_recorder=False,
                         coverage=False, faults=KV_KILL_FAULTS, **KV)
    return jax_snapshots(jax_eng, np.arange(48), (0, 20, 60, 120))


@pytest.mark.parametrize("bug", [False, True], ids=["honest", "durabilitybug"])
def test_kv_handlers_match_jax(kv_snapshots, bug):
    jax_m, port_m = (JaxDurabilityBugKv(4), DurabilityBugKv(4)) if bug else (jax_kv.KvMachine(4), kv.KvMachine(4))
    check_handlers(jax_m, port_m, kv_snapshots, _kv_inputs)


def test_kv_hooks_match_jax(kv_snapshots):
    np_nodes, now = kv_snapshots[-1]
    bad = jax.tree.map(np.copy, np_nodes)
    bad.stale[0::4, 2] = True  # STALE_READ
    bad.acked_version[1::4, 1] = 50  # a client ahead of the server
    for jax_m, port_m in ((jax_kv.KvMachine(4), kv.KvMachine(4)), (JaxDurabilityBugKv(4), DurabilityBugKv(4))):
        check_hooks(jax_m, port_m, [np_nodes, bad], now)
    check_projection(jax_kv.KvMachine(4), kv.KvMachine(4), [s for s, _ in kv_snapshots] + [bad], now)
    _, code = kv.KvMachine(4).invariant(torch_nodes(kv.KvState, bad), torch.from_numpy(now.copy()))
    assert kv.STALE_READ in code.tolist()


# -- mq ------------------------------------------------------------------------


def _mq_inputs(seed, np_nodes, now):
    """The broker, producers and the consumer, every timer, every message
    type with seqs around the broker's cursors, offsets around the
    consumer's and the log's length (and past the log), and producer ids
    past the range."""
    g = np.random.default_rng(seed)
    lanes, node, tid, t_now, rand = _base(g, now, 4, 4)
    node[::3] = 0
    src = g.integers(0, 4, lanes).astype(np.int32)
    log_len = np.asarray(np_nodes.log_len)[:, 0]
    payload = np.zeros((lanes, 5), np.int32)
    payload[:, 0] = np.where(node == 0, g.choice([1, 3], lanes), g.integers(1, 5, lanes))
    prod = g.integers(1, 3, lanes)
    expected = np.asarray(np_nodes.expected)[np.arange(lanes), 0, prod]
    offset = np.asarray(np_nodes.offset)[:, 3]
    payload[:, 1] = np.where(payload[:, 0] == 1, prod, np.where(payload[:, 0] == 4, offset + g.integers(-1, 2, lanes),
                                                                g.integers(0, 12, lanes)))
    payload[::9, 1] = g.choice([-1, 3, 7], len(payload[::9]))
    payload[:, 2] = np.where(payload[:, 0] == 1, expected + g.integers(-1, 2, lanes),
                             np.where(payload[:, 0] == 3, log_len + g.integers(-2, 2, lanes), prod))
    payload[::11, 2] = g.choice([-1, 24, 30], len(payload[::11]))
    seen = np.asarray(np_nodes.seen)[np.arange(lanes), 3, prod]
    payload[:, 3] = seen + g.integers(-1, 2, lanes)
    return node, tid, t_now, rand, src, payload


@pytest.fixture(scope="module")
def mq_snapshots():
    jax_eng, _ = engines(JaxNoDedupBroker(4), NoDedupBroker(4), rng_stream=2, flight_recorder=False, coverage=False,
                         faults=MQ_FAULTS, **NODEDUP)
    return jax_snapshots(jax_eng, np.arange(48), (0, 15, 30, 45))


@pytest.mark.parametrize("bug", [False, True], ids=["honest", "nodedup"])
def test_mq_handlers_match_jax(mq_snapshots, bug):
    jax_m, port_m = (JaxNoDedupBroker(4), NoDedupBroker(4)) if bug else (jax_mq.MqMachine(4), mq.MqMachine(4))
    check_handlers(jax_m, port_m, mq_snapshots, _mq_inputs)


def test_mq_hooks_match_jax(mq_snapshots):
    np_nodes, now = mq_snapshots[-1]
    bad = jax.tree.map(np.copy, np_nodes)
    bad.bad[0::4, 3] = True  # DUP_OR_GAP
    bad.offset[1::4, 3] = 20  # done
    check_hooks(jax_mq.MqMachine(4), mq.MqMachine(4), [np_nodes, bad], now)
    check_projection(jax_mq.MqMachine(4), mq.MqMachine(4), [np_nodes, bad], now)
    port_m = mq.MqMachine(4)
    t_nodes, t_now = torch_nodes(mq.MqState, bad), torch.from_numpy(now.copy())
    assert mq.DUP_OR_GAP in port_m.invariant(t_nodes, t_now)[1].tolist() and bool(port_m.is_done(t_nodes, t_now).any())


# -- twopc ---------------------------------------------------------------------


def _twopc_inputs(seed, np_nodes, now):
    """The coordinator and participants, boot, tick and stray timers,
    every message type for the current txn, its neighbours and ids past
    the log, votes and decisions of every value, and sources past the
    node range (the vote bitmask's shift)."""
    g = np.random.default_rng(seed)
    lanes, node, tid, t_now, rand = _base(g, now, 4, 2)
    node[::3] = 0
    src = g.integers(1, 4, lanes).astype(np.int32)
    src[::13] = g.choice([-1, 0, 4, 40], len(src[::13]))
    cur = np.asarray(np_nodes.cur_txn)[:, 0]
    payload = np.zeros((lanes, 4), np.int32)
    payload[:, 0] = np.where(node == 0, g.choice([2, 4], lanes), g.choice([1, 3], lanes))
    payload[::10, 0] = g.integers(0, 6, len(payload[::10]))
    payload[:, 1] = cur + g.integers(-1, 2, lanes)
    payload[::9, 1] = g.choice([-1, 6, 7], len(payload[::9]))
    payload[:, 2] = g.integers(0, 3, lanes)
    return node, tid, t_now, rand, src, payload


@pytest.fixture(scope="module")
def twopc_snapshots():
    jax_eng, _ = engines(JaxEagerCommitTwoPc(4, 6), EagerCommitTwoPc(4, 6), rng_stream=2, flight_recorder=False,
                         coverage=False, faults=TWOPC_FAULTS, **TWOPC)
    return jax_snapshots(jax_eng, np.arange(48), (0, 10, 30, 60))


@pytest.mark.parametrize("bug", [False, True], ids=["honest", "eagercommit"])
def test_twopc_handlers_match_jax(twopc_snapshots, bug):
    jax_m, port_m = (JaxEagerCommitTwoPc(4, 6), EagerCommitTwoPc(4, 6)) if bug else \
        (jax_twopc.TwoPcMachine(4, 6), twopc.TwoPcMachine(4, 6))
    check_handlers(jax_m, port_m, twopc_snapshots, _twopc_inputs)


def test_twopc_hooks_match_jax(twopc_snapshots):
    np_nodes, now = twopc_snapshots[-1]
    bad = jax.tree.map(np.copy, np_nodes)
    bad.outcome[0::4, 1, 2], bad.outcome[0::4, 2, 2] = twopc.COMMIT, twopc.ABORT  # ATOMICITY
    bad.cur_txn[1::4, 0] = 6  # done
    bad.votes_recv[2::4, 0] = 0b1110
    jax_m, port_m = jax_twopc.TwoPcMachine(4, 6), twopc.TwoPcMachine(4, 6)
    check_hooks(jax_m, port_m, [np_nodes, bad], now)
    check_projection(jax_m, port_m, [s for s, _ in twopc_snapshots] + [bad], now)
    _, code = port_m.invariant(torch_nodes(twopc.TwoPcState, bad), torch.from_numpy(now.copy()))
    assert twopc.ATOMICITY in code.tolist()


# -- run_batch -----------------------------------------------------------------

# (id, the JAX machine, the port's, config, plan, seeds, step budget, the
# bug's code, or None for an honest model that must run clean)
RUNS = [
    ("kv", lambda: jax_kv.KvMachine(4), lambda: build_machine("kv"), KV, KV_FAULTS, 32, 160, None),
    ("durabilitybug-kv", lambda: JaxDurabilityBugKv(4), lambda: DurabilityBugKv(4), KV, KV_KILL_FAULTS, 48, 160,
     kv.STALE_READ),
    ("mq", lambda: jax_mq.MqMachine(4), lambda: build_machine("mq"), MQ, MQ_FAULTS, 24, 256, None),
    ("nodedup-mq", lambda: JaxNoDedupBroker(4), lambda: NoDedupBroker(4), NODEDUP, NO_FAULTS, 32, 48, mq.DUP_OR_GAP),
    ("twopc", lambda: jax_twopc.TwoPcMachine(4, 6), lambda: build_machine("twopc"), TWOPC, TWOPC_FAULTS, 32, 128,
     None),
    ("eagercommit-twopc", lambda: JaxEagerCommitTwoPc(4, 6), lambda: EagerCommitTwoPc(4, 6), EAGER, NO_FAULTS, 32, 48,
     twopc.ATOMICITY),
]


@pytest.mark.parametrize("rng_stream", [2, 3])
@pytest.mark.parametrize("name,jax_machine,port_machine,cfg,faults,lanes,steps,code", RUNS, ids=[r[0] for r in RUNS])
def test_run_batch_matches_jax(name, jax_machine, port_machine, cfg, faults, lanes, steps, code, rng_stream):
    """Recorder and coverage on: the whole BatchResult equals JAX's; an
    honest model runs clean (twopc through its six txns), a bug fails with
    its code on the same seeds. mq lanes end in 180-330 events, so the
    budget holds some of them mid-stream."""
    jax_eng, port = engines(jax_machine(), port_machine(), rng_stream=rng_stream, faults=faults, **cfg)
    seeds = np.arange(lanes, dtype=np.uint32)
    want = jax.jit(jax_eng.run_batch, static_argnums=1)(jnp.asarray(seeds), steps)
    got = port.run_batch(seeds, steps)
    same(want, got, name)
    codes = set(got.fail_code.numpy()[got.failed.numpy()].tolist())
    assert codes == ({code} if code else set()), codes
    if name == "twopc":
        assert bool(got.done.all()) and got.summary["txns"].tolist() == [6] * lanes


# -- the legacy init_node restart bridge ---------------------------------------

LANES = 2


def _lanes(*vals, dtype=torch.int32):
    return torch.tensor(vals, dtype=dtype)


def _keys():
    return torch.zeros((LANES, 2), dtype=torch.int64)


def test_base_restart_if_honors_legacy_init_node_override():
    """A machine written against the older hook (init_node only) keeps
    its durable state under the engine's restart_if path."""

    @dataclasses.dataclass
    class S:
        durable: torch.Tensor
        volatile: torch.Tensor

    class LegacyMachine(Machine):
        NUM_NODES = 3
        state_type = S

        def init(self, rng_key):
            z = torch.zeros((rng_key.shape[0], 3), dtype=torch.int32)
            return S(durable=z, volatile=z)

        def init_node(self, nodes, i, rng_key):  # the legacy restart hook
            mask = torch.arange(3)[None, :] == i[:, None]
            return dataclasses.replace(nodes, volatile=torch.where(mask, 0, nodes.volatile))

    m = LegacyMachine()
    nodes = S(durable=torch.tensor([[5, 6, 7]] * LANES, dtype=torch.int32),
              volatile=torch.tensor([[1, 2, 3]] * LANES, dtype=torch.int32))
    out = m.restart_if(nodes, _lanes(1, 1), _lanes(True, False, dtype=torch.bool), _keys())
    assert out.durable.tolist() == [[5, 6, 7]] * LANES  # the durable leaf survives
    assert out.volatile.tolist() == [[1, 0, 3], [1, 2, 3]]  # only row 1 of lane 0: cond gates the rest


def test_shipped_model_honors_legacy_init_node_override():
    """A subclass of a shipped model that overrides only the legacy
    init_node hook gets its restart semantics through the engine's
    restart dispatch."""

    class LegacyWipeKv(kv.KvMachine):
        def init_node(self, nodes, i, rng_key):  # the legacy hook only
            # wipe everything on restart, the server's store included
            return self._wipe_node_if(nodes, i, torch.ones_like(i, dtype=torch.bool), rng_key)

    m = LegacyWipeKv(4)
    nodes = m.init(_keys())
    nodes = dataclasses.replace(nodes, version=nodes.version + 7)
    server = _lanes(kv.SERVER, kv.SERVER)
    out = m.restart_node_if(nodes, server, _lanes(True, False, dtype=torch.bool), _keys())
    assert out.version[:, kv.SERVER].tolist() == [0, 7]  # the legacy wipe, gated by cond
    # the stock model keeps its durable store
    stock = kv.KvMachine(4).restart_node_if(nodes, server, _lanes(True, True, dtype=torch.bool), _keys())
    assert stock.version[:, kv.SERVER].tolist() == [7, 7]


def test_legacy_init_node_calling_super_does_not_recurse():
    """A legacy init_node override that calls super().init_node() (which
    shipped models implement through restart_if) does not recurse
    through the dispatch, and a new-style restart_if override still wins
    it."""

    class LegacySuperKv(kv.KvMachine):
        def init_node(self, nodes, i, rng_key):
            # the stock client reset first, then also wipe the server's store
            nodes = super().init_node(nodes, i, rng_key)
            return self._wipe_node_if(nodes, i, torch.ones_like(i, dtype=torch.bool), rng_key)

    m = LegacySuperKv(4)
    nodes = m.init(_keys())
    nodes = dataclasses.replace(nodes, version=nodes.version + 7, acked_version=nodes.acked_version + 3)
    out = m.restart_node_if(nodes, _lanes(1, 1), _lanes(True, True, dtype=torch.bool), _keys())
    assert out.version[:, 1].tolist() == [0, 0] and out.acked_version[:, 1].tolist() == [0, 0]

    class NewStyleKv(kv.KvMachine):
        def restart_if(self, nodes, i, cond, rng_key):
            return self._wipe_node_if(nodes, i, cond, rng_key)

    out2 = NewStyleKv(4).restart_node_if(nodes, _lanes(kv.SERVER, kv.SERVER), _lanes(True, True, dtype=torch.bool),
                                         _keys())
    assert out2.version[:, kv.SERVER].tolist() == [0, 0]


# -- the registry ----------------------------------------------------------------


def test_registry_builds_every_name_of_the_reference():
    """The reference's CLI registry names its machines in the message it
    exits with for an unknown name; the port builds each, with the same
    class name and node count, and refuses an unknown name naming it."""
    from madsim_tpu.__main__ import build_machine as jax_build

    with pytest.raises(SystemExit) as exc:
        jax_build("no-such-machine")
    names = ast.literal_eval(str(exc.value).split("choose from ", 1)[1])
    assert {"kv", "mq", "twopc"} <= set(names) and len(names) >= 30
    for name in names:
        jax_m, port_m = jax_build(name), build_machine(name)
        assert (type(port_m).__name__, port_m.NUM_NODES) == (type(jax_m).__name__, jax_m.NUM_NODES), name
    m = build_machine("mq")
    assert (m.log_capacity, m.max_seq, build_machine("twopc").MAX_TXN) == (24, 10, 6)
    with pytest.raises(ValueError, match="unknown machine 'no-such-machine'"):
        build_machine("no-such-machine")
