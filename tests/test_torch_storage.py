"""The storage fault kinds in the port, against the JAX package and host
oracles (the ports of tests/test_chaos_palette.py's torn and heal-asym
tests): `torn_hash` and `torn_restart_if` on a four-leaf toy (atomic,
lost, prefix and volatile rows), the leaf order that salts the damage
against `jax.tree.leaves`, the two refusals of `allow_torn`, the
raft-compact model (its constructor's refusals, handlers and hooks), the
torn-snapshot hunt (`run_batch` and the replay of its first find), the
one-way heal window's oracle on the port's replay, and honest
raft-compact under the 11-kind soak. Every comparison with the JAX
package is exact, on both RNG streams where the engine runs."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from madsim_tpu.engine import core as jax_core
from madsim_tpu.engine import machine as jax_machine
from madsim_tpu.engine.replay import replay as jax_replay
from madsim_tpu.models import raft_compact as jax_rc
from madsim_tpu_torch.engine import Engine, EngineConfig, FaultPlan, core
from madsim_tpu_torch.engine import machine
from madsim_tpu_torch.engine.replay import replay
from madsim_tpu_torch.interop import tree_to_numpy
from madsim_tpu_torch.models import build_machine, raft_compact
from madsim_tpu_torch.models.echo import EchoMachine
from madsim_tpu_torch.utils import take

from test_chaos_palette import HORIZON_US, TICK_US, WINDOW
from test_chaos_palette import BidiTickMachine as JaxBidiTickMachine
from test_chaos_palette import TornToy as JaxTornToy
from test_torch_chaos import TickMachine
from torch_port_util import check_handlers, engines, jax_snapshots, jax_to_numpy, same, torch_nodes, tree_diff

STREAMS = [2, 3]
# the torn-snapshot plan of tests/test_chaos_palette.py:355-382
TORN_FAULTS = dict(n_faults=3, t_max_us=1_800_000, dur_min_us=100_000, dur_max_us=600_000, allow_partition=False,
                   allow_kill=False, allow_torn=True, strict_restart=True)
TORN_CONFIG = dict(horizon_us=4_000_000, queue_capacity=64, flight_recorder=True, coverage=True)
# the reference test's 48 seeds; by step 448 seeds 0 and 27 (v3) and 2,
# 3, 27 and 38 (v2) have failed LOG_MATCHING in the JAX package
TORN_SEEDS, TORN_STEPS = np.arange(48, dtype=np.uint32), 448
# the honest soak of tests/test_chaos_palette.py:430-441: every kind
SOAK_CONFIG = dict(horizon_us=4_000_000, queue_capacity=96, packet_loss_rate=0.01, flight_recorder=True,
                   coverage=True, fr_digest_ring=4)
SOAK_FAULTS = dict(n_faults=3, t_max_us=2_400_000, dur_min_us=100_000, dur_max_us=600_000, allow_dir_clog=True,
                   allow_group=True, allow_storm=True, allow_delay=True, allow_pause=True, allow_skew=True,
                   allow_dup=True, allow_torn=True, allow_heal_asym=True, strict_restart=True)


@dataclasses.dataclass
class TornState:
    atomic: torch.Tensor  # int32[L, 3]
    lost: torch.Tensor  # int32[L, 3]
    ring: torch.Tensor  # int32[L, 3, 4]
    vol: torch.Tensor  # int32[L, 3]


class TornToy(machine.Machine):
    """The reference test's four-leaf machine: one leaf of each torn
    class, and a volatile one."""

    NUM_NODES = 3
    PAYLOAD_WIDTH = 3
    state_type = TornState

    def init(self, rng_key):
        z = torch.zeros((rng_key.shape[0], self.NUM_NODES), dtype=torch.int32, device=rng_key.device)
        ring = torch.zeros((rng_key.shape[0], self.NUM_NODES, 4), dtype=torch.int32, device=rng_key.device)
        return TornState(atomic=z, lost=z, ring=ring, vol=z)

    def durable_spec(self):
        return TornState(atomic=True, lost=True, ring=True, vol=False)

    def torn_spec(self):
        return TornState(atomic=machine.TORN_ATOMIC, lost=machine.TORN_LOSE, ring=machine.TORN_PREFIX,
                         vol=machine.TORN_ATOMIC)

    def on_timer(self, nodes, node, timer_id, now_us, rand_u32):
        return nodes, self.empty_outbox(node.shape[0], node.device)

    def on_message(self, nodes, node, src, payload, now_us, rand_u32):
        return nodes, self.empty_outbox(node.shape[0], node.device)


class BidiTickMachine(TickMachine):
    """The reference test's tickers with traffic both ways between nodes
    0 and 2, so one-way clog windows show in the delivery trace."""

    def on_timer(self, nodes, node, timer_id, now_us, rand_u32):
        outbox = self.empty_outbox(node.shape[0], node.device)
        is_tick = timer_id == 1
        nodes = dataclasses.replace(nodes, ticks=machine.set_at(nodes.ticks, node, take(nodes.ticks, node) + 1,
                                                                is_tick))
        outbox = machine.set_timer_if(outbox, 0, torch.ones_like(is_tick), TICK_US, 1)
        pay = machine.make_payload(self.PAYLOAD_WIDTH, 1, take(nodes.ticks, node))
        peer = torch.where(node == 0, self.NUM_NODES - 1, 0)
        return nodes, machine.send_if(outbox, 0, is_tick & ((node == 0) | (node == 2)), peer, pay)


def _leaf_names(jax_tree):
    """The JAX package's flatten order of a state tree, by leaf name."""
    paths = jax.tree_util.tree_flatten_with_path(jax_tree)[0]
    return [getattr(p[0], "name", getattr(p[0], "key", None)) for p, _ in paths]


def test_constants_match_the_reference():
    for name in ("F_TORN", "F_TORN_RESTART", "F_HASYM", "F_HASYM_HEAL", "K_TORN", "K_HEAL_ASYM"):
        assert getattr(core, name) == getattr(jax_core, name), name
    for name in ("TORN_ATOMIC", "TORN_LOSE", "TORN_PREFIX"):
        assert getattr(machine, name) == getattr(jax_machine, name), name
    assert raft_compact.M_IS == jax_rc.M_IS


def test_torn_hash_matches_jax():
    g = np.random.default_rng(3)
    seeds = np.concatenate([g.integers(0, 2**32, 500, dtype=np.uint32),
                            np.array([0, 1, 0x7FFFFFFF, 0x80000000, 0xDEADBEEF, 0xFFFFFFFF], np.uint32)])
    for leaf in (0, 1, 2, 3, 7, 13, 100, 2**20):
        want = np.asarray(jax.jit(lambda s, li=leaf: jax_machine.torn_hash(s, li))(jnp.asarray(seeds)))
        assert np.array_equal(machine.torn_hash(torch.from_numpy(seeds.astype(np.int64)), leaf).numpy(), want), leaf
        # an int32 bit pattern is the same word
        assert np.array_equal(machine.torn_hash(torch.from_numpy(seeds.view(np.int32)), leaf).numpy(), want), leaf


def test_torn_leaf_order_matches_jax():
    """The port walks a state's fields in declaration order; that must be
    `jax.tree.leaves`' order, or each leaf takes another's damage word
    (which a test at one seed can pass by luck)."""
    key = jax.random.PRNGKey(0)
    for jax_m, port_m in ((JaxTornToy(), TornToy()), (jax_rc.TornSnapshotRaftCompact(5, 8),
                                                         raft_compact.TornSnapshotRaftCompact(5, 8))):
        want = _leaf_names(jax_m.init(key))
        assert machine.state_leaf_names(port_m.durable_spec()) == want
        assert machine.state_leaf_names(port_m.torn_spec()) == want
        assert want == _leaf_names(jax_m.durable_spec()) == _leaf_names(jax_m.torn_spec())


def test_torn_restart_damages_by_contract():
    """The reference's unit test on the port's toy (lane 0), then every
    lane against the JAX package's `torn_restart_if` on random nodes,
    conditions and seeds: volatile leaves wipe, atomic rows survive,
    lost rows revert whole on the seeded coin, prefix rows keep exactly
    the seeded prefix of the trailing axis; cond off is a passthrough."""
    m = TornToy()
    lanes = 64
    g = np.random.default_rng(11)
    nodes_np = {
        "atomic": np.tile(np.array([11, 12, 13], np.int32), (lanes, 1)),
        "lost": np.tile(np.array([21, 22, 23], np.int32), (lanes, 1)),
        "ring": np.tile(np.arange(1, 13, dtype=np.int32).reshape(3, 4), (lanes, 1, 1)),
        "vol": np.tile(np.array([31, 32, 33], np.int32), (lanes, 1)),
    }
    nodes = TornState(**{k: torch.from_numpy(v.copy()) for k, v in nodes_np.items()})
    node = g.integers(0, 3, lanes).astype(np.int32)
    cond = g.random(lanes) < 0.75
    seed = g.integers(0, 2**32, lanes, dtype=np.uint32)
    node[0], cond[0], seed[0] = 1, True, 0xDEADBEEF
    key = torch.zeros((lanes, 2), dtype=torch.int64)
    out = m.torn_restart_if(nodes, torch.from_numpy(node), torch.from_numpy(cond), key,
                            torch.from_numpy(seed.astype(np.int64)))
    h_lost = int(machine.torn_hash(torch.tensor([0xDEADBEEF]), 1))
    h_ring = int(machine.torn_hash(torch.tensor([0xDEADBEEF]), 2))
    cut = (h_ring >> 1) % 5
    assert out.atomic[0].tolist() == [11, 12, 13]
    assert out.vol[0].tolist() == [31, 0, 33]
    assert out.lost[0].tolist() == [21, 0 if h_lost & 1 else 22, 23]
    assert out.ring[0, 1].tolist() == [5, 6, 7, 8][:cut] + [0] * (4 - cut)
    assert out.ring[0, 0].tolist() == [1, 2, 3, 4] and out.ring[0, 2].tolist() == [9, 10, 11, 12]

    jax_m = JaxTornToy()
    fn = jax.jit(jax.vmap(jax_m.torn_restart_if))
    keys = jnp.zeros((lanes, 2), jnp.uint32)
    want = fn(nodes_np, jnp.asarray(node), jnp.asarray(cond), keys, jnp.asarray(seed))
    assert not tree_diff(jax_to_numpy(want), tree_to_numpy(out))
    off = m.torn_restart_if(nodes, torch.from_numpy(node), torch.zeros(lanes, dtype=torch.bool), key,
                            torch.from_numpy(seed.astype(np.int64)))
    assert not tree_diff(tree_to_numpy(nodes), tree_to_numpy(off))
    # every class was exercised: some lost rows reverted, some kept
    lost_row = out.lost.numpy()[np.arange(lanes), node]
    assert (lost_row[cond] == 0).any() and (lost_row[cond] != 0).any()


def test_torn_requires_durable_spec_and_valid_torn_spec():
    with pytest.raises(ValueError, match="durable_spec"):
        Engine(EchoMachine(rounds=4), EngineConfig(queue_capacity=32, faults=FaultPlan(n_faults=1, allow_torn=True)),
               device="cpu")

    class BadTornSpec(TornToy):
        def torn_spec(self):
            return TornState(atomic=1, lost=99, ring=1, vol=1)

    with pytest.raises(ValueError, match="torn_spec"):
        Engine(BadTornSpec(), EngineConfig(queue_capacity=32, faults=FaultPlan(n_faults=1, allow_torn=True)),
               device="cpu")
    # the toy's own contract is accepted
    Engine(TornToy(), EngineConfig(queue_capacity=32, faults=FaultPlan(n_faults=1, allow_torn=True)), device="cpu")


def test_raft_compact_refusals_are_loud():
    with pytest.raises(ValueError, match="<= 31"):
        raft_compact.RaftCompactMachine(num_nodes=32)
    with pytest.raises(ValueError, match="compact_lag"):
        raft_compact.RaftCompactMachine(num_nodes=5, log_capacity=8, compact_lag=9)
    with pytest.raises(ValueError, match="compact_lag"):
        raft_compact.RaftCompactMachine(num_nodes=5, log_capacity=8, compact_lag=0)
    raft_compact.RaftCompactMachine(num_nodes=31)  # the boundary itself is fine
    assert type(build_machine("raft-compact")) is raft_compact.RaftCompactMachine
    assert type(build_machine("demo-tornsnapshot-raft")) is raft_compact.TornSnapshotRaftCompact


@pytest.fixture(scope="module")
def compact_snapshots():
    """Node states of a JAX torn hunt: compacted logs, snapshots, lost
    snapshots after torn restarts."""
    jax_eng, _ = engines(jax_rc.TornSnapshotRaftCompact(5, 8), raft_compact.TornSnapshotRaftCompact(5, 8),
                         faults=TORN_FAULTS, **TORN_CONFIG)
    snaps = jax_snapshots(jax_eng, np.arange(32) + 400, (0, 60, 150, 260))
    assert int(np.asarray(snaps[-1][0].base).max()) > 0  # compaction happened
    return snaps


def _compact_inputs(seed, np_nodes, now):
    """Handler inputs around a state: live and stale timers of each base,
    every message type with terms and indices around each node's own
    (below, at and past the trim point)."""
    g = np.random.default_rng(seed)
    lanes = len(now)
    node = g.integers(0, 5, lanes).astype(np.int32)
    rows = np.arange(lanes)
    epoch = np.asarray(np_nodes.epoch)[rows, node]
    tid = np.where(g.random(lanes) < 0.8, g.integers(1, 4, lanes) + 4 * epoch, g.integers(0, 9, lanes)).astype(np.int32)
    t_now = (now + g.integers(0, 400_000, lanes)).astype(np.int32)
    rand = g.integers(0, 2**32, (lanes, 4), dtype=np.uint32)
    src = ((node + g.integers(1, 5, lanes)) % 5).astype(np.int32)
    term = np.asarray(np_nodes.term)[rows, node]
    base = np.asarray(np_nodes.base)[rows, node]
    last = base + np.asarray(np_nodes.log_len)[rows, node]
    payload = np.zeros((lanes, 6), np.int32)
    payload[:, 0] = g.integers(1, 6, lanes)
    payload[:, 1] = term + g.integers(-1, 2, lanes)
    payload[:, 2] = np.where(payload[:, 0] == 1, src, last + g.integers(-4, 3, lanes))
    payload[:, 3] = np.where(payload[:, 0] == 4, last + g.integers(-3, 2, lanes), g.integers(0, term + 2))
    payload[:, 4] = g.integers(0, term + 2)
    payload[:, 5] = base + g.integers(-1, 6, lanes)
    return node, tid, t_now, rand, src, payload


@pytest.mark.parametrize("torn", [False, True], ids=["honest", "tornsnapshot"])
def test_raft_compact_handlers_match_jax(compact_snapshots, torn):
    cls = "TornSnapshotRaftCompact" if torn else "RaftCompactMachine"
    check_handlers(getattr(jax_rc, cls)(5, 8), getattr(raft_compact, cls)(5, 8), compact_snapshots, _compact_inputs)


def test_raft_compact_hooks_match_jax(compact_snapshots):
    """invariant (both checks and ElectionSafety), is_done, summary,
    coverage_projection, the restart hook and the torn restart against
    the JAX package on the hunt's states and on damaged copies."""
    from torch_port_util import check_hooks

    jax_m, port_m = jax_rc.TornSnapshotRaftCompact(5, 8), raft_compact.TornSnapshotRaftCompact(5, 8)
    np_nodes, now = compact_snapshots[-1]
    bad = jax.tree.map(np.copy, np_nodes)
    bad.snap_idx[0::5, 1] = bad.base[0::5, 1] - 1  # (b): a trimmed log with no snapshot
    bad.commit[0::5, 1] = bad.base[0::5, 1] + 1
    bad.log_term[1::5, 2, 1] += 1  # (a): a committed position disagrees
    bad.commit[1::5, :] = bad.base[1::5, :] + 1
    bad.role[2::5, :2], bad.term[2::5, :2] = 2, 9  # two leaders of one term
    bad.commit[3::5, :] = 16  # every node at target
    check_hooks(jax_m, port_m, [np_nodes, bad], now)
    t_now = torch.from_numpy(now.copy())
    _, code = port_m.invariant(torch_nodes(port_m.state_type, bad), t_now)
    assert {101, 102} <= set(code.tolist())
    proj = jax.jit(jax.vmap(jax_m.coverage_projection))
    torn = jax.jit(jax.vmap(jax_m.torn_restart_if))
    g = np.random.default_rng(4)
    lanes = len(now)
    for k, s in enumerate(compact_snapshots + [(bad, now)]):
        s = s[0]
        t_nodes = torch_nodes(port_m.state_type, s)
        assert np.array_equal(port_m.coverage_projection(t_nodes, t_now).numpy(), np.asarray(proj(s, now))), k
        node = g.integers(0, 5, lanes).astype(np.int32)
        cond = g.random(lanes) < 0.7
        keys = g.integers(0, 2**32, (lanes, 2), dtype=np.uint32)
        seed = g.integers(0, 2**32, lanes, dtype=np.uint32)
        same(torn(s, node, cond, keys, seed),
             port_m.torn_restart_if(t_nodes, torch.from_numpy(node), torch.from_numpy(cond),
                                    torch.from_numpy(keys.astype(np.int64)), torch.from_numpy(seed.astype(np.int64))),
             ("torn_restart_if", k))


@pytest.mark.parametrize("rng_stream", STREAMS)
def test_torn_hunt_matches_jax(rng_stream):
    """The acceptance scenario: TornSnapshotRaftCompact under the torn
    plan, the whole `BatchResult` (flight recorder, coverage map, fail
    codes) equal to the JAX package's; only LOG_MATCHING is found, and
    the first find's replay on the port fails 102."""
    jax_eng, port = engines(jax_rc.TornSnapshotRaftCompact(5, 8), raft_compact.TornSnapshotRaftCompact(5, 8),
                            faults=TORN_FAULTS, rng_stream=rng_stream, **TORN_CONFIG)
    assert port.cov_band_bits == 4
    want = jax.jit(jax_eng.run_batch, static_argnums=1)(jnp.asarray(TORN_SEEDS), TORN_STEPS)
    got = port.run_batch(TORN_SEEDS, TORN_STEPS)
    same(want, got)
    failed = got.failed.numpy()
    assert failed.any() and set(got.fail_code.numpy()[failed].tolist()) == {raft_compact.LOG_MATCHING}
    assert got.fr["inj"][:, core.K_TORN].sum() > 0
    first = int(TORN_SEEDS[np.argmax(failed)])
    rp = replay(port, first, max_steps=TORN_STEPS, trace=False)
    assert rp.failed and rp.fail_code == raft_compact.LOG_MATCHING
    assert jax_replay(jax_eng, first, max_steps=TORN_STEPS, trace=False).fail_code == rp.fail_code


@pytest.mark.parametrize("rng_stream", STREAMS)
def test_heal_asym_one_way_window(rng_stream):
    """The reference's replay-trace oracle for asymmetric healing on the
    port (seed 4): the fault clogs pair (0, 2) both ways at t0, heals
    2 -> 0 at t1 and 0 -> 2 at t2 > t1; no 0 -> 2 delivery lands while
    that direction is dark, 2 -> 0 deliveries reappear inside the one-way
    window, and both flow after t2. The trace equals the JAX package's."""
    faults = dict(n_faults=1, allow_partition=False, allow_kill=False, allow_heal_asym=True, **WINDOW)
    cfg = dict(horizon_us=HORIZON_US, queue_capacity=32, rng_stream=rng_stream)
    jax_eng = jax_core.Engine(JaxBidiTickMachine(), jax_core.EngineConfig(faults=jax_core.FaultPlan(**faults), **cfg))
    port = Engine(BidiTickMachine(), EngineConfig(faults=FaultPlan(**faults), **cfg), device="cpu")
    want, rp = jax_replay(jax_eng, 4, max_steps=600), replay(port, 4, max_steps=600)
    events = lambda tr: [(e.step, e.time_us, e.kind, e.node, e.src, tuple(e.payload), e.seq) for e in tr]  # noqa
    assert events(rp.trace) == events(want.trace)
    assert not rp.failed
    fault_ops = sorted((e.time_us, e.payload[0], e.payload[1], e.payload[2]) for e in rp.trace if e.kind == "fault")
    assert len(fault_ops) == 3
    (t0, op0, a, b), (t1, op1, h1a, h1b), (t2, op2, h2a, h2b) = fault_ops
    assert op0 == core.F_HASYM and {op1, op2} == {core.F_HASYM_HEAL} and (a, b) == (0, 2)
    assert {(h1a, h1b), (h2a, h2b)} == {(0, 2), (2, 0)} and t0 < t1 < t2
    assert (h1a, h1b) == (2, 0)  # seed 4: b -> a heals first
    lat_min, lat_max = 1_000, 10_000
    msgs = [(e.time_us, e.src, e.node) for e in rp.trace if e.kind == "msg" and e.time_us < HORIZON_US]
    send_02 = [t for t, s, n in msgs if (s, n) == (0, 2)]
    send_20 = [t for t, s, n in msgs if (s, n) == (2, 0)]
    assert not [t for t in send_02 if t0 + lat_max <= t < t2 + lat_min]
    assert [t for t in send_20 if t1 + lat_max <= t <= t2]
    assert [t for t in send_02 if t > t2 + lat_max] and [t for t in send_20 if t > t2 + lat_max]
    assert [t for t in send_02 if t < t0] and [t for t in send_20 if t < t0]


@pytest.mark.parametrize("rng_stream", STREAMS)
def test_honest_raft_compact_soaks_clean(rng_stream):
    """Honest raft-compact under every kind at once (the reference's slow
    soak, cut to its first 16 seeds and 320 steps): equal to the JAX package, no
    failures, torn restarts and one-way heals injected, the torn and
    heal-asym coverage bands live."""
    from madsim_tpu_torch.runtime.coverage import coverage_dict, unpack_map

    jax_eng, port = engines(jax_rc.RaftCompactMachine(5, 8), raft_compact.RaftCompactMachine(5, 8),
                            faults=SOAK_FAULTS, rng_stream=rng_stream, **SOAK_CONFIG)
    seeds = np.arange(16, dtype=np.uint32)  # the reference soak's first 16
    want = jax.jit(jax_eng.run_batch, static_argnums=1)(jnp.asarray(seeds), 320)
    got = port.run_batch(seeds, 320)
    same(want, got)
    assert not bool(got.failed.any()), set(got.fail_code.tolist())
    inj = got.fr["inj"].sum(dim=0).tolist()
    assert inj[core.K_TORN] > 0 and inj[core.K_HEAL_ASYM] > 0, inj
    bands = coverage_dict(unpack_map(got.cov["map"].numpy(), 14).any(axis=0), 14, band_bits=4)["by_band"]
    assert bands["torn"] > 0 and bands["heal_asym"] > 0, bands
