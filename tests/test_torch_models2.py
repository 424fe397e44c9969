"""The port's single-decree Paxos, etcd lease-election, Kafka consumer-group
and echo machines against the JAX models: the batched handlers against
the vmapped ones on reachable node states (JAX runs of each model's bug
variant) for the honest machine and the bug, the invariant (every fail
code), termination, summary, coverage projection and restart hooks, then
`run_batch` under the plans of tests/test_engine_paxos.py,
tests/test_engine_etcd.py and tests/test_engine_group.py, where each
demo fails with its code on the same seeds on both engines; the group
under pause, skew and dup with their coverage bands live
(tests/test_chaos_palette.py:513); and the echo fixture on both
streams. Every comparison is exact."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from madsim_tpu.models import echo as jax_echo
from madsim_tpu.models import etcd as jax_etcd
from madsim_tpu.models import kafka_group as jax_group
from madsim_tpu.models import paxos as jax_paxos
from madsim_tpu_torch.models import build_machine, echo, etcd, kafka_group, paxos

from torch_port_util import check_handlers, check_hooks, check_projection, engines, jax_snapshots, same, torch_nodes

PAXOS = dict(horizon_us=8_000_000, queue_capacity=96)
PAXOS_FAULTS = dict(n_faults=2, t_max_us=4_000_000, dur_min_us=200_000, dur_max_us=800_000)
# the no-promise test's heavier contention
NOPROMISE_FAULTS = dict(n_faults=3, t_max_us=2_000_000, dur_min_us=150_000, dur_max_us=600_000)
ETCD = dict(horizon_us=8_000_000, queue_capacity=96)
ETCD_FAULTS = dict(n_faults=2, t_max_us=5_000_000, dur_min_us=200_000, dur_max_us=800_000)
DOUBLEGRANT = dict(horizon_us=9_000_000, queue_capacity=96)
DOUBLEGRANT_FAULTS = dict(n_faults=3, t_max_us=6_000_000, dur_min_us=150_000, dur_max_us=600_000)
GROUP = dict(horizon_us=8_000_000, queue_capacity=96)
GROUP_FAULTS = dict(n_faults=3, t_max_us=1_500_000, dur_min_us=250_000, dur_max_us=700_000)
NOFENCING = dict(horizon_us=9_000_000, queue_capacity=96)
NOFENCING_FAULTS = dict(n_faults=3, t_max_us=5_000_000, dur_min_us=200_000, dur_max_us=800_000, allow_kill=False)
SNAP_STEPS = (0, 12, 30, 60)


class JaxDoubleGrantEtcd(jax_etcd.EtcdMachine):
    CHECK_OWNER_ON_CAMPAIGN = False


def _rows(np_nodes, field, node):
    return np.asarray(getattr(np_nodes, field))[np.arange(len(node)), node]


# -- paxos ---------------------------------------------------------------------


def _paxos_inputs(seed, np_nodes, now):
    """Proposers and acceptors, boot / propose / retry / stray timers,
    every message type with ballots around each node's promise."""
    g = np.random.default_rng(seed)
    lanes = len(now)
    node = g.integers(0, 5, lanes).astype(np.int32)
    node[::3] = g.integers(0, 2, len(node[::3]))
    tid = g.integers(0, 4, lanes).astype(np.int32)
    t_now = (now + g.integers(0, 300_000, lanes)).astype(np.int32)
    rand = g.integers(0, 2**32, (lanes, 4), dtype=np.uint32)
    src = ((node + g.integers(1, 5, lanes)) % 5).astype(np.int32)
    ballot = np.maximum(_rows(np_nodes, "promised", node), _rows(np_nodes, "ballot", node))
    payload = np.zeros((lanes, 5), np.int32)
    payload[:, 0] = g.integers(1, 6, lanes)
    payload[:, 1] = np.where(g.random(lanes) < 0.5, _rows(np_nodes, "ballot", node), ballot + g.integers(-3, 4, lanes))
    payload[:, 2] = g.integers(-1, 8, lanes)
    payload[:, 3] = g.integers(0, 3, lanes)
    return node, tid, t_now, rand, src, payload


@pytest.fixture(scope="module")
def paxos_snapshots():
    jax_eng, _ = engines(jax_paxos.NoPromiseCheckPaxos(5), paxos.NoPromiseCheckPaxos(5), rng_stream=2,
                         flight_recorder=False, coverage=False, faults=NOPROMISE_FAULTS, **PAXOS)
    return jax_snapshots(jax_eng, np.arange(64) + 64, SNAP_STEPS)


@pytest.mark.parametrize("bug", [False, True], ids=["honest", "nopromise"])
def test_paxos_handlers_match_jax(paxos_snapshots, bug):
    cls = "NoPromiseCheckPaxos" if bug else "PaxosMachine"
    check_handlers(getattr(jax_paxos, cls)(5), getattr(paxos, cls)(5), paxos_snapshots, _paxos_inputs)


def test_paxos_hooks_match_jax(paxos_snapshots):
    jax_m, port_m = jax_paxos.PaxosMachine(5), paxos.PaxosMachine(5)
    np_nodes, now = paxos_snapshots[-1]
    bad = jax.tree.map(np.copy, np_nodes)
    bad.bad[0::4, 0] = True  # AGREEMENT
    bad.decided[1::4, :2] = True  # both proposers decided
    check_hooks(jax_m, port_m, [np_nodes, bad], now)
    check_projection(jax_m, port_m, [s for s, _ in paxos_snapshots] + [bad], now)
    _, code = port_m.invariant(torch_nodes(port_m.state_type, bad), torch.from_numpy(now.copy()))
    assert paxos.AGREEMENT in code.tolist()


# -- etcd ----------------------------------------------------------------------


def _etcd_inputs(seed, np_nodes, now):
    """The server and clients, live, stale and boot ticks, every message
    type from and about each client (and a client id past the range),
    generations at and around the server's."""
    g = np.random.default_rng(seed)
    lanes = len(now)
    node = g.integers(0, 4, lanes).astype(np.int32)
    node[::3] = 0
    epoch = _rows(np_nodes, "epoch", node)
    tid = np.where(g.random(lanes) < 0.7, 1 + 4 * epoch, g.integers(0, 9, lanes)).astype(np.int32)
    t_now = (now + g.integers(0, 400_000, lanes)).astype(np.int32)
    rand = g.integers(0, 2**32, (lanes, 4), dtype=np.uint32)
    src = g.integers(0, 4, lanes).astype(np.int32)
    payload = np.zeros((lanes, 5), np.int32)
    payload[:, 0] = np.where(node == 0, g.choice([1, 3, 7, 10], lanes), g.integers(1, 12, lanes))
    payload[:, 1] = g.integers(1, 4, lanes)
    payload[::11, 1] = g.choice([-1, 4, 9], len(payload[::11]))
    payload[:, 2] = (t_now - g.integers(0, 400_000, lanes)).astype(np.int32)
    gen = np.asarray(np_nodes.srv_gen)[:, 0]
    payload[:, 3] = gen + g.integers(-1, 2, lanes)
    return node, tid, t_now, rand, src, payload


@pytest.fixture(scope="module")
def etcd_snapshots():
    jax_eng, _ = engines(JaxDoubleGrantEtcd(4, 99, 9999), build_machine("demo-doublegrant-etcd"), rng_stream=2,
                         flight_recorder=False, coverage=False, faults=ETCD_FAULTS, **ETCD)
    return jax_snapshots(jax_eng, np.arange(64) + 100, (0, 20, 60, 140))


@pytest.mark.parametrize("bug", [None, "CHECK_OWNER_ON_CAMPAIGN", "REVIVE_EXPIRED_LEASES", "EXTEND_DEADLINE_ON_WON"])
def test_etcd_handlers_match_jax(etcd_snapshots, bug):
    flags = {bug: bug != "CHECK_OWNER_ON_CAMPAIGN"} if bug else {}
    check_handlers(type("V", (jax_etcd.EtcdMachine,), flags)(4), type("V", (etcd.EtcdMachine,), flags)(4),
                   etcd_snapshots, _etcd_inputs)


def test_etcd_hooks_match_jax(etcd_snapshots):
    jax_m, port_m = jax_etcd.EtcdMachine(4), etcd.EtcdMachine(4)
    np_nodes, now = etcd_snapshots[-1]
    bad = jax.tree.map(np.copy, np_nodes)
    bad.violated[0::4, 0] = True  # the server saw a double grant
    bad.cl_leader[1::4, 2], bad.cl_deadline[1::4, 2] = True, now[1::4] + 10  # a believer the server disowns
    bad.srv_gen[2::4, 0], bad.cl_writes[2::4, 1] = 3, 6  # done
    check_hooks(jax_m, port_m, [np_nodes, bad], now)
    check_projection(jax_m, port_m, [s for s, _ in etcd_snapshots] + [bad], now)
    _, code = port_m.invariant(torch_nodes(port_m.state_type, bad), torch.from_numpy(now.copy()))
    assert etcd.LEASE_SAFETY in code.tolist()


# -- kafka group ---------------------------------------------------------------


def _group_inputs(seed, np_nodes, now):
    """The coordinator and members, every timer, every message type with
    partitions, offsets and generations around the state's (and past
    the log and the partition range)."""
    g = np.random.default_rng(seed)
    lanes = len(now)
    node = g.integers(0, 4, lanes).astype(np.int32)
    node[::3] = 0
    tid = g.integers(0, 5, lanes).astype(np.int32)
    t_now = (now + g.integers(0, 300_000, lanes)).astype(np.int32)
    rand = g.integers(0, 2**32, (lanes, 4), dtype=np.uint32)
    src = g.integers(1, 4, lanes).astype(np.int32)
    gen = np.asarray(np_nodes.gen)[:, 0]
    payload = np.zeros((lanes, 5), np.int32)
    payload[:, 0] = np.where(node == 0, g.choice([1, 3, 5], lanes), g.choice([2, 4], lanes))
    part = g.integers(0, 2, lanes)
    pos = np.asarray(np_nodes.position)[np.arange(lanes), node, part]
    payload[:, 1] = np.where(payload[:, 0] == 5, gen + g.integers(-1, 2, lanes),
                             np.where(payload[:, 0] == 2, gen + g.integers(0, 2, lanes), part))
    payload[::9, 1] = g.choice([-1, 2, 5], len(payload[::9]))
    payload[:, 2] = np.where(payload[:, 0] == 2, g.integers(0, 4, lanes),
                             np.where(payload[:, 0] == 5, part, pos + g.integers(-1, 2, lanes)))
    payload[:, 3] = np.where(payload[:, 0] == 5, pos + g.integers(-2, 3, lanes), g.integers(0, 13, lanes))
    payload[:, 4] = g.integers(0, 13, lanes)
    return node, tid, t_now, rand, src, payload


@pytest.fixture(scope="module")
def group_snapshots():
    jax_eng, _ = engines(jax_group.NoFencingGroupMachine(4), kafka_group.NoFencingGroupMachine(4), rng_stream=2,
                         flight_recorder=False, coverage=False, faults=NOFENCING_FAULTS, **NOFENCING)
    return jax_snapshots(jax_eng, np.arange(64) + 500, (0, 30, 70, 150))


@pytest.mark.parametrize("bug", [False, True], ids=["honest", "nofencing"])
def test_group_handlers_match_jax(group_snapshots, bug):
    cls = "NoFencingGroupMachine" if bug else "KafkaGroupMachine"
    check_handlers(getattr(jax_group, cls)(4), getattr(kafka_group, cls)(4), group_snapshots, _group_inputs)


def test_group_hooks_match_jax(group_snapshots):
    jax_m, port_m = jax_group.KafkaGroupMachine(4), kafka_group.KafkaGroupMachine(4)
    np_nodes, now = group_snapshots[-1]
    bad = jax.tree.map(np.copy, np_nodes)
    bad.bad_regress[0::4, 0] = True  # COMMIT_REGRESS
    bad.committed[1::4, 0, 1] = 5
    bad.consumed[1::4, 0, 1, 2] = False  # LOST_RECORD
    bad.committed[2::4, 0] = 12  # done
    bad.committed[3::8, 0, 0] = 13  # past the log
    check_hooks(jax_m, port_m, [np_nodes, bad], now)
    _, code = port_m.invariant(torch_nodes(port_m.state_type, bad), torch.from_numpy(now.copy()))
    assert {kafka_group.LOST_RECORD, kafka_group.COMMIT_REGRESS} <= set(code.tolist())


# -- run_batch -----------------------------------------------------------------

# (registry name, the JAX machine, config, plan, seeds, step budget, the
# code the demo fails with): the plans of the reference tests, the bug
# seeds around the reference's stream starts
RUNS = [
    ("paxos", lambda: jax_paxos.PaxosMachine(5), PAXOS, PAXOS_FAULTS, np.arange(32), 600, None),
    ("demo-nopromise-paxos", lambda: jax_paxos.NoPromiseCheckPaxos(5), PAXOS, NOPROMISE_FAULTS, np.arange(128), 64,
     paxos.AGREEMENT),
    ("etcd", lambda: jax_etcd.EtcdMachine(4), ETCD, ETCD_FAULTS, np.arange(24), 800, None),
    ("demo-doublegrant-etcd", lambda: JaxDoubleGrantEtcd(4, 99, 9999), DOUBLEGRANT, DOUBLEGRANT_FAULTS,
     np.arange(32) + 100, 200, etcd.LEASE_SAFETY),
    ("group", lambda: jax_group.KafkaGroupMachine(4), GROUP, GROUP_FAULTS, np.arange(24), 640, None),
    ("demo-nofencing-group", lambda: jax_group.NoFencingGroupMachine(4), NOFENCING, NOFENCING_FAULTS,
     np.arange(32) + 500, 288, kafka_group.COMMIT_REGRESS),
]


@pytest.mark.parametrize("name,jax_machine,cfg,faults,seeds,steps,code", RUNS, ids=[r[0] for r in RUNS])
def test_run_batch_matches_jax(name, jax_machine, cfg, faults, seeds, steps, code):
    """Recorder and coverage on; the honest model runs clean, the demo
    fails with its code, on the same seeds on both engines."""
    jax_eng, port = engines(jax_machine(), build_machine(name), rng_stream=2, faults=faults, **cfg)
    seeds = seeds.astype(np.uint32)
    want = jax.jit(jax_eng.run_batch, static_argnums=1)(jnp.asarray(seeds), steps)
    got = port.run_batch(seeds, steps)
    same(want, got)
    codes = set(got.fail_code.numpy()[got.failed.numpy()].tolist())
    assert codes == ({code} if code else set()), codes
    if code is None:
        assert bool(got.done.all())


def test_group_rebalance_under_pause_skew_dup():
    """The consumer group under pause, skew and dup (the reference's test,
    cut to 16 of its 32 seeds), on the counter stream: equal to the JAX
    package, clean, pause windows force rebalances past the three joins,
    and the pause, skew and dup bands of the 4-bit coverage layout go
    live."""
    from madsim_tpu_torch.runtime.coverage import coverage_dict, unpack_map

    faults = dict(n_faults=3, t_max_us=2_000_000, dur_min_us=200_000, dur_max_us=500_000, allow_partition=False,
                  allow_kill=False, allow_pause=True, allow_skew=True, allow_dup=True)
    jax_eng, port = engines(jax_group.KafkaGroupMachine(4, 2, 12), kafka_group.KafkaGroupMachine(4, 2, 12),
                            horizon_us=3_000_000, queue_capacity=192, cov_slots_log2=12, faults=faults)
    seeds = np.arange(16, dtype=np.uint32)
    want = jax.jit(jax_eng.run_batch, static_argnums=1)(jnp.asarray(seeds), 3500)
    got = port.run_batch(seeds, 3500)
    same(want, got)
    assert not bool(got.failed.any()), set(got.fail_code.tolist())
    inj = got.fr["inj"].sum(dim=0).tolist()
    assert inj[6] > 0 and inj[7] > 0 and int(got.fr["dup"].sum()) > 0, inj
    assert any(g > 3 for g in got.summary["generation"].tolist())
    bands = coverage_dict(unpack_map(got.cov["map"].numpy(), 12).any(axis=0), 12, band_bits=4)["by_band"]
    for band in ("pause", "skew", "dup"):
        assert bands[band] > 0, (band, bands)


@pytest.mark.parametrize("rng_stream", [2, 3])
def test_echo_run_batch_matches_jax(rng_stream):
    """The JAX suite's fixture under pair clogs and kills with loss."""
    jax_eng, port = engines(jax_echo.EchoMachine(rounds=10), build_machine("echo"), rng_stream=rng_stream,
                            horizon_us=3_000_000, queue_capacity=16, packet_loss_rate=0.05,
                            faults=dict(n_faults=2, t_max_us=1_000_000, dur_min_us=100_000, dur_max_us=400_000))
    seeds = np.arange(32, dtype=np.uint32)
    want = jax.jit(jax_eng.run_batch, static_argnums=1)(jnp.asarray(seeds), 400)
    got = port.run_batch(seeds, 400)
    same(want, got)
    assert int(got.summary["acked"].sum()) > 0 and not bool(got.failed.any())
    assert isinstance(port.machine, echo.EchoMachine) and port.machine.rounds == 10
