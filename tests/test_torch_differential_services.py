"""The port's service differentials (`madsim_tpu_torch.differential_services`)
against the JAX package's, mirroring tests/test_differential_services.py
case by case: the MVCC etcd machine against `EtcdService`, the consumer
group machine against the Kafka `Broker` coordinator, the S3 machine
against `S3Service`, with the JAX package's services passed in as the
port's factory argument, and with no factory, on the port's own
services. The port's side is its single-lane replay on the CPU; every
report equals the JAX package's on the same seed (`ok`, the mismatch
list, revisions, op and commit counts, `replay_failed`), and the drift
cases (a bugged machine variant, a bugged service through the factory)
are caught on both packages alike."""

import jax.numpy as jnp
import numpy as np
import pytest

import madsim_tpu.differential_services as jax_diff
from madsim_tpu.engine import Engine as JaxEngine
from madsim_tpu.engine import EngineConfig as JaxConfig
from madsim_tpu.engine import FaultPlan as JaxFaultPlan
from madsim_tpu.models import etcd_mvcc as jax_mvcc
from madsim_tpu.models import kafka_group as jax_group
from madsim_tpu.models import s3 as jax_s3
from madsim_tpu.services.etcd.service import EtcdService
from madsim_tpu.services.kafka import Broker
from madsim_tpu.services.s3 import S3Service
from madsim_tpu_torch.differential_services import (
    differential_etcd_mvcc,
    differential_kafka_group,
    differential_s3,
    drive_kafka_coordinator,
)
from madsim_tpu_torch.engine import Engine, EngineConfig, FaultPlan, replay
from madsim_tpu_torch.models import etcd_mvcc, kafka_group, s3

import torch_port_util  # noqa: F401  (one torch thread; the partitionable Threefry pin)


def _pair(jax_machine, machine, horizon_us, queue, faults):
    return (
        JaxEngine(jax_machine, JaxConfig(horizon_us=horizon_us, queue_capacity=queue, faults=JaxFaultPlan(**faults))),
        Engine(machine, EngineConfig(horizon_us=horizon_us, queue_capacity=queue, faults=FaultPlan(**faults)),
               device="cpu"),
    )


def _failing(engines, seeds, max_steps, code=None):
    """The seeds of `seeds` the port's batch fails (with `code`, if
    given), held equal to the JAX package's batch."""
    jax_eng, eng = engines
    res = eng.make_runner(max_steps=max_steps)(np.asarray(seeds, dtype=np.uint32))
    jres = jax_eng.make_runner(max_steps=max_steps)(jnp.asarray(seeds, dtype=jnp.uint32))
    got = [s for s, c, f in zip(seeds, res.fail_code.tolist(), res.failed.tolist()) if f and code in (None, c)]
    want = [s for s, c, f in zip(seeds, jres.fail_code.tolist(), jres.failed.tolist()) if f and code in (None, c)]
    assert got == want
    return got


# -- etcd MVCC machine <-> EtcdService ---------------------------------------


def _mvcc(machine=None, jax_machine=None, faults=None, horizon_us=5_000_000):
    return _pair(jax_machine or jax_mvcc.EtcdMvccMachine(4), machine or etcd_mvcc.EtcdMvccMachine(4),
                 horizon_us, 48, faults or {})


def _mvcc_both(engines, seed, factory=EtcdService):
    jax_eng, eng = engines
    got = differential_etcd_mvcc(eng, seed, service_factory=factory)
    assert got == jax_diff.differential_etcd_mvcc(jax_eng, seed, service_factory=factory), seed
    return got


MVCC_CHAOS = dict(n_faults=3, allow_dir_clog=True, allow_storm=True, t_max_us=3_000_000, dur_min_us=200_000,
                  dur_max_us=800_000)


def test_mvcc_machine_matches_service_fault_free():
    engines = _mvcc()
    for seed in range(8):
        out = _mvcc_both(engines, seed)
        assert out["ok"], (seed, out["mismatches"])
        assert out["revision"][0] > 1  # real MVCC work compared
        assert not out["replay_failed"]


def test_mvcc_machine_matches_service_under_chaos():
    """Retransmits (dedup path), clogs, storms: the effective op stream
    still produces identical MVCC state in both implementations."""
    engines = _mvcc(faults=MVCC_CHAOS, horizon_us=8_000_000)
    for seed in range(16, 28):
        out = _mvcc_both(engines, seed)
        assert out["ok"], (seed, out["mismatches"])


def test_mvcc_differential_catches_semantic_drift():
    """The NO_DEDUP machine variant double-applies retransmits; the
    differential flags it on a seed where the lane double-applied."""
    faults = dict(n_faults=2, allow_partition=False, allow_kill=False, allow_storm=True, storm_loss_u16=55000,
                  t_max_us=2_000_000, dur_min_us=400_000, dur_max_us=900_000)

    class JaxNoDedup(jax_mvcc.EtcdMvccMachine):
        NO_DEDUP = True

    engines = _mvcc(etcd_mvcc.NoDedupMvcc(4), JaxNoDedup(4), faults=faults, horizon_us=8_000_000)
    failing = _failing(engines, list(range(128)), 3000)
    assert failing, "storm vocabulary should surface NO_DEDUP"
    out = _mvcc_both(engines, failing[0])
    assert not out["ok"]
    assert any("revision" in m or "version" in m for m in out["mismatches"]), out


def test_mvcc_differential_catches_service_side_lease_bug():
    """BIDIRECTIONAL: drift seeded on the SERVICE side (a build whose
    expiry sweep leaks the first attached key of every expired lease),
    passed in through the factory, is flagged on the seed range the
    clean-service chaos case certifies as agreeing."""
    engines = _mvcc(faults=MVCC_CHAOS, horizon_us=8_000_000)

    def buggy(rng):
        return EtcdService(rng, lease_expiry_off_by_one=True)

    flagged = []
    for seed in range(16, 28):
        out = _mvcc_both(engines, seed, factory=buggy)
        if not out["ok"]:
            flagged.append((seed, out["mismatches"]))
    assert flagged, "service-side lease-expiry bug went undetected"
    assert any("revision" in m or "liveness" in m for _seed, ms in flagged for m in ms), flagged


# -- kafka group machine <-> Broker coordinator -------------------------------


def _group(machine=None, jax_machine=None, faults=None):
    return _pair(jax_machine or jax_group.KafkaGroupMachine(num_nodes=4, partitions=2, log_len=12),
                 machine or kafka_group.KafkaGroupMachine(num_nodes=4, partitions=2, log_len=12),
                 8_000_000, 96, faults or dict(n_faults=0))


def _group_both(engines, seed, **kw):
    jax_eng, eng = engines
    got = differential_kafka_group(eng, seed, broker_factory=Broker, **kw)
    assert got == jax_diff.differential_kafka_group(jax_eng, seed, **kw), seed
    return got


def test_group_machine_matches_broker_fault_free():
    engines = _group()
    for seed in range(6):
        out = _group_both(engines, seed)
        assert out["ok"], (seed, out["mismatches"])
        assert not out["had_fault"]
        assert out["machine_gen"] == out["broker_gen"] == 3
        assert out["fencing_checked"] > 0  # real commits compared
        assert not out["replay_failed"]


def test_group_machine_matches_broker_under_kill_faults():
    """With the broker's evictions driven from the machine's session
    ticks and coordinator kill/restart windows mirrored, the contract
    under kill faults is the strong one: exact member set, generation,
    assignment and committed offsets."""
    engines = _group(faults=dict(n_faults=2, allow_partition=False, allow_kill=True, t_max_us=800_000,
                                 dur_min_us=250_000, dur_max_us=700_000))
    killed_runs = 0
    for seed in range(8):
        out = _group_both(engines, seed, max_steps=12000)
        assert out["ok"], (seed, out["mismatches"])
        killed_runs += bool(out["had_fault"])
    assert killed_runs >= 3  # the strong contract was exercised under kills


def test_broker_fencing_blocks_machine_found_zombie_commits():
    """The port finds a seed where the UNFENCED machine lets a zombie
    commit regress an offset; the same delivered commit stream against
    the Broker (fencing on) has those commits rejected, as on the JAX
    package's replay of that seed."""
    faults = dict(n_faults=3, t_max_us=1_500_000, dur_min_us=250_000, dur_max_us=700_000)
    engines = _group(kafka_group.NoFencingGroupMachine(4, 2, 12), jax_group.NoFencingGroupMachine(4, 2, 12),
                     faults=faults)
    regress_seeds = _failing(engines, list(range(96)), 12000, code=kafka_group.COMMIT_REGRESS)
    assert regress_seeds, "chaos should surface the no-fencing zombie"
    seed = regress_seeds[0]
    jax_eng, eng = engines
    rp = replay(eng, seed, max_steps=12000)
    assert rp.fail_code == kafka_group.COMMIT_REGRESS
    _b, members, accept_log = drive_kafka_coordinator(eng.machine, rp.trace, Broker)
    from madsim_tpu.engine import replay as jax_replay

    _jb, jax_members, jax_log = jax_diff.drive_kafka_coordinator(jax_eng.machine,
                                                                jax_replay(jax_eng, seed, max_steps=12000).trace)
    assert (members, accept_log) == (jax_members, jax_log)
    rejected = [row for row in accept_log if row[5] is False]
    assert rejected, "the broker's fencing should reject the zombie commits"


# -- S3 machine <-> S3Service -------------------------------------------------


def _s3(machine=None, jax_machine=None, faults=None):
    return _pair(jax_machine or jax_s3.S3Machine(num_nodes=4), machine or s3.S3Machine(num_nodes=4),
                 8_000_000, 48, faults or dict(n_faults=0))


def _s3_both(engines, seed):
    jax_eng, eng = engines
    got = differential_s3(eng, seed, s3_factory=S3Service)
    assert got == jax_diff.differential_s3(jax_eng, seed), seed
    return got


def test_s3_machine_matches_service_fault_free():
    """Event-for-event: the full store (objects, sessions, lifecycle
    effects) agrees after EVERY applied server event."""
    engines = _s3()
    for seed in range(6):
        out = _s3_both(engines, seed)
        assert out["ok"], (seed, out["mismatches"])
        assert out["events_compared"] > 10
        assert out["max_objects"] > 0 or out["max_sessions"] > 0
        assert not out["replay_failed"]


def test_s3_machine_matches_service_under_chaos():
    """Kills (of the server too: the adapter mirrors the drop window),
    partitions, storms, dir clogs, group splits: identical stores at
    every event."""
    engines = _s3(faults=dict(n_faults=3, allow_dir_clog=True, allow_group=True, allow_storm=True,
                              t_max_us=3_000_000, dur_min_us=200_000, dur_max_us=800_000))
    for seed in range(6):
        out = _s3_both(engines, seed)
        assert out["ok"], (seed, out["mismatches"])


def test_s3_differential_catches_semantic_drift():
    """The arrival-order-concat machine variant diverges from the
    service's sorted-parts join; the differential flags it on a seed
    where the batch caught the bug."""
    class JaxArrivalOrder(jax_s3.S3Machine):
        CONCAT_ARRIVAL_ORDER = True

    engines = _s3(s3.ArrivalOrderS3(num_nodes=4), JaxArrivalOrder(num_nodes=4))
    failing = _failing(engines, list(range(512)), 4000)
    assert failing, "longer sweep should surface the arrival-order bug"
    out = _s3_both(engines, failing[0])
    assert not out["ok"]
    assert any("content" in m for m in out["mismatches"]), out["mismatches"]


@pytest.mark.parametrize("check", ["etcd", "kafka", "s3"])
def test_default_service_matches_jax(check):
    """Called with no factory, each port check runs on the port's own
    service, and its report equals the JAX package's default (its own
    service) on the same seed."""
    engines = {"etcd": _mvcc, "kafka": _group, "s3": _s3}[check]()
    fn = {"etcd": differential_etcd_mvcc, "kafka": differential_kafka_group, "s3": differential_s3}[check]
    jax_fn = {"etcd": jax_diff.differential_etcd_mvcc, "kafka": jax_diff.differential_kafka_group,
              "s3": jax_diff.differential_s3}[check]
    jax_eng, eng = engines
    for seed in (0, 1):
        got = fn(eng, seed)
        assert got == jax_fn(jax_eng, seed), (check, seed)
        assert got["ok"], (check, seed, got["mismatches"])
