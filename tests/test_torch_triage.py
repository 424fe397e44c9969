"""The port's triage path against the JAX package: what a user does with
a found bug. The on-device trace ring (the whole BatchResult, ring
included, on both streams and under a pause plan; `ring_trace` against
the tail of the port's replay; a ring that never filled; `run_stream`
with a ring), `check_determinism`, `shrink` (the same ShrinkResult as
JAX's on both streams), the corpus file (`config_to_dict`, `save` byte
for byte, `add`), digest trails recorded by one package and audited by
the other, and the Perfetto and JSONL exports byte for byte. The
scenario is the reference's own ring and shrink test
(tests/test_engine_etcd.py:132-177): the double-grant etcd demo at
Q = 96 with 5% loss. Every comparison is exact."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import madsim_tpu.engine as jax_engine
from madsim_tpu.engine import audit as jax_audit
from madsim_tpu.engine import corpus as jax_corpus
from madsim_tpu.engine import trace_export as jax_export
from madsim_tpu.engine.replay import TraceEvent as JaxTraceEvent
from madsim_tpu.engine.shrink import shrink as jax_shrink
from madsim_tpu.__main__ import build_machine as jax_build
from madsim_tpu.models import etcd as jax_etcd
from madsim_tpu_torch.engine import Engine, EngineConfig, FaultPlan, audit, corpus, trace_export
from madsim_tpu_torch.engine.core import K_PAUSE
from madsim_tpu_torch.engine.replay import decode_ring, replay
from madsim_tpu_torch.engine.shrink import shrink
from madsim_tpu_torch.errors import NonDeterminism
from madsim_tpu_torch.models import build_machine, etcd, kv

from torch_port_util import engines, same

TRIAGE = dict(horizon_us=8_000_000, queue_capacity=96, packet_loss_rate=0.05, trace_ring=32)
ETCD_FAULTS = dict(n_faults=2, t_max_us=5_000_000, dur_min_us=200_000, dur_max_us=800_000)
# double-grant lanes fail LEASE_SAFETY 16-60 events in
STEPS = 48
LANES = 16


class JaxDoubleGrantEtcd(jax_etcd.EtcdMachine):
    CHECK_OWNER_ON_CAMPAIGN = False


def _triage(rng_stream, **overrides):
    kw = {**TRIAGE, **overrides}
    faults = kw.pop("faults", ETCD_FAULTS)
    return engines(JaxDoubleGrantEtcd(4, 99, 9999), build_machine("demo-doublegrant-etcd"), rng_stream=rng_stream,
                   faults=faults, **kw)


def _keys(events):
    return [(e.step, e.time_us, e.kind, e.node, e.src, e.payload) for e in events]


@pytest.fixture(scope="module", params=[2, 3], ids=["rng_stream=2", "rng_stream=3"])
def triage_batch(request):
    jax_eng, port = _triage(request.param)
    seeds = np.arange(LANES, dtype=np.uint32)
    want = jax.jit(jax_eng.run_batch, static_argnums=1)(jnp.asarray(seeds), STEPS)
    return jax_eng, port, want, port.make_runner(max_steps=STEPS)(seeds)


# -- the trace ring ------------------------------------------------------------


def test_ring_matches_jax(triage_batch):
    """The whole BatchResult, the ring's six leaves among them."""
    _, port, want, got = triage_batch
    same(want, got)
    assert sorted(got.ring) == ["kind", "node", "payload", "src", "step", "time"]
    assert got.ring["payload"].shape == (LANES, 32, port.machine.PAYLOAD_WIDTH)
    assert bool(got.failed.any()) and set(got.fail_code[got.failed].tolist()) == {etcd.LEASE_SAFETY}
    assert port.failing_seeds(got).tolist() == np.arange(LANES)[got.failed.numpy()].tolist()


def test_ring_trace_is_the_tail_of_the_replay(triage_batch):
    """A failing lane's ring, decoded, equals the last events of its
    replay; the digest checkpoints decode as the audit's decoder reads
    them."""
    _, port, _, got = triage_batch
    lanes = np.nonzero(got.failed.numpy())[0][:2]
    for lane in lanes.tolist():
        ring = port.ring_trace(got, lane)
        rp = replay(port, int(got.seeds[lane]), max_steps=STEPS)
        assert 0 < len(ring) <= 32 and rp.fail_code == etcd.LEASE_SAFETY
        assert _keys(ring) == _keys(rp.trace[-len(ring):])
        assert port.digest_checkpoints(got, lane) == audit.decode_checkpoint_ring(
            {k: v[lane] for k, v in got.fr.items()})


def test_ring_under_a_pause_plan_matches_jax():
    """Pause windows defer events by rewriting their queue slot's time;
    the ring keeps the popped (gathered) time, as the replay trace does.
    Lanes that end inside the budget write nothing more."""
    faults = dict(n_faults=3, t_max_us=600_000, dur_min_us=200_000, dur_max_us=500_000, allow_pause=True,
                  allow_partition=False)
    jax_eng, port = engines(jax_etcd.EtcdMachine(4, 1, 2), etcd.EtcdMachine(4, 1, 2), rng_stream=3, faults=faults,
                            **TRIAGE)
    seeds = np.arange(LANES, dtype=np.uint32)
    want = jax.jit(jax_eng.run_batch, static_argnums=1)(jnp.asarray(seeds), 96)
    got = port.run_batch(seeds, 96)
    same(want, got)
    paused = got.fr["inj"][:, K_PAUSE] > 0
    done = got.done & ~got.failed
    assert bool(paused.any()) and bool(done.any()) and int(got.steps.min()) < 96
    # a lane that ended: its last ring entry is its last step, nothing after
    assert got.ring["step"].amax(dim=1)[done].tolist() == (got.steps[done] - 1).tolist()
    lane = int(np.nonzero(paused.numpy())[0][0])
    ring = port.ring_trace(got, lane)
    assert _keys(ring) == _keys(replay(port, lane, max_steps=96).trace[-len(ring):])


def test_decode_ring_on_a_lane_that_never_filled_its_ring():
    _, port = _triage(3, trace_ring=64)
    state = port.run_segment(port.init_batch([5, 6]), 10)
    events = decode_ring({k: v[0] for k, v in state.ring.items()})
    assert [e.step for e in events] == list(range(10))
    assert _keys(events) == _keys(replay(port, 5, max_steps=10).trace)
    assert int((state.ring["step"][0] < 0).sum()) == 54
    _, no_ring = _triage(3, trace_ring=0)
    with pytest.raises(ValueError, match="trace_ring=0"):
        no_ring.ring_trace(no_ring.run_batch([1], 4), 0)


def test_run_stream_with_a_ring_matches_jax():
    jax_eng, port = _triage(2, trace_ring=8)
    kw = dict(batch=16, segment_steps=32, seed_start=700, max_steps=256)
    want, got = jax_eng.run_stream(40, pipelined=False, **kw), port.run_stream(40, pipelined=False, **kw)
    for key in ("completed", "failing", "infra", "abandoned", "seeds_consumed"):
        assert got[key] == want[key], key
    for key in ("coverage", "flight_recorder", "host_syncs", "drains", "dispatches", "device_segments"):
        assert got["stats"][key] == want["stats"][key], key
    assert np.array_equal(got["coverage_map"], want["coverage_map"]) and len(got["failing"]) >= 32


# -- check_determinism ---------------------------------------------------------


def test_check_determinism_passes_an_honest_batch():
    _, port = _triage(3)
    seeds = np.arange(8, dtype=np.uint32)
    res = port.check_determinism(seeds, max_steps=24)
    assert bool(res.failed.any()) and res.steps.tolist() == port.run_batch(seeds, 24).steps.tolist()


def test_check_determinism_names_the_leaves_a_host_counter_moves():
    class CountingKv(kv.KvMachine):
        """Its tick reads a Python counter: host state smuggled into a handler."""

        calls = 0

        def on_timer(self, nodes, node, timer_id, now_us, rand_u32):
            CountingKv.calls += 1
            nodes, outbox = super().on_timer(nodes, node, timer_id, now_us, rand_u32)
            return nodes, dataclasses.replace(outbox, timer_delay_us=outbox.timer_delay_us + CountingKv.calls % 7)

    eng = Engine(CountingKv(4), EngineConfig(queue_capacity=64), device="cpu")
    with pytest.raises(NonDeterminism, match=r"diverging leaves: \[.*'\.now_us'"):
        eng.check_determinism(np.arange(4, dtype=np.uint32), max_steps=40)


# -- shrink --------------------------------------------------------------------


@pytest.mark.parametrize("rng_stream", [2, 3])
def test_shrink_matches_jax(rng_stream):
    """A double-grant seed shrinks through every step (the fault prefix,
    loss off, the kind ablation, the horizon) to the same result on both
    packages, and the shrunk config reproduces on the port."""
    jax_eng, port = _triage(rng_stream, flight_recorder=False, coverage=False)
    seed = 3
    want = jax_shrink(jax_eng, seed, max_steps=64)
    got = shrink(port, seed, max_steps=64)
    assert jax_corpus.config_to_dict(want.shrunk) == corpus.config_to_dict(got.shrunk)
    for field in ("seed", "fail_code", "steps", "fail_time_us", "attempts", "kinds_removed", "guided"):
        assert getattr(got, field) == getattr(want, field), field
    assert got.summary() == want.summary()
    s = got.shrunk
    assert (s.faults.n_faults, s.packet_loss_rate, got.kinds_removed) == (0, 0.0, ("kill", "pair"))
    assert s.horizon_us == got.fail_time_us + 1 and got.attempts == 1 + 1 + 1 + 2 + 1
    rp = replay(Engine(port.machine, s, device="cpu"), seed, max_steps=got.steps, trace=False)
    assert rp.failed and rp.fail_code == etcd.LEASE_SAFETY


def test_shrink_refuses_a_passing_seed_and_a_provenance_word():
    """A passing seed is refused, with or without a provenance word to
    guide the shrink (guided shrink runs in test_torch_provenance.py)."""
    honest = Engine(etcd.EtcdMachine(4, 2, 6), EngineConfig(**TRIAGE, faults=FaultPlan(**ETCD_FAULTS)), device="cpu")
    for word in (None, 0b101):
        with pytest.raises(ValueError, match="does not fail"):
            shrink(honest, 0, max_steps=16, prov_word=word)


# -- the corpus ------------------------------------------------------------------

FULL = dict(horizon_us=7_000_000, queue_capacity=80, latency_min_us=2_000, latency_max_us=9_000,
            packet_loss_rate=0.02, handler_rand_words=6, trace_ring=16, rng_stream=3, flight_recorder=True,
            fr_digest_every=32, coverage=True, cov_slots_log2=12, cov_buffer=8, pallas_megakernel=True)
FULL_FAULTS = dict(n_faults=3, allow_dir_clog=True, allow_dup=True, strict_restart=True, storm_loss_u16=40000,
                   t_min_us=1_000, t_max_us=2_000_000, dur_min_us=50_000, dur_max_us=900_000)


def _entry(pkg, seed, **kw):
    cfg = pkg.EngineConfig(**{**TRIAGE, "rng_stream": 3}, faults=pkg.FaultPlan(**ETCD_FAULTS))
    return (jax_corpus if pkg is jax_engine else corpus).CorpusEntry(
        machine="demo-doublegrant-etcd", seed=seed, fail_code=etcd.LEASE_SAFETY, status="open", config=cfg,
        max_steps=48, **kw)


def test_config_to_dict_matches_jax():
    want = jax_corpus.config_to_dict(jax_engine.EngineConfig(**FULL, faults=jax_engine.FaultPlan(**FULL_FAULTS)))
    got = corpus.config_to_dict(EngineConfig(**FULL, faults=FaultPlan(**FULL_FAULTS)))
    assert got == want and list(got) == list(want) and list(got["faults"]) == list(want["faults"])
    assert "flight_recorder" not in got and "pallas_megakernel" not in got and got["trace_ring"] == 16


def test_save_is_byte_for_byte_the_references_and_add_dedups(tmp_path):
    extra = dict(note="found by a hunt", digest_every=16, digests=[[16, 1, 2], [32, 3, 4]], digest_final=[40, 5, 6],
                 meta={"filed_by": "test", "rng_stream": 3})
    jax_corpus.save(str(tmp_path / "jax.json"), [_entry(jax_engine, 3, **extra), _entry(jax_engine, 9)])
    corpus.save(str(tmp_path / "port.json"), [_entry(corpus, 3, **extra), _entry(corpus, 9)])
    assert (tmp_path / "port.json").read_bytes() == (tmp_path / "jax.json").read_bytes()
    path = str(tmp_path / "added.json")
    assert corpus.add(path, _entry(corpus, 3, **extra)) and corpus.add(path, _entry(corpus, 9))
    assert not corpus.add(path, _entry(corpus, 3))
    assert [e.seed for e in corpus.load(path)] == [3, 9]
    assert (tmp_path / "added.json").read_bytes() == (tmp_path / "port.json").read_bytes()


def test_entries_recorded_by_either_package_audit_match_on_the_other(tmp_path):
    """The port records an entry (trail and environment), saves it, and
    the JAX package loads it: its check still reproduces and its audit
    matches. And the other way round."""
    port_entry, trail = audit.record_entry(_entry(corpus, 3, meta={"filed_by": "test"}), build_machine, every=8,
                                           device="cpu")
    assert trail.failed and trail.fail_code == etcd.LEASE_SAFETY and len(port_entry.digests) >= 2
    meta = port_entry.meta
    assert meta["filed_by"] == "test" and meta["digest"] == "fr-v1" and meta["torch"] == torch.__version__
    corpus.add(str(tmp_path / "port.json"), port_entry)
    (loaded,) = jax_corpus.load(str(tmp_path / "port.json"))
    assert jax_corpus.check(loaded, jax_build).ok
    assert jax_audit.audit_entry(loaded, jax_build).status == "match"

    jax_entry, _ = jax_audit.record_entry(_entry(jax_engine, 5), jax_build, every=8)
    jax_corpus.add(str(tmp_path / "jax.json"), jax_entry)
    (loaded,) = corpus.load(str(tmp_path / "jax.json"))
    assert corpus.check(loaded, build_machine, device="cpu").verdict == "still open (reproduces)"
    got = audit.audit_entry(loaded, build_machine, device="cpu")
    assert got.status == "match", got.verdict


# -- the trace export ------------------------------------------------------------


@pytest.mark.parametrize("with_flows", [False, True], ids=["plain", "flows"])
def test_exports_are_byte_for_byte_the_references(tmp_path, with_flows):
    _, port = _triage(3)
    events = replay(port, 3, max_steps=STEPS).trace
    assert {e.kind for e in events} == {"timer", "msg", "fault"}

    def as_jax(e):
        return JaxTraceEvent(**dataclasses.asdict(e))

    kw = jax_kw = {}
    if with_flows:
        # send -> delivery pairs; one delivery without its seq, whose
        # flow id falls back to the two steps
        msgs = [i for i, e in enumerate(events) if e.kind == "msg"]
        flows = [(events[i - 1], events[i]) for i in msgs[::2]]
        flows[0] = (flows[0][0], dataclasses.replace(flows[0][1], seq=-1))
        kw = dict(flows=flows, highlight={1, 4})
        jax_kw = dict(flows=[(as_jax(a), as_jax(b)) for a, b in flows], highlight={1, 4})
    common = dict(machine="demo-doublegrant-etcd", seed=3)
    n = trace_export.write_perfetto(str(tmp_path / "port.json"), events, num_nodes=4, **common, **kw)
    m = jax_export.write_perfetto(str(tmp_path / "jax.json"), [as_jax(e) for e in events], num_nodes=4, **common,
                                  **jax_kw)
    assert n == m == len(events)
    assert (tmp_path / "port.json").read_bytes() == (tmp_path / "jax.json").read_bytes()
    n = trace_export.write_jsonl(str(tmp_path / "port.jsonl"), events, **common)
    m = jax_export.write_jsonl(str(tmp_path / "jax.jsonl"), [as_jax(e) for e in events], **common)
    assert n == m and (tmp_path / "port.jsonl").read_bytes() == (tmp_path / "jax.jsonl").read_bytes()
