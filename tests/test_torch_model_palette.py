"""The etcd-MVCC, S3, multi-Paxos and gossip models on the counter-based
stream (`rng_stream=3`, the step megakernel) under one mixed plan of
every fault kind the port runs (pair, kill, dir, group, storm, delay,
pause and skew) with message duplication and 2% packet loss, recorder
and coverage on: `run_batch` must give the JAX package's whole
`BatchResult`. Each model's own tests hold it on the default stream
under its own plan; this holds the palette and the megakernel at the
models' queue depths (48, 64 and 256). Every comparison is exact."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from madsim_tpu.engine import Engine as JaxEngine
from madsim_tpu.engine import EngineConfig as JaxConfig
from madsim_tpu.engine import FaultPlan as JaxFaultPlan
from madsim_tpu.models.etcd_mvcc import EtcdMvccMachine as JaxMvcc
from madsim_tpu.models.gossip import GossipMachine as JaxGossip
from madsim_tpu.models.multipaxos import MultiPaxosMachine as JaxMultiPaxos
from madsim_tpu.models.s3 import S3Machine as JaxS3
from madsim_tpu_torch.engine import Engine, EngineConfig, FaultPlan
from madsim_tpu_torch.interop import tree_to_numpy
from madsim_tpu_torch.models import build_machine

from torch_port_util import jax_to_numpy, tree_diff

MIXED = dict(n_faults=3, allow_dir_clog=True, allow_group=True, allow_storm=True, allow_delay=True,
             allow_pause=True, allow_skew=True, allow_dup=True)
CONFIG = dict(rng_stream=3, packet_loss_rate=0.02, flight_recorder=True, coverage=True)
# the faults fall where each run reaches in its step budget: 300 steps of
# mvcc, s3 or multi-Paxos pass ~1 virtual s, 200 steps of 33-node gossip
# ~50 ms
WITHIN_1S = dict(t_max_us=1_000_000, dur_min_us=100_000, dur_max_us=800_000)
WITHIN_40MS = dict(t_max_us=40_000, dur_min_us=5_000, dur_max_us=30_000)

# (registry name, JAX machine, lanes, queue_capacity, horizon_us, fault times, max_steps)
MODELS = [
    ("etcd-mvcc", lambda: JaxMvcc(4), 16, 48, 8_000_000, WITHIN_1S, 300),
    ("s3", lambda: JaxS3(4), 16, 48, 8_000_000, WITHIN_1S, 300),
    ("multipaxos", lambda: JaxMultiPaxos(5), 16, 64, 8_000_000, WITHIN_1S, 300),
    ("gossip", lambda: JaxGossip(33), 8, 256, 5_000_000, WITHIN_40MS, 200),
]


@pytest.mark.parametrize("name,jax_machine,lanes,q,horizon,times,steps", MODELS, ids=[m[0] for m in MODELS])
def test_model_under_the_palette_matches_jax(name, jax_machine, lanes, q, horizon, times, steps):
    cfg = dict(CONFIG, queue_capacity=q, horizon_us=horizon)
    faults = {**MIXED, **times}
    jax_eng = JaxEngine(jax_machine(), JaxConfig(faults=JaxFaultPlan(**faults), **cfg))
    port = Engine(build_machine(name), EngineConfig(faults=FaultPlan(**faults), **cfg), device="cpu")
    assert port.use_megakernel and port.cov_band_bits == 4
    seeds = np.arange(lanes, dtype=np.uint32) + 4000
    want = jax.jit(jax_eng.run_batch, static_argnums=1)(jnp.asarray(seeds), steps)
    got = port.run_batch(seeds, steps)
    diff = tree_diff(jax_to_numpy(want), tree_to_numpy(got))
    assert not diff, diff[:5]
    inj = got.fr["inj"].sum(dim=0)
    assert int(got.fr["dup"].sum()) > 0 and int((inj[:8] > 0).sum()) >= 6, inj.tolist()
