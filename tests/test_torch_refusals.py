"""`Engine.__init__`'s config refusals on the port, each held against the
JAX package's message word for word (the configs of ROADMAP.md §3
fault 1): an unknown RNG stream, an unknown coverage band layout, a
coverage map past 2^20 slots, the megakernel forced on the v2 stream,
group partitions outside 2-60 nodes."""

import pytest

from madsim_tpu.engine import Engine as JaxEngine
from madsim_tpu.engine import EngineConfig as JaxConfig
from madsim_tpu.engine import FaultPlan as JaxFaultPlan
from madsim_tpu.models import raft as jax_raft
from madsim_tpu_torch.engine import Engine, EngineConfig, FaultPlan
from madsim_tpu_torch.models import raft

import torch_port_util  # noqa: F401  (one torch thread; the partitionable Threefry pin)

# (case, config fields, fault plan fields, node count, a word of the message)
REFUSALS = [
    ("rng-stream", dict(rng_stream=7), {}, 5, "supported versions"),
    ("band-bits", dict(cov_band_bits_min=5), {}, 5, "known banded layouts"),
    ("slots", dict(coverage=True, cov_slots_log2=30), {}, 5, "3 phase bits"),
    ("megakernel", dict(pallas_megakernel=True, rng_stream=2), {}, 5, "cannot be expressed as a counter"),
    ("group-61", dict(queue_capacity=256), dict(allow_group=True), 61, "payload args 1+2 carry 30 bits each"),
]


@pytest.mark.parametrize("cfg,faults,nodes,word", [r[1:] for r in REFUSALS], ids=[r[0] for r in REFUSALS])
def test_refusal_matches_jax(cfg, faults, nodes, word):
    jm, m = jax_raft.RaftMachine(5, 8), raft.RaftMachine(5, 8)
    jm.NUM_NODES = m.NUM_NODES = nodes
    with pytest.raises(ValueError) as want:
        JaxEngine(jm, JaxConfig(faults=JaxFaultPlan(**faults), **cfg))
    with pytest.raises(ValueError) as got:
        Engine(m, EngineConfig(faults=FaultPlan(**faults), **cfg), device="cpu")
    assert str(got.value) == str(want.value) and word in str(got.value)
