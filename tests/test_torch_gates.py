"""The configuration gates the port has lifted, each held against the
JAX package: `run_batch` of the flagship hunt with one override (the
split-chain stream, packet loss, the recorder or coverage off, the step
megakernel off, and the dir, group, storm and delay fault kinds) must give the
reference's whole `BatchResult`. The ids are the gates' names, as
`test_unported_gates_raise` named them while they were closed."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from madsim_tpu.models import raft as jax_raft
from madsim_tpu_torch.interop import tree_to_numpy
from madsim_tpu_torch.models import raft

from torch_port_util import FLAGSHIP_FAULTS, engines, jax_to_numpy, tree_diff

LIFTED = [
    ("rng_stream=2", dict(rng_stream=2)),
    ("packet_loss_rate>0", dict(packet_loss_rate=0.01)),
    ("coverage=False", dict(coverage=False)),
    ("flight_recorder=False", dict(flight_recorder=False)),
    ("pallas_megakernel=False", dict(pallas_megakernel=False)),
] + [
    (f"FaultPlan.{flag}", dict(faults={**FLAGSHIP_FAULTS, flag: True}))
    for flag in ("allow_dir_clog", "allow_group", "allow_storm", "allow_delay")
]


@pytest.mark.parametrize("gate,overrides", LIFTED, ids=[g for g, _ in LIFTED])
def test_lifted_gates_match_jax(gate, overrides):
    jax_eng, port = engines(jax_raft.RaftMachine(5, 8), raft.RaftMachine(5, 8), **overrides)
    seeds = np.arange(24, dtype=np.uint32) + 77
    want = jax.jit(jax_eng.run_batch, static_argnums=1)(jnp.asarray(seeds), 256)
    got = port.run_batch(seeds, 256)
    diff = tree_diff(jax_to_numpy(want), tree_to_numpy(got))
    assert not diff, diff[:5]
    if gate.startswith("FaultPlan."):
        kind = {"allow_dir_clog": 2, "allow_group": 3, "allow_storm": 4, "allow_delay": 5}[gate.split(".")[1]]
        assert np.asarray(want.fr["inj"])[:, kind].sum() > 0  # the kind was injected
    assert port.use_megakernel == (gate not in ("rng_stream=2", "pallas_megakernel=False"))


def test_megakernel_is_refused_on_the_split_chain_stream():
    from madsim_tpu_torch.engine import Engine, EngineConfig

    with pytest.raises(ValueError, match="rng_stream=3"):
        Engine(raft.RaftMachine(5, 8), EngineConfig(rng_stream=2, pallas_megakernel=True), device="cpu")
    assert Engine(raft.RaftMachine(5, 8), EngineConfig(rng_stream=3), device="cpu").use_megakernel
