"""The port's soak tests, mirroring tests/test_soak.py at its shapes:
six randomized configs across machines on the engine (on the CUDA card
where there is one, else on the CPU), and a chaotic host workload on the
port's runtime held against the JAX package's (`torch_host_util.both`):
nothing crashes, everything reproduces. Minutes long, so `slow`, as the
reference's."""

import numpy as np
import pytest
import torch

from madsim_tpu_torch.engine import Engine, EngineConfig, FaultPlan, replay
from madsim_tpu_torch.models.echo import EchoMachine
from madsim_tpu_torch.models.kv import KvMachine
from madsim_tpu_torch.models.mq import MqMachine
from madsim_tpu_torch.models.raft import RaftMachine
from madsim_tpu_torch.models.twopc import TwoPcMachine
from torch_host_util import both

pytestmark = pytest.mark.slow

DEVICE = "cuda" if torch.cuda.is_available() else "cpu"

CONFIGS = [
    ("raft3", lambda: RaftMachine(3, 6),
     EngineConfig(horizon_us=4_000_000, queue_capacity=80,
                  faults=FaultPlan(n_faults=1, t_max_us=2_000_000))),
    ("raft5-lossy", lambda: RaftMachine(5, 8),
     EngineConfig(horizon_us=4_000_000, queue_capacity=96, packet_loss_rate=0.05,
                  faults=FaultPlan(n_faults=2, t_max_us=2_500_000))),
    ("kv-killy", lambda: KvMachine(5),
     EngineConfig(horizon_us=3_000_000, queue_capacity=80,
                  faults=FaultPlan(n_faults=3, allow_partition=False, t_max_us=2_000_000,
                                   dur_min_us=50_000, dur_max_us=300_000))),
    ("mq-lossy", lambda: MqMachine(5, log_capacity=32, max_seq=8),
     EngineConfig(horizon_us=5_000_000, queue_capacity=96, packet_loss_rate=0.15,
                  faults=FaultPlan(n_faults=1, t_max_us=2_000_000))),
    ("echo-chaotic", lambda: EchoMachine(rounds=8),
     EngineConfig(horizon_us=20_000_000, queue_capacity=48, packet_loss_rate=0.2)),
    ("twopc-killy", lambda: TwoPcMachine(5, 5),
     EngineConfig(horizon_us=6_000_000, queue_capacity=96, packet_loss_rate=0.1,
                  faults=FaultPlan(n_faults=2, t_max_us=3_000_000,
                                   dur_min_us=100_000, dur_max_us=400_000))),
]


@pytest.mark.parametrize("name,mk,cfg", CONFIGS, ids=[c[0] for c in CONFIGS])
def test_engine_soak_config(name, mk, cfg):
    eng = Engine(mk(), cfg, device=DEVICE)
    res = eng.make_runner(max_steps=3500)(np.arange(24, dtype=np.uint32))
    # correct protocols: no invariant failures, every lane terminates
    assert bool(res.done.all()), f"{name}: undone lanes"
    assert not bool(res.failed.any()), f"{name}: codes {set(res.fail_code.tolist())}"
    # a random lane replays bit-identically
    lane = int(res.steps.argmax())  # the gnarliest lane
    rp = replay(eng, lane, max_steps=3500)
    assert int(rp.state.step) == int(res.steps[lane])
    assert int(rp.state.now_us) == int(res.now_us[lane])


def test_host_supervisor_torture_deterministic():
    """Random kill/restart/pause/resume/clog storm over RPC traffic:
    never crashes, reproduces exactly per seed, and serves the same
    requests on both packages."""

    def work(m):
        class Op(m.net.Request):
            def __init__(self, v):
                self.v = v

        def run_seed(seed):
            async def main():
                handle = m.Handle.current()
                net = m.plugin.simulator(m.net.NetSim)
                rng = m.rand.thread_rng()
                served = []

                def mk_server(i):
                    async def serve():
                        ep = await m.net.Endpoint.bind("0.0.0.0:700")

                        async def on_op(req, data):
                            served.append((i, req.v))
                            return req.v

                        ep.add_rpc_handler(Op, on_op)
                        await m.time.sleep(1e9)

                    return serve

                servers = []
                for i in range(3):
                    node = handle.create_node().ip(f"10.9.0.{i+1}").init(mk_server(i)).restart_on_panic().build()
                    servers.append(node)
                client = handle.create_node().ip("10.9.0.99").build()

                async def load():
                    ep = await m.net.Endpoint.bind("0.0.0.0:0")
                    n = 0
                    while True:
                        target = rng.gen_range(0, 3)
                        try:
                            await ep.call_timeout(f"10.9.0.{target+1}:700", Op(n), 0.3)
                        except TimeoutError:
                            pass
                        n += 1
                        await m.time.sleep(0.01)

                client.spawn(load())

                for _ in range(40):
                    await m.time.sleep(rng.random() * 0.3)
                    op = rng.gen_range(0, 6)
                    victim = servers[rng.gen_range(0, 3)]
                    if op == 0:
                        handle.kill(victim.id)
                    elif op == 1:
                        handle.restart(victim.id)
                    elif op == 2:
                        handle.pause(victim.id)
                    elif op == 3:
                        handle.resume(victim.id)
                    elif op == 4:
                        net.clog_node(victim.id)
                    else:
                        net.unclog_node(victim.id)
                return tuple(served)

            return m.Runtime(seed=seed).block_on(main())

        runs = {seed: run_seed(seed) for seed in (11, 12)}
        assert all(run_seed(seed) == out for seed, out in runs.items())
        return runs

    runs = both(work)
    assert runs[11] != runs[12]
