"""The port's cross-engine differential against the JAX package's
under chaos, mirroring the rest of tests/test_differential.py: a vote
bug planted in both authoring models (the port's device Raft, the JAX
package's host example) caught by both engines, and the loss storms of
the device schedule reaching the host run with the engine's base loss
rate. Each report equals the one the JAX package's `differential_raft`
gives on the same seeds. The `_own_host_run` cases plant the bug in the
port's own host example (examples/raft_host_torch.py) and run the
port's own host Raft."""

import torch

from madsim_tpu.differential import _load_raft_host
from madsim_tpu.models.raft import RaftMachine as JaxRaft
from madsim_tpu_torch.engine.core import F_LOSS_STORM
from madsim_tpu_torch.models.raft import RaftMachine

from torch_port_util import differential_engines as _engines
from torch_port_util import raft_differential as _both
from torch_port_util import raft_differential_own_host as _both_own


def test_same_bug_class_caught_by_both_engines():
    """A protocol bug (grant votes unconditionally) planted in BOTH
    authoring models is caught by BOTH engines' invariants, and the
    port's report on the bugged pair equals the JAX package's."""
    import jax.numpy as jnp

    from madsim_tpu.engine.machine import send_if as jax_send_if
    from madsim_tpu.models import raft as R
    from madsim_tpu_torch.engine.machine import send_if
    from madsim_tpu_torch.models import raft as PR
    from madsim_tpu_torch.utils import take

    class JaxBuggyDeviceRaft(JaxRaft):
        def on_message(self, nodes, node, src, payload, now_us, rand_u32):
            nodes2, outbox = super().on_message(nodes, node, src, payload, now_us, rand_u32)
            is_rv = payload[0] == R.M_RV
            vote = self._pay(R.M_VOTE, jnp.maximum(payload[1], nodes.term[node]), 1)
            return nodes2, jax_send_if(outbox, 0, is_rv, src, vote)

    class BuggyDeviceRaft(RaftMachine):
        def on_message(self, nodes, node, src, payload, now_us, rand_u32):
            nodes2, outbox = super().on_message(nodes, node, src, payload, now_us, rand_u32)
            is_rv = payload[:, 0] == PR.M_RV
            vote = self._pay(PR.M_VOTE, torch.maximum(payload[:, 1], take(nodes.term, node)), 1)
            return nodes2, send_if(outbox, 0, is_rv, src, vote)

    ex = _load_raft_host()

    class BuggyHostNode(ex.RaftNode):
        async def on_request_vote(self, req, data):
            if req.term > self.term:
                self.become_follower(req.term)
            return {"term": self.term, "granted": True}

    engines = _engines(JaxBuggyDeviceRaft(5, 8), BuggyDeviceRaft(5, 8),
                       dict(n_faults=2, t_max_us=2_000_000, dur_min_us=200_000, dur_max_us=600_000),
                       horizon_us=3_000_000)
    report = _both(engines, range(16), host_node_cls=BuggyHostNode)
    assert report["schedule_mismatches"] == 0
    assert report["device_violations"] >= 1, report
    assert report["host_violations"] >= 1, report


def test_loss_storm_reaches_the_host_run():
    """A near-total storm from the device schedule reaches the host
    fabric at its scheduled time with the storm's rate (the rate the
    fabric reads, tests/test_differential.py:104-126, through the
    harness): the report equals the JAX package's."""
    engines = _engines(JaxRaft(5, 8), RaftMachine(5, 8),
                       dict(n_faults=1, allow_partition=False, allow_kill=False, allow_storm=True,
                            storm_loss_u16=65535, t_max_us=1_000_000, dur_min_us=500_000, dur_max_us=900_000),
                       horizon_us=3_000_000)
    report = _both(engines, range(4))
    for row in report["rows"]:
        storm = [e for e in row["schedule"] if e["op"] == F_LOSS_STORM]
        assert storm and row["host"]["loss_trace"][:2] == [(0, 0.0), (storm[0]["t_us"], 65535 / 65536.0)]
    assert report["schedule_mismatches"] == 0


def test_loss_storm_composites_with_base_rate():
    """The harness hands the engine's static packet_loss_rate to the
    host run as its base rate: storms add to it and their end restores
    it (not 0.0), on the port as on the JAX package."""
    engines = _engines(JaxRaft(5, 8), RaftMachine(5, 8),
                       dict(n_faults=2, allow_partition=False, allow_kill=False, allow_storm=True,
                            t_max_us=1_000_000, dur_min_us=100_000, dur_max_us=300_000),
                       horizon_us=2_000_000, packet_loss_rate=0.25)
    report = _both(engines, range(3), max_steps=2000)
    for row in report["rows"]:
        trace = row["host"]["loss_trace"]
        assert trace[0] == (0, 0.25) and trace[-1][1] == 0.25
        assert all(rate >= 0.25 for _t, rate in trace) and any(rate > 0.25 for _t, rate in trace)


def _bugged_device_pair():
    """The vote-granting device Raft of both packages."""
    import jax.numpy as jnp

    from madsim_tpu.engine.machine import send_if as jax_send_if
    from madsim_tpu.models import raft as R
    from madsim_tpu_torch.engine.machine import send_if
    from madsim_tpu_torch.models import raft as PR
    from madsim_tpu_torch.utils import take

    class JaxBuggyDeviceRaft(JaxRaft):
        def on_message(self, nodes, node, src, payload, now_us, rand_u32):
            nodes2, outbox = super().on_message(nodes, node, src, payload, now_us, rand_u32)
            is_rv = payload[0] == R.M_RV
            vote = self._pay(R.M_VOTE, jnp.maximum(payload[1], nodes.term[node]), 1)
            return nodes2, jax_send_if(outbox, 0, is_rv, src, vote)

    class BuggyDeviceRaft(RaftMachine):
        def on_message(self, nodes, node, src, payload, now_us, rand_u32):
            nodes2, outbox = super().on_message(nodes, node, src, payload, now_us, rand_u32)
            is_rv = payload[:, 0] == PR.M_RV
            vote = self._pay(PR.M_VOTE, torch.maximum(payload[:, 1], take(nodes.term, node)), 1)
            return nodes2, send_if(outbox, 0, is_rv, src, vote)

    return JaxBuggyDeviceRaft(5, 8), BuggyDeviceRaft(5, 8)


def _vote_granting(node_cls):
    class BuggyHostNode(node_cls):
        async def on_request_vote(self, req, data):
            if req.term > self.term:
                self.become_follower(req.term)
            return {"term": self.term, "granted": True}

    return BuggyHostNode


def test_same_bug_class_caught_with_the_ports_own_host_run():
    """The vote bug planted in the port's device Raft and in the port's
    own host example is caught by both of the port's engines; the report
    equals the JAX package's on its own bugged pair."""
    from madsim_tpu_torch.differential import _load_raft_host as own_load_raft_host

    engines = _engines(*_bugged_device_pair(),
                       dict(n_faults=2, t_max_us=2_000_000, dur_min_us=200_000, dur_max_us=600_000),
                       horizon_us=3_000_000)
    report = _both_own(engines, range(16), host_node_cls=_vote_granting(own_load_raft_host().RaftNode),
                       jax_host_node_cls=_vote_granting(_load_raft_host().RaftNode))
    assert report["schedule_mismatches"] == 0
    assert report["device_violations"] >= 1, report
    assert report["host_violations"] >= 1, report


def test_loss_storm_composites_with_the_ports_own_host_run():
    """Storms over the engine's base loss rate reach the port's own host
    fabric and their end restores the base; the report equals the JAX
    package's."""
    engines = _engines(JaxRaft(5, 8), RaftMachine(5, 8),
                       dict(n_faults=2, allow_partition=False, allow_kill=False, allow_storm=True,
                            t_max_us=1_000_000, dur_min_us=100_000, dur_max_us=300_000),
                       horizon_us=2_000_000, packet_loss_rate=0.25)
    report = _both_own(engines, range(3), max_steps=2000)
    for row in report["rows"]:
        trace = row["host"]["loss_trace"]
        assert trace[0] == (0, 0.25) and trace[-1][1] == 0.25
        assert any(rate > 0.25 for _t, rate in trace)
