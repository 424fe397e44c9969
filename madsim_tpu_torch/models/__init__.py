"""Protocol models of the port (lane-batched Machines) and the registry
that rebuilds a machine from its CLI name, as corpus entries name it."""

from .multipaxos import MultiPaxosMachine, MultiPaxosState, NoPromiseCheckMultiPaxos
from .raft import RaftMachine, RaftState

__all__ = [
    "MultiPaxosMachine", "MultiPaxosState", "NoPromiseCheckMultiPaxos", "RaftMachine", "RaftState",
    "build_machine",
]


class OvercommitRaft(RaftMachine):
    COMMIT_TO_LOG_LEN = True  # Raft §5.3 commit-bound bug


class QuorumOffByOneRaft(RaftMachine):
    QUORUM_OFF_BY_ONE = True  # commit below majority (needs group faults)


class VolatileCommitRaft(RaftMachine):
    PERSIST_COMMIT_NOT_LOG = True  # durable commitIndex, volatile log


class DupVoteRaft(RaftMachine):
    DUP_VOTE_COUNT = True  # per-message vote tally (caught by dup chaos)


_MACHINES = {
    "raft": lambda n: RaftMachine(num_nodes=n or 5, log_capacity=8),
    "demo-overcommit-raft": lambda n: OvercommitRaft(num_nodes=n or 5, log_capacity=8),
    "demo-quorumoffbyone-raft": lambda n: QuorumOffByOneRaft(num_nodes=n or 5, log_capacity=8),
    "demo-volatilecommit-raft": lambda n: VolatileCommitRaft(num_nodes=n or 5, log_capacity=8),
    "demo-dupvote-raft": lambda n: DupVoteRaft(num_nodes=n or 5, log_capacity=8),
    "multipaxos": lambda n: MultiPaxosMachine(num_nodes=n or 5),
    "demo-nopromise-multipaxos": lambda n: NoPromiseCheckMultiPaxos(num_nodes=n or 5),
}


def build_machine(name: str, nodes: int = 0):
    """The machine of a registry name (the names of the reference's CLI
    registry), with `nodes` nodes, or the machine's default when 0.
    Names the reference knows but the port has no model for raise
    NotImplementedError."""
    if name not in _MACHINES:
        raise NotImplementedError(
            f"machine {name!r} is not ported to madsim_tpu_torch yet; the port has "
            f"{sorted(_MACHINES)}"
        )
    return _MACHINES[name](nodes)
