"""Protocol models of the port (lane-batched Machines) and the registry
that rebuilds a machine from its CLI name, as corpus entries name it."""

from .echo import EchoMachine, EchoState
from .etcd import EtcdMachine, EtcdState
from .etcd_mvcc import EtcdMvccMachine, MvccState, NoDedupMvcc, PrematureGiveupMvcc
from .gossip import DupAckGossip, GossipMachine, GossipState
from .kafka_group import GroupState, KafkaGroupMachine, NoFencingGroupMachine
from .kv import KvMachine, KvState
from .mq import MqMachine, MqState
from .multipaxos import MultiPaxosMachine, MultiPaxosState, NoPromiseCheckMultiPaxos
from .paxos import NoPromiseCheckPaxos, PaxosMachine, PaxosState
from .raft import RaftMachine, RaftState
from .raft_compact import RaftCompactMachine, RaftCompactState, TornSnapshotRaftCompact
from .s3 import AbortLeakS3, ArrivalOrderS3, EarlyExpiryS3, NoDedupS3, S3Machine, S3State, TombstoneLeakS3
from .twopc import TwoPcMachine, TwoPcState

__all__ = [
    "AbortLeakS3", "ArrivalOrderS3", "DoubleGrantEtcd", "DupAckGossip", "EarlyExpiryS3", "EchoMachine",
    "EchoState", "EtcdMachine", "EtcdMvccMachine", "EtcdState", "GossipMachine", "GossipState", "GroupState",
    "KafkaGroupMachine", "KvMachine", "KvState", "MqMachine", "MqState", "MultiPaxosMachine", "MultiPaxosState",
    "MvccState", "NoDedupMvcc", "NoDedupS3", "NoFencingGroupMachine", "NoPromiseCheckMultiPaxos",
    "NoPromiseCheckPaxos", "PaxosMachine", "PaxosState", "PrematureGiveupMvcc", "RaftCompactMachine",
    "RaftCompactState", "RaftMachine", "RaftState", "S3Machine", "S3State", "TombstoneLeakS3",
    "TornSnapshotRaftCompact", "TwoPcMachine", "TwoPcState", "build_machine",
]


class DoubleGrantEtcd(EtcdMachine):
    CHECK_OWNER_ON_CAMPAIGN = False  # non-atomic election txn


class OvercommitRaft(RaftMachine):
    COMMIT_TO_LOG_LEN = True  # Raft §5.3 commit-bound bug


class QuorumOffByOneRaft(RaftMachine):
    QUORUM_OFF_BY_ONE = True  # commit below majority (needs group faults)


class VolatileCommitRaft(RaftMachine):
    PERSIST_COMMIT_NOT_LOG = True  # durable commitIndex, volatile log


class DupVoteRaft(RaftMachine):
    DUP_VOTE_COUNT = True  # per-message vote tally (caught by dup chaos)


_MACHINES = {
    "echo": lambda n: EchoMachine(rounds=10),
    "raft": lambda n: RaftMachine(num_nodes=n or 5, log_capacity=8),
    "kv": lambda n: KvMachine(num_nodes=n or 4),
    "mq": lambda n: MqMachine(num_nodes=n or 4),
    "twopc": lambda n: TwoPcMachine(num_nodes=n or 4),
    "demo-overcommit-raft": lambda n: OvercommitRaft(num_nodes=n or 5, log_capacity=8),
    "demo-quorumoffbyone-raft": lambda n: QuorumOffByOneRaft(num_nodes=n or 5, log_capacity=8),
    "demo-volatilecommit-raft": lambda n: VolatileCommitRaft(num_nodes=n or 5, log_capacity=8),
    "demo-dupvote-raft": lambda n: DupVoteRaft(num_nodes=n or 5, log_capacity=8),
    "raft-compact": lambda n: RaftCompactMachine(num_nodes=n or 5, log_capacity=8),
    "demo-tornsnapshot-raft": lambda n: TornSnapshotRaftCompact(num_nodes=n or 5, log_capacity=8),
    "paxos": lambda n: PaxosMachine(num_nodes=n or 5),
    "demo-nopromise-paxos": lambda n: NoPromiseCheckPaxos(num_nodes=n or 5),
    "etcd": lambda n: EtcdMachine(num_nodes=n or 4),
    "demo-doublegrant-etcd": lambda n: DoubleGrantEtcd(num_nodes=n or 4, target_gens=99, target_writes=9999),
    "group": lambda n: KafkaGroupMachine(num_nodes=n or 4),
    "demo-nofencing-group": lambda n: NoFencingGroupMachine(num_nodes=n or 4),
    "multipaxos": lambda n: MultiPaxosMachine(num_nodes=n or 5),
    "demo-nopromise-multipaxos": lambda n: NoPromiseCheckMultiPaxos(num_nodes=n or 5),
    "etcd-mvcc": lambda n: EtcdMvccMachine(num_nodes=n or 4),
    "demo-nodedup-mvcc": lambda n: NoDedupMvcc(num_nodes=n or 4),
    "demo-giveup-mvcc": lambda n: PrematureGiveupMvcc(num_nodes=n or 4),
    "s3": lambda n: S3Machine(num_nodes=n or 4),
    "demo-arrivalorder-s3": lambda n: ArrivalOrderS3(num_nodes=n or 4),
    "demo-abortleak-s3": lambda n: AbortLeakS3(num_nodes=n or 4),
    "demo-earlyexpiry-s3": lambda n: EarlyExpiryS3(num_nodes=n or 4),
    "demo-tombstoneleak-s3": lambda n: TombstoneLeakS3(num_nodes=n or 4),
    "demo-nodedup-s3": lambda n: NoDedupS3(num_nodes=n or 4),
    "gossip": lambda n: GossipMachine(num_nodes=n or 33),
    "demo-dupack-gossip": lambda n: DupAckGossip(num_nodes=n or 33),
}


def build_machine(name: str, nodes: int = 0):
    """The machine of a registry name (the names of the reference's CLI
    registry, every one of them), with `nodes` nodes, or the machine's
    default when 0. An unknown name raises ValueError naming it."""
    if name not in _MACHINES:
        raise ValueError(f"unknown machine {name!r}; choose from {sorted(_MACHINES)}")
    return _MACHINES[name](nodes)
