"""Protocol models of the port (lane-batched Machines)."""

from .raft import RaftMachine, RaftState

__all__ = ["RaftMachine", "RaftState"]
