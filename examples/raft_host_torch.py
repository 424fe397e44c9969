"""MadRaft-style Raft on the port's HOST engine — free-form async authoring.

The port's copy of `examples/raft_host.py`, importing `madsim_tpu_torch`:
leader election + log replication written as ordinary async tasks over
the simulated fabric, with elections surviving partitions, and every
seed bit-reproducible. `madsim_tpu_torch.differential` loads it under
the same module name as the reference's, so RPC type ids are equal.

Run:  python examples/raft_host_torch.py [num_seeds]
Also imported by tests/test_torch_host_vs_jax.py.
"""

from __future__ import annotations

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import madsim_tpu_torch
from madsim_tpu_torch import time as sim_time
from madsim_tpu_torch.net import Endpoint, NetSim, Request
from madsim_tpu_torch.plugin import simulator
from madsim_tpu_torch.runtime import Handle, Runtime
from madsim_tpu_torch.task import spawn

FOLLOWER, CANDIDATE, LEADER = "follower", "candidate", "leader"


class RequestVote(Request):
    def __init__(self, term, candidate, last_idx, last_term):
        self.term = term
        self.candidate = candidate
        self.last_idx = last_idx
        self.last_term = last_term


class AppendEntries(Request):
    def __init__(self, term, leader, prev_idx, prev_term, entries, commit):
        self.term = term
        self.leader = leader
        self.prev_idx = prev_idx
        self.prev_term = prev_term
        self.entries = entries  # list of (term, value)
        self.commit = commit


class RaftNode:
    """One Raft peer as ordinary async code."""

    def __init__(self, me: int, peers: list, state: dict):
        self.me = me
        self.peers = peers  # ip:port of every node (incl. self)
        self.state = state  # shared dict: harness observations + stable storage
        # stable storage survives kill/restart (Raft §5.1); the node re-reads
        # it on every (re)boot, like the reference's fs-backed persistence
        stable = state.setdefault("stable", {}).setdefault(
            me, {"term": 0, "voted_for": None, "log": [(0, None)]}
        )
        self.term = stable["term"]
        self.voted_for = stable["voted_for"]
        self.log = list(stable["log"])
        self.commit = 0
        self.role = FOLLOWER
        self.election_deadline = 0.0
        self.next_idx = {p: len(self.log) for p in range(len(peers))}

    def persist(self):
        self.state["stable"][self.me] = {
            "term": self.term,
            "voted_for": self.voted_for,
            "log": list(self.log),
        }

    def rng(self):
        return madsim_tpu_torch.rand.thread_rng()

    def reset_election_timer(self):
        self.election_deadline = sim_time.now() + 0.15 + self.rng().random() * 0.15

    def become_follower(self, term):
        if term > self.term:
            self.term = term
            self.voted_for = None
            self.persist()
        self.role = FOLLOWER

    async def run(self):
        ep = await Endpoint.bind(f"0.0.0.0:{5000 + self.me}")
        ep.add_rpc_handler(RequestVote, self.on_request_vote)
        ep.add_rpc_handler(AppendEntries, self.on_append_entries)
        self.reset_election_timer()
        spawn(self.ticker(ep))
        await sim_time.sleep(1e9)

    async def ticker(self, ep):
        """Event-driven: a leader beats on a fixed cadence; everyone else
        sleeps exactly until the election deadline (handlers move the
        deadline; waking at a stale one just re-sleeps) — no 20 ms
        polling, ~7x fewer timer events per simulated second."""
        while True:
            if self.role == LEADER:
                await self.heartbeat(ep)
                await sim_time.sleep(0.05)
                continue
            delta = self.election_deadline - sim_time.now()
            if delta > 1e-6:  # float dust would arm a zero-delay timer spin
                await sim_time.sleep(delta)
                continue
            await self.campaign(ep)

    async def campaign(self, ep):
        self.term += 1
        self.role = CANDIDATE
        self.voted_for = self.me
        self.persist()
        self.reset_election_timer()
        votes = 1
        term = self.term
        last_idx = len(self.log) - 1
        req = RequestVote(term, self.me, last_idx, self.log[last_idx][0])
        for peer_id, addr in enumerate(self.peers):
            if peer_id == self.me:
                continue
            try:
                rsp = await ep.call_timeout(addr, req, 0.05)
            except TimeoutError:
                continue
            if rsp["term"] > self.term:
                self.become_follower(rsp["term"])
                return
            if rsp["granted"]:
                votes += 1
        if self.role == CANDIDATE and self.term == term and votes > len(self.peers) // 2:
            self.role = LEADER
            self.next_idx = {p: len(self.log) for p in range(len(self.peers))}
            self.state.setdefault("leaders_by_term", {}).setdefault(term, set()).add(self.me)
            # client load model: the leader appends an entry per term
            self.log.append((self.term, f"op-t{self.term}"))
            self.persist()

    async def heartbeat(self, ep):
        acks = 1
        term = self.term
        for peer_id, addr in enumerate(self.peers):
            if peer_id == self.me:
                continue
            # per-peer nextIndex with backoff, so lagging/restarted
            # followers catch up from wherever their log diverged
            prev = min(self.next_idx.get(peer_id, len(self.log)), len(self.log)) - 1
            prev = max(prev, 0)
            req = AppendEntries(
                self.term, self.me, prev, self.log[prev][0], self.log[prev + 1 :], self.commit
            )
            try:
                rsp = await ep.call_timeout(addr, req, 0.05)
            except TimeoutError:
                continue
            if rsp["term"] > self.term:
                self.become_follower(rsp["term"])
                return
            if rsp["ok"]:
                acks += 1
                self.next_idx[peer_id] = len(self.log)
            else:
                self.next_idx[peer_id] = max(1, self.next_idx.get(peer_id, 1) - 1)
        # an on_append_entries during the awaited ack loop can depose us;
        # a deposed/newer-term node must not record these acks as a commit
        if self.role != LEADER or self.term != term:
            return
        if acks > len(self.peers) // 2:
            self.commit = len(self.log) - 1
            self.state["max_commit"] = max(self.state.get("max_commit", 0), self.commit)
            self.state.setdefault("commits", {})[self.me] = self.commit

    async def on_request_vote(self, req: RequestVote, data):
        if req.term > self.term:
            self.become_follower(req.term)
        my_last = len(self.log) - 1
        log_ok = (req.last_term, req.last_idx) >= (self.log[my_last][0], my_last)
        granted = (
            req.term == self.term
            and self.voted_for in (None, req.candidate)
            and log_ok
        )
        if granted:
            self.voted_for = req.candidate
            self.persist()
            self.reset_election_timer()
        return {"term": self.term, "granted": granted}

    async def on_append_entries(self, req: AppendEntries, data):
        if req.term < self.term:
            return {"term": self.term, "ok": False}
        self.become_follower(req.term)
        self.reset_election_timer()
        if req.prev_idx >= len(self.log) or self.log[req.prev_idx][0] != req.prev_term:
            return {"term": self.term, "ok": False}
        if req.entries:
            self.log = self.log[: req.prev_idx + 1] + list(req.entries)
            self.persist()
        self.commit = min(req.commit, len(self.log) - 1)
        self.state.setdefault("commits", {})[self.me] = max(
            self.state.setdefault("commits", {}).get(self.me, 0), self.commit
        )
        return {"term": self.term, "ok": True}


async def scenario(n=5, horizon=3.0):
    handle = Handle.current()
    net = simulator(NetSim)
    rng = madsim_tpu_torch.rand.thread_rng()
    state: dict = {}
    peers = [f"10.2.0.{i+1}:{5000+i}" for i in range(n)]
    nodes = []
    for i in range(n):
        node = (
            handle.create_node()
            .name(f"raft-{i}")
            .ip(f"10.2.0.{i+1}")
            .init(lambda i=i: RaftNode(i, peers, state).run())
            .build()
        )
        nodes.append(node)

    # chaos: a random partition + a random kill/restart inside the horizon
    async def chaos():
        await sim_time.sleep(rng.random() * horizon / 2)
        a = rng.gen_range(0, n)
        b = (a + 1 + rng.gen_range(0, n - 1)) % n
        net.partition([nodes[a].id], [nodes[b].id])
        await sim_time.sleep(rng.random() * horizon / 4)
        net.heal([nodes[a].id], [nodes[b].id])
        victim = rng.gen_range(0, n)
        handle.kill(nodes[victim].id)
        await sim_time.sleep(0.2)
        handle.restart(nodes[victim].id)

    spawn(chaos())
    await sim_time.sleep(horizon)

    # safety: at most one leader per term
    for term, leaders in state.get("leaders_by_term", {}).items():
        assert len(leaders) == 1, f"election safety violated in term {term}: {leaders}"
    return {
        "terms_with_leader": len(state.get("leaders_by_term", {})),
        "max_commit": state.get("max_commit", 0),
    }


def main():
    num_seeds = int(sys.argv[1]) if len(sys.argv) > 1 else 20
    t0 = time.perf_counter()
    elected = 0
    for seed in range(num_seeds):
        result = Runtime(seed=seed).block_on(scenario())
        elected += 1 if result["terms_with_leader"] > 0 else 0
    dt = time.perf_counter() - t0
    print(
        f"{num_seeds} seeds in {dt:.2f}s -> {num_seeds / dt:.1f} seeds/sec (host engine); "
        f"{elected}/{num_seeds} seeds elected a leader"
    )


if __name__ == "__main__":
    main()
