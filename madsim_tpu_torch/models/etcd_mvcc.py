"""The MVCC etcd machine (revisions, txns, leases) as a lane-batched
Machine.

The port of `madsim_tpu/models/etcd_mvcc.py`. Node 0 is the MVCC server
(a fixed key table, the revision counter, lease slots); nodes 1..N-1 are
clients, each running a seed-drawn program of put / delete / txn on a
key pair / lease grant / leased put / keepalive, with at-least-once
retry and a monotone per-client request sequence the server dedups on.

Every handler runs on the whole batch at once: `[L, N, ...]` node
tensors and `[L]` node indices. A client handler reads and writes its
own row (`node_row` / `write_row`); the server's state is row 0, read
once as a row dict, swept, applied and written back, and the per-lane
choice among "applied", "swept only" and "untouched" is a select.

Invariants (fail codes):
  * REV_SKEW (201): revision != 1 + mutations applied;
  * TXN_ATOMICITY (202): the txn key pair diverged;
  * LEASE_EARLY (203): the sweep expired a lease before its true expiry;
  * DUP_APPLY (204): more puts applied to a client's key than it issued;
  * MVCC_ORDER (205): a live key's create/mod revision order broke;
  * ABANDONED_WRITE (206): an op its client reported FAILED applied.

Bug variants (class flags): `NO_DEDUP` (retransmits double-apply),
`KEEPALIVE_NO_EXTEND` (keepalive does not move the expiry the sweep
reads) and `PREMATURE_GIVEUP` (a deadline-RPC client gives up after
GIVEUP_US against a token-dedup server, so a late request applies after
its failure was reported; only the delay-spike fault kind delivers it
late enough).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from ..engine.machine import Machine, Outbox, make_payload, node_row, send_if, set_at, set_timer_if, write_row
from ..utils import take, tree_where

SERVER = 0

# message types
M_REQ = 1
M_ACK = 2

# op kinds (client programs draw uniformly)
OP_PUT = 0
OP_DEL = 1
OP_TXN = 2
OP_GRANT = 3
OP_PUT_LEASED = 4
OP_KA = 5
N_OPS = 6

# fail codes
REV_SKEW = 201
TXN_ATOMICITY = 202
LEASE_EARLY = 203
DUP_APPLY = 204
MVCC_ORDER = 205
ABANDONED_WRITE = 206

RETRY_US = 100_000  # client retry / op-issue tick
GIVEUP_US = 300_000  # PREMATURE_GIVEUP: report failure after this
TTL_MIN_US = 300_000  # granted lease TTLs
TTL_SPAN_US = 500_000
GIVEUP_DONE_US = 7_000_000  # PREMATURE_GIVEUP lanes stay open this long

# ack statuses
ST_OK = 0
ST_ERR = 1

# the server's fields: row 0 of each
_SERVER_FIELDS = ("rev", "applied", "val", "ver", "mod_rev", "create_rev", "key_lease", "puts_applied",
                  "lease_used", "lease_real", "lease_ttl", "last_req", "early_expiry", "dirty_abandoned")


@dataclasses.dataclass
class MvccState:
    # server row 0 (durable)
    rev: torch.Tensor  # int32[L, N] MVCC revision (init 1)
    applied: torch.Tensor  # int32[L, N] mutations applied (ghost)
    val: torch.Tensor  # int32[L, N, K]
    ver: torch.Tensor  # int32[L, N, K] version; 0 = absent
    mod_rev: torch.Tensor  # int32[L, N, K]
    create_rev: torch.Tensor  # int32[L, N, K]
    key_lease: torch.Tensor  # int32[L, N, K] lease slot + 1; 0 = none
    puts_applied: torch.Tensor  # int32[L, N, K] ghost: puts applied per key
    lease_used: torch.Tensor  # int32[L, N, C] expiry the sweep reads; -1 = invalid
    lease_real: torch.Tensor  # int32[L, N, C] ghost: true refresh-based expiry
    lease_ttl: torch.Tensor  # int32[L, N, C] granted TTL
    last_req: torch.Tensor  # int32[L, N, C] dedup: highest applied seq per client
    early_expiry: torch.Tensor  # bool[L, N] ghost: the sweep fired early
    # client rows 1.. (durable journal)
    seq: torch.Tensor  # int32[L, N] current op seq (0 = none issued)
    acked: torch.Tensor  # int32[L, N] highest acked seq
    opk: torch.Tensor  # int32[L, N] current op kind
    oparg: torch.Tensor  # int32[L, N] current op arg (TTL of a grant)
    issued_at: torch.Tensor  # int32[L, N] when the op in flight was issued
    abandoned_seq: torch.Tensor  # int32[L, N] ghost: highest seq reported FAILED
    dirty_abandoned: torch.Tensor  # bool[L, N] ghost (server row): an abandoned op applied
    applied_bits: torch.Tensor  # int32[L, N, 4] the server's token bitmap, row = client
    puts_sent: torch.Tensor  # int32[L, N, K] ghost: put ops issued per key
    epoch: torch.Tensor  # int32[L, N] timer epoch


class EtcdMvccMachine(Machine):
    """1 MVCC server + (N-1) clients; K = (N-1) client keys + a txn pair."""

    PAYLOAD_WIDTH = 5
    MAX_MSGS = 1
    MAX_TIMERS = 1
    state_type = MvccState

    NO_DEDUP = False
    KEEPALIVE_NO_EXTEND = False
    PREMATURE_GIVEUP = False

    def __init__(self, num_nodes: int = 4, target_ops: int = 6):
        self.NUM_NODES = num_nodes
        self.n_clients = num_nodes - 1
        self.K = self.n_clients + 2  # per-client keys + the txn pair
        self.n_leases = self.n_clients  # one lease slot per client
        self.target_ops = target_ops

    def init(self, rng_key) -> MvccState:
        lanes, n, k, c = rng_key.shape[0], self.NUM_NODES, self.K, self.n_leases
        kw = {"dtype": torch.int32, "device": rng_key.device}
        zn = torch.zeros((lanes, n), **kw)
        zk = torch.zeros((lanes, n, k), **kw)
        zl = torch.zeros((lanes, n, c), **kw)
        fn = torch.zeros((lanes, n), dtype=torch.bool, device=rng_key.device)
        return MvccState(
            rev=zn + 1, applied=zn, val=zk, ver=zk, mod_rev=zk, create_rev=zk, key_lease=zk,
            puts_applied=zk, lease_used=zl - 1, lease_real=zl - 1, lease_ttl=zl, last_req=zl,
            early_expiry=fn, seq=zn, acked=zn, opk=zn, oparg=zn, issued_at=zn, abandoned_seq=zn,
            dirty_abandoned=fn, applied_bits=torch.zeros((lanes, n, 4), **kw), puts_sent=zk, epoch=zn,
        )

    def restart_if(self, nodes: MvccState, i, cond, rng_key) -> MvccState:
        """Everything is durable (a raft-backed store, journaled client
        programs): a restart only re-fires BOOT."""
        return nodes

    # -- timers (clients only) -------------------------------------------------

    def on_timer(self, nodes: MvccState, node, timer_id, now_us, rand_u32) -> Tuple[MvccState, Outbox]:
        r = node_row(nodes, node)
        outbox = self.empty_outbox(node.shape[0], node.device)
        is_boot = timer_id == 0
        t_epoch = torch.div(timer_id - 1, 2, rounding_mode="floor")
        live = is_boot | (t_epoch == r["epoch"])
        is_client = node != SERVER
        r["epoch"] = torch.where(is_boot & live, r["epoch"] + 1, r["epoch"])

        done_c = r["acked"] >= self.target_ops
        act = live & is_client & ~done_c
        # PREMATURE_GIVEUP: after GIVEUP_US without an ack the client
        # reports the op FAILED and moves on; the ghost keeps its seq
        give_up = act & (r["seq"] > r["acked"]) & (now_us - r["issued_at"] >= GIVEUP_US)
        give_up = give_up & self.PREMATURE_GIVEUP
        r["abandoned_seq"] = torch.where(give_up, r["seq"], r["abandoned_seq"])

        # issue the next op once the current one is acked (or abandoned)
        need_new = act & ((r["acked"] == r["seq"]) | give_up)
        kind = (rand_u32[:, 0] % N_OPS).to(torch.int32)
        ttl = TTL_MIN_US + (rand_u32[:, 1] % TTL_SPAN_US).to(torch.int32)
        r["seq"] = torch.where(need_new, r["seq"] + 1, r["seq"])
        r["opk"] = torch.where(need_new, kind, r["opk"])
        r["oparg"] = torch.where(need_new, ttl, r["oparg"])
        own_key = node - 1
        is_put_kind = (r["opk"] == OP_PUT) | (r["opk"] == OP_PUT_LEASED)
        r["puts_sent"] = set_at(r["puts_sent"], own_key, take(r["puts_sent"], own_key) + 1, need_new & is_put_kind)
        r["issued_at"] = torch.where(need_new, now_us, r["issued_at"])

        # (re)send the op in flight; re-arm the retry chain. The deadline-RPC
        # client of PREMATURE_GIVEUP sends each op once, at issue
        send = act & (r["seq"] > r["acked"])
        if self.PREMATURE_GIVEUP:
            send = send & need_new
        outbox = send_if(outbox, 0, send, SERVER,
                         make_payload(self.PAYLOAD_WIDTH, M_REQ, r["seq"], r["opk"], r["oparg"]))
        jitter = (rand_u32[:, 2] % (RETRY_US // 4)).to(torch.int32)
        delay = torch.where(is_boot, jitter, RETRY_US + jitter)
        outbox = set_timer_if(outbox, 0, live & is_client & ~done_c, delay, 1 + 2 * r["epoch"])
        return write_row(nodes, node, r), outbox

    # -- server ----------------------------------------------------------------

    def _sweep(self, s: dict, now_us) -> dict:
        """The lazy lease-expiry sweep on the server row `s` (a dict of
        row-0 fields): invalidate expired leases and tombstone their keys,
        one revision bump a key. Firing before `lease_real` is the
        LEASE_EARLY bug."""
        now = now_us[:, None]
        expired = (s["lease_used"] >= 0) & (s["lease_used"] < now)
        early = expired & (s["lease_real"] > now)
        lease_of_key = s["key_lease"]
        safe_slot = (lease_of_key - 1).clamp(0, self.n_leases - 1).to(torch.int64)
        kill = (s["ver"] > 0) & (lease_of_key > 0) & expired.gather(1, safe_slot)
        n_del = kill.sum(dim=1, dtype=torch.int32)
        new_rev = s["rev"] + n_del
        return dict(
            s,
            rev=new_rev,
            applied=s["applied"] + n_del,
            ver=torch.where(kill, 0, s["ver"]),
            val=torch.where(kill, 0, s["val"]),
            key_lease=torch.where(kill, 0, s["key_lease"]),
            mod_rev=torch.where(kill, new_rev[:, None], s["mod_rev"]),
            lease_used=torch.where(expired, -1, s["lease_used"]),
            lease_real=torch.where(expired, -1, s["lease_real"]),
            early_expiry=s["early_expiry"] | early.any(dim=1),
        )

    def _apply(self, s: dict, c, seq, kind, arg, now_us) -> Tuple[dict, torch.Tensor]:
        """Apply one deduped op of client c to the server row. Returns
        (row, status)."""
        k = self.K
        ks = torch.arange(k, device=c.device)
        own = ks == (c - 1)[:, None]
        p0, p1 = ks == k - 2, ks == k - 1
        slot = c - 1  # the client's lease slot
        lease_ok = take(s["lease_used"], slot) >= 0
        rev0, ver = s["rev"], s["ver"]
        live = ver > 0

        # which keys the op writes, and with what
        is_put, is_del, is_txn = kind == OP_PUT, kind == OP_DEL, kind == OP_TXN
        is_pl = (kind == OP_PUT_LEASED) & lease_ok
        txn_then = torch.remainder(ver[:, k - 2], 2) == 0
        txn_val = torch.where(txn_then, seq, -seq)
        col = lambda x: x[:, None]  # noqa: E731
        put_mask = own & col(is_put | is_pl)
        del_mask = own & col(is_del) & live
        txn_mask = (p0 | p1) & col(is_txn)
        # revision bumps: put 1, effective delete 1, txn 2 (sequential puts)
        bump_at = torch.where(put_mask | del_mask, 1, torch.where(txn_mask, torch.where(p0, 1, 2), 0))
        n_mut = (put_mask.sum(dim=1, dtype=torch.int32) + del_mask.sum(dim=1, dtype=torch.int32)
                 + 2 * is_txn.to(torch.int32))
        key_rev = col(rev0) + bump_at.to(torch.int32)
        wm = put_mask | txn_mask
        new_val = torch.where(txn_mask, col(txn_val), col(seq))
        s = dict(
            s,
            val=torch.where(wm, new_val, torch.where(del_mask, 0, s["val"])),
            ver=torch.where(wm, ver + 1, torch.where(del_mask, 0, ver)),
            mod_rev=torch.where(wm | del_mask, key_rev, s["mod_rev"]),
            create_rev=torch.where(wm & ~live, key_rev, s["create_rev"]),
            key_lease=torch.where(wm, torch.where(own & col(is_pl), col(slot + 1), 0),
                                  torch.where(del_mask, 0, s["key_lease"])),
            puts_applied=torch.where(wm, s["puts_applied"] + 1, s["puts_applied"]),
            rev=rev0 + n_mut,
            applied=s["applied"] + n_mut,
        )

        # lease ops
        is_grant = kind == OP_GRANT
        is_ka = (kind == OP_KA) & lease_ok
        ls = torch.arange(self.n_leases, device=c.device) == col(slot)
        expire = now_us + torch.where(is_grant, arg, take(s["lease_ttl"], slot))
        set_used = is_grant | (is_ka & (not self.KEEPALIVE_NO_EXTEND))
        set_real = is_grant | is_ka
        s["lease_used"] = torch.where(ls & col(set_used), col(expire), s["lease_used"])
        s["lease_real"] = torch.where(ls & col(set_real), col(expire), s["lease_real"])
        s["lease_ttl"] = torch.where(ls & col(is_grant), col(arg), s["lease_ttl"])
        err = ((kind == OP_PUT_LEASED) | (kind == OP_KA)) & ~lease_ok
        return s, torch.where(err, ST_ERR, ST_OK).to(torch.int32)

    # -- messages --------------------------------------------------------------

    def on_message(self, nodes: MvccState, node, src, payload, now_us, rand_u32) -> Tuple[MvccState, Outbox]:
        outbox = self.empty_outbox(node.shape[0], node.device)
        mtype, seq = payload[:, 0], payload[:, 1]
        n = self.NUM_NODES
        col = lambda x: x[:, None]  # noqa: E731

        # ---- server: REQ -------------------------------------------------
        is_req = (node == SERVER) & (mtype == M_REQ)
        old = {f: getattr(nodes, f)[:, SERVER] for f in _SERVER_FIELDS}
        swept = self._sweep(old, now_us)
        slot = (src - 1).clamp(0, self.n_leases - 1)
        if self.PREMATURE_GIVEUP:
            # a token-dedup server: a late DISTINCT seq still applies, and a
            # seq past the 128-token window is never a duplicate
            in_window = seq < 128
            word = torch.div(seq, 32, rounding_mode="floor").clamp(0, 3)
            bit = torch.bitwise_left_shift(torch.ones_like(seq), torch.remainder(seq, 32).clamp(0, 31))
            is_dup = in_window & ((take(take(nodes.applied_bits, src), word) & bit) != 0)
        elif self.NO_DEDUP:
            is_dup = torch.zeros_like(is_req)
        else:
            is_dup = seq <= take(swept["last_req"], slot)
        applied, status = self._apply(swept, src, seq, payload[:, 2], payload[:, 3], now_us)
        applied["last_req"] = set_at(applied["last_req"], slot, torch.maximum(take(applied["last_req"], slot), seq))
        # ghost: applying an op its client already reported FAILED is the
        # PREMATURE_GIVEUP breach, reachable only by a late delivery
        late_abandoned = seq <= take(nodes.abandoned_seq, src)
        applied["dirty_abandoned"] = applied["dirty_abandoned"] | late_abandoned
        swept["last_req"] = applied["last_req"]
        do_apply = is_req & ~is_dup
        nodes = write_row(nodes, torch.zeros_like(node), tree_where(do_apply, applied, tree_where(is_req, swept, old)))
        if self.PREMATURE_GIVEUP:
            token = ((torch.arange(n, device=node.device) == col(src))[:, :, None]
                     & (torch.arange(4, device=node.device) == col(word))[:, None, :]
                     & in_window[:, None, None] & do_apply[:, None, None])
            nodes = dataclasses.replace(
                nodes, applied_bits=torch.where(token, nodes.applied_bits | bit[:, None, None], nodes.applied_bits))
        ack = make_payload(self.PAYLOAD_WIDTH, M_ACK, seq, torch.where(is_dup, ST_OK, status), nodes.rev[:, SERVER])
        outbox = send_if(outbox, 0, is_req, src, ack)

        # ---- client: ACK -------------------------------------------------
        is_ack = (node != SERVER) & (mtype == M_ACK)
        acked, my_seq = take(nodes.acked, node), take(nodes.seq, node)
        acked = torch.where(is_ack, torch.maximum(acked, torch.minimum(seq, my_seq)), acked)
        return dataclasses.replace(nodes, acked=set_at(nodes.acked, node, acked)), outbox

    # -- invariants / results --------------------------------------------------

    def invariant(self, nodes: MvccState, now_us):
        k, nc = self.K, self.n_clients
        rev = nodes.rev[:, SERVER]
        rev_skew = rev != 1 + nodes.applied[:, SERVER]
        val, ver = nodes.val[:, SERVER], nodes.ver[:, SERVER]
        txn_div = (val[:, k - 2] != val[:, k - 1]) | (ver[:, k - 2] != ver[:, k - 1])
        early = nodes.early_expiry[:, SERVER]
        ck = torch.arange(nc, device=rev.device)
        sent = nodes.puts_sent[:, ck + 1, ck]
        dup = (nodes.puts_applied[:, SERVER, :nc] > sent).any(dim=1)
        mod, create = nodes.mod_rev[:, SERVER], nodes.create_rev[:, SERVER]
        order = ((ver > 0) & ((mod > rev[:, None]) | (create > mod) | (mod < 1))).any(dim=1)
        dirty = nodes.dirty_abandoned[:, SERVER]
        ok = ~(rev_skew | txn_div | early | dup | order | dirty)
        code = torch.where(rev_skew, REV_SKEW, torch.where(txn_div, TXN_ATOMICITY, torch.where(
            early, LEASE_EARLY, torch.where(dup, DUP_APPLY, torch.where(
                order, MVCC_ORDER, torch.where(dirty, ABANDONED_WRITE, 0))))))
        return ok, code.to(torch.int32)

    def is_done(self, nodes: MvccState, now_us):
        base = (nodes.acked[:, 1:] >= self.target_ops).all(dim=1)
        if self.PREMATURE_GIVEUP:
            # an abandoned request may still be in flight (spiked up to
            # 5 s): the lane stays open so its late arrival is seen
            return base & (now_us >= GIVEUP_DONE_US)
        return base

    def summary(self, nodes: MvccState):
        return {
            "revision": nodes.rev[:, SERVER],
            "applied": nodes.applied[:, SERVER],
            "ops_acked": nodes.acked[:, 1:].sum(dim=1, dtype=torch.int32),
        }


class NoDedupMvcc(EtcdMvccMachine):
    NO_DEDUP = True  # retransmits double-apply (needs storms or dir clogs)


class PrematureGiveupMvcc(EtcdMvccMachine):
    PREMATURE_GIVEUP = True  # deadline-RPC timeout mishandling (the delay kind's find)
