"""The S3 object-store machine (multipart uploads and lifecycle) as a
lane-batched Machine.

The port of `madsim_tpu/models/s3.py`. Node 0 is the S3 server; nodes
1..N-1 are clients, each working a seed-drawn program against its own
object key (put / delete / create-multipart / upload-part / complete /
abort) with at-least-once retry and a monotone per-client request
sequence the server dedups on. The server also runs a lifecycle ticker:
objects expire OBJ_AGE_US after their last write and multipart sessions
abort MPU_AGE_US after creation, swept on every server event.

Every handler runs on the whole batch at once: `[L, N, ...]` node
tensors and `[L]` node indices. A client handler reads and writes its
own row; the server's state is row 0, read once as a row dict.

Invariants (fail codes):
  * MPU_CONCAT (211): a live object's content differs from the ghost's
    (the parts uploaded, folded in part-number order);
  * MPU_ORPHAN (212): parts stored with no session open;
  * LC_EARLY (213): lifecycle expired an object before its age;
  * LC_PARTIAL (214): an absent object still holds content;
  * DUP_APPLY (215): more content writes applied than the client issued.

Bug variants (class flags): `CONCAT_ARRIVAL_ORDER`, `ABORT_KEEPS_PARTS`,
`LC_EARLY_HALF`, `LC_TOMBSTONE_LEAK` and `NO_DEDUP`, one per invariant,
in that order.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from ..engine.machine import Machine, Outbox, make_payload, node_row, send_if, set_at, set_timer_if, write_row
from ..utils import take, tree_where

SERVER = 0

M_REQ = 1
M_ACK = 2

# op kinds
OP_PUT = 0
OP_DEL = 1
OP_CREATE = 2
OP_PART = 3
OP_COMPLETE = 4
OP_ABORT = 5
N_OPS = 6
# the kind draw, weighted like a multipart workload: PART 3/8, others 1/8
KIND_TABLE = (OP_PUT, OP_DEL, OP_CREATE, OP_PART, OP_PART, OP_PART, OP_COMPLETE, OP_ABORT)

# fail codes
MPU_CONCAT = 211
MPU_ORPHAN = 212
LC_EARLY = 213
LC_PARTIAL = 214
DUP_APPLY = 215

RETRY_US = 100_000
OBJ_AGE_US = 2_500_000  # lifecycle object expiration
MPU_AGE_US = 1_500_000  # lifecycle abort of an incomplete multipart session
LC_TICK_US = 500_000  # the server's lifecycle ticker
OBSERVE_US = 4_000_000  # lanes watch the lifecycle phase before they are done

ST_OK = 0
ST_ERR = 1

# the server's fields: row 0 of each
_SERVER_FIELDS = ("obj_ver", "obj_val", "obj_expected", "obj_mtime", "mpu_active", "mpu_created", "mpu_mask",
                  "part_val", "part_arr", "mpu_arrcnt", "last_req", "writes_applied", "lc_early")


@dataclasses.dataclass
class S3State:
    # server row 0 (durable object store)
    obj_ver: torch.Tensor  # int32[L, N, K] write counter; 0 = absent
    obj_val: torch.Tensor  # int32[L, N, K] content fold the server built
    obj_expected: torch.Tensor  # int32[L, N, K] ghost: the honest content
    obj_mtime: torch.Tensor  # int32[L, N, K] last modified (us)
    mpu_active: torch.Tensor  # int32[L, N, K] 1 = session open
    mpu_created: torch.Tensor  # int32[L, N, K] session creation time
    mpu_mask: torch.Tensor  # int32[L, N, K] bitmask of uploaded part numbers
    part_val: torch.Tensor  # int32[L, N, K, P] part contents
    part_arr: torch.Tensor  # int32[L, N, K, P] arrival order of each part
    mpu_arrcnt: torch.Tensor  # int32[L, N, K] arrival counter
    last_req: torch.Tensor  # int32[L, N, K] dedup: highest applied seq per client
    writes_applied: torch.Tensor  # int32[L, N, K] ghost: content writes applied
    lc_early: torch.Tensor  # bool[L, N] ghost: the sweep fired early
    # client rows 1.. (durable journal)
    seq: torch.Tensor  # int32[L, N]
    acked: torch.Tensor  # int32[L, N]
    opk: torch.Tensor  # int32[L, N]
    oparg: torch.Tensor  # int32[L, N]
    writes_sent: torch.Tensor  # int32[L, N, K] ghost: put / complete ops issued
    epoch: torch.Tensor  # int32[L, N]


class S3Machine(Machine):
    """1 S3 server + (N-1) clients, one object key per client."""

    PAYLOAD_WIDTH = 5
    MAX_MSGS = 1
    MAX_TIMERS = 1
    P = 4  # part slots per multipart session
    state_type = S3State

    CONCAT_ARRIVAL_ORDER = False
    ABORT_KEEPS_PARTS = False
    LC_EARLY_HALF = False
    LC_TOMBSTONE_LEAK = False
    NO_DEDUP = False

    def __init__(self, num_nodes: int = 4, target_ops: int = 6):
        self.NUM_NODES = num_nodes
        self.n_clients = num_nodes - 1
        self.K = self.n_clients
        self.target_ops = target_ops

    def init(self, rng_key) -> S3State:
        lanes, n, k, p = rng_key.shape[0], self.NUM_NODES, self.K, self.P
        kw = {"dtype": torch.int32, "device": rng_key.device}
        zn = torch.zeros((lanes, n), **kw)
        zk = torch.zeros((lanes, n, k), **kw)
        zp = torch.zeros((lanes, n, k, p), **kw)
        return S3State(
            obj_ver=zk, obj_val=zk, obj_expected=zk, obj_mtime=zk, mpu_active=zk, mpu_created=zk, mpu_mask=zk,
            part_val=zp, part_arr=zp, mpu_arrcnt=zk, last_req=zk, writes_applied=zk,
            lc_early=torch.zeros((lanes, n), dtype=torch.bool, device=rng_key.device),
            seq=zn, acked=zn, opk=zn, oparg=zn, writes_sent=zk, epoch=zn,
        )

    def restart_if(self, nodes: S3State, i, cond, rng_key) -> S3State:
        """Durable on both sides: a restart only re-fires BOOT."""
        return nodes

    # -- timers ------------------------------------------------------------------

    def on_timer(self, nodes: S3State, node, timer_id, now_us, rand_u32) -> Tuple[S3State, Outbox]:
        outbox = self.empty_outbox(node.shape[0], node.device)
        is_boot = timer_id == 0
        t_epoch = torch.div(timer_id - 1, 2, rounding_mode="floor")
        epoch = take(nodes.epoch, node)
        live = is_boot | (t_epoch == epoch)
        is_client, is_server = node != SERVER, node == SERVER
        epoch = torch.where(is_boot & live, epoch + 1, epoch)
        nodes = dataclasses.replace(nodes, epoch=set_at(nodes.epoch, node, epoch))

        # server: the lifecycle ticker sweeps and re-arms
        old = {f: getattr(nodes, f)[:, SERVER] for f in _SERVER_FIELDS}
        tick = live & is_server & ~is_boot
        nodes = write_row(nodes, torch.zeros_like(node), tree_where(tick, self._sweep(old, now_us), old))
        r = node_row(nodes, node)
        tid = 1 + 2 * r["epoch"]
        outbox = set_timer_if(outbox, 0, live & is_server, LC_TICK_US, tid)

        done_c = r["acked"] >= self.target_ops
        act = live & is_client & ~done_c
        # issue the next op once the current one is acked
        need_new = act & (r["acked"] == r["seq"])
        draw = (rand_u32[:, 0] % len(KIND_TABLE)).to(torch.int32)  # KIND_TABLE[draw], without a table copy
        kind = torch.where(draw < OP_PART, draw, torch.where(draw < OP_PART + 3, OP_PART, draw - 2))
        part_ix = (rand_u32[:, 1] % self.P).to(torch.int32)
        r["seq"] = torch.where(need_new, r["seq"] + 1, r["seq"])
        r["opk"] = torch.where(need_new, kind, r["opk"])
        r["oparg"] = torch.where(need_new, part_ix, r["oparg"])
        own_key = node - 1
        is_write_kind = (r["opk"] == OP_PUT) | (r["opk"] == OP_COMPLETE)
        r["writes_sent"] = set_at(r["writes_sent"], own_key, take(r["writes_sent"], own_key) + 1,
                                  need_new & is_write_kind)

        # (re)send the op in flight; re-arm the retry chain
        send = act & (r["seq"] > r["acked"])
        outbox = send_if(outbox, 0, send, SERVER,
                         make_payload(self.PAYLOAD_WIDTH, M_REQ, r["seq"], r["opk"], r["oparg"]))
        jitter = (rand_u32[:, 2] % (RETRY_US // 4)).to(torch.int32)
        delay = torch.where(is_boot, jitter, RETRY_US + jitter)
        outbox = set_timer_if(outbox, 0, live & is_client & ~done_c, delay, tid)
        r = {k: r[k] for k in ("seq", "opk", "oparg", "writes_sent")}
        return write_row(nodes, node, r), outbox

    # -- server ------------------------------------------------------------------

    def _fold_parts(self, vals, mask_bits, order):
        """h = h * 31 + val over the present parts in `order` ([L, P]);
        an absent part takes no fold step."""
        h = torch.zeros_like(mask_bits)
        for r in range(self.P):
            ix = order[:, r]
            present = ((mask_bits >> ix) & 1) > 0
            h = torch.where(present, h * 31 + take(vals, ix), h)
        return h

    def _sweep(self, s: dict, now_us) -> dict:
        """The lifecycle sweep on the server row: expire old objects,
        abort stale sessions. Expiring before last_modified + OBJ_AGE_US
        is the LC_EARLY bug."""
        age = OBJ_AGE_US // 2 if self.LC_EARLY_HALF else OBJ_AGE_US
        now = now_us[:, None]
        mtime = s["obj_mtime"]
        expire = (s["obj_ver"] > 0) & (now >= mtime + age)
        early = expire & (now < mtime + OBJ_AGE_US)
        stale = (s["mpu_active"] > 0) & (now >= s["mpu_created"] + MPU_AGE_US)
        return dict(
            s,
            obj_ver=torch.where(expire, 0, s["obj_ver"]),
            obj_val=s["obj_val"] if self.LC_TOMBSTONE_LEAK else torch.where(expire, 0, s["obj_val"]),
            obj_expected=torch.where(expire, 0, s["obj_expected"]),
            mpu_active=torch.where(stale, 0, s["mpu_active"]),
            mpu_mask=torch.where(stale, 0, s["mpu_mask"]),
            part_val=torch.where(stale[:, :, None], 0, s["part_val"]),
            part_arr=torch.where(stale[:, :, None], 0, s["part_arr"]),
            lc_early=s["lc_early"] | early.any(dim=1),
        )

    def _apply(self, s: dict, c, seq, kind, arg, now_us) -> Tuple[dict, torch.Tensor]:
        """Apply one deduped op of client c to the server row."""
        p = self.P
        key = (c - 1).clamp(0, self.K - 1)
        km = torch.arange(self.K, device=c.device) == key[:, None]
        active = take(s["mpu_active"], key) > 0
        mask_bits = take(s["mpu_mask"], key)

        is_put, is_del, is_create = kind == OP_PUT, kind == OP_DEL, kind == OP_CREATE
        is_part = (kind == OP_PART) & active
        is_complete = (kind == OP_COMPLETE) & active & (mask_bits != 0)
        is_abort = (kind == OP_ABORT) & active
        err = (((kind == OP_PART) & ~active) | ((kind == OP_COMPLETE) & (~active | (mask_bits == 0)))
               | ((kind == OP_ABORT) & ~active))

        # a completed object's content: the parts in part-number order; the
        # ghost is always that fold, the buggy variant folds in arrival
        # order (absent parts sort last; a stable sort keeps ties in slot
        # order, as the reference's)
        vals, arrs = take(s["part_val"], key), take(s["part_arr"], key)
        index_order = torch.arange(p, dtype=torch.int32, device=c.device)
        present = ((mask_bits[:, None] >> index_order) & 1) > 0
        honest = self._fold_parts(vals, mask_bits, index_order.expand(c.shape[0], p))
        if self.CONCAT_ARRIVAL_ORDER:
            arrival = torch.argsort(torch.where(present, arrs, 2**30), dim=1, stable=True).to(torch.int32)
            built = self._fold_parts(vals, mask_bits, arrival)
        else:
            built = honest

        # object writes: a put stores `seq`, a complete the fold
        writes = is_put | is_complete
        s = dict(s)
        at = lambda f, v: torch.where(km, v[:, None], s[f])  # noqa: E731  (the client's key of the row)
        s["obj_ver"] = at("obj_ver", torch.where(writes, take(s["obj_ver"], key) + 1,
                                                 torch.where(is_del, 0, take(s["obj_ver"], key))))
        s["obj_val"] = at("obj_val", torch.where(writes, torch.where(is_put, seq, built),
                                                 torch.where(is_del, 0, take(s["obj_val"], key))))
        s["obj_expected"] = at("obj_expected", torch.where(writes, torch.where(is_put, seq, honest),
                                                           torch.where(is_del, 0, take(s["obj_expected"], key))))
        kw = km & writes[:, None]
        s["obj_mtime"] = torch.where(kw, now_us[:, None], s["obj_mtime"])
        s["writes_applied"] = torch.where(kw, s["writes_applied"] + 1, s["writes_applied"])

        # session lifecycle: create opens (a fresh session never sees old
        # parts), complete and abort close
        clears = is_create | is_complete | (is_abort & (not self.ABORT_KEEPS_PARTS))
        closes = is_complete | is_abort
        s["mpu_active"] = at("mpu_active", torch.where(is_create, 1, torch.where(closes, 0,
                                                                                 take(s["mpu_active"], key))))
        s["mpu_created"] = torch.where(km & is_create[:, None], now_us[:, None], s["mpu_created"])
        s["mpu_mask"] = torch.where(km & clears[:, None], 0, s["mpu_mask"])
        s["mpu_arrcnt"] = torch.where(km & is_create[:, None], 0, s["mpu_arrcnt"])
        part_clear = (km & clears[:, None])[:, :, None]
        s["part_val"] = torch.where(part_clear, 0, s["part_val"])
        s["part_arr"] = torch.where(part_clear, 0, s["part_arr"])

        # part upload: content `seq` at slot `arg`, stamped with its arrival
        slot = arg.clamp(0, p - 1)
        pm = (km & is_part[:, None])[:, :, None] & (torch.arange(p, device=c.device) == slot[:, None])[:, None, :]
        arrcnt = take(s["mpu_arrcnt"], key)
        s["part_val"] = torch.where(pm, seq[:, None, None], s["part_val"])
        s["part_arr"] = torch.where(pm, arrcnt[:, None, None], s["part_arr"])
        bit = torch.bitwise_left_shift(torch.ones_like(slot), slot)
        km_part = km & is_part[:, None]
        s["mpu_mask"] = torch.where(km_part, (take(s["mpu_mask"], key) | bit)[:, None], s["mpu_mask"])
        s["mpu_arrcnt"] = torch.where(km_part, (arrcnt + 1)[:, None], s["mpu_arrcnt"])
        return s, torch.where(err, ST_ERR, ST_OK).to(torch.int32)

    # -- messages ------------------------------------------------------------------

    def on_message(self, nodes: S3State, node, src, payload, now_us, rand_u32) -> Tuple[S3State, Outbox]:
        outbox = self.empty_outbox(node.shape[0], node.device)
        mtype, seq = payload[:, 0], payload[:, 1]

        # ---- server: REQ -------------------------------------------------
        is_req = (node == SERVER) & (mtype == M_REQ)
        old = {f: getattr(nodes, f)[:, SERVER] for f in _SERVER_FIELDS}
        swept = self._sweep(old, now_us)
        key = (src - 1).clamp(0, self.K - 1)
        if self.NO_DEDUP:
            is_dup = torch.zeros_like(is_req)
        else:
            is_dup = seq <= take(swept["last_req"], key)
        applied, status = self._apply(swept, src, seq, payload[:, 2], payload[:, 3], now_us)
        applied["last_req"] = set_at(applied["last_req"], key, torch.maximum(take(applied["last_req"], key), seq))
        swept["last_req"] = applied["last_req"]
        rows = tree_where(is_req & ~is_dup, applied, tree_where(is_req, swept, old))
        nodes = write_row(nodes, torch.zeros_like(node), rows)
        ack = make_payload(self.PAYLOAD_WIDTH, M_ACK, seq, torch.where(is_dup, ST_OK, status), 0)
        outbox = send_if(outbox, 0, is_req, src, ack)

        # ---- client: ACK -------------------------------------------------
        is_ack = (node != SERVER) & (mtype == M_ACK)
        acked, my_seq = take(nodes.acked, node), take(nodes.seq, node)
        acked = torch.where(is_ack, torch.maximum(acked, torch.minimum(seq, my_seq)), acked)
        return dataclasses.replace(nodes, acked=set_at(nodes.acked, node, acked)), outbox

    # -- invariants / results --------------------------------------------------

    def invariant(self, nodes: S3State, now_us):
        ver, val = nodes.obj_ver[:, SERVER], nodes.obj_val[:, SERVER]
        concat = ((ver > 0) & (val != nodes.obj_expected[:, SERVER])).any(dim=1)
        orphan = ((nodes.mpu_active[:, SERVER] == 0) & (nodes.mpu_mask[:, SERVER] != 0)).any(dim=1)
        early = nodes.lc_early[:, SERVER]
        partial = ((ver == 0) & (val != 0)).any(dim=1)
        ck = torch.arange(self.n_clients, device=ver.device)
        sent = nodes.writes_sent[:, ck + 1, ck]
        dup = (nodes.writes_applied[:, SERVER, : self.n_clients] > sent).any(dim=1)
        ok = ~(concat | orphan | early | partial | dup)
        code = torch.where(concat, MPU_CONCAT, torch.where(orphan, MPU_ORPHAN, torch.where(
            early, LC_EARLY, torch.where(partial, LC_PARTIAL, torch.where(dup, DUP_APPLY, 0)))))
        return ok, code.to(torch.int32)

    def is_done(self, nodes: S3State, now_us):
        # the lane stays open through the lifecycle window after the
        # clients go quiet, which is what the lifecycle invariants watch
        return (nodes.acked[:, 1:] >= self.target_ops).all(dim=1) & (now_us >= OBSERVE_US)

    def summary(self, nodes: S3State):
        return {
            "objects_live": (nodes.obj_ver[:, SERVER] > 0).sum(dim=1, dtype=torch.int32),
            "sessions_open": nodes.mpu_active[:, SERVER].sum(dim=1, dtype=torch.int32),
            "writes_applied": nodes.writes_applied[:, SERVER].sum(dim=1, dtype=torch.int32),
            "ops_acked": nodes.acked[:, 1:].sum(dim=1, dtype=torch.int32),
        }


class ArrivalOrderS3(S3Machine):
    CONCAT_ARRIVAL_ORDER = True  # complete concatenates parts in upload order


class AbortLeakS3(S3Machine):
    ABORT_KEEPS_PARTS = True  # abort leaks the session's parts


class EarlyExpiryS3(S3Machine):
    LC_EARLY_HALF = True  # lifecycle expires at half the configured age


class TombstoneLeakS3(S3Machine):
    LC_TOMBSTONE_LEAK = True  # expiry clears existence but not content


class NoDedupS3(S3Machine):
    NO_DEDUP = True  # retried puts double-apply
