"""Service-machine differential harness, the device side: the port of
`madsim_tpu/differential_services.py`.

`models/etcd_mvcc.py`, `models/kafka_group.py` and `models/s3.py`
*claim* to mirror the semantics of host services (an etcd MVCC store, a
Kafka group coordinator, an S3 object store). This module makes those
claims checkable per seed, for the components where semantic drift is
most likely. The services are the port's own (`services/etcd/service.py`,
`services/kafka`, `services/s3`), host code that runs nothing on the
card; each check also takes a factory (`service_factory=` /
`broker_factory=` / `s3_factory=`) to drive another build of the
service, such as a deliberately bugged one. The device side is the
port's single-lane `replay`, on the engine's device.

* `differential_etcd_mvcc(engine, seed)` — replay
  the device lane, decode every request the MVCC server actually
  processed (the delivered M_REQ stream, dedup included), drive the
  service with the same ops at the same virtual times, and
  compare the full MVCC outcome: revision counter, per-live-key
  value/version/create_revision/mod_revision/lease attachment, and the
  txn pair. Virtual-time bridge: 1 machine microsecond = 1 service
  lease tick (`EtcdService.advance`), TTLs granted as ttl+1 so the
  machine's strict `expiry < now` matches the service's
  `remaining <= 0`.

* `differential_kafka_group(engine, seed)` — replay
  the device lane, decode the membership timeline (heartbeats/joins)
  and commit stream, drive the broker's group coordinator with the same timeline
  (machine µs as broker ms, same session length, roundrobin strategy),
  and compare membership, generation, range assignment, and committed
  offsets. On fault-free seeds the agreement is event-for-event; under
  kill faults the coordinator may split one expiry batch the machine
  handles atomically (it sweeps on member traffic, the machine on its
  session tick), so the adapter drives the broker's expiry from the
  machine's own session ticks.

* `differential_s3(engine, seed)` — the full store
  compared after every applied server event.

Abstraction note (documented divergence): the machine models leases as
one slot per client where a re-grant refreshes the slot in place;
genuine etcd is id-per-grant. The adapter mirrors the slot model by
refreshing the service lease's TTL on re-grant instead of creating a
second lease — one line, called out here so it can be audited.
"""

from __future__ import annotations

import dataclasses
from types import SimpleNamespace
from typing import Callable, Dict, List, Optional, Tuple

from .engine.replay import ReplayResult, replay


def _lane_nodes(state) -> SimpleNamespace:
    """A one-lane replay state's node leaves as numpy arrays, the lane
    axis dropped (the reference's replay state has none)."""
    nodes = state.nodes
    return SimpleNamespace(**{f.name: getattr(nodes, f.name)[0].cpu().numpy() for f in dataclasses.fields(nodes)})


# =========================================================================
# etcd MVCC bridge
# =========================================================================


class _SvcRng:
    def gen_range(self, lo: int, hi: int) -> int:  # lease ids (unused: explicit ids)
        return lo


def _mvcc_key(machine, k: int) -> bytes:
    if k == machine.K - 2:
        return b"pair/0"
    if k == machine.K - 1:
        return b"pair/1"
    return f"client/{k}".encode()


def drive_etcd_service(machine, trace, service_factory: Optional[Callable] = None):
    """Apply the device lane's delivered M_REQ stream to an etcd service
    (`service_factory(rng)`, `EtcdService` when None), mirroring the
    machine's sweep-then-apply order and dedup rule. A factory building
    a deliberately-bugged SERVICE lets the bidirectional tests check
    that the differential catches drift seeded on either side."""
    from .models import etcd_mvcc as M
    from .services.etcd.service import EtcdService

    svc = (service_factory or EtcdService)(_SvcRng())
    last_req: Dict[int, int] = {}
    lease_of: Dict[int, int] = {}  # client -> service lease id (the slot)
    last_t = 0
    for ev in trace:
        if ev.kind != "msg" or ev.node != M.SERVER:
            continue
        mtype, seq, kind, arg = ev.payload[0], ev.payload[1], ev.payload[2], ev.payload[3]
        if mtype != M.M_REQ:
            continue
        c = ev.src
        # the machine sweeps lazily on every server event (module
        # docstring: any client-visible read is itself a server event)
        svc.advance(ev.time_us - last_t)
        last_t = ev.time_us
        if seq <= last_req.get(c, 0):
            continue  # dedup: re-ack without re-applying
        last_req[c] = max(last_req.get(c, 0), seq)
        key = _mvcc_key(machine, c - 1)
        lease_id = lease_of.get(c)
        lease_live = lease_id is not None and lease_id in svc.leases
        if kind == M.OP_PUT:
            svc.put(key, str(seq).encode())
        elif kind == M.OP_DEL:
            svc.delete(key)
        elif kind == M.OP_TXN:
            p0, p1 = _mvcc_key(machine, machine.K - 2), _mvcc_key(machine, machine.K - 1)
            kv0 = svc.kv.get(p0)
            then = ((kv0.version if kv0 else 0) % 2) == 0
            val = seq if then else -seq
            # both branches write BOTH pair keys (machine txn semantics);
            # service txn applies its op list as sequential puts
            svc.txn([], [("put", p0, str(val).encode(), 0),
                        ("put", p1, str(val).encode(), 0)], [])
        elif kind == M.OP_GRANT:
            if lease_live:
                # slot model: re-grant refreshes the slot's lease in
                # place (see module docstring abstraction note)
                svc.leases[lease_id] = [arg + 1, arg + 1]
            else:
                lease_of[c] = c  # deterministic id = client index
                svc.lease_grant(arg + 1, lease_id=c)
        elif kind == M.OP_PUT_LEASED:
            if lease_live:
                svc.put(key, str(seq).encode(), lease=lease_id)
        elif kind == M.OP_KA:
            if lease_live:
                svc.lease_keep_alive(lease_id)
    return svc


def differential_etcd_mvcc(
    engine, seed: int, max_steps: int = 3000, service_factory: Optional[Callable] = None
) -> Dict:
    """One seed, both implementations, full MVCC state comparison.

    Returns {"ok", "mismatches": [str], "revision": (machine, service),
    "ops": n_effective} — ok=True means the machine and the service
    agree exactly on every compared MVCC fact. The check is
    bidirectional: drift seeded in the MACHINE (NO_DEDUP variants) or
    in the SERVICE (`service_factory` building e.g. a service whose
    lease expiry is off by one) both break the agreement."""
    machine = engine.machine
    rp: ReplayResult = replay(engine, seed, max_steps=max_steps)
    svc = drive_etcd_service(machine, rp.trace, service_factory=service_factory)
    nodes = _lane_nodes(rp.state)

    mismatches: List[str] = []
    m_rev = int(nodes.rev[0])
    if svc.revision != m_rev:
        mismatches.append(f"revision: machine {m_rev} != service {svc.revision}")
    if svc.revision - 1 != int(nodes.applied[0]):
        mismatches.append(
            f"applied: machine {int(nodes.applied[0])} != service {svc.revision - 1}"
        )
    for k in range(machine.K):
        key = _mvcc_key(machine, k)
        m_live = int(nodes.ver[0, k]) > 0
        s_kv = svc.kv.get(key)
        if m_live != (s_kv is not None):
            mismatches.append(f"{key!r}: liveness machine {m_live} != service {s_kv is not None}")
            continue
        if not m_live:
            continue
        if int(s_kv.value) != int(nodes.val[0, k]):
            mismatches.append(f"{key!r}: value {int(nodes.val[0, k])} != {s_kv.value!r}")
        if s_kv.version != int(nodes.ver[0, k]):
            mismatches.append(f"{key!r}: version {int(nodes.ver[0, k])} != {s_kv.version}")
        if s_kv.mod_revision != int(nodes.mod_rev[0, k]):
            mismatches.append(
                f"{key!r}: mod_rev {int(nodes.mod_rev[0, k])} != {s_kv.mod_revision}"
            )
        if s_kv.create_revision != int(nodes.create_rev[0, k]):
            mismatches.append(
                f"{key!r}: create_rev {int(nodes.create_rev[0, k])} != {s_kv.create_revision}"
            )
        m_slot = int(nodes.key_lease[0, k])  # slot+1; 0 = none
        s_lease = s_kv.lease
        if (m_slot > 0) != (s_lease != 0):
            mismatches.append(f"{key!r}: lease attach {m_slot} != {s_lease}")
        elif m_slot > 0 and s_lease != m_slot:  # adapter id == client == slot+1
            mismatches.append(f"{key!r}: lease owner slot {m_slot} != id {s_lease}")
    n_ops = sum(
        1 for ev in rp.trace
        if ev.kind == "msg" and ev.node == 0 and ev.payload[0] == 1
    )
    return {
        "ok": not mismatches,
        "mismatches": mismatches,
        "revision": (m_rev, svc.revision),
        "ops": n_ops,
        "replay_failed": rp.failed,
    }


# =========================================================================
# kafka consumer-group bridge
# =========================================================================


GROUP = "diff-group"
TOPIC = "diff-topic"


def drive_kafka_coordinator(machine, trace, broker_factory: Optional[Callable] = None):
    """Apply the device lane's membership timeline + commit stream to a
    broker's group coordinator (`broker_factory(expire_on_traffic=False)`,
    `Broker` when None). Machine µs are passed as broker ms
    (same numeric session semantics, same strict expiry inequality).

    The broker runs in timer-driven expiry mode (`expire_on_traffic=False`) and the adapter
    drives `sweep_expired` from the machine's OWN session-tick events in
    the trace, so evictions land at identical moments on both sides and
    the event-for-event contract survives kill faults. Kill windows on
    the coordinator node are mirrored (the engine drops handler events
    on a dead node), and a coordinator RESTART wipes the broker's member
    table — the machine's volatile-member-table semantics.

    Transport shim (documented divergence): the Broker stores the
    last-committed offset like real Kafka, which rides ordered TCP; the
    machine's fabric is datagram, so it absorbs reordered commits with
    max(). The adapter restores the ordered-transport assumption by
    skipping a same-regime commit that is <= the broker's current
    offset — those rows get accepted=None in the log.

    Returns (broker, member_of, accept_log); accept_log rows are
    (t, src, gen, part, off, accepted|None, before, after)."""
    from .engine.core import F_KILL, F_RESTART
    from .models import kafka_group as G
    from .services.kafka import Broker

    b = (broker_factory or Broker)(expire_on_traffic=False)
    b.create_topic(TOPIC, machine.P)
    member_of: Dict[int, str] = {}
    regime: Dict[int, int] = {}
    accept_log: List[Tuple] = []
    coord_killed = False
    for ev in trace:
        if ev.kind == "fault":
            op, a = ev.payload[0], ev.payload[1]
            if a == G.COORD and op == F_KILL:
                coord_killed = True
            elif a == G.COORD and op == F_RESTART:
                coord_killed = False
                # the member table is volatile (restart_if wipes
                # joined/last_hb); gen + committed offsets are durable
                g = b.groups.get(GROUP)
                if g is not None:
                    g.members.clear()
            continue
        if ev.node != G.COORD or coord_killed:
            continue
        t, src, mtype = ev.time_us, ev.src, ev.payload[0]
        if ev.kind == "timer":
            if ev.payload[0] == G.T_SESSION:
                b.sweep_expired(GROUP, t)  # the machine's eviction moment
            continue
        if ev.kind != "msg":
            continue
        if mtype == G.M_HB:
            # member ids sort in node-id order: the machine ranks joined
            # members by node id, the broker's assignors rank by member
            # id — pinning the ids aligns the two rank orders exactly
            mid, _gen = b.join_group(
                GROUP, member_of.get(src) or f"m{src:02d}", [TOPIC],
                G.SESSION_US, "roundrobin", t,
            )
            member_of[src] = mid
        elif mtype == G.M_COMMIT:
            c_gen, c_part, c_off = int(ev.payload[1]), int(ev.payload[2]), int(ev.payload[3])
            mid = member_of.get(src)
            before = b.committed(GROUP, TOPIC, c_part)
            if (
                regime.get(c_part) == c_gen
                and before is not None
                and c_off <= before
            ):
                accept_log.append((t, src, c_gen, c_part, c_off, None, before, before))
                continue
            try:
                if mid is None:
                    raise KeyError(src)
                b.commit_offsets(
                    GROUP, {(TOPIC, c_part): c_off}, mid, c_gen, now_ms=t,
                )
                accepted = True
                regime[c_part] = c_gen
            except Exception:
                accepted = False
            after = b.committed(GROUP, TOPIC, c_part)
            accept_log.append((t, src, c_gen, c_part, c_off, accepted, before, after))
    return b, member_of, accept_log


def _machine_fencing_mirror(machine, trace):
    """Host mirror of the machine coordinator's fencing inputs for
    FAULT-FREE lanes (no expiry, so gen bumps only on joins): yields
    would-accept decisions per commit, in delivery order."""
    from .models import kafka_group as G

    joined: List[int] = []  # in node-id order (machine ranks by node id)
    gen = 0
    decisions = []
    for ev in trace:
        if ev.kind != "msg" or ev.node != G.COORD:
            continue
        src, mtype = ev.src, ev.payload[0]
        if mtype == G.M_HB:
            if src not in joined:
                joined.append(src)
                joined.sort()
                gen += 1
        elif mtype == G.M_COMMIT:
            c_gen, c_part = int(ev.payload[1]), int(ev.payload[2])
            k = len(joined)
            owner = joined[c_part % k] if k else -1
            decisions.append(
                (c_gen == gen) and (src in joined) and (owner == src)
            )
    return gen, decisions


def differential_kafka_group(
    engine, seed: int, max_steps: int = 4000, *, broker_factory: Optional[Callable] = None
) -> Dict:
    """One seed, machine vs broker coordinator — the STRONG contract on
    every lane, faulted or not: exact member-set, generation, assignment and committed-offset equality.
    The adapter aligns the broker's evictions with the machine's session
    ticks and mirrors coordinator kill/restart windows, so there is no
    divergence window for a fencing decision to hide in. The host
    fencing mirror (joins-only gen accounting) additionally pins the
    per-commit accept stream on fault-free lanes."""
    from .models import kafka_group as G

    machine = engine.machine
    rp = replay(engine, seed, max_steps=max_steps)
    nodes = _lane_nodes(rp.state)
    b, member_of, accept_log = drive_kafka_coordinator(machine, rp.trace, broker_factory)
    g = b.groups.get(GROUP)

    mismatches: List[str] = []
    m_members = {i for i in range(1, machine.NUM_NODES) if bool(nodes.joined[i])}
    b_members = set()
    if g:
        mid_to_src = {mid: src for src, mid in member_of.items()}
        b_members = {mid_to_src[mid] for mid in g.members if mid in mid_to_src}
    if m_members != b_members:
        mismatches.append(
            f"members: machine {sorted(m_members)} != broker {sorted(b_members)}"
        )

    m_gen = int(nodes.gen[G.COORD])
    b_gen = g.generation if g else 0
    if m_gen != b_gen:
        mismatches.append(f"generation: machine {m_gen} != broker {b_gen}")

    # assignment: both sides range/round-robin by rank over the joined
    # set — with (non-empty) membership equal, the owner maps must agree
    # exactly. Empty membership skips: after a coordinator restart with
    # no rejoin yet, the machine's durable assign_member still shows
    # pre-kill owners while the broker has no assignments — not drift.
    if g is not None and m_members == b_members and m_members:
        m_assign = {
            p: int(nodes.assign_member[G.COORD, p]) for p in range(machine.P)
        }
        b_assign = {p: -1 for p in range(machine.P)}
        for src, mid in member_of.items():
            if mid in g.members:
                for (_topic, p) in g.assignments.get(mid, ()):
                    b_assign[p] = src
        if m_assign != b_assign:
            mismatches.append(f"assignment: machine {m_assign} != broker {b_assign}")

    # committed offsets: exact equality on every partition, all lanes
    for p in range(machine.P):
        m_off = int(nodes.committed[G.COORD, p])
        b_off = b.committed(GROUP, TOPIC, p) or 0
        if m_off != b_off:
            mismatches.append(f"committed[{p}]: machine {m_off} != broker {b_off}")

    had_fault = any(ev.kind == "fault" for ev in rp.trace)
    fencing_agreements = fencing_total = 0
    if not had_fault and g is not None:
        m_gen_mirror, decisions = _machine_fencing_mirror(machine, rp.trace)
        if m_gen_mirror != m_gen:
            mismatches.append(
                f"host mirror drift: gen {m_gen_mirror} != machine {m_gen}"
            )
        # event-for-event fencing agreement (ordering-normalized rows
        # excluded: the broker never saw them)
        for (row, want) in zip(accept_log, decisions):
            if row[5] is None:
                continue
            fencing_total += 1
            if row[5] == want:
                fencing_agreements += 1
            else:
                mismatches.append(
                    f"fencing: commit {row[:5]} broker={row[5]} machine-rule={want}"
                )

    return {
        "ok": not mismatches,
        "mismatches": mismatches,
        "had_fault": had_fault,
        "machine_gen": m_gen,
        "broker_gen": b_gen,
        "commits": len(accept_log),
        "fencing_checked": fencing_total,
        "replay_failed": rp.failed,
    }


# =========================================================================
# S3 object-store bridge
# =========================================================================

BUCKET = "diff"


class _S3Rng:
    """Deterministic upload-id source for the driven service."""

    def __init__(self) -> None:
        self.n = 0

    def next_u64(self) -> int:
        self.n += 1
        return self.n


def _s3_fold(body: bytes) -> int:
    """Recompute the machine's int32 content fold from real bytes: the
    adapter encodes every part/put body as one 4-byte big-endian chunk,
    so a completed object is a chunk sequence in part-number order —
    exactly the machine's h = fold(h*31 + val)."""
    h = 0
    for i in range(0, len(body), 4):
        h = h * 31 + int.from_bytes(body[i : i + 4], "big", signed=True)
    return h


def drive_s3_service(machine, trace, s3_factory: Optional[Callable] = None, on_server_event=None):
    """Apply the device lane's effective server events to an S3 service
    (`s3_factory(rng)`, `S3Service` when None), mirroring the machine's
    lazy lifecycle sweep (the
    service's apply_lifecycle run at every live server event), the
    dedup rule, the kill/restart drop window (handler events on a dead
    server are dropped by the engine — the adapter tracks the fault
    stream and drops them too), and the epoch gating of the server's
    lifecycle ticker.

    `on_server_event(ev, svc, uid_of)` fires after every applied server
    event — the hook differential_s3 uses for its event-for-event
    comparison.

    Documented adapter divergences (single-session-per-key model):
    CREATE aborts the replaced upload (the machine has one session slot
    per key; the service keys sessions by upload_id); empty COMPLETE is
    skipped (the machine rejects it like real S3; the sim service would
    accept). Time bridge: 1 machine µs = 1 service second, lifecycle
    rule days scaled so the cutoffs coincide exactly.

    Returns (svc, uid_of)."""
    from .engine.core import F_KILL, F_RESTART
    from .models import s3 as S
    from .services.s3 import S3Service

    svc = (s3_factory or S3Service)(_S3Rng())
    svc.create_bucket(BUCKET)
    svc.put_bucket_lifecycle_configuration(
        BUCKET,
        {"rules": [{
            "id": "diff",
            "prefix": "",
            "days": S.OBJ_AGE_US / 86400.0,
            "abort_multipart_days": S.MPU_AGE_US / 86400.0,
        }]},
    )
    uid_of: Dict[int, str] = {}  # client -> active upload id
    last_req: Dict[int, int] = {}
    killed = False
    epoch = 0

    def key_of(c: int) -> str:
        return f"client/{c - 1}"

    for ev in trace:
        # kill/restart window: the engine drops handler events (msgs,
        # timers) delivered to a dead node
        if ev.kind == "fault":
            op, a = ev.payload[0], ev.payload[1]
            if op == F_KILL and a == S.SERVER:
                killed = True
            elif op == F_RESTART and a == S.SERVER:
                killed = False
            continue
        if ev.node != S.SERVER or killed:
            continue
        t = float(ev.time_us)
        if ev.kind == "timer":
            tid = ev.payload[0]
            if tid == 0:
                epoch += 1  # BOOT: re-arms the ticker chain
            elif (tid - 1) // 2 == epoch:
                svc.apply_lifecycle(t)  # live lifecycle tick
                if on_server_event is not None:
                    on_server_event(ev, svc, uid_of)
            continue
        if ev.kind != "msg" or ev.payload[0] != S.M_REQ:
            continue
        # request path: the machine sweeps before applying, dup or not
        svc.apply_lifecycle(t)
        seq, kind, arg = int(ev.payload[1]), int(ev.payload[2]), int(ev.payload[3])
        c = ev.src
        if seq <= last_req.get(c, 0):
            if on_server_event is not None:
                on_server_event(ev, svc, uid_of)
            continue  # dedup: re-ack without re-applying
        last_req[c] = seq
        body = int(seq).to_bytes(4, "big", signed=True)
        uid = uid_of.get(c)
        live = uid is not None and uid in svc.uploads
        if kind == S.OP_PUT:
            svc.put_object(BUCKET, key_of(c), body, now=t)
        elif kind == S.OP_DEL:
            svc.delete_object(BUCKET, key_of(c))
        elif kind == S.OP_CREATE:
            if live:
                svc.abort_multipart_upload(uid)  # single-session slot model
            uid_of[c] = svc.create_multipart_upload(BUCKET, key_of(c), now=t)["upload_id"]
        elif kind == S.OP_PART:
            if live:
                svc.upload_part(uid, arg + 1, body)  # service parts are 1-based
        elif kind == S.OP_COMPLETE:
            if live and svc.uploads[uid][2]:
                svc.complete_multipart_upload(uid, now=t)
                uid_of.pop(c, None)
        elif kind == S.OP_ABORT:
            if live:
                svc.abort_multipart_upload(uid)
                uid_of.pop(c, None)
        if on_server_event is not None:
            on_server_event(ev, svc, uid_of)
    return svc, uid_of


def _compare_s3(machine, snap, svc, uid_of, where: str, mismatches: List[str]) -> Tuple[int, int]:
    """Full store comparison at one moment: object liveness + content +
    last_modified per key, session liveness + part set + part contents +
    creation time, orphaned-upload count. Returns (objects, sessions)."""
    bucket = svc.buckets[BUCKET]
    n_objects = 0
    for k in range(machine.K):
        key = f"client/{k}"
        m_live = int(snap["obj_ver"][k]) > 0
        obj = bucket.get(key)
        if m_live != (obj is not None):
            mismatches.append(
                f"{where} {key}: liveness machine {m_live} != service {obj is not None}"
            )
            continue
        if not m_live:
            continue
        n_objects += 1
        s_fold = _s3_fold(obj.body)
        if s_fold != int(snap["obj_val"][k]):
            mismatches.append(
                f"{where} {key}: content machine {int(snap['obj_val'][k])} != service {s_fold}"
            )
        if int(obj.last_modified) != int(snap["obj_mtime"][k]):
            mismatches.append(
                f"{where} {key}: mtime machine {int(snap['obj_mtime'][k])} != "
                f"service {int(obj.last_modified)}"
            )

    m_sessions = 0
    for c in range(1, machine.NUM_NODES):
        k = c - 1
        m_active = int(snap["mpu_active"][k]) > 0
        uid = uid_of.get(c)
        s_active = uid is not None and uid in svc.uploads
        if m_active != s_active:
            mismatches.append(
                f"{where} client {c}: session machine {m_active} != service {s_active}"
            )
            continue
        if not m_active:
            continue
        m_sessions += 1
        _b, _key, parts, created = svc.uploads[uid]
        m_mask = int(snap["mpu_mask"][k])
        s_mask = 0
        for pn in parts:
            s_mask |= 1 << (pn - 1)
        if m_mask != s_mask:
            mismatches.append(
                f"{where} client {c}: part set machine {m_mask:b} != service {s_mask:b}"
            )
        else:
            for pn, pbody in parts.items():
                m_val = int(snap["part_val"][k][pn - 1])
                s_val = int.from_bytes(pbody, "big", signed=True)
                if m_val != s_val:
                    mismatches.append(
                        f"{where} client {c} part {pn}: machine {m_val} != service {s_val}"
                    )
        if int(created) != int(snap["mpu_created"][k]):
            mismatches.append(
                f"{where} client {c}: session created machine "
                f"{int(snap['mpu_created'][k])} != service {int(created)}"
            )
    extra = len(svc.uploads) - m_sessions
    if extra:
        mismatches.append(f"{where}: service holds {extra} orphaned upload(s)")
    return n_objects, m_sessions


def differential_s3(
    engine, seed: int, max_steps: int = 4000, *, s3_factory: Optional[Callable] = None
) -> Dict:
    """One seed, machine vs the S3 service — EVENT-FOR-EVENT: the
    full store (objects, multipart sessions, lifecycle effects) is
    compared after every applied server event, not just at the end, so
    drift that later expiry would mask is still caught. ok=True means
    both implementations agreed at every server event of the lane."""
    machine = engine.machine
    snaps: Dict[int, Dict] = {}
    leaves = ("obj_ver", "obj_val", "obj_mtime", "mpu_active", "mpu_mask", "mpu_created", "part_val")

    def hook(ev, state):
        # snapshot the server row (lane 0, node 0) after every server event
        if ev.node == 0:
            snaps[ev.step] = {k: getattr(state.nodes, k)[0, 0].cpu().numpy() for k in leaves}

    rp: ReplayResult = replay(engine, seed, max_steps=max_steps, on_step=hook)

    mismatches: List[str] = []
    compared = [0]
    tally = {"objects": 0, "sessions": 0}

    def on_server_event(ev, svc, uid_of):
        snap = snaps.get(ev.step)
        if snap is None:
            return
        compared[0] += 1
        n_obj, n_sess = _compare_s3(
            machine, snap, svc, uid_of, f"step {ev.step} t={ev.time_us}", mismatches
        )
        tally["objects"] = max(tally["objects"], n_obj)
        tally["sessions"] = max(tally["sessions"], n_sess)

    drive_s3_service(machine, rp.trace, s3_factory, on_server_event=on_server_event)

    had_fault = any(ev.kind == "fault" for ev in rp.trace)
    return {
        "ok": not mismatches,
        "mismatches": mismatches[:20],
        "had_fault": had_fault,
        "events_compared": compared[0],
        "max_objects": tally["objects"],
        "max_sessions": tally["sessions"],
        "replay_failed": rp.failed,
    }
