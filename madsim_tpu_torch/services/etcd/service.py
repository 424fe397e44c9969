"""The etcd state machine: MVCC-revisioned KV, leases, elections, watch.

Reference: madsim-etcd-client/src/service.rs — put/get/delete/txn over a
sorted map (:191+), leases with TTL decremented by a 1 s background tick
(:25-35,:398,:466), campaign/proclaim/leader/observe/resign elections
(:487+, election.rs), request size limit 1.5 MiB (:36-40), state
dump/load (:160).
"""

from __future__ import annotations

from collections import deque
from typing import Any, Callable, Dict, List, Optional, Tuple

from ...errors import SimError

MAX_REQUEST_BYTES = int(1.5 * 1024 * 1024)  # reference: service.rs:36-40


class EtcdError(SimError):
    pass


class KeyValue:
    __slots__ = ("key", "value", "create_revision", "mod_revision", "version", "lease")

    def __init__(self, key: bytes, value: bytes, create_revision: int, mod_revision: int, version: int, lease: int):
        self.key = key
        self.value = value
        self.create_revision = create_revision
        self.mod_revision = mod_revision
        self.version = version
        self.lease = lease

    def to_dict(self) -> dict:
        return {
            "key": self.key.decode("latin1"),
            "value": self.value.decode("latin1"),
            "create_revision": self.create_revision,
            "mod_revision": self.mod_revision,
            "version": self.version,
            "lease": self.lease,
        }

    @staticmethod
    def from_dict(d: dict) -> "KeyValue":
        return KeyValue(
            d["key"].encode("latin1"),
            d["value"].encode("latin1"),
            d["create_revision"],
            d["mod_revision"],
            d["version"],
            d["lease"],
        )


class Event:
    PUT = "put"
    DELETE = "delete"

    def __init__(self, kind: str, kv: KeyValue, prev_kv: Optional[KeyValue]):
        self.kind = kind
        self.kv = kv
        self.prev_kv = prev_kv


class EtcdService:
    """Reference: service.rs `EtcdService`."""

    def __init__(self, rng, history_limit: int = 10_000,
                 lease_expiry_off_by_one: bool = False):
        self.rng = rng
        # watchable-history bound: exceeding it auto-compacts the oldest
        # whole revisions away (a real etcd bounds history by compaction
        # too; without this a write-heavy run leaks one Event per put)
        self.history_limit = history_limit
        # TEST-ONLY seeded bug for the bidirectional service
        # differential (tests/test_differential_services.py): the expiry
        # sweep's revoke loop starts at index 1 — the classic off-by-one
        # — leaking the first attached key of every EXPIRED lease.
        # Explicit lease_revoke calls are unaffected. Never set this
        # outside tests.
        self.lease_expiry_off_by_one = lease_expiry_off_by_one
        self.revision = 1
        self.kv: Dict[bytes, KeyValue] = {}
        # lease id -> (granted_ttl, remaining_ttl)
        self.leases: Dict[int, List[int]] = {}
        self.lease_keys: Dict[int, set] = {}
        # watchers: fn(event) -> None (detached on error by caller)
        self.watchers: List[Tuple[bytes, bytes, Callable[[Event], None]]] = []
        # event history for watch start_revision replay (bounded by
        # compaction, like etcd's MVCC keyspace history); deque so the
        # steady-state trim is O(1) per write, not a list rebuild
        self.history: "deque[Tuple[int, Event]]" = deque()
        # compact_revision: the revision a client last compacted at
        # (etcd's compactMainRev — compact() below it is ErrCompacted).
        # history_floor: the lowest revision whose events are still
        # replayable for watch(start_revision) — raised by compaction,
        # by the bounded-history trim, and by load() (which has no
        # history at all). Kept separate so a load at revision R doesn't
        # make compact(R) impossible (see load()).
        self.compact_revision = 0
        self.history_floor = 0

    # -- helpers --------------------------------------------------------------

    def _bump(self) -> int:
        self.revision += 1
        return self.revision

    @staticmethod
    def _in_range(key: bytes, lo: bytes, hi: bytes) -> bool:
        """Range convention shared by get/delete/watch/replay:
        hi == b"" means the single key `lo`, not unbounded-above
        (watch previously disagreed with _keys_in here and delivered
        every key >= lo to a single-key watcher)."""
        if hi == b"":
            return key == lo
        return lo <= key < hi

    def _notify(self, ev: Event) -> None:
        self.history.append((ev.kv.mod_revision, ev))
        if len(self.history) > self.history_limit:
            # drop whole revisions only: a range delete emits several
            # events at one revision, and replaying half of one would
            # silently lose data
            boundary = self.history[0][0]
            while len(self.history) > self.history_limit:
                boundary = self.history.popleft()[0]
            while self.history and self.history[0][0] == boundary:
                self.history.popleft()
            self.history_floor = max(self.history_floor, boundary + 1)
        for lo, hi, cb in list(self.watchers):
            if self._in_range(ev.kv.key, lo, hi):
                cb(ev)

    def history_since(self, start_revision: int, lo: bytes, hi: bytes) -> List[Event]:
        """Replay events at mod_revision >= start_revision in [lo, hi).
        Raises if the range was compacted away (etcd: ErrCompacted —
        only revisions strictly BELOW the compaction point are gone;
        compact(R) retains the events at R itself)."""
        if start_revision < max(self.history_floor, self.compact_revision):
            raise EtcdError("etcdserver: mvcc: required revision has been compacted")
        return [
            ev for rev, ev in self.history
            if rev >= start_revision and self._in_range(ev.kv.key, lo, hi)
        ]

    def compact(self, revision: int) -> dict:
        """Discard event history below `revision`
        (reference class: etcd Maintenance/KV compact)."""
        if revision > self.revision:
            raise EtcdError("etcdserver: mvcc: required revision is a future revision")
        if revision <= self.compact_revision:
            raise EtcdError("etcdserver: mvcc: required revision has been compacted")
        self.compact_revision = revision
        self.history_floor = max(self.history_floor, revision)
        self.history = deque((r, e) for r, e in self.history if r >= revision)
        return {"revision": self.revision, "compact_revision": revision}

    def add_watcher(self, lo: bytes, hi: bytes, cb: Callable[[Event], None]):
        entry = (lo, hi, cb)
        self.watchers.append(entry)
        return entry

    def remove_watcher(self, entry) -> None:
        try:
            self.watchers.remove(entry)
        except ValueError:
            pass

    @staticmethod
    def _range(key: bytes, range_end: bytes) -> Tuple[bytes, bytes]:
        return key, range_end

    def _keys_in(self, lo: bytes, hi: bytes) -> List[bytes]:
        if hi == b"":
            return [lo] if lo in self.kv else []
        return sorted(k for k in self.kv if lo <= k < hi)

    # -- kv --------------------------------------------------------------------

    def put(self, key: bytes, value: bytes, lease: int = 0, prev_kv: bool = False):
        if len(key) + len(value) > MAX_REQUEST_BYTES:
            raise EtcdError("etcdserver: request is too large")
        if lease and lease not in self.leases:
            raise EtcdError("etcdserver: requested lease not found")
        rev = self._bump()
        old = self.kv.get(key)
        new = KeyValue(
            key,
            value,
            old.create_revision if old else rev,
            rev,
            old.version + 1 if old else 1,
            lease,
        )
        self.kv[key] = new
        if old is not None and old.lease and old.lease != lease:
            self.lease_keys.get(old.lease, set()).discard(key)
        if lease:
            self.lease_keys.setdefault(lease, set()).add(key)
        self._notify(Event(Event.PUT, new, old))
        return {"revision": rev, "prev_kv": old if prev_kv else None}

    def get(
        self,
        key: bytes,
        range_end: bytes = b"",
        limit: int = 0,
        count_only: bool = False,
        keys_only: bool = False,
    ):
        keys = self._keys_in(key, range_end)
        kvs = [self.kv[k] for k in keys]
        count = len(kvs)
        if limit:
            kvs = kvs[:limit]
        if keys_only:
            kvs = [KeyValue(kv.key, b"", kv.create_revision, kv.mod_revision, kv.version, kv.lease) for kv in kvs]
        return {"revision": self.revision, "kvs": [] if count_only else kvs, "count": count}

    def delete(self, key: bytes, range_end: bytes = b"", prev_kv: bool = False):
        keys = self._keys_in(key, range_end)
        deleted = []
        if keys:
            rev = self._bump()
            for k in keys:
                old = self.kv.pop(k)
                deleted.append(old)
                if old.lease:
                    self.lease_keys.get(old.lease, set()).discard(k)
                tomb = KeyValue(k, b"", 0, rev, 0, 0)
                self._notify(Event(Event.DELETE, tomb, old))
        return {
            "revision": self.revision,
            "deleted": len(deleted),
            "prev_kvs": deleted if prev_kv else [],
        }

    # -- txn --------------------------------------------------------------------

    def txn(self, compares: List[tuple], then_ops: List[tuple], else_ops: List[tuple]):
        ok = all(self._compare(c) for c in compares)
        ops = then_ops if ok else else_ops
        responses = [self._apply_op(op) for op in ops]
        return {"revision": self.revision, "succeeded": ok, "responses": responses}

    def _compare(self, c: tuple) -> bool:
        target, key, op, operand = c
        kv = self.kv.get(key)
        if target == "value":
            actual: Any = kv.value if kv else b""
        elif target == "create_revision":
            actual = kv.create_revision if kv else 0
        elif target == "mod_revision":
            actual = kv.mod_revision if kv else 0
        elif target == "version":
            actual = kv.version if kv else 0
        else:
            raise EtcdError(f"bad compare target {target}")
        if op == "=":
            return actual == operand
        if op == "!=":
            return actual != operand
        if op == ">":
            return actual > operand
        if op == "<":
            return actual < operand
        raise EtcdError(f"bad compare op {op}")

    def _apply_op(self, op: tuple):
        kind = op[0]
        if kind == "put":
            return ("put", self.put(op[1], op[2], lease=op[3]))
        if kind == "get":
            return ("get", self.get(op[1], range_end=op[2]))
        if kind == "delete":
            return ("delete", self.delete(op[1], range_end=op[2]))
        raise EtcdError(f"bad txn op {kind}")

    # -- leases (reference: service.rs:25-35 tick + :398+) ----------------------

    def lease_grant(self, ttl: int, lease_id: int = 0):
        if lease_id == 0:
            while True:
                lease_id = self.rng.gen_range(1, 1 << 62)
                if lease_id not in self.leases:
                    break
        if lease_id in self.leases:
            raise EtcdError("etcdserver: lease already exists")
        self.leases[lease_id] = [ttl, ttl]
        self.lease_keys.setdefault(lease_id, set())
        return {"id": lease_id, "ttl": ttl}

    def lease_revoke(self, lease_id: int):
        if lease_id not in self.leases:
            raise EtcdError("etcdserver: requested lease not found")
        del self.leases[lease_id]
        for key in sorted(self.lease_keys.pop(lease_id, set())):
            self.delete(key)
        return {"revision": self.revision}

    def lease_keep_alive(self, lease_id: int):
        if lease_id not in self.leases:
            raise EtcdError("etcdserver: requested lease not found")
        granted = self.leases[lease_id][0]
        self.leases[lease_id][1] = granted
        return {"id": lease_id, "ttl": granted}

    def lease_time_to_live(self, lease_id: int):
        if lease_id not in self.leases:
            raise EtcdError("etcdserver: requested lease not found")
        granted, remaining = self.leases[lease_id]
        return {"id": lease_id, "granted_ttl": granted, "ttl": remaining,
                "keys": sorted(self.lease_keys.get(lease_id, set()))}

    def lease_list(self):
        return {"leases": sorted(self.leases)}

    def tick(self) -> None:
        """1-second lease countdown (reference: service.rs:25-35 spawned
        tick task; expiry deletes attached keys)."""
        self.advance(1)

    def advance(self, n: int) -> None:
        """`n` ticks at once — lease accounting is linear in elapsed
        time, so this equals n sequential tick() calls. Used by the
        service-differential harness as its virtual-time bridge
        (differential_services.py: 1 machine µs = 1 tick)."""
        if n <= 0:
            return
        expired = []
        for lease_id, pair in self.leases.items():
            pair[1] -= n
            if pair[1] <= 0:
                expired.append(lease_id)
        for lease_id in expired:
            if self.lease_expiry_off_by_one:
                # seeded bug (see __init__): skip the first attached key
                del self.leases[lease_id]
                for key in sorted(self.lease_keys.pop(lease_id, set()))[1:]:
                    self.delete(key)
                continue
            self.lease_revoke(lease_id)

    # -- elections (reference: service.rs:487+, election.rs) --------------------

    def _election_prefix(self, name: bytes) -> Tuple[bytes, bytes]:
        return name + b"/", name + b"0"  # '/'+1 == '0'

    def campaign(self, name: bytes, value: bytes, lease: int):
        """Create the candidate key; caller loops until it is the leader."""
        key = name + b"/" + format(lease, "x").encode()
        if key not in self.kv:
            self.put(key, value, lease=lease)
        return self.is_leader(name, key)

    def is_leader(self, name: bytes, key: bytes) -> dict:
        lo, hi = self._election_prefix(name)
        keys = self._keys_in(lo, hi)
        if not keys:
            return {"leader": None, "is_leader": False}
        leader_key = min(keys, key=lambda k: self.kv[k].create_revision)
        kv = self.kv[leader_key]
        return {
            "leader": {"name": name, "key": leader_key, "rev": kv.create_revision, "lease": kv.lease},
            "is_leader": leader_key == key,
            "value": kv.value,
        }

    def leader(self, name: bytes) -> dict:
        info = self.is_leader(name, b"")
        if info["leader"] is None:
            raise EtcdError("election: no leader")
        return info

    def proclaim(self, leader: dict, value: bytes):
        key = leader["key"]
        kv = self.kv.get(key)
        if kv is None or kv.create_revision != leader["rev"]:
            raise EtcdError("election: session expired")
        return self.put(key, value, lease=kv.lease)

    def resign(self, leader: dict):
        return self.delete(leader["key"])

    # -- maintenance / persistence ----------------------------------------------

    def status(self) -> dict:
        return {"version": "madsim-tpu-etcd", "db_size": len(self.kv), "revision": self.revision}

    def dump(self) -> str:
        """Serialize full state (reference: service.rs:160 dump as TOML;
        JSON here — same capability, stdlib-friendly)."""
        import json

        return json.dumps(
            {
                "revision": self.revision,
                "compact_revision": self.compact_revision,
                "kv": [kv.to_dict() for kv in self.kv.values()],
                "leases": {str(k): v for k, v in self.leases.items()},
                "lease_keys": {str(k): sorted(x.decode("latin1") for x in v) for k, v in self.lease_keys.items()},
            }
        )

    def load(self, text: str) -> None:
        import json

        data = json.loads(text)
        self.revision = data["revision"]
        # loaded state has no event history: watchers cannot replay
        # revisions up to and including the load point (the floor sits
        # one past the last missing revision or a
        # start_revision==revision watch would silently skip that
        # revision's events). compact_revision stays at its dumped
        # value so compact(current revision) still works after a
        # restore, like real etcd.
        self.history = deque()
        self.history_floor = self.revision + 1
        self.compact_revision = data.get("compact_revision", 0)
        self.kv = {}
        for d in data["kv"]:
            kv = KeyValue.from_dict(d)
            self.kv[kv.key] = kv
        self.leases = {int(k): list(v) for k, v in data["leases"].items()}
        self.lease_keys = {
            int(k): {x.encode("latin1") for x in v} for k, v in data["lease_keys"].items()
        }
