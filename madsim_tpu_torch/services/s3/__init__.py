"""Simulated S3 — aws-sdk-style fluent client + in-sim server
(reference: madsim-aws-sdk-s3).

`S3Service` is a sorted-map object store with multipart-upload state and
per-bucket lifecycle configuration (reference: src/server/service.rs:27-60+);
`SimServer` serves the request enum over `Endpoint.connect1`
(reference: src/server/rpc_server.rs:22-65); the client exposes fluent
builders (`client.put_object().bucket(b).key(k).body(data).send()`)
mirroring the aws-sdk surface (reference: src/client.rs, src/operation/*).
"""

from __future__ import annotations

import hashlib
from typing import Any, Dict, List, Optional, Tuple

from ...dual import rand, time as sim_time  # mode-selected (sim or asyncio)
from ...errors import SimError
from ...net.network import ConnectionReset, parse_addr
from ...dual import net as _dual_net
from ...dual import task as _dual_task
from .._conn import StreamCaller

Endpoint = _dual_net.Endpoint
spawn = _dual_task.spawn

__all__ = ["S3Error", "S3Service", "SimServer", "Client", "Config"]


class S3Error(SimError):
    def __init__(self, code: str, message: str):
        super().__init__(f"{code}: {message}")
        self.code = code
        self.message = message


class _Object:
    __slots__ = ("body", "last_modified", "etag", "content_type", "metadata")

    def __init__(self, body: bytes, last_modified: float,
                 content_type: str = "binary/octet-stream",
                 metadata: Optional[Dict[str, str]] = None):
        self.body = body
        self.last_modified = last_modified
        self.etag = hashlib.md5(body).hexdigest()
        self.content_type = content_type
        self.metadata = dict(metadata or {})


class S3Service:
    """Reference: src/server/service.rs `S3Service`."""

    def __init__(self, rng):
        self.rng = rng
        self.buckets: Dict[str, Dict[str, _Object]] = {}
        # upload_id -> (bucket, key, {part_number: bytes}, created_at)
        self.uploads: Dict[str, Tuple[str, str, Dict[int, bytes], float]] = {}
        self.lifecycle: Dict[str, dict] = {}

    def _bucket(self, name: str) -> Dict[str, _Object]:
        if name not in self.buckets:
            raise S3Error("NoSuchBucket", name)
        return self.buckets[name]

    # -- operations (the request enum) --

    def create_bucket(self, bucket: str) -> dict:
        if bucket in self.buckets:
            raise S3Error("BucketAlreadyExists", bucket)
        self.buckets[bucket] = {}
        return {"location": f"/{bucket}"}

    def delete_bucket(self, bucket: str) -> dict:
        if self._bucket(bucket):
            raise S3Error("BucketNotEmpty", bucket)
        del self.buckets[bucket]
        return {}

    def put_object(self, bucket: str, key: str, body: bytes, now: float,
                   content_type: Optional[str] = None,
                   metadata: Optional[Dict[str, str]] = None) -> dict:
        b = self._bucket(bucket)
        obj = _Object(bytes(body), now,
                      content_type=content_type or "binary/octet-stream",
                      metadata=metadata)
        b[key] = obj
        return {"e_tag": obj.etag}

    @staticmethod
    def _parse_range(spec: str, size: int) -> Tuple[int, int]:
        """HTTP range header subset: bytes=a-b | bytes=a- | bytes=-n."""
        if not spec.startswith("bytes="):
            raise S3Error("InvalidRange", spec)
        lo_s, _, hi_s = spec[len("bytes="):].partition("-")
        try:
            if lo_s == "":  # suffix form: last n bytes (n must be > 0)
                n = int(hi_s)
                if n <= 0 or size == 0:
                    raise S3Error("InvalidRange", f"{spec} for object of {size} bytes")
                return max(0, size - n), size - 1
            lo = int(lo_s)
            hi = int(hi_s) if hi_s else size - 1
        except ValueError as exc:
            raise S3Error("InvalidRange", spec) from exc
        if lo > hi or lo >= size:
            raise S3Error("InvalidRange", f"{spec} for object of {size} bytes")
        return lo, min(hi, size - 1)

    def get_object(self, bucket: str, key: str, range: Optional[str] = None) -> dict:
        b = self._bucket(bucket)
        if key not in b:
            raise S3Error("NoSuchKey", key)
        obj = b[key]
        body = obj.body
        out = {"e_tag": obj.etag, "last_modified": obj.last_modified,
               "content_type": obj.content_type, "metadata": dict(obj.metadata)}
        if range is not None:
            lo, hi = self._parse_range(range, len(body))
            out["body"] = body[lo:hi + 1]
            out["content_length"] = hi - lo + 1
            out["content_range"] = f"bytes {lo}-{hi}/{len(body)}"
        else:
            out["body"] = body
            out["content_length"] = len(body)
        return out

    def head_object(self, bucket: str, key: str) -> dict:
        info = self.get_object(bucket, key)
        info.pop("body")
        return info

    def copy_object(self, src_bucket: str, src_key: str, bucket: str, key: str, now: float) -> dict:
        src = self.get_object(src_bucket, src_key)
        # AWS COPY directive default: source metadata travels with the copy
        return self.put_object(bucket, key, src["body"], now,
                               content_type=src["content_type"],
                               metadata=src["metadata"])

    def delete_object(self, bucket: str, key: str) -> dict:
        self._bucket(bucket).pop(key, None)
        return {}

    def delete_objects(self, bucket: str, keys: List[str]) -> dict:
        b = self._bucket(bucket)
        deleted = [k for k in keys if b.pop(k, None) is not None]
        return {"deleted": deleted}

    def list_objects_v2(self, bucket: str, prefix: str = "",
                        continuation: Optional[str] = None, max_keys: int = 1000,
                        delimiter: Optional[str] = None,
                        start_after: Optional[str] = None) -> dict:
        """AWS semantics incl. the delimiter/common-prefixes edges a real
        app hits first: keys containing `delimiter` after `prefix` are
        rolled up into one CommonPrefix entry each; contents and common
        prefixes share the lexicographic order and the max_keys budget."""
        b = self._bucket(bucket)
        keys = sorted(k for k in b if k.startswith(prefix or ""))
        # start_after is always a plain key bound (AWS semantics)
        if start_after:
            keys = [k for k in keys if k > start_after]
        if continuation:
            # structured opaque token: "p\0<common-prefix>" means the whole
            # rolled-up group was consumed (a plain key that merely ends
            # with the delimiter, e.g. a "folder/" marker object, must NOT
            # skip its group — that was a silent-data-loss bug)
            if continuation.startswith("p\0"):
                cp = continuation[2:]
                keys = [k for k in keys if k > cp and not k.startswith(cp)]
            else:
                token = continuation[2:] if continuation.startswith("k\0") else continuation
                keys = [k for k in keys if k > token]

        entries: List[Tuple[str, Optional[str]]] = []  # (sort key, rolled prefix|None)
        seen_prefixes = set()
        for k in keys:
            if delimiter:
                rest = k[len(prefix or ""):]
                d = rest.find(delimiter)
                if d >= 0:
                    cp = (prefix or "") + rest[: d + len(delimiter)]
                    if cp not in seen_prefixes:
                        seen_prefixes.add(cp)
                        entries.append((cp, cp))
                    continue
            entries.append((k, None))

        page = entries[:max_keys]
        truncated = len(entries) > len(page)
        contents = [
            {"key": k, "size": len(b[k].body), "e_tag": b[k].etag,
             "last_modified": b[k].last_modified}
            for k, cp in page if cp is None
        ]
        common = [{"prefix": cp} for _k, cp in page if cp is not None]
        next_token = None
        if truncated and page:
            last_key, last_cp = page[-1]
            next_token = f"p\0{last_cp}" if last_cp is not None else f"k\0{last_key}"
        return {
            "contents": contents,
            "common_prefixes": common,
            "is_truncated": truncated,
            "next_continuation_token": next_token,
            "key_count": len(page),
        }

    # -- multipart (reference: src/operation/{create,upload,complete,abort}_*) --

    def create_multipart_upload(self, bucket: str, key: str, now: float = 0.0) -> dict:
        self._bucket(bucket)
        upload_id = format(self.rng.next_u64(), "032x")
        self.uploads[upload_id] = (bucket, key, {}, now)
        return {"upload_id": upload_id}

    def upload_part(self, upload_id: str, part_number: int, body: bytes) -> dict:
        if upload_id not in self.uploads:
            raise S3Error("NoSuchUpload", upload_id)
        if part_number < 1 or part_number > 10_000:
            raise S3Error("InvalidArgument", "part number out of range")
        self.uploads[upload_id][2][part_number] = bytes(body)
        return {"e_tag": hashlib.md5(bytes(body)).hexdigest()}

    def complete_multipart_upload(self, upload_id: str, now: float) -> dict:
        if upload_id not in self.uploads:
            raise S3Error("NoSuchUpload", upload_id)
        bucket, key, parts, _created = self.uploads.pop(upload_id)
        body = b"".join(parts[n] for n in sorted(parts))
        return self.put_object(bucket, key, body, now)

    def abort_multipart_upload(self, upload_id: str) -> dict:
        if upload_id not in self.uploads:
            raise S3Error("NoSuchUpload", upload_id)
        del self.uploads[upload_id]
        return {}

    # -- lifecycle (reference: service.rs lifecycle config) --

    def put_bucket_lifecycle_configuration(self, bucket: str, config: dict) -> dict:
        self._bucket(bucket)
        self.lifecycle[bucket] = config
        return {}

    def get_bucket_lifecycle_configuration(self, bucket: str) -> dict:
        self._bucket(bucket)
        return self.lifecycle.get(bucket, {"rules": []})

    def apply_lifecycle(self, now: float) -> dict:
        """Enforce lifecycle rules against the (virtual) clock — the
        background job a real S3 runs ~daily. Rule shape:
        {"id", "status" (default Enabled), "prefix", "days" (object
        expiration), "abort_multipart_days" (incomplete-upload abort)}.
        """
        expired: List[Tuple[str, str]] = []
        aborted: List[str] = []
        for bucket, cfg in self.lifecycle.items():
            b = self.buckets.get(bucket)
            if b is None:
                continue
            for rule in cfg.get("rules", []):
                if rule.get("status", "Enabled") != "Enabled":
                    continue
                prefix = rule.get("prefix", "")
                days = rule.get("days")
                if days is not None:
                    cutoff = now - days * 86400.0
                    for k in [k for k, o in b.items()
                              if k.startswith(prefix) and o.last_modified <= cutoff]:
                        del b[k]
                        expired.append((bucket, k))
                mp_days = rule.get("abort_multipart_days")
                if mp_days is not None:
                    cutoff = now - mp_days * 86400.0
                    for uid in [uid for uid, (ub, uk, _p, created) in self.uploads.items()
                                if ub == bucket and uk.startswith(prefix)
                                and created <= cutoff]:
                        del self.uploads[uid]
                        aborted.append(uid)
        return {"expired": expired, "aborted_uploads": aborted}


class SimServer:
    """Reference: src/server/rpc_server.rs `SimServer`."""

    def __init__(self, lifecycle_interval: float = 3600.0) -> None:
        # period of the lifecycle enforcement job (a real S3 runs it
        # ~daily; an hour of virtual time keeps sim behavior observable)
        self.lifecycle_interval = lifecycle_interval
        self.service: Optional[S3Service] = None

    async def serve(self, addr: Any, on_bound=None) -> None:
        self.service = S3Service(rand.thread_rng())
        ep = await Endpoint.bind(addr)
        if on_bound is not None:
            on_bound(ep)

        async def lifecycle_ticker():
            it = sim_time.interval(self.lifecycle_interval)
            while True:
                await it.tick()
                self.service.apply_lifecycle(sim_time.now())

        spawn(lifecycle_ticker(), name="s3-lifecycle-tick")
        while True:
            tx, rx, _peer = await ep.accept1()
            spawn(self._handle(tx, rx), name="s3-conn")

    async def _handle(self, tx, rx) -> None:
        svc = self.service
        try:
            while (req := await rx.recv()) is not None:
                op, params = req
                try:
                    fn = getattr(svc, op, None)
                    if fn is None:
                        raise S3Error("NotImplemented", op)
                    if op in ("put_object", "copy_object", "complete_multipart_upload",
                              "create_multipart_upload"):
                        params = {**params, "now": sim_time.now()}
                    tx.send(("ok", fn(**params)))
                except S3Error as e:
                    tx.send(("err", (e.code, e.message)))
        except ConnectionReset:
            pass
        finally:
            tx.close()  # real mode: one fd per connection must not linger


# -- client --------------------------------------------------------------------


class Config:
    """Reference: src/config.rs (endpoint_url is the only knob that
    matters in-sim)."""

    def __init__(self, endpoint_url: str):
        self.endpoint_url = endpoint_url


class _FluentOp:
    """aws-sdk fluent builder: unknown attribute calls set parameters,
    `.send()` performs the request (reference: src/operation/*.rs)."""

    def __init__(self, client: "Client", op: str):
        self._client = client
        self._op = op
        self._params: Dict[str, Any] = {}

    def __getattr__(self, name: str):
        if name.startswith("_"):
            raise AttributeError(name)

        def setter(value: Any) -> "_FluentOp":
            self._params[name] = value
            return self

        return setter

    async def send(self):
        return await self._client._call(self._op, self._params)


class Client:
    """Reference: src/client.rs `Client::from_conf`."""

    _OPS = [
        "create_bucket",
        "delete_bucket",
        "put_object",
        "get_object",
        "head_object",
        "copy_object",
        "delete_object",
        "delete_objects",
        "list_objects_v2",
        "create_multipart_upload",
        "upload_part",
        "complete_multipart_upload",
        "abort_multipart_upload",
        "put_bucket_lifecycle_configuration",
        "get_bucket_lifecycle_configuration",
    ]

    def __init__(self, config: Config):
        self._endpoint_url = config.endpoint_url
        self._addr = parse_addr(config.endpoint_url.replace("http://", ""))
        self._caller: Optional[StreamCaller] = None
        # real mode with an HTTP(S3) endpoint reachable: genuine REST +
        # SigV4 passthrough (reference: madsim-aws-sdk-s3 non-sim build
        # re-exporting the real aws-sdk client)
        self._real = None

    @staticmethod
    def from_conf(config: Config) -> "Client":
        return Client(config)

    def __getattr__(self, name: str):
        if name in Client._OPS:
            return lambda: _FluentOp(self, name)
        raise AttributeError(name)

    async def close(self) -> None:
        """Release the backend (REST keep-alive connection or sim fd).
        The REST close contends with in-flight requests on the
        connection lock, so it runs off the event loop."""
        if self._real is not None:
            real, self._real = self._real, None
            from ...dual import IS_SIM

            if IS_SIM:
                real.close()
            else:
                import asyncio

                await asyncio.to_thread(real.close)
        if self._caller is not None:
            self._caller.close()
            self._caller = None

    async def _call(self, op: str, params: Dict[str, Any]):
        if self._caller is None and self._real is None:
            from ...dual import IS_SIM, real_passthrough_enabled

            if not IS_SIM and real_passthrough_enabled():
                from .real_client import probe_real_s3

                self._real = await probe_real_s3(self._endpoint_url)
        if self._real is not None:
            return await self._real.call(op, params)
        if self._caller is None:
            self._caller = StreamCaller()
            await self._caller.open(self._addr)
        idem = op in ("get_object", "head_object", "list_objects_v2",
                      "get_bucket_lifecycle_configuration")
        rsp = await self._caller.call((op, params), idempotent=idem)
        if rsp is None:
            raise S3Error("ServiceUnavailable", "s3 server unreachable")
        status, payload = rsp
        if status == "err":
            code, msg = payload
            raise S3Error(code, msg)
        return payload
