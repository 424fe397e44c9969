"""S3HttpGateway — genuine S3 REST wire (path-style, XML) served from
the sim `S3Service` state machine over asyncio streams; the inverse of
`real_client.py` and the s3 twin of the etcd gRPC gateway.

Used by in-process tests to prove the real-mode S3 passthrough speaks
the actual protocol, and by
`python -m madsim_tpu_torch serve --service s3 --http` to give real-mode apps
(or any S3 SDK pointed at the endpoint) an S3-compatible server.

Signatures are accepted but not verified (like minio's anonymous mode);
bind only on trusted interfaces."""

from __future__ import annotations

import asyncio
import datetime
import random
# madsim: allow-file(D001,D002) — genuine-wire S3 gateway: runs only
# against real clients on real sockets (request ids, lifecycle now).
import time
import urllib.parse
from email.utils import formatdate
from typing import Dict, Optional, Tuple

from . import S3Error, S3Service

__all__ = ["S3HttpGateway"]

_STATUS = {
    "NoSuchBucket": 404, "NoSuchKey": 404, "NoSuchUpload": 404,
    "BucketAlreadyExists": 409, "BucketNotEmpty": 409,
    "InvalidRange": 416, "InvalidArgument": 400, "NotImplemented": 501,
}
_REASONS = {200: "OK", 204: "No Content", 206: "Partial Content",
            400: "Bad Request", 404: "Not Found", 409: "Conflict",
            416: "Range Not Satisfiable", 501: "Not Implemented"}


class _Rng:
    def next_u64(self) -> int:
        return random.getrandbits(64)


def _iso(ts: float) -> str:
    return datetime.datetime.fromtimestamp(
        ts, tz=datetime.timezone.utc
    ).strftime("%Y-%m-%dT%H:%M:%S.000Z")


def _xml_escape(s: str) -> str:
    return (s.replace("&", "&amp;").replace("<", "&lt;").replace(">", "&gt;"))


class S3HttpGateway:
    def __init__(self, lifecycle_interval: float = 3600.0):
        self.svc = S3Service(_Rng())
        self.lifecycle_interval = lifecycle_interval
        self._server: Optional[asyncio.AbstractServer] = None
        self._lc_task: Optional[asyncio.Task] = None
        # open keep-alive connections; stop() must close them or
        # wait_closed() blocks on their handlers (3.12 semantics)
        self._writers: set = set()

    async def start(self, addr: str = "127.0.0.1:0") -> int:
        host, _, port = addr.rpartition(":")
        self._server = await asyncio.start_server(self._conn, host or "127.0.0.1", int(port))

        async def lifecycle():
            while True:
                await asyncio.sleep(self.lifecycle_interval)
                self.svc.apply_lifecycle(time.time())

        self._lc_task = asyncio.ensure_future(lifecycle())
        return self._server.sockets[0].getsockname()[1]

    async def wait(self) -> None:
        """Block until the server terminates (public CLI surface)."""
        await self._server.serve_forever()

    async def serve(self, addr: str) -> None:
        await self.start(addr)
        await self.wait()

    async def stop(self) -> None:
        if self._lc_task is not None:
            self._lc_task.cancel()
        for w in list(self._writers):
            w.close()
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()

    # -- HTTP plumbing --------------------------------------------------------

    async def _conn(self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter):
        self._writers.add(writer)
        try:
            while True:
                line = await reader.readline()
                if not line or line in (b"\r\n", b"\n"):
                    return
                try:
                    method, target, _ver = line.decode().split(None, 2)
                except ValueError:
                    return
                headers: Dict[str, str] = {}
                while True:
                    h = await reader.readline()
                    if h in (b"\r\n", b"\n", b""):
                        break
                    k, _, v = h.decode().partition(":")
                    headers[k.strip().lower()] = v.strip()
                n = int(headers.get("content-length", 0))
                body = await reader.readexactly(n) if n else b""
                status, out_headers, out_body = self._route(method, target, headers, body)
                reason = _REASONS.get(status, "Error")
                head = [f"HTTP/1.1 {status} {reason}"]
                out_headers.setdefault("content-length", str(len(out_body)))
                out_headers.setdefault("connection", "keep-alive")
                # S3 identity marker: every real implementation sets it,
                # and probe_real_s3 requires it (or an S3 XML root) to
                # distinguish a genuine store from a random HTTP server
                out_headers.setdefault(
                    "x-amz-request-id", f"{random.getrandbits(64):016X}"
                )
                head += [f"{k}: {v}" for k, v in out_headers.items()]
                writer.write(("\r\n".join(head) + "\r\n\r\n").encode())
                if method != "HEAD":
                    writer.write(out_body)
                await writer.drain()
        except (asyncio.IncompleteReadError, ConnectionResetError):
            pass
        finally:
            self._writers.discard(writer)
            writer.close()

    def _error(self, e: S3Error) -> Tuple[int, Dict[str, str], bytes]:
        body = (
            f'<?xml version="1.0"?><Error><Code>{_xml_escape(e.code)}</Code>'
            f"<Message>{_xml_escape(e.message)}</Message></Error>"
        ).encode()
        return _STATUS.get(e.code, 400), {"content-type": "application/xml"}, body

    @staticmethod
    def _obj_headers(info: dict) -> Dict[str, str]:
        h = {
            "etag": f'"{info["e_tag"]}"',
            "last-modified": formatdate(info["last_modified"], usegmt=True),
            "content-type": info.get("content_type", "binary/octet-stream"),
        }
        for k, v in (info.get("metadata") or {}).items():
            h[f"x-amz-meta-{k}"] = v
        return h

    # -- routing --------------------------------------------------------------

    def _route(self, method: str, target: str, headers, body) -> Tuple[int, Dict[str, str], bytes]:
        u = urllib.parse.urlsplit(target)
        q = dict(urllib.parse.parse_qsl(u.query, keep_blank_values=True))
        parts = u.path.lstrip("/").split("/", 1)
        bucket = urllib.parse.unquote(parts[0]) if parts[0] else ""
        key = urllib.parse.unquote(parts[1]) if len(parts) > 1 else ""
        try:
            return self._dispatch(method, bucket, key, q, headers, body)
        except S3Error as e:
            return self._error(e)

    def _dispatch(self, method, bucket, key, q, headers, body):
        svc = self.svc
        now = time.time()
        xml_hdr = {"content-type": "application/xml"}
        if not bucket:
            # ListBuckets — enough for SDK probes
            names = "".join(
                f"<Bucket><Name>{_xml_escape(b)}</Name></Bucket>" for b in sorted(svc.buckets)
            )
            return 200, xml_hdr, (
                f'<?xml version="1.0"?><ListAllMyBucketsResult><Buckets>{names}'
                f"</Buckets></ListAllMyBucketsResult>"
            ).encode()

        if not key:
            if method == "PUT" and "lifecycle" in q:
                import xml.etree.ElementTree as ET

                root = ET.fromstring(body)
                rules = []
                for r in root:
                    if not r.tag.endswith("Rule"):
                        continue
                    d = {c.tag.rsplit("}", 1)[-1]: c for c in r}
                    rule = {"id": d["ID"].text or "" if "ID" in d else "",
                            "status": d["Status"].text if "Status" in d else "Enabled"}
                    if "Filter" in d:
                        for c in d["Filter"]:
                            if c.tag.endswith("Prefix"):
                                rule["prefix"] = c.text or ""
                    if "Prefix" in d:
                        rule["prefix"] = d["Prefix"].text or ""
                    if "Expiration" in d:
                        for c in d["Expiration"]:
                            if c.tag.endswith("Days"):
                                rule["days"] = int(c.text)
                    if "AbortIncompleteMultipartUpload" in d:
                        for c in d["AbortIncompleteMultipartUpload"]:
                            if c.tag.endswith("DaysAfterInitiation"):
                                rule["abort_multipart_days"] = int(c.text)
                    rules.append(rule)
                svc.put_bucket_lifecycle_configuration(bucket, {"rules": rules})
                return 200, {}, b""
            if method == "GET" and "lifecycle" in q:
                cfg = svc.get_bucket_lifecycle_configuration(bucket)
                rules = []
                for r in cfg.get("rules", []):
                    seg = [f"<ID>{_xml_escape(r.get('id', ''))}</ID>",
                           f"<Status>{r.get('status', 'Enabled')}</Status>",
                           f"<Filter><Prefix>{_xml_escape(r.get('prefix', ''))}</Prefix></Filter>"]
                    if "days" in r:
                        seg.append(f"<Expiration><Days>{r['days']}</Days></Expiration>")
                    if "abort_multipart_days" in r:
                        seg.append(
                            "<AbortIncompleteMultipartUpload><DaysAfterInitiation>"
                            f"{r['abort_multipart_days']}"
                            "</DaysAfterInitiation></AbortIncompleteMultipartUpload>"
                        )
                    rules.append(f"<Rule>{''.join(seg)}</Rule>")
                return 200, xml_hdr, (
                    f'<?xml version="1.0"?><LifecycleConfiguration>{"".join(rules)}'
                    f"</LifecycleConfiguration>"
                ).encode()
            if method == "PUT":
                svc.create_bucket(bucket)
                return 200, {}, b""
            if method == "DELETE":
                svc.delete_bucket(bucket)
                return 204, {}, b""
            if method == "POST" and "delete" in q:
                import xml.etree.ElementTree as ET

                root = ET.fromstring(body)
                keys = [
                    c2.text or ""
                    for c in root if c.tag.endswith("Object")
                    for c2 in c if c2.tag.endswith("Key")
                ]
                out = svc.delete_objects(bucket, keys)
                deleted = "".join(
                    f"<Deleted><Key>{_xml_escape(k)}</Key></Deleted>" for k in out["deleted"]
                )
                return 200, xml_hdr, (
                    f'<?xml version="1.0"?><DeleteResult>{deleted}</DeleteResult>'
                ).encode()
            if method in ("GET", "HEAD") and q.get("list-type") == "2":
                import base64

                cont = q.get("continuation-token")
                if cont:
                    # tokens are opaque to clients (genuine S3 base64s
                    # them); the sim token contains a NUL separator that
                    # XML cannot carry raw
                    cont = base64.urlsafe_b64decode(cont).decode("utf-8")
                out = svc.list_objects_v2(
                    bucket,
                    prefix=q.get("prefix", ""),
                    continuation=cont,
                    max_keys=int(q.get("max-keys", 1000)),
                    delimiter=q.get("delimiter") or None,
                    start_after=q.get("start-after") or None,
                )
                contents = "".join(
                    "<Contents>"
                    f"<Key>{_xml_escape(c['key'])}</Key>"
                    f"<Size>{c['size']}</Size>"
                    f"<ETag>\"{c['e_tag']}\"</ETag>"
                    f"<LastModified>{_iso(c['last_modified'])}</LastModified>"
                    "</Contents>"
                    for c in out["contents"]
                )
                prefixes = "".join(
                    f"<CommonPrefixes><Prefix>{_xml_escape(cp['prefix'])}</Prefix></CommonPrefixes>"
                    for cp in out["common_prefixes"]
                )
                token = out["next_continuation_token"]
                if token:
                    token = base64.urlsafe_b64encode(token.encode("utf-8")).decode()
                token_xml = (
                    f"<NextContinuationToken>{token}</NextContinuationToken>"
                    if token else ""
                )
                return 200, xml_hdr, (
                    f'<?xml version="1.0"?><ListBucketResult>'
                    f"<IsTruncated>{'true' if out['is_truncated'] else 'false'}</IsTruncated>"
                    f"<KeyCount>{out['key_count']}</KeyCount>"
                    f"{contents}{prefixes}{token_xml}</ListBucketResult>"
                ).encode()
            raise S3Error("NotImplemented", f"{method} /{bucket}?{sorted(q)}")

        # -- object routes --
        if method == "POST" and "uploads" in q:
            out = svc.create_multipart_upload(bucket, key, now)
            return 200, xml_hdr, (
                f'<?xml version="1.0"?><InitiateMultipartUploadResult>'
                f"<Bucket>{_xml_escape(bucket)}</Bucket><Key>{_xml_escape(key)}</Key>"
                f"<UploadId>{out['upload_id']}</UploadId>"
                f"</InitiateMultipartUploadResult>"
            ).encode()
        if method == "POST" and "uploadId" in q:
            out = svc.complete_multipart_upload(q["uploadId"], now)
            return 200, xml_hdr | {"etag": f'"{out["e_tag"]}"'}, (
                f'<?xml version="1.0"?><CompleteMultipartUploadResult>'
                f"<ETag>\"{out['e_tag']}\"</ETag></CompleteMultipartUploadResult>"
            ).encode()
        if method == "PUT" and "uploadId" in q:
            out = svc.upload_part(q["uploadId"], int(q.get("partNumber", 0)), body)
            return 200, {"etag": f'"{out["e_tag"]}"'}, b""
        if method == "DELETE" and "uploadId" in q:
            svc.abort_multipart_upload(q["uploadId"])
            return 204, {}, b""
        if method == "PUT" and "x-amz-copy-source" in headers:
            src = headers["x-amz-copy-source"].lstrip("/")
            src_bucket, _, src_key = src.partition("/")
            out = svc.copy_object(
                urllib.parse.unquote(src_bucket), urllib.parse.unquote(src_key),
                bucket, key, now,
            )
            return 200, xml_hdr, (
                f'<?xml version="1.0"?><CopyObjectResult><ETag>"{out["e_tag"]}"</ETag>'
                f"<LastModified>{_iso(now)}</LastModified></CopyObjectResult>"
            ).encode()
        if method == "PUT":
            metadata = {
                k[len("x-amz-meta-"):]: v for k, v in headers.items()
                if k.startswith("x-amz-meta-")
            }
            out = svc.put_object(
                bucket, key, body, now,
                content_type=headers.get("content-type"),
                metadata=metadata or None,
            )
            return 200, {"etag": f'"{out["e_tag"]}"'}, b""
        if method == "GET":
            info = svc.get_object(bucket, key, range=headers.get("range"))
            h = self._obj_headers(info)
            if "content_range" in info:
                h["content-range"] = info["content_range"]
                return 206, h, info["body"]
            return 200, h, info["body"]
        if method == "HEAD":
            info = svc.head_object(bucket, key)
            h = self._obj_headers(info)
            h["content-length"] = str(info["content_length"])
            return 200, h, b""
        if method == "DELETE":
            svc.delete_object(bucket, key)
            return 204, {}, b""
        raise S3Error("NotImplemented", f"{method} /{bucket}/{key}")
