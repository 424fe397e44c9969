"""Real-client passthrough for S3 — the analogue of the reference's
non-sim build re-exporting the genuine aws-sdk-s3 client
(`madsim-aws-sdk-s3/src/lib.rs` non-sim re-export).

`RealS3Backend` speaks the genuine S3 REST protocol (path-style
addressing, AWS Signature V4, XML bodies) with nothing but the standard
library — the protocol, not a vendor SDK, is what the reference's dual
build guarantees. It translates the sim Client's `(op, params)` calls
into signed HTTP requests and parses responses back into the exact
payload shapes `S3Service` produces, so app code can't tell which
backend answered.

Credentials come from the standard env vars (`AWS_ACCESS_KEY_ID`,
`AWS_SECRET_ACCESS_KEY`, optional `AWS_SESSION_TOKEN`, region from
`AWS_REGION`/`AWS_DEFAULT_REGION`, default us-east-1). Works against
AWS and S3-compatible stores (minio, localstack) and against
`python -m madsim_tpu_torch serve --service s3 --http` (real_gateway.py).

The SigV4 signer is validated against AWS's published signature test
vector (tests/test_s3_real.py)."""

from __future__ import annotations

import asyncio
import datetime
import hashlib
import hmac
import http.client
import os
import urllib.parse
import xml.etree.ElementTree as ET
from email.utils import parsedate_to_datetime
from typing import Dict, Optional, Tuple

from . import S3Error

_EMPTY_SHA256 = hashlib.sha256(b"").hexdigest()


# -- AWS Signature V4 (stdlib) ------------------------------------------------


def _hmac(key: bytes, msg: str) -> bytes:
    return hmac.new(key, msg.encode(), hashlib.sha256).digest()


def _uri_encode(s: str, encode_slash: bool = True) -> str:
    safe = "-_.~" if encode_slash else "-_.~/"
    return urllib.parse.quote(s, safe=safe)


def sigv4_sign(
    method: str,
    path: str,
    query: Dict[str, str],
    headers: Dict[str, str],
    payload_hash: str,
    *,
    access_key: str,
    secret_key: str,
    region: str,
    service: str = "s3",
    amz_date: str,
) -> str:
    """Returns the Authorization header value (AWS SigV4, single chunk).

    Pure function of its inputs so it can be checked against AWS's
    published test vectors."""
    date = amz_date[:8]
    canonical_query = "&".join(
        f"{_uri_encode(k)}={_uri_encode(str(v))}" for k, v in sorted(query.items())
    )
    lower = {k.lower(): " ".join(str(v).split()) for k, v in headers.items()}
    signed_headers = ";".join(sorted(lower))
    canonical_headers = "".join(f"{k}:{lower[k]}\n" for k in sorted(lower))
    canonical_request = "\n".join(
        [method, _uri_encode(path, encode_slash=False), canonical_query,
         canonical_headers, signed_headers, payload_hash]
    )
    scope = f"{date}/{region}/{service}/aws4_request"
    string_to_sign = "\n".join(
        ["AWS4-HMAC-SHA256", amz_date, scope,
         hashlib.sha256(canonical_request.encode()).hexdigest()]
    )
    k = _hmac(_hmac(_hmac(_hmac(b"AWS4" + secret_key.encode(), date), region), service),
              "aws4_request")
    signature = hmac.new(k, string_to_sign.encode(), hashlib.sha256).hexdigest()
    return (
        f"AWS4-HMAC-SHA256 Credential={access_key}/{scope}, "
        f"SignedHeaders={signed_headers}, Signature={signature}"
    )


# -- XML helpers --------------------------------------------------------------


def _strip_ns(tag: str) -> str:
    return tag.rsplit("}", 1)[-1]


def _xml_escape(s: str) -> str:
    return s.replace("&", "&amp;").replace("<", "&lt;").replace(">", "&gt;")


def _xml_dict(elem) -> dict:
    return {_strip_ns(c.tag): c for c in elem}


def _text(elem, name: str, default: str = "") -> str:
    for c in elem:
        if _strip_ns(c.tag) == name:
            return c.text or ""
    return default


def _epoch(iso_or_http: str) -> float:
    """ISO8601 (XML) or RFC7231 (Last-Modified header) -> epoch float."""
    if not iso_or_http:
        return 0.0
    try:
        return datetime.datetime.fromisoformat(
            iso_or_http.replace("Z", "+00:00")
        ).timestamp()
    except ValueError:
        try:
            return parsedate_to_datetime(iso_or_http).timestamp()
        except (TypeError, ValueError):
            return 0.0


class RealS3Backend:
    """(op, params) -> signed REST call -> sim-shaped payload."""

    def __init__(self, host: str, port: int, *, access_key: str, secret_key: str,
                 region: str, session_token: Optional[str] = None, timeout: float = 10.0,
                 tls: bool = False):
        import threading

        self.host = host
        self.port = port
        self.tls = tls
        self.access_key = access_key
        self.secret_key = secret_key
        self.session_token = session_token
        self.region = region
        self.timeout = timeout
        # one cached keep-alive connection, serialized: http.client
        # connections are not thread-safe and asyncio.to_thread may run
        # requests on different worker threads
        self._conn_lock = threading.Lock()
        self._conn = None

    @classmethod
    def from_env(cls, endpoint_url: str, timeout: float = 10.0) -> "RealS3Backend":
        u = urllib.parse.urlparse(
            endpoint_url if "://" in endpoint_url else f"http://{endpoint_url}"
        )
        tls = u.scheme == "https"
        return cls(
            u.hostname or "127.0.0.1", u.port or (443 if tls else 80), tls=tls,
            access_key=os.environ.get("AWS_ACCESS_KEY_ID", "madsim"),
            secret_key=os.environ.get("AWS_SECRET_ACCESS_KEY", "madsim"),
            session_token=os.environ.get("AWS_SESSION_TOKEN"),
            region=os.environ.get("AWS_REGION")
            or os.environ.get("AWS_DEFAULT_REGION", "us-east-1"),
            timeout=timeout,
        )

    # -- transport ------------------------------------------------------------

    def _request_sync(self, method: str, path: str, query: Dict[str, str],
                      headers: Dict[str, str], body: bytes) -> Tuple[int, Dict[str, str], bytes]:
        payload_hash = hashlib.sha256(body).hexdigest() if body else _EMPTY_SHA256
        # madsim: allow(D001) — SigV4 signing needs the real UTC date
        amz_date = datetime.datetime.now(datetime.timezone.utc).strftime("%Y%m%dT%H%M%SZ")
        h = dict(headers)
        default_port = 443 if self.tls else 80
        h["host"] = (
            self.host if self.port == default_port else f"{self.host}:{self.port}"
        )
        h["x-amz-date"] = amz_date
        h["x-amz-content-sha256"] = payload_hash
        if self.session_token:
            h["x-amz-security-token"] = self.session_token
        h["Authorization"] = sigv4_sign(
            method, path, query, h, payload_hash,
            access_key=self.access_key, secret_key=self.secret_key,
            region=self.region, amz_date=amz_date,
        )
        # the wire must carry EXACTLY the octets the signature
        # canonicalized: same percent-encoding for path and query
        enc_path = _uri_encode(path, encode_slash=False)
        qs = "&".join(
            f"{_uri_encode(k)}={_uri_encode(str(v))}" for k, v in sorted(query.items())
        )
        target = enc_path + (f"?{qs}" if qs else "")
        conn_cls = http.client.HTTPSConnection if self.tls else http.client.HTTPConnection
        idempotent = method in ("GET", "HEAD")
        with self._conn_lock:
            # keep-alive reuse; a stale cached connection (server closed
            # it between requests) gets one reconnect — but only when the
            # failure is provably pre-response: a SEND-time error always
            # (the server saw nothing complete), a response-time error
            # only for idempotent reads. A mutation whose response was
            # lost is ambiguous (the server may have applied it) and is
            # surfaced, never blindly re-sent — the retry discipline
            # services/_conn.py:32-37 documents for the sim protocol.
            for attempt in (0, 1):
                if self._conn is None:
                    self._conn = conn_cls(self.host, self.port, timeout=self.timeout)
                sent = False
                try:
                    self._conn.request(method, target, body=body or None, headers=h)
                    sent = True
                    rsp = self._conn.getresponse()
                    data = rsp.read()
                    return rsp.status, {k.lower(): v for k, v in rsp.getheaders()}, data
                except (http.client.HTTPException, ConnectionError, BrokenPipeError):
                    self._conn.close()
                    self._conn = None
                    if attempt or (sent and not idempotent):
                        raise
            raise AssertionError("unreachable")

    def close(self) -> None:
        with self._conn_lock:
            if self._conn is not None:
                self._conn.close()
                self._conn = None

    async def _request(self, method: str, path: str, query=None, headers=None,
                       body: bytes = b"") -> Tuple[int, Dict[str, str], bytes]:
        return await asyncio.to_thread(
            self._request_sync, method, path, dict(query or {}), dict(headers or {}), body
        )

    @staticmethod
    def _raise(status: int, data: bytes) -> None:
        code, msg = "UnknownError", f"http {status}"
        if data:
            try:
                root = ET.fromstring(data)
                code = _text(root, "Code", code)
                msg = _text(root, "Message", msg)
            except ET.ParseError:
                pass
        elif status == 404:
            code = "NoSuchKey"
        raise S3Error(code, msg)

    # -- op dispatch (the SimServer request enum, over REST) ------------------

    async def call(self, op: str, p: Dict) -> Dict:
        fn = getattr(self, f"_op_{op}", None)
        if fn is None:
            raise S3Error("NotImplemented", f"{op} has no real-mode mapping")
        return await fn(p)

    async def _op_create_bucket(self, p):
        st, _h, data = await self._request("PUT", f"/{p['bucket']}")
        if st not in (200, 204):
            self._raise(st, data)
        return {"location": f"/{p['bucket']}"}

    async def _op_delete_bucket(self, p):
        st, _h, data = await self._request("DELETE", f"/{p['bucket']}")
        if st not in (200, 204):
            self._raise(st, data)
        return {}

    async def _op_put_object(self, p):
        headers = {}
        if p.get("content_type"):
            headers["content-type"] = p["content_type"]
        for k, v in (p.get("metadata") or {}).items():
            headers[f"x-amz-meta-{k}"] = v
        body = p.get("body", b"")
        if isinstance(body, str):
            body = body.encode()
        st, h, data = await self._request(
            "PUT", f"/{p['bucket']}/{p['key']}", headers=headers, body=bytes(body)
        )
        if st != 200:
            self._raise(st, data)
        return {"e_tag": h.get("etag", "").strip('"')}

    async def _op_get_object(self, p, want_body: bool = True):
        headers = {}
        if p.get("range"):
            headers["range"] = p["range"]
        st, h, data = await self._request(
            "GET" if want_body else "HEAD", f"/{p['bucket']}/{p['key']}", headers=headers
        )
        if st not in (200, 206):
            self._raise(st, data)
        out = {
            "e_tag": h.get("etag", "").strip('"'),
            "last_modified": _epoch(h.get("last-modified", "")),
            "content_type": h.get("content-type", "binary/octet-stream"),
            "metadata": {
                k[len("x-amz-meta-"):]: v for k, v in h.items()
                if k.startswith("x-amz-meta-")
            },
        }
        if want_body:
            out["body"] = data
            out["content_length"] = len(data)
            if "content-range" in h:
                out["content_range"] = h["content-range"]
        else:
            out["content_length"] = int(h.get("content-length", 0))
        return out

    async def _op_head_object(self, p):
        return await self._op_get_object(p, want_body=False)

    async def _op_copy_object(self, p):
        headers = {"x-amz-copy-source": f"/{p['src_bucket']}/{p['src_key']}"}
        st, h, data = await self._request(
            "PUT", f"/{p['bucket']}/{p['key']}", headers=headers
        )
        if st != 200:
            self._raise(st, data)
        etag = h.get("etag", "").strip('"')
        if data:
            try:
                etag = _text(ET.fromstring(data), "ETag", etag).strip('"')
            except ET.ParseError:
                pass
        return {"e_tag": etag}

    async def _op_delete_object(self, p):
        st, _h, data = await self._request("DELETE", f"/{p['bucket']}/{p['key']}")
        if st not in (200, 204):
            self._raise(st, data)
        return {}

    async def _op_delete_objects(self, p):
        objs = "".join(
            f"<Object><Key>{_xml_escape(k)}</Key></Object>" for k in p.get("keys", [])
        )
        body = f'<?xml version="1.0"?><Delete>{objs}</Delete>'.encode()
        import base64

        headers = {"content-md5": base64.b64encode(hashlib.md5(body).digest()).decode()}
        st, _h, data = await self._request(
            "POST", f"/{p['bucket']}", query={"delete": ""}, headers=headers, body=body
        )
        if st != 200:
            self._raise(st, data)
        root = ET.fromstring(data)
        return {"deleted": [
            _text(c, "Key") for c in root if _strip_ns(c.tag) == "Deleted"
        ]}

    async def _op_list_objects_v2(self, p):
        query = {"list-type": "2"}
        if p.get("prefix"):
            query["prefix"] = p["prefix"]
        if p.get("continuation"):
            query["continuation-token"] = p["continuation"]
        if p.get("max_keys"):
            query["max-keys"] = str(p["max_keys"])
        if p.get("delimiter"):
            query["delimiter"] = p["delimiter"]
        if p.get("start_after"):
            query["start-after"] = p["start_after"]
        st, _h, data = await self._request("GET", f"/{p['bucket']}", query=query)
        if st != 200:
            self._raise(st, data)
        root = ET.fromstring(data)
        contents, common = [], []
        for c in root:
            tag = _strip_ns(c.tag)
            if tag == "Contents":
                contents.append({
                    "key": _text(c, "Key"),
                    "size": int(_text(c, "Size", "0")),
                    "e_tag": _text(c, "ETag").strip('"'),
                    "last_modified": _epoch(_text(c, "LastModified")),
                })
            elif tag == "CommonPrefixes":
                common.append({"prefix": _text(c, "Prefix")})
        token = _text(root, "NextContinuationToken") or None
        return {
            "contents": contents,
            "common_prefixes": common,
            "is_truncated": _text(root, "IsTruncated") == "true",
            "next_continuation_token": token,
            "key_count": int(_text(root, "KeyCount", "0") or 0),
        }

    async def _op_create_multipart_upload(self, p):
        st, _h, data = await self._request(
            "POST", f"/{p['bucket']}/{p['key']}", query={"uploads": ""}
        )
        if st != 200:
            self._raise(st, data)
        root = ET.fromstring(data)
        upload_id = _text(root, "UploadId")
        self._mpu = getattr(self, "_mpu", {})
        self._mpu[upload_id] = (p["bucket"], p["key"], {})
        return {"upload_id": upload_id}

    async def _op_upload_part(self, p):
        bucket, key, etags = self._mpu_entry(p["upload_id"])
        body = p.get("body", b"")
        if isinstance(body, str):
            body = body.encode()
        st, h, data = await self._request(
            "PUT", f"/{bucket}/{key}",
            query={"partNumber": str(p["part_number"]), "uploadId": p["upload_id"]},
            body=bytes(body),
        )
        if st != 200:
            self._raise(st, data)
        etag = h.get("etag", "").strip('"')
        etags[p["part_number"]] = etag
        return {"e_tag": etag}

    async def _op_complete_multipart_upload(self, p):
        bucket, key, etags = self._mpu_entry(p["upload_id"])
        parts = "".join(
            f"<Part><PartNumber>{n}</PartNumber><ETag>\"{etags[n]}\"</ETag></Part>"
            for n in sorted(etags)
        )
        body = (
            f'<?xml version="1.0"?><CompleteMultipartUpload>{parts}'
            f"</CompleteMultipartUpload>"
        ).encode()
        st, h, data = await self._request(
            "POST", f"/{bucket}/{key}", query={"uploadId": p["upload_id"]}, body=body
        )
        if st != 200:
            self._raise(st, data)
        self._mpu.pop(p["upload_id"], None)
        etag = h.get("etag", "").strip('"')
        if data:
            try:
                etag = _text(ET.fromstring(data), "ETag", etag).strip('"')
            except ET.ParseError:
                pass
        return {"e_tag": etag}

    async def _op_abort_multipart_upload(self, p):
        bucket, key, _etags = self._mpu_entry(p["upload_id"])
        st, _h, data = await self._request(
            "DELETE", f"/{bucket}/{key}", query={"uploadId": p["upload_id"]}
        )
        if st not in (200, 204):
            self._raise(st, data)
        self._mpu.pop(p["upload_id"], None)
        return {}

    def _mpu_entry(self, upload_id: str):
        entry = getattr(self, "_mpu", {}).get(upload_id)
        if entry is None:
            raise S3Error("NoSuchUpload", upload_id)
        return entry

    async def _op_put_bucket_lifecycle_configuration(self, p):
        rules = []
        for r in (p.get("config") or {}).get("rules", []):
            parts = [f"<ID>{_xml_escape(r.get('id', ''))}</ID>",
                     f"<Status>{r.get('status', 'Enabled')}</Status>",
                     f"<Filter><Prefix>{_xml_escape(r.get('prefix', ''))}</Prefix></Filter>"]
            if "days" in r:
                parts.append(f"<Expiration><Days>{r['days']}</Days></Expiration>")
            if "abort_multipart_days" in r:
                parts.append(
                    "<AbortIncompleteMultipartUpload><DaysAfterInitiation>"
                    f"{r['abort_multipart_days']}"
                    "</DaysAfterInitiation></AbortIncompleteMultipartUpload>"
                )
            rules.append(f"<Rule>{''.join(parts)}</Rule>")
        body = (
            f'<?xml version="1.0"?><LifecycleConfiguration>{"".join(rules)}'
            f"</LifecycleConfiguration>"
        ).encode()
        import base64

        headers = {"content-md5": base64.b64encode(hashlib.md5(body).digest()).decode()}
        st, _h, data = await self._request(
            "PUT", f"/{p['bucket']}", query={"lifecycle": ""}, headers=headers, body=body
        )
        if st not in (200, 204):
            self._raise(st, data)
        return {}

    async def _op_get_bucket_lifecycle_configuration(self, p):
        st, _h, data = await self._request(
            "GET", f"/{p['bucket']}", query={"lifecycle": ""}
        )
        if st == 404:
            return {"rules": []}
        if st != 200:
            self._raise(st, data)
        rules = []
        root = ET.fromstring(data)
        for r in root:
            if _strip_ns(r.tag) != "Rule":
                continue
            d = _xml_dict(r)
            rule = {"id": _text(r, "ID"), "status": _text(r, "Status", "Enabled")}
            if "Filter" in d:
                rule["prefix"] = _text(d["Filter"], "Prefix")
            elif "Prefix" in d:
                rule["prefix"] = d["Prefix"].text or ""
            if "Expiration" in d:
                rule["days"] = int(_text(d["Expiration"], "Days", "0"))
            if "AbortIncompleteMultipartUpload" in d:
                rule["abort_multipart_days"] = int(
                    _text(d["AbortIncompleteMultipartUpload"], "DaysAfterInitiation", "0")
                )
            rules.append(rule)
        return {"rules": rules}


async def probe_real_s3(endpoint_url: str, timeout: float = 2.0) -> Optional[RealS3Backend]:
    """Endpoint answers HTTP like an S3 store -> backend; else None
    (caller falls back to the sim pickle protocol)."""
    backend = RealS3Backend.from_env(endpoint_url, timeout=timeout)
    try:
        st, headers, data = await backend._request("GET", "/")
    except Exception:
        return None
    # An HTTP answer alone is not enough — any web server would match,
    # locking a misconfigured app onto the REST path with opaque XML
    # errors instead of the documented sim-protocol fallback. Require an
    # S3-specific marker: the x-amz-request-id/x-amz-id-2 headers every
    # S3 implementation (AWS, MinIO, ceph-rgw, our gateway) sets, or an
    # S3 XML document root (ListAllMyBucketsResult on 200, Error with an
    # S3 error code otherwise).
    if not (100 <= st <= 599):
        return None
    hdrs = {k.lower() for k in headers} if headers else set()
    s3_marker = "x-amz-request-id" in hdrs or "x-amz-id-2" in hdrs
    if not s3_marker and data:
        try:
            root_tag = _strip_ns(ET.fromstring(data).tag)
            s3_marker = root_tag in ("ListAllMyBucketsResult", "Error")
        except ET.ParseError:
            s3_marker = False
    if not s3_marker:
        return None
    # the short PROBE deadline must not become the per-request
    # socket timeout for real operations (etcd learned this too)
    backend.timeout = 30.0
    backend.close()  # drop the probe-deadline connection
    return backend
