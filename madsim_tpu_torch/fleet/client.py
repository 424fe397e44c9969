"""Thin stdlib HTTP client for the fleet control plane.

`python -m madsim_tpu_torch fleet submit|status|result|cancel|queue` wrap
these calls; scripts can import them directly. Discovery mirrors the
server side: `--addr host:port`, or `--port-file PATH` (the file
`fleet serve --port-file` / `serve --port-file` writes atomically)
resolves to `127.0.0.1:<port>` without racing the daemon's startup.

Torch-free by construction — the client runs on boxes with no
accelerator stack at all.
"""

from __future__ import annotations

import json
import os
import random
import time
import urllib.error
import urllib.request
from typing import Iterator, Optional, Tuple

from . import httpd

DEFAULT_ADDR = "127.0.0.1:8142"

#: HTTP statuses worth retrying: the server is restarting or shedding
#: load, not rejecting the request. Every other status (400 validation,
#: 404, 409 not-terminal-yet) fails immediately — retrying a refusal
#: only hides it. 429 is retried too, but on the server's own schedule:
#: the admission layer names its price (Retry-After header +
#: `retry_after_s` body field) and the client honors it instead of
#: guessing with exponential backoff.
TRANSIENT_HTTP = frozenset({502, 503, 504})
DEFAULT_RETRIES = 5
RETRY_BACKOFF_S = 0.1
RETRY_BACKOFF_MAX_S = 2.0


class FleetClientError(RuntimeError):
    def __init__(self, status: int, message: str,
                 retry_after: Optional[float] = None):
        super().__init__(f"HTTP {status}: {message}")
        self.status = status
        #: the server's Retry-After in seconds (429 admission refusals;
        #: the JSON body's sub-second `retry_after_s` wins over the
        #: header's integer rendering), None when the server named none
        self.retry_after = retry_after


def resolve_addr(addr: Optional[str] = None,
                 port_file: Optional[str] = None,
                 wait_s: float = 5.0) -> str:
    """Pick the daemon address: explicit --addr wins, then --port-file
    (polled up to `wait_s` — the file appears atomically once the
    server has bound), then $MADSIM_TPU_FLEET_ADDR, then the default."""
    if addr:
        return addr
    if port_file:
        # madsim: allow(D001) — host-side startup-discovery poll
        deadline = time.monotonic() + wait_s
        while True:
            try:
                return f"127.0.0.1:{httpd.read_port_file(port_file)}"
            except (OSError, ValueError):
                if time.monotonic() > deadline:  # madsim: allow(D001)
                    raise RuntimeError(
                        f"port file {port_file!r} did not appear within "
                        f"{wait_s}s — is the daemon running?"
                    ) from None
                time.sleep(0.05)  # madsim: allow(D001)
    return os.environ.get("MADSIM_TPU_FLEET_ADDR", DEFAULT_ADDR)


def _request_once(addr: str, method: str, path: str,
                  body: Optional[dict], timeout: float) -> Tuple[int, dict]:
    data = json.dumps(body).encode() if body is not None else None
    req = urllib.request.Request(
        f"http://{addr}{path}", data=data, method=method,
        headers={"Content-Type": "application/json"} if data else {},
    )
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, json.loads(resp.read().decode() or "{}")
    except urllib.error.HTTPError as exc:
        payload = exc.read().decode(errors="replace")
        retry_after = None
        try:
            doc = json.loads(payload)
            msg = doc.get("error", payload)
            if doc.get("retry_after_s") is not None:
                retry_after = float(doc["retry_after_s"])
        except (json.JSONDecodeError, TypeError, ValueError):
            msg = payload
        if retry_after is None:
            try:
                retry_after = float(exc.headers.get("Retry-After"))
            except (TypeError, ValueError):
                retry_after = None
        raise FleetClientError(exc.code, msg, retry_after) from None


def request(addr: str, method: str, path: str,
            body: Optional[dict] = None,
            timeout: float = 30.0,
            retries: int = DEFAULT_RETRIES) -> Tuple[int, dict]:
    """One control-plane call, with transient-failure retry: connection
    refused/reset (the daemon is restarting — `fleet serve` comes back
    on the same port-file), socket timeouts, and 502/503/504 are
    retried up to `retries` times with seeded-jitter exponential
    backoff; every other HTTP error raises immediately. `retries=0`
    (the `--no-retry` escape hatch) restores fail-fast.

    The jitter RNG is SEEDED from (method, path) — the repo's
    discipline extends to its backoff schedules: two runs of the same
    verb jitter identically, so a chaos failure replays.

    Caveat: a connection cut AFTER the server processed a POST but
    before the response arrived retries into a second submit (two
    identical jobs, distinct ids). The store runs both to the same
    byte-identical report, so the cost is compute, not correctness."""
    rng = random.Random(f"fleet-client {method} {path}")
    attempt = 0
    while True:
        try:
            return _request_once(addr, method, path, body, timeout)
        except FleetClientError as exc:
            retryable = exc.status in TRANSIENT_HTTP or exc.status == 429
            if not retryable or attempt >= retries:
                raise
            if exc.status == 429 and exc.retry_after is not None:
                # admission refusal: wait what the server asked, plus
                # seeded jitter so a shed burst doesn't re-arrive as
                # one synchronized herd
                time.sleep(exc.retry_after  # madsim: allow(D001)
                           + RETRY_BACKOFF_S * rng.random())
                attempt += 1
                continue
        except (urllib.error.URLError, ConnectionError, TimeoutError,
                OSError):
            # URLError wraps ECONNREFUSED during a server restart
            if attempt >= retries:
                raise
        delay = min(RETRY_BACKOFF_S * (2 ** attempt), RETRY_BACKOFF_MAX_S)
        time.sleep(delay * (0.5 + rng.random()))  # madsim: allow(D001)
        attempt += 1


def submit(addr: str, spec: dict, *, priority: int = 0,
           deadline_s: Optional[float] = None,
           tenant: Optional[str] = None,
           retries: int = DEFAULT_RETRIES) -> dict:
    doc = {"spec": spec, "priority": priority}
    if deadline_s:
        doc["deadline_s"] = deadline_s
    if tenant:
        doc["tenant"] = tenant  # admission accounting, not spec
    _, out = request(addr, "POST", "/jobs", doc, retries=retries)
    return out


def status(addr: str, job_id: str, feed: int = 20, wait: float = 0,
           retries: int = DEFAULT_RETRIES) -> dict:
    """Job doc + live feed. `wait > 0` long-polls: the server holds the
    request until the job document or its stats feed changes (or the
    window — capped server-side — elapses), so watchers make one
    request per state change instead of busy-polling. The client
    timeout stretches past the wait window."""
    path = f"/jobs/{job_id}?feed={feed}"
    if wait:
        path += f"&wait={wait:g}"
    _, out = request(addr, "GET", path, timeout=30.0 + float(wait),
                     retries=retries)
    return out


def result(addr: str, job_id: str,
           retries: int = DEFAULT_RETRIES) -> dict:
    _, out = request(addr, "GET", f"/jobs/{job_id}/result",
                     retries=retries)
    return out


def cancel(addr: str, job_id: str,
           retries: int = DEFAULT_RETRIES) -> dict:
    _, out = request(addr, "DELETE", f"/jobs/{job_id}", retries=retries)
    return out


def queue(addr: str, retries: int = DEFAULT_RETRIES) -> dict:
    _, out = request(addr, "GET", "/queue", retries=retries)
    return out


def timeline(addr: str, job_id: str,
             retries: int = DEFAULT_RETRIES) -> dict:
    """The merged cross-process Perfetto timeline for a job."""
    _, out = request(addr, "GET", f"/jobs/{job_id}/timeline",
                     retries=retries)
    return out


def profile(addr: str, job_id: str,
            retries: int = DEFAULT_RETRIES) -> dict:
    """The three-clock merged profile for a job: the timeline's host
    plane + the worker's device-profile capture and failing-lane
    virtual trace (present when the worker ran under
    MADSIM_TPU_XPROF=1), aligned by xprof clock-sync markers."""
    _, out = request(addr, "GET", f"/jobs/{job_id}/profile",
                     retries=retries)
    return out


# -- the SSE tail (push, not poll) ----------------------------------------


def parse_sse(fp) -> Iterator[dict]:
    """Parse a Server-Sent-Events byte stream into
    `{"id", "event", "data"}` frames (data JSON-decoded when possible).
    Factored off the socket so the parser unit-tests against a
    BytesIO."""
    frame: dict = {}
    for raw in fp:
        line = raw.decode("utf-8", errors="replace").rstrip("\r\n")
        if not line:
            if "data" in frame or "event" in frame:
                data = frame.get("data")
                try:
                    frame["data"] = json.loads(data) if data else None
                except json.JSONDecodeError:
                    pass  # leave the raw string — the caller decides
                yield frame
            frame = {}
            continue
        if line.startswith(":"):
            continue  # SSE comment / keepalive
        key, _, value = line.partition(":")
        value = value[1:] if value.startswith(" ") else value
        if key == "data" and "data" in frame:
            frame["data"] += "\n" + value
        elif key in ("id", "event", "data", "retry"):
            frame[key] = value
    if "data" in frame or "event" in frame:
        yield frame


def iter_events(addr: str, job_id: str, since: int = 0,
                timeout: float = 45.0) -> Iterator[dict]:
    """Tail a job's event stream: yields each SSE frame, transparently
    reconnecting with `since=<last id>` when the server's tail-poll
    window closes the stream. Ends (without reconnecting) after an
    `end` frame — the job reached a terminal state — or an `error`
    frame. The per-request timeout must outlast the server's
    WAIT_CAP_S window."""
    cursor = int(since)
    while True:
        req = urllib.request.Request(
            f"http://{addr}/jobs/{job_id}/events?since={cursor}",
            headers={"Accept": "text/event-stream"},
        )
        try:
            with urllib.request.urlopen(req, timeout=timeout) as resp:
                for frame in parse_sse(resp):
                    ev = frame.get("event")
                    if frame.get("id"):
                        try:
                            cursor = max(cursor, int(frame["id"]))
                        except ValueError:
                            pass
                    if ev == "error":
                        data = frame.get("data")
                        msg = (data or {}).get("error") if isinstance(
                            data, dict) else str(data)
                        raise FleetClientError(503, msg or "stream error")
                    yield frame
                    if ev == "end":
                        return
        except urllib.error.HTTPError as exc:
            payload = exc.read().decode(errors="replace")
            try:
                msg = json.loads(payload).get("error", payload)
            except json.JSONDecodeError:
                msg = payload
            raise FleetClientError(exc.code, msg) from None
        # stream closed without `end`: the tail-poll window elapsed —
        # reconnect from the cursor (push-not-poll with bounded parks)
