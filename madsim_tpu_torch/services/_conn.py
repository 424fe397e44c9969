"""Broker-connection strategy shared by the kafka/s3 service clients.

Sim mode: one fresh connect1 channel per request. Channels are free in
the simulator, and a timed-out/abandoned call then abandons only its own
channel — no request/response correlation needed, concurrent callers
cannot desynchronize.

Real mode: one PERSISTENT stream guarded by a lock (the per-call pattern
would churn a real TCP connection per request — an idle consumer poll
loop alone would cycle ~100 sockets/sec into TIME_WAIT). The stream is
reopened once on failure; a cancellation mid-call (timeout) drops the
stream so a late response can never be mis-paired with the next request.

The servers already speak both shapes: their handlers loop
`while (req := await rx.recv()) is not None`, serving one connection for
one or many requests.
"""

from __future__ import annotations

from typing import Any, Optional

from ..dual import IS_SIM, net as _dual_net
from ..net.network import ConnectionReset

Endpoint = _dual_net.Endpoint


class StreamCaller:
    """`await call(req) -> response payload | None` (None = unavailable).

    `idempotent=True` marks requests safe to transparently re-send after
    a response was lost mid-flight (reads). Mutations are only retried
    when the failure happened at SEND time on a stale cached stream —
    provably before the server saw anything — never after an ambiguous
    response loss (a blind produce/create retry would silently duplicate
    the operation)."""

    def __init__(self) -> None:
        self._ep = None
        self._addr = None
        self._stream = None  # (tx, rx), real mode only
        self._lock = None

    async def open(self, addr) -> None:
        self._ep = await Endpoint.bind(("0.0.0.0", 0))
        self._addr = addr
        if not IS_SIM:
            import asyncio

            self._lock = asyncio.Lock()

    async def call(self, req: tuple, idempotent: bool = False) -> Optional[Any]:
        if IS_SIM:
            tx, rx = await self._ep.connect1(self._addr)
            try:
                tx.send(req)
                return await rx.recv()
            finally:
                tx.close()

        async with self._lock:
            try:
                # separate budgets: a send-time reconnect is provably safe
                # (nothing reached the server) and must not consume the
                # single ambiguous-loss retry an idempotent request gets
                send_retries = 1
                loss_retries = 1 if idempotent else 0
                while True:
                    if self._stream is None:
                        try:
                            self._stream = await self._ep.connect1(self._addr)
                        except (ConnectionReset, OSError):
                            # server down/refusing: "unavailable", not a
                            # raw exception out of the drop-in client API
                            if send_retries > 0:
                                send_retries -= 1
                                continue
                            return None
                    tx, rx = self._stream
                    try:
                        tx.send(req)
                    except (ConnectionReset, OSError):
                        # stale cached stream detected before anything left
                        # this process: always safe to reopen + retry
                        self._drop_stream()
                        if send_retries > 0:
                            send_retries -= 1
                            continue
                        return None
                    try:
                        rsp = await rx.recv()
                    except (ConnectionReset, OSError):
                        # OSError: socket failures the real transport does
                        # not map (ETIMEDOUT, broken pipe, ...) — same
                        # "unavailable" outcome, never a raw exception out
                        # of the drop-in client API
                        rsp = None
                    if rsp is None:
                        # request may or may not have been applied
                        self._drop_stream()
                        if loss_retries > 0:
                            loss_retries -= 1
                            continue
                        return None
                    return rsp
            except BaseException:
                # cancellation (call timeout) or unexpected error mid-call:
                # the stream may carry an unconsumed response — drop it
                self._drop_stream()
                raise

    async def open_stream(self):
        """Open a DEDICATED (tx, rx) channel to the server, outside the
        shared unary stream — for long-lived subscriptions (etcd watch/
        observe). Connect failures surface as ConnectionReset so callers
        can map them to their drop-in typed error."""
        try:
            return await self._ep.connect1(self._addr)
        except ConnectionReset:
            raise
        except OSError as e:
            raise ConnectionReset(str(e)) from e

    def _drop_stream(self) -> None:
        if self._stream is not None:
            tx, _rx = self._stream
            try:
                tx.close()
            except Exception:  # noqa: BLE001 - best-effort teardown
                pass
            self._stream = None

    def close(self) -> None:
        """Release the cached stream and the local endpoint (real mode:
        the TCP fd) — client `close()` must not leak per-backend."""
        self._drop_stream()
        if self._ep is not None:
            try:
                self._ep.close()
            except Exception:  # noqa: BLE001 - best-effort teardown
                pass
            self._ep = None
