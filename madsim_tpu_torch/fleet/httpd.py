"""Shared HTTP daemon glue — realized-port files + graceful SIGTERM.

The port of `madsim_tpu/fleet/httpd.py`. `serve --service stats` is a
stdlib `ThreadingHTTPServer` daemon that tests and supervisors need to
discover WITHOUT racing: binding `--addr host:0` already prints the
realized port, but a supervisor parsing stdout is a race.
`--port-file PATH` writes the realized port atomically after the socket
exists — a poller sees either no file or a complete port.

Graceful shutdown: historically only KeyboardInterrupt closed the
server; a systemd/docker/CI `SIGTERM` killed it mid-response with the
socket unclosed. `run_http_server` installs a SIGTERM handler that
breaks `serve_forever` the same way Ctrl-C does, then closes the
listening socket in `finally`.

Stdlib only: safe to import from any control-plane process.
"""

from __future__ import annotations

import http.server
import signal
from typing import Optional, Tuple


def write_port_file(path: str, port: int) -> None:
    """Atomic (shared `runtime/atomicio` discipline): a discovery
    poller never reads a torn or empty port file."""
    from ..runtime.atomicio import atomic_write_text

    atomic_write_text(path, f"{port}\n")


def read_port_file(path: str) -> int:
    with open(path) as f:
        return int(f.read().strip())


def bind(addr: str, handler) -> Tuple[http.server.ThreadingHTTPServer, str, int]:
    """Parse `host:port` (port 0 = ephemeral), bind, and return
    (server, host, realized_port)."""
    host, port = addr.rsplit(":", 1)
    srv = http.server.ThreadingHTTPServer((host, int(port)), handler)
    return srv, host, srv.server_address[1]


def run_http_server(
    srv: http.server.ThreadingHTTPServer,
    *,
    port_file: Optional[str] = None,
) -> int:
    """Serve until KeyboardInterrupt or SIGTERM, then close gracefully.
    Writes `port_file` (realized port) before serving. Returns 0."""
    if port_file:
        write_port_file(port_file, srv.server_address[1])

    def _on_term(signum, frame):  # SIGTERM == Ctrl-C: drain and close
        raise KeyboardInterrupt

    prev = None
    try:
        prev = signal.signal(signal.SIGTERM, _on_term)
    except ValueError:  # pragma: no cover - not the main thread
        prev = None
    try:
        srv.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        srv.server_close()
        if prev is not None:
            signal.signal(signal.SIGTERM, prev)
    return 0
