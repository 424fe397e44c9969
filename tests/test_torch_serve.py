"""The port's `serve --service stats` (`python -m madsim_tpu_torch
serve`), mirroring tests/test_fleet.py:569-603: bound on `--addr
127.0.0.1:0`, it writes its realized port to `--port-file`, answers
/healthz, /stats and /metrics from a StatsEmitter base (the bytes of
BASE.json and BASE.prom, the files a port hunt with `--stats` writes),
404 before any stats exist, and exits 0 on SIGTERM. The host services
(`--service etcd|kafka|s3`) stay the JAX package's: the port exits 2
with one line naming `python -m madsim_tpu serve`."""

import os
import pathlib
import signal
import subprocess
import sys
import time
import urllib.error
import urllib.request

import pytest

from madsim_tpu_torch.fleet import httpd

REPO = pathlib.Path(__file__).resolve().parents[1]


def test_port_file_roundtrip(tmp_path):
    path = str(tmp_path / "p.port")
    httpd.write_port_file(path, 12345)
    assert httpd.read_port_file(path) == 12345
    assert not os.path.exists(path + ".tmp")  # rename, not rewrite


def _get(port, route):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{route}", timeout=10) as resp:
        return resp.status, resp.headers["Content-Type"], resp.read()


def test_serve_stats_answers_and_exits_on_sigterm(tmp_path):
    from madsim_tpu_torch.tracing import StatsEmitter

    base = str(tmp_path / "stats")
    port_file = str(tmp_path / "daemon.port")
    proc = subprocess.Popen(
        [sys.executable, "-m", "madsim_tpu_torch", "serve", "--service", "stats", "--addr", "127.0.0.1:0",
         "--port-file", port_file, "--stats", base],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )
    try:
        deadline = time.monotonic() + 60
        while not os.path.exists(port_file):
            assert proc.poll() is None, proc.stdout.read()
            assert time.monotonic() < deadline, "port file never appeared"
            time.sleep(0.05)
        port = httpd.read_port_file(port_file)
        assert _get(port, "/healthz") == (200, "text/plain", b"ok\n")
        with pytest.raises(urllib.error.HTTPError) as missing:
            _get(port, "/stats")
        assert missing.value.code == 404
        emitter = StatsEmitter(base)
        emitter.emit({"kind": "hunt_batch", "machine": "raft", "batch": 1, "completed": 32, "failing": 2})
        emitter.close()
        status, ctype, body = _get(port, "/stats")
        assert (status, ctype) == (200, "application/json") and body == open(base + ".json", "rb").read()
        status, ctype, body = _get(port, "/metrics")
        assert (status, ctype) == (200, "text/plain; version=0.0.4") and body == open(base + ".prom", "rb").read()
        with pytest.raises(urllib.error.HTTPError) as unknown:
            _get(port, "/nope")
        assert unknown.value.code == 404
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=30) == 0  # graceful, not -15
        out = proc.stdout.read()
        assert f"stats serving on 127.0.0.1:{port} (GET /stats /metrics /healthz; files {base}.json/.prom)" in out
    finally:
        if proc.poll() is None:
            proc.kill()
