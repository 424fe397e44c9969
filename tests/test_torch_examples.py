"""The port's examples stay runnable, mirroring
tests/test_examples.py::test_raft_host_example."""

import os
import subprocess
import sys

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(script, *args):
    return subprocess.run(
        [sys.executable, os.path.join(_REPO, "examples", script), *args],
        capture_output=True,
        text=True,
        timeout=120,
    )


def test_raft_host_torch_example():
    r = _run("raft_host_torch.py", "3")
    assert r.returncode == 0, r.stderr[-500:]
    assert "3/3 seeds elected a leader" in r.stdout
