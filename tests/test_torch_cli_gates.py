"""The port's command line where it refuses or stops: every gate the port
keeps exits with status 2 and one line naming the gate and its ROADMAP
item (or that it has none), before any engine is built; `lint` runs
with its own exit codes, baseline and cache (the lifted
mesh gates, `--devices N` and `--multihost`, are held against the JAX
package in tests/test_torch_cli_mesh.py, tests/test_torch_multihost.py
and tests/test_torch_cli_fleet.py); `serve` runs the host services
(etcd, kafka, s3) in real mode and, outside it, exits with the
reference's message naming the port's command line; without a card and without
`--device cpu` a command exits non-zero and never falls back to the
CPU; an unknown machine or fault kind exits as the reference's does.
Then the short runs held against the JAX package's command line: the
`--stop-on-plateau` early exit with `--stats` (and its refusal without
`--coverage`, tests/test_coverage.py:280-320), `explore` on the batch
path with coverage, and `check`."""

import json

import pytest
import torch

from madsim_tpu_torch.__main__ import main

from torch_port_util import run_pair

ECHO = ["--machine", "echo", "--seeds", "8", "--faults", "0", "--max-steps", "50"]
GATES = [
    # `prof compile` reads the JAX compile autopsy: eager PyTorch has no
    # stage for it to time, so it stays refused with a line of its own
    pytest.param("prof", ["prof", "compile"], "no trace, lowering or backend stage", id="prof"),
    # the fleet runs; what it cannot run yet stays refused
    pytest.param("--compile-cache", ["fleet", "worker", "--root", "farm", "--compile-cache", "cache"], "compile",
                 id="fleet-worker--compile-cache"),
    pytest.param("--compile-cache", ["replay", "--machine", "echo", "--compile-cache", "cache"], "compile",
                 id="--compile-cache"),
]


@pytest.mark.parametrize("gate,argv,item", GATES)
def test_gates_exit_2_naming_themselves(gate, argv, item, capsys, monkeypatch):
    from madsim_tpu_torch.engine import core

    def no_engine(*args, **kwargs):
        raise AssertionError("a gated command built an engine")

    monkeypatch.setattr(core.Engine, "__init__", no_engine)
    assert main([*argv, "--device", "cpu"] if argv[0] in ("explore", "hunt", "replay", "prof") else argv) == 2
    err = capsys.readouterr().err.strip()
    assert len(err.splitlines()) == 1 and gate in err and item in err and "not ported" in err


def test_lint_runs_with_its_exit_codes(tmp_path, capsys):
    """`lint` is open (the static analyzer, `analysis/`): exit 0 clean,
    1 findings, 2 usage error, as the JAX package's `analysis/cli.py`
    states."""
    clean = tmp_path / "clean.py"
    clean.write_text("x = 1\n")
    dirty = tmp_path / "dirty.py"
    dirty.write_text("import time\nts = time.time()\n")
    assert main(["lint", "--no-import-check", str(clean)]) == 0
    assert capsys.readouterr().out.strip() == "lint: clean"
    assert main(["lint", "--no-import-check", str(dirty)]) == 1
    out = capsys.readouterr().out
    assert "D001" in out and "madsim_tpu_torch.time" in out and "lint: 1 error(s)" in out
    assert main(["lint", str(tmp_path / "missing.py")]) == 2
    assert "no such path" in capsys.readouterr().err


def test_lint_without_import_check_imports_no_torch():
    """The default run (the port's package, every pass but the C import
    half) imports neither torch nor JAX nor the JAX package."""
    import pathlib
    import subprocess
    import sys

    repo = pathlib.Path(__file__).resolve().parents[1]
    code = (
        "import sys\n"
        "from madsim_tpu_torch.__main__ import main\n"
        "rc = main(['lint', '--no-import-check'])\n"
        "print(rc, sorted(m for m in ('torch', 'jax', 'madsim_tpu') if m in sys.modules))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=repo, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.splitlines()[-2:] == ["lint: clean", "0 []"]


def test_lint_keeps_its_own_baseline_and_cache(tmp_path, capsys):
    """`--update-baseline` and `--cache` write the port's files, never
    the JAX package's `.madsim-lint-baseline.json` or `.madsim-lint-cache/`."""
    root = tmp_path / "repo"
    (root / "madsim_tpu_torch" / "engine").mkdir(parents=True)
    (root / "madsim_tpu_torch" / "engine" / "core.py").write_text("X = 1\n")
    (root / "madsim_tpu_torch" / "foo.py").write_text("import time\nts = time.time()\n")
    pkg = str(root / "madsim_tpu_torch")
    argv = ["lint", "--no-import-check", "--rules", "D", "--repo-root", str(root), pkg]
    assert main([*argv, "--update-baseline"]) == 0
    assert main([*argv, "--cache"]) == 0
    assert "1 baselined" in capsys.readouterr().out
    assert sorted(p.name for p in root.iterdir()) == [
        ".madsim-torch-lint-baseline.json", ".madsim-torch-lint-cache", "madsim_tpu_torch",
    ]


_SERVICE_CALL = {
    "etcd": "from madsim_tpu_torch.services.etcd import Client\n"
            "cli = await Client.connect(ADDR)\n"
            "print((await cli.put('k', 'v'))['revision'])",
    "kafka": "from madsim_tpu_torch.services import kafka\n"
             "admin = await kafka.ClientConfig({'bootstrap.servers': ADDR}).create_admin()\n"
             "print(await admin.create_topics([kafka.NewTopic('t', 2)]))",
    "s3": "from madsim_tpu_torch.services import s3\n"
          "cli = s3.Client.from_conf(s3.Config(endpoint_url='http://' + ADDR))\n"
          "print(await cli.create_bucket().bucket('b').send())",
}
_SERVICE_ANSWER = {"etcd": "2", "kafka": "[('t', None)]", "s3": "{'location': '/b'}"}


@pytest.mark.parametrize("service", ["etcd", "kafka", "s3"])
def test_host_services_serve(service):
    """`serve --service etcd|kafka|s3` under MADSIM_TPU_MODE=real prints
    its ready line with the bound port and answers a client's call;
    outside real mode it exits with the reference's message, naming
    the port's command line."""
    import os
    import subprocess
    import sys

    from madsim_tpu.__main__ import main as jax_main
    from torch_mirror_util import load_pair

    argv = ["serve", "--service", service, "--addr", "127.0.0.1:0"]
    with pytest.raises(SystemExit) as want:
        jax_main(argv)
    with pytest.raises(SystemExit) as got:
        main(argv)
    assert str(got.value) == str(want.value).replace("-m madsim_tpu ", "-m madsim_tpu_torch ")
    assert "MADSIM_TPU_MODE=real python -m madsim_tpu_torch serve --service " + service in str(got.value)

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, MADSIM_TPU_MODE="real", PYTHONPATH=repo)
    server, addr = load_pair("test_real_mode")["port"].start_real_server(service, repo, env)
    try:
        body = _SERVICE_CALL[service].replace("\n", "\n    ")
        code = f"import asyncio\nADDR = {addr!r}\nasync def main():\n    {body}\nasyncio.run(main())\n"
        out = subprocess.run([sys.executable, "-c", code], env=env, cwd=repo, capture_output=True, text=True,
                             timeout=60)
    finally:
        server.kill()
        server.wait()
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip() == _SERVICE_ANSWER[service]


@pytest.mark.parametrize("argv", [["explore", *ECHO], ["regress", "--corpus", "c.json"], ["check", *ECHO],
                                  ["bench", "--lanes", "64"], ["bench", "--machine", "echo"]],
                         ids=["explore", "regress", "check", "bench", "bench-machine"])
def test_no_card_exits_without_falling_back(argv, capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert main(argv) != 0
    assert "no CUDA device" in capsys.readouterr().err


def test_unknown_machine_and_kinds_exit_as_the_reference(capsys):
    from madsim_tpu.__main__ import main as jax_main

    for argv in (["explore", "--machine", "nope", "--seeds", "4"],
                 ["explore", *ECHO, "--fault-kinds", "pair,bogus"],
                 ["explore", *ECHO, "--faults", "1", "--fault-kinds", "dup"]):
        with pytest.raises(SystemExit) as want:
            jax_main(argv)
        with pytest.raises(SystemExit) as got:
            main([*argv, "--device", "cpu"])
        assert str(got.value) == str(want.value) and str(got.value)


def test_plateau_with_stats_matches_jax(tmp_path):
    base = {who: str(tmp_path / who) for who in ("jax", "port")}
    argv = ["explore", "--machine", "echo", "--seeds", "160", "--batch", "32", "--stream", "--coverage",
            "--faults", "0", "--horizon", "1.0", "--max-steps", "200", "--stop-on-plateau", "2"]
    want, got = run_pair([*argv, "--stats", base["jax"]], [*argv, "--stats", base["port"]])
    assert got == want and got[0] == 0 and "plateau" in got[1]

    def rows(b):
        out = []
        for line in open(b + ".jsonl"):
            row = json.loads(line)
            for key in ("ts", "seeds_per_sec", "elapsed_s"):
                row.pop(key, None)
            out.append(row)
        return out

    assert rows(base["port"]) == rows(base["jax"])
    [summary] = [r for r in rows(base["port"]) if r["kind"] == "explore_summary"]
    assert summary["plateau"] is True and f"streamed {summary['completed']} seeds" in got[1]


def test_plateau_requires_coverage():
    from madsim_tpu_torch.__main__ import main

    with pytest.raises(SystemExit, match="--coverage"):
        main(["explore", "--machine", "echo", "--seeds", "32", "--batch", "32", "--stream", "--faults", "0",
              "--stop-on-plateau", "2", "--max-steps", "200", "--device", "cpu"])


def test_explore_batch_and_check_match_jax():
    want, got = run_pair(["explore", "--machine", "demo-doublegrant-etcd", "--seeds", "16", "--horizon", "8.0",
                          "--max-steps", "200", "--coverage"])
    assert got == want and got[0] == 1 and "failure codes: [120]" in got[1] and "coverage: " in got[1]
    want, got = run_pair(["check", "--machine", "kv", "--seeds", "8", "--max-steps", "120"])
    assert got == want and got[0] == 0 and "determinism check passed for 8 seeds" in got[1]


def test_command_line_runs_with_jax_blocked(tmp_path):
    """`python -m madsim_tpu_torch` imports nothing of JAX or the JAX
    package: a hunt, its corpus regress and a coverage report run with
    them blocked."""
    import pathlib
    import subprocess
    import sys

    repo = pathlib.Path(__file__).resolve().parents[1]
    corpus = str(tmp_path / "c.json")
    code = (
        "import runpy, sys\n"
        "for m in ('jax', 'jaxlib', 'flax', 'madsim_tpu'): sys.modules[m] = None\n"
        "sys.argv = ['madsim_tpu_torch'] + sys.argv[1:]\n"
        "runpy.run_module('madsim_tpu_torch', run_name='__main__')\n"
    )
    hunt = ["hunt", "--machine", "demo-doublegrant-etcd", "--seeds", "4", "--horizon", "8.0", "--max-steps", "200",
            "--corpus", corpus, "--limit", "1", "--device", "cpu"]
    for argv, rc in ((hunt, 1), (["regress", "--corpus", corpus, "--device", "cpu"], 0)):
        out = subprocess.run([sys.executable, "-c", code, *argv], cwd=repo, capture_output=True, text=True,
                             timeout=300)
        assert out.returncode == rc, out.stderr[-2000:]
    assert "1/1 entries satisfied" in out.stdout
