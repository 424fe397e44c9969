"""The port copies of the repo-root bench scripts (`benches/*_torch.py`,
`benches/chip_sweeps_torch.sh`) against the JAX package's originals:
no copy imports `madsim_tpu` or `jax`; the two device scripts exit 2
without a card and without `--device cpu`; `rpc_bench_torch.py` runs the
reference's criterion suite to the JAX script's completed calls, bytes
and final virtual time on the native core and on the pure-Python path;
every command line of `chip_sweeps_torch.sh` parses under the port's
command line and is `chip_sweeps_r5.sh`'s with the port's program. The
guided and sweep scripts' runs are held in
`test_torch_bench_scripts_guided*.py` and `test_torch_bench_scripts_sweep.py`."""

import ast
import json
import os
import re
import shlex
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCHES = os.path.join(REPO, "benches")
COPIES = ("rpc_bench_torch.py", "guided_compare_torch.py", "tpu_sweep_torch.py")


def _imported_modules(path):
    """Every module an `import` or `from ... import` in `path` names."""
    tree = ast.parse(open(path).read(), path)
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.append(node.module)
    return names


@pytest.mark.parametrize("script", COPIES)
def test_copy_imports_neither_jax_nor_the_jax_package(script):
    names = _imported_modules(os.path.join(BENCHES, script))
    assert any(n.split(".")[0] == "madsim_tpu_torch" for n in names), names
    bad = [n for n in names if n.split(".")[0] in ("madsim_tpu", "jax", "jaxlib")]
    assert not bad, f"{script} imports {bad}"


@pytest.mark.parametrize("script", COPIES)
def test_original_stays_beside_its_copy(script):
    """The JAX script the copy ports is still there and still imports the
    JAX package (the copies never replace it)."""
    original = os.path.join(BENCHES, script.replace("_torch", ""))
    assert any(n.split(".")[0] == "madsim_tpu" for n in _imported_modules(original))


@pytest.mark.parametrize("argv", [["tpu_sweep_torch.py", "16", "96"], ["tpu_sweep_torch.py"],
                                  ["tpu_sweep_torch.py", "--mesh"], ["guided_compare_torch.py", "--smoke"],
                                  ["guided_compare_torch.py"]],
                         ids=lambda a: " ".join(a))
def test_no_card_exits_2_without_falling_back(argv, tmp_path):
    """Without a card and without --device cpu: exit 2, the port's "no
    CUDA device" line, no result and nothing written."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, os.path.join(BENCHES, argv[0]), *argv[1:]], cwd=tmp_path, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 2, proc.stderr
    assert proc.stdout == ""
    err = proc.stderr.strip().splitlines()
    assert len(err) == 1 and err[0].startswith("madsim_tpu_torch: no CUDA device:"), err
    assert "--device cpu" in err[0]
    assert list(tmp_path.iterdir()) == []


# runs the reference's criterion suite of one rpc bench script (loaded by
# path) at small call counts, and prints JSON: whether the host engine's
# native core ran, and for each case the calls completed, the payload
# bytes sent and acknowledged (the handler's replies) and the final
# virtual time of its Runtime
RPC_PROBE = r"""
import importlib.util, json, sys
spec = importlib.util.spec_from_file_location("rpc", sys.argv[1])
mod = importlib.util.module_from_spec(spec)
spec.loader.exec_module(mod)
pkg = mod.Endpoint.__module__.split(".")[0]
native = importlib.import_module(pkg + "._native")
rec = {}
E, R = mod.Endpoint, mod.Runtime
call, call_with_data, block_on = E.call, E.call_with_data, R.block_on

async def counted_call(self, *a, **k):
    r = await call(self, *a, **k)
    rec["calls"] += 1
    return r

async def counted_data(self, dst, req, data, *a, **k):
    r = await call_with_data(self, dst, req, data, *a, **k)
    rec["calls"] += 1
    rec["sent"] += len(data)
    rec["acked"] += r[0] if isinstance(r, tuple) else r
    return r

def timed_block_on(self, coro):
    async def run():
        out = await coro
        rec["end_ns"] = mod.sim_time.now_ns()
        return out
    return block_on(self, run())

E.call, E.call_with_data, R.block_on = counted_call, counted_data, timed_block_on
cases = []
for size in (None, 16, 256, 4096, 65536, 1 << 20):
    rec.clear()
    rec.update(calls=0, sent=0, acked=0)
    if size is None:
        rate = mod.bench_empty_rpc(calls=50)
    else:
        rate = mod.bench_rpc_with_data(size, calls=20)
    cases.append({"size": size, **rec, "rate_positive": rate > 0})
print(json.dumps({"native": native.available(), "cases": cases}))
"""


def _rpc_run(script, pure):
    env = dict(os.environ, PYTHONPATH=REPO)
    env.pop("MADSIM_TPU_NO_NATIVE", None)
    if pure:
        env["MADSIM_TPU_NO_NATIVE"] = "1"
    proc = subprocess.run([sys.executable, "-c", RPC_PROBE, os.path.join(BENCHES, script)], env=env,
                          capture_output=True, text=True, timeout=300, cwd=REPO)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def rpc_runs():
    return {"jax": _rpc_run("rpc_bench.py", pure=False), "native": _rpc_run("rpc_bench_torch.py", pure=False),
            "pure": _rpc_run("rpc_bench_torch.py", pure=True)}


@pytest.mark.parametrize("path", ["native", "pure"])
def test_rpc_bench_equals_the_jax_script(rpc_runs, path):
    """The empty RPC at 50 calls and every data size at 20 calls: the same
    completed calls, bytes sent and acknowledged and final virtual time as
    the JAX script, on the native core and on the pure-Python path."""
    got, want = rpc_runs[path], rpc_runs["jax"]
    assert got["cases"] == want["cases"]
    assert [c["calls"] for c in got["cases"]] == [50, 20, 20, 20, 20, 20]
    assert [c["sent"] for c in got["cases"]] == [0] + [20 * s for s in (16, 256, 4096, 65536, 1 << 20)]
    assert [c["acked"] for c in got["cases"]] == [c["sent"] for c in got["cases"]]
    assert all(c["end_ns"] > 0 and c["rate_positive"] for c in got["cases"])


def test_rpc_bench_runs_both_host_paths(rpc_runs):
    """MADSIM_TPU_NO_NATIVE=1 runs the pure-Python path; without it the
    native core runs where g++ builds it."""
    import shutil

    assert rpc_runs["pure"]["native"] is False
    if shutil.which("g++"):
        assert rpc_runs["native"]["native"] is True


def test_rpc_bench_prints_the_jax_scripts_lines_and_keys():
    """The whole script, as a user runs it: six lines and one JSON line,
    each line's label and the JSON keys the JAX script's."""
    outs = {}
    for script in ("rpc_bench.py", "rpc_bench_torch.py"):
        proc = subprocess.run([sys.executable, os.path.join(BENCHES, script)], capture_output=True, text=True,
                              timeout=300, cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO))
        assert proc.returncode == 0, proc.stderr[-3000:]
        outs[script] = proc.stdout.strip().splitlines()
    got, want = outs["rpc_bench_torch.py"], outs["rpc_bench.py"]
    assert len(got) == len(want) == 7
    number = re.compile(r" +[0-9.,]+ (us/call|MB/s|simulated)")
    assert [number.sub(r" <n> \1", ln) for ln in got[:6]] == [number.sub(r" <n> \1", ln) for ln in want[:6]]
    assert list(json.loads(got[6])) == list(json.loads(want[6]))


def _sweep_commands(path):
    """Each command of a chip-sweeps script: (argv, time-prefixed), the
    backslash continuations joined and comments dropped."""
    text = open(path).read().replace("\\\n", " ")
    cmds = []
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#") or line == "set -x":
            continue
        argv = shlex.split(line)
        timed = argv[0] == "time"
        cmds.append((argv[1:] if timed else argv, timed))
    return cmds


def test_chip_sweeps_torch_is_the_r5_script_on_the_port():
    """Every command of chip_sweeps_torch.sh is chip_sweeps_r5.sh's, with
    `python bench.py` as `python -m madsim_tpu_torch bench`, `python -m
    madsim_tpu` as `python -m madsim_tpu_torch` and the hunt's corpus,
    `/tmp/chip_corpus.json`, as `chip_corpus_torch.json` in the working
    directory (the two sweeps never share a corpus file)."""
    port = _sweep_commands(os.path.join(BENCHES, "chip_sweeps_torch.sh"))
    ref = _sweep_commands(os.path.join(BENCHES, "chip_sweeps_r5.sh"))
    mapped = []
    for argv, timed in ref:
        if argv[:2] == ["python", "bench.py"]:
            argv = ["python", "-m", "madsim_tpu_torch", "bench", *argv[2:]]
        elif argv[:3] == ["python", "-m", "madsim_tpu"]:
            argv = ["python", "-m", "madsim_tpu_torch", *argv[3:]]
        argv = ["chip_corpus_torch.json" if a == "/tmp/chip_corpus.json" else a for a in argv]
        mapped.append((argv, timed))
    assert port == mapped
    assert len(port) == 6


@pytest.mark.parametrize("index", range(6))
def test_chip_sweeps_torch_command_parses_under_the_port(index):
    from madsim_tpu_torch.__main__ import _gate, _parser

    argv, _timed = _sweep_commands(os.path.join(BENCHES, "chip_sweeps_torch.sh"))[index]
    assert argv[:3] == ["python", "-m", "madsim_tpu_torch"]
    args, extra = _parser().parse_known_args(argv[3:])
    assert not extra and not _gate(args)
    assert args.cmd in ("bench", "hunt", "explore")


def test_makefile_targets_run_the_copies():
    text = open(os.path.join(REPO, "Makefile")).read()
    assert re.search(r"^rpc-bench-torch:\n\t\$\(PY\) benches/rpc_bench_torch\.py$", text, re.M)
    assert re.search(r"^chip-sweeps-torch:\n\tsh benches/chip_sweeps_torch\.sh$", text, re.M)
