"""The port's examples, mirroring tests/test_examples.py: the host Raft
example runs; the service examples (`chaos_pipeline_torch.py`,
`etcd_dual_torch.py` in sim and in real mode against `python -m
madsim_tpu_torch serve`, `group_consumers_torch.py`) print the JAX
examples' lines; the device examples' machines and configs
(`examples/bug_hunt_torch.py`, `examples/delay_hunt_torch.py`) equal the
JAX examples' own classes (`examples/bug_hunt.py`, `delay_hunt.py`,
loaded by path, their `main()` not run) lane for lane at 64 lanes; the
device examples refuse to run without a card unless `--device cpu` is
given; and, as `slow` cases, each whole example on the CPU makes the
reference tests' stdout checks and prints the JAX example's
deterministic lines."""

import importlib.util
import os
import re
import subprocess
import sys

import numpy as np
import pytest

from torch_mirror_util import load_pair
from torch_port_util import same

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_EXAMPLES = os.path.join(_REPO, "examples")


def _run(script, *args, timeout=120):
    return subprocess.run(
        [sys.executable, os.path.join(_EXAMPLES, script), *args],
        capture_output=True,
        text=True,
        timeout=timeout,
    )


def _load(script):
    """An example as a module, by path (its `main()` is not run)."""
    name = "example_" + script.replace(".py", "")
    spec = importlib.util.spec_from_file_location(name, os.path.join(_EXAMPLES, script))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_raft_host_torch_example():
    r = _run("raft_host_torch.py", "3")
    assert r.returncode == 0, r.stderr[-500:]
    assert "3/3 seeds elected a leader" in r.stdout


# -- the device examples' engines against the JAX examples' ----------------

LANES = 64

# (the JAX example's class, the JAX config's keywords, its fault plan's
# keywords, max_steps, whether some lane must fail); the configs are the
# ones the JAX examples' main() builds
_BUG = dict(horizon_us=3_000_000, queue_capacity=96)
_BUG_FAULTS = dict(n_faults=1, t_max_us=2_000_000)
_DELAY = dict(horizon_us=8_000_000, queue_capacity=48)
_DELAY_FAULTS = dict(n_faults=3, t_max_us=3_000_000, dur_min_us=200_000, dur_max_us=800_000,
                     allow_partition=False, allow_kill=False)
CASES = {
    "bug-hunt": ("DoubleVoteRaft", _BUG, _BUG_FAULTS, 240, True),
    "delay-spikes": ("PrematureGiveup", _DELAY, {**_DELAY_FAULTS, "allow_delay": True}, 400, True),
    "loss-storms": ("PrematureGiveup", _DELAY, {**_DELAY_FAULTS, "allow_storm": True}, 400, False),
    "partitions-kills": ("PrematureGiveup", _DELAY, {**_DELAY_FAULTS, "allow_partition": True,
                                                     "allow_kill": True}, 400, False),
}


def _port_engine(case):
    if case == "bug-hunt":
        return _load("bug_hunt_torch.py").make_engine("cpu")
    kinds = {k: v for k, v in CASES[case][2].items() if k.startswith("allow_")}
    return _load("delay_hunt_torch.py").engine("cpu", **kinds)


@pytest.mark.parametrize("case", sorted(CASES))
def test_example_engine_matches_jax(case):
    import jax
    import jax.numpy as jnp

    from madsim_tpu.engine import Engine as JaxEngine
    from madsim_tpu.engine import EngineConfig as JaxConfig
    from madsim_tpu.engine import FaultPlan as JaxFaultPlan
    from madsim_tpu_torch.engine import EngineConfig, FaultPlan

    cls_name, cfg, faults, steps, must_fail = CASES[case]
    jax_example = _load("bug_hunt.py" if case == "bug-hunt" else "delay_hunt.py")
    machine = getattr(jax_example, cls_name)
    kw = dict(num_nodes=5, log_capacity=8) if case == "bug-hunt" else dict(num_nodes=4)
    jax_eng = JaxEngine(machine(**kw), JaxConfig(faults=JaxFaultPlan(**faults), **cfg))
    port = _port_engine(case)
    assert port.config == EngineConfig(faults=FaultPlan(**faults), **cfg)
    assert type(port.machine).__name__ == cls_name

    seeds = np.arange(LANES, dtype=np.uint32)
    want = jax.jit(jax_eng.run_batch, static_argnums=1)(jnp.asarray(seeds), steps)
    got = port.make_runner(max_steps=steps)(seeds)
    same(want, got, case)
    n_failed = int(got.failed.sum())
    assert (n_failed > 0) if must_fail else (n_failed == 0), (case, n_failed)
    if case == "delay-spikes":
        assert {int(c) for c in got.fail_code.tolist() if c} == {206}


def _same_lines(script, *args):
    """The port example's stdout, held equal to the JAX example's."""
    got, want = _run(script.replace(".py", "_torch.py"), *args), _run(script, *args)
    assert got.returncode == want.returncode == 0, got.stderr[-500:] + want.stderr[-500:]
    assert got.stdout == want.stdout
    return got.stdout


def test_chaos_pipeline_example_deterministic():
    out = _same_lines("chaos_pipeline.py", "7")
    assert _run("chaos_pipeline_torch.py", "7").stdout == out
    assert "evt-after-crash" in out


def test_etcd_dual_example_sim_mode():
    out = _same_lines("etcd_dual.py")
    assert "[sim]" in out and "'txn_succeeded': True" in out


def test_etcd_dual_example_real_mode():
    """The same app bytes over real TCP: the port's example against the
    port's `serve`, the JAX example against the JAX package's."""
    pair = load_pair("test_real_mode")
    env = dict(os.environ, MADSIM_TPU_MODE="real", PYTHONPATH=_REPO)
    outs = []
    for pkg, script in (("port", "etcd_dual_torch.py"), ("jax", "etcd_dual.py")):
        server, addr = pair[pkg].start_real_server("etcd", _REPO, env)
        try:
            r = subprocess.run([sys.executable, os.path.join(_EXAMPLES, script), addr], env=env,
                               capture_output=True, text=True, timeout=60)
        finally:
            server.kill()
            server.wait()
        assert r.returncode == 0, r.stdout + r.stderr
        outs.append(r.stdout)
    assert outs[0] == outs[1]
    assert "[real]" in outs[0] and "'txn_succeeded': True" in outs[0]


def test_group_consumers_example():
    assert "at-least-once holds" in _same_lines("group_consumers.py", "7")


@pytest.mark.parametrize("script", ["bug_hunt_torch.py", "delay_hunt_torch.py"])
def test_device_example_refuses_without_a_card(script):
    """No fallback: without a CUDA card and without `--device cpu` the
    example exits non-zero with one clear line and prints no result."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("this box has a CUDA card")
    r = _run(script)
    assert r.returncode != 0
    assert "no CUDA device; pass --device cpu" in r.stderr
    assert r.stdout == ""


def test_slice_runs_without_jax_grpcio_or_protobuf():
    """The port and this slice's modules import, and both device examples'
    engines run, with JAX, the JAX package, grpcio and protobuf
    unimportable: `import madsim_tpu_torch` needs none of them."""
    code = (
        "import runpy, sys\n"
        "for m in ('jax', 'jaxlib', 'flax', 'madsim_tpu', 'grpc', 'google.protobuf'): sys.modules[m] = None\n"
        "import madsim_tpu_torch, madsim_tpu_torch.tokio, madsim_tpu_torch.dual, madsim_tpu_torch.real\n"
        "import madsim_tpu_torch.grpc.build, madsim_tpu_torch.tracing\n"
        "assert madsim_tpu_torch.dual.IS_SIM and madsim_tpu_torch.tracing.instrument\n"
        f"bug = runpy.run_path({os.path.join(_EXAMPLES, 'bug_hunt_torch.py')!r})\n"
        f"delay = runpy.run_path({os.path.join(_EXAMPLES, 'delay_hunt_torch.py')!r})\n"
        "a = bug['make_engine']('cpu').run_batch(range(8), 64)\n"
        "b = delay['engine']('cpu', allow_delay=True).run_batch(range(8), 64)\n"
        "print('ran', int(a.steps.max()), int(b.steps.max()))\n"
    )
    env = dict(os.environ, PYTHONPATH=_REPO)
    r = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-800:]
    assert r.stdout.startswith("ran ")


# -- the whole examples on the CPU (minutes each) -----------------------------


def _check_bug_hunt(stdout):
    assert "invariant violations" in stdout
    assert "failed=True" in stdout
    assert ("traces diverge at step" in stdout or "no passing seed" in stdout)


def _check_delay_hunt(stdout):
    assert "delay spikes" in stdout and "codes {206}" in stdout
    for vocab in ("loss storms", r"partitions \+ kills"):
        assert re.search(rf"{vocab}:\s*0/256 seeds flagged", stdout), stdout
    assert "replay + shrink: seed" in stdout


@pytest.mark.slow
def test_bug_hunt_torch_example():
    r = _run("bug_hunt_torch.py", "--device", "cpu", timeout=1800)
    assert r.returncode == 0, r.stderr[-500:]
    _check_bug_hunt(r.stdout)


@pytest.mark.slow
def test_delay_hunt_torch_example():
    r = _run("delay_hunt_torch.py", "--device", "cpu", timeout=1800)
    assert r.returncode == 0, r.stderr[-500:]
    _check_delay_hunt(r.stdout)


_DETERMINISTIC = ("ran ", "=== 2.", "replay: ", "=== 3.", "traces diverge", "no passing seed", "seeds flagged",
                  "replay + shrink")


def _deterministic_lines(stdout):
    """The lines of an example's stdout that the engine decides: counts,
    codes, the failing seed, the replay's outcome and event count, the
    passing neighbour, the diff's first divergent step and the shrink
    summary."""
    return [line.strip() for line in stdout.splitlines() if any(m in line for m in _DETERMINISTIC)]


@pytest.mark.slow
@pytest.mark.parametrize("name", ["bug_hunt", "delay_hunt"])
def test_example_stdout_matches_jax(name):
    port = _run(f"{name}_torch.py", "--device", "cpu", timeout=1800)
    ref = _run(f"{name}.py", timeout=1800)
    assert port.returncode == 0, port.stderr[-500:]
    assert ref.returncode == 0, ref.stderr[-500:]
    want = _deterministic_lines(ref.stdout)
    assert want and _deterministic_lines(port.stdout) == want
