"""`benches/guided_compare_torch.py` against `benches/guided_compare.py`
(both loaded by path) on the CPU: `main` on raft's coverage row at a
budget of 64 seeds in batches of 16 lanes, lanes cut at 300 events,
gives the JAX script's slots (1,220 unguided, 1,283 guided), escalation,
trail and bias, verdict and exit code; its JSON keys are the JAX
script's and `device`, and its markdown is the JAX script's apart from
the title and the sentence naming the device."""

import importlib.util
import json
import os

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUDGET, BATCH = 64, 16
RAFT_ROW = ("raft", 3, 3, 2.0, 300)


def load(name, script):
    spec = importlib.util.spec_from_file_location(name, os.path.join(REPO, "benches", script))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = {}
    for pkg, script, extra in (("jax", "guided_compare.py", []),
                               ("torch", "guided_compare_torch.py", ["--device", "cpu"])):
        mod = load(f"guided_compare_{pkg}", script)
        mod.COVERAGE_MODELS, mod.DEMO_CONFIGS = (RAFT_ROW,), ()
        tmp = tmp_path_factory.mktemp(pkg)
        paths = {k: str(tmp / f"{k}.out") for k in ("json", "out", "trail")}
        rc = mod.main(["--budget", str(BUDGET), "--batch", str(BATCH), "--json", paths["json"], "--out",
                       paths["out"], "--trail-out", paths["trail"], *extra])
        out[pkg] = {"mod": mod, "rc": rc, "json": json.loads(open(paths["json"]).read()),
                    "md": open(paths["out"]).read(), "trail": json.loads(open(paths["trail"]).read())}
    return out


def _deterministic(row):
    return {k: v for k, v in row.items() if not k.endswith("elapsed_s")}


def test_coverage_row_equals_the_jax_script(runs):
    got, want = runs["torch"]["json"]["coverage"], runs["jax"]["json"]["coverage"]
    assert [_deterministic(r) for r in got] == [_deterministic(r) for r in want]
    assert [(r["unguided_slots"], r["guided_slots"], r["escalation"]) for r in got] == [(1220, 1283, 1)]


def test_trail_and_bias_equal_the_jax_script(runs):
    got, want = runs["torch"]["trail"], runs["jax"]["trail"]
    assert got == want
    trail = got["raft"]["trail"]
    assert len(trail) == BUDGET // BATCH
    assert sorted(s for r in trail for s in r["seeds"]) == sorted({s for r in trail for s in r["seeds"]})


def test_verdict_and_exit_code_equal_the_jax_script(runs):
    for key in ("ok", "failures", "budget", "batch", "demos"):
        assert runs["torch"]["json"][key] == runs["jax"]["json"][key]
    assert runs["torch"]["json"]["ok"] is True
    assert runs["torch"]["rc"] == runs["jax"]["rc"] == 0


def test_json_keys_are_the_jax_scripts_and_the_device(runs):
    assert set(runs["torch"]["json"]) == set(runs["jax"]["json"]) | {"device"}
    assert runs["torch"]["json"]["device"] == {"type": "cpu"}


def test_markdown_equals_the_jax_script_but_the_device(runs):
    got, want = runs["torch"]["md"].splitlines(), runs["jax"]["md"].splitlines()
    assert len(got) == len(want)
    differ = [i for i, (a, b) in enumerate(zip(got, want)) if a != b]
    # the title (the reference names its PR, the port its package) and the
    # paragraph that names the device
    assert differ == [0, 2]
    assert got[0] == "# Guided-hunter comparison (madsim_tpu_torch)"
    assert "On the CPU (`--device cpu`); elapsed" in got[2]
    assert want[2].replace("CPU, 1-core reference box; elapsed", "On the CPU (`--device cpu`); elapsed") == got[2]


def test_markdown_names_the_card(runs):
    """On the card the paragraph gives the card's name and power limit
    as nvidia-smi gives them."""
    mod = runs["torch"]["mod"]
    results = {**runs["torch"]["json"], "device": {"type": "cuda", "card": {"name": "NVIDIA H100 80GB HBM3",
                                                                            "power_limit": "700.00 W"}}}
    line = mod.render_markdown(results).splitlines()[2]
    assert "On the card, NVIDIA H100 80GB HBM3, power limit 700.00 W; elapsed" in line
