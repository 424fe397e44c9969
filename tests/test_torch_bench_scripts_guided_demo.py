"""`benches/guided_compare_torch.py`'s find-speed row against
`benches/guided_compare.py`'s (both loaded by path) on the CPU: the
volatile-commit demo under the full 11-kind palette, 64 seeds in
batches of 16 lanes, lanes cut at 300 events, where both modes find it;
`run_unguided` and `run_guided` on both packages give the same first
finds, failing seeds, escalation, trail seeds and bias."""

import importlib.util
import os

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FULL = "pair,kill,dir,group,storm,delay,pause,skew,dup,torn,heal-asym"
DEMO = ("demo-volatilecommit-raft", 3, 3, 2.0, 300, FULL, 64, 16, 0, False, 1)


def load(name, script):
    spec = importlib.util.spec_from_file_location(name, os.path.join(REPO, "benches", script))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def rows():
    out = {}
    for pkg, script, extra in (("jax", "guided_compare.py", ()), ("torch", "guided_compare_torch.py", ("cpu",))):
        mod = load(f"guided_demo_{pkg}", script)
        ns = mod._args_ns(*DEMO, *extra)
        eng = mod._build_engine(ns)
        out[pkg] = {"ns": ns, "eng": eng, "unguided": mod.run_unguided(eng, ns), "guided": mod.run_guided(eng, ns)}
    return out


def test_args_carry_the_device(rows):
    assert rows["torch"]["ns"].device == "cpu"
    assert rows["torch"]["eng"].device.type == "cpu"
    assert vars(rows["jax"]["ns"]).items() <= vars(rows["torch"]["ns"]).items()


@pytest.mark.parametrize("mode", ["unguided", "guided"])
def test_demo_finds_equal_the_jax_script(rows, mode):
    got, want = rows["torch"][mode], rows["jax"][mode]
    assert got["first_find"] == want["first_find"] is not None
    assert [tuple(f) for f in got["failing"]] == [tuple(f) for f in want["failing"]]
    assert got["slots"] == want["slots"]


def test_demo_row_values(rows):
    ug, g = rows["torch"]["unguided"], rows["torch"]["guided"]
    assert (ug["first_find"], len(ug["failing"])) == (7, 5)
    assert (g["first_find"], len(g["failing"]), g["escalation"]) == (7, 10, 0)


def test_demo_trail_and_bias_equal_the_jax_script(rows):
    got, want = rows["torch"]["guided"], rows["jax"]["guided"]
    assert [r["seeds"] for r in got["trail"]] == [r["seeds"] for r in want["trail"]]
    assert got["trail"] == want["trail"]
    assert got["bias"] == want["bias"]
    assert got["escalation"] == want["escalation"]
