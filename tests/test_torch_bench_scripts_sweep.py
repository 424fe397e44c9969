"""`benches/tpu_sweep_torch.py` against `benches/tpu_sweep.py` (both
loaded by path) on the CPU: the point at 16 lanes in 96-step segments
gives the JAX script's completed seeds, device segments, host syncs and
coverage, with the kernel A/B (MADSIM_TPU_PALLAS_POP=0) too; its line's
keys are the JAX line's with `pallas_pop` as `pallas_megakernel`, plus
`card`; the `--mesh` form over one and two gloo ranks at batch 16 gives
the unsharded point's results, writes its document and appends the
port's history rows."""

import importlib.util
import json
import os
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BATCH, SEG = 16, 96
SAME = ("completed", "device_segments", "host_syncs", "coverage", "rng_stream", "clog_packed", "pipelined",
        "donation", "flight_recorder", "batch", "segment_steps")


def load(name, script):
    spec = importlib.util.spec_from_file_location(name, os.path.join(REPO, "benches", script))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def mods():
    argv = sys.argv
    sys.argv = [argv[0]]  # the JAX script reads --mesh from argv at import
    try:
        return {"jax": load("tpu_sweep_jax", "tpu_sweep.py"), "torch": load("tpu_sweep_torch", "tpu_sweep_torch.py")}
    finally:
        sys.argv = argv


@pytest.fixture(scope="module")
def points(mods):
    return {"jax": mods["jax"].run_point(BATCH, SEG), "torch": mods["torch"].run_point(BATCH, SEG, "cpu")}


def test_point_equals_the_jax_script(points):
    got, want = points["torch"], points["jax"]
    assert {k: got[k] for k in SAME} == {k: want[k] for k in SAME}
    assert (got["completed"], got["device_segments"], got["host_syncs"]) == (48, 12, 3)
    assert got["coverage"]["slots_hit"] == 1027


def test_line_keys_map_onto_the_jax_line(points):
    got, want = points["torch"], points["jax"]
    assert [{"pallas_pop": "pallas_megakernel"}.get(k, k) for k in want] == [k for k in got if k != "card"]
    assert set(got) == (set(want) - {"pallas_pop"}) | {"pallas_megakernel", "card"}
    assert got["platform"] == want["platform"] == "cpu"
    assert got["card"] is None
    assert got["pallas_megakernel"] is True


def test_kernel_ab_turns_the_megakernel_off(mods, points, monkeypatch):
    """MADSIM_TPU_PALLAS_POP=0 maps onto EngineConfig(pallas_megakernel=
    False): the same results, the gate resolved off."""
    monkeypatch.setenv("MADSIM_TPU_PALLAS_POP", "0")
    assert mods["torch"].sweep_config().pallas_megakernel is False
    off = mods["torch"].run_point(BATCH, SEG, "cpu")
    assert off["pallas_megakernel"] is False
    assert {k: off[k] for k in SAME} == {k: points["jax"][k] for k in SAME}


def test_default_grid_is_the_jax_scripts(mods):
    assert mods["torch"].DEFAULT_GRID == [(4096, 192), (8192, 192), (16384, 192), (32768, 192), (8192, 384),
                                          (16384, 384)]


def test_mesh_over_gloo_ranks_equals_the_unsharded_point(mods, points, tmp_path, monkeypatch):
    hist = tmp_path / "history.jsonl"
    monkeypatch.setenv("MADSIM_TPU_BENCH_HISTORY", str(hist))
    out = tmp_path / "mesh.json"
    doc = mods["torch"].run_mesh_sweep(str(out), batch=BATCH, segment_steps=SEG, device="cpu")
    assert json.loads(out.read_text()) == doc
    assert [p["devices"] for p in doc["points"]] == [1, 2]
    for p in doc["points"]:
        assert p["backend"] == "gloo"
        assert (p["completed"], p["coverage"]) == (points["torch"]["completed"], points["torch"]["coverage"])
    assert set(doc["scaling_vs_1dev"]) == {"1", "2"} and doc["scaling_vs_1dev"]["1"] == 1.0
    assert (doc["platform"], doc["shared_card"], doc["card"]) == ("cpu", False, None)
    rows = [json.loads(line) for line in hist.read_text().splitlines()]
    assert [r["tag"] for r in rows] == ["mesh_d1", "mesh_d2"]
    assert [r["fingerprint"]["device_count"] for r in rows] == [1, 2]
    assert {r["source"] for r in rows} == {"benches/tpu_sweep_torch.py --mesh"}
    assert all(r["fingerprint"]["gates"]["pallas_megakernel"] for r in rows)
