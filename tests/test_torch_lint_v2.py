"""Lint v2 on the port — the two-pass analyzer of
`madsim_tpu_torch/analysis/`: program model, L/T/R/S families, SARIF,
the model cache, and the baseline ratchet; case for case the mirror of
tests/test_lint_v2.py.

Fast by construction: everything here is stdlib-`ast` (no torch import,
no engine). Drift tests mutate synthesized mini-repos or scratch copies
of the port's files; the T and S fixtures are the torch twins in
tests/torch_lint_fixtures/.
"""

import argparse
import json
import os
import shutil

import pytest

from madsim_tpu_torch.analysis import layers, lintcache, projectmodel, rrules, srules, trules
from madsim_tpu_torch.analysis.axes import CARRY, EntryPoint
from madsim_tpu_torch.analysis.cli import main as lint_main, run_lint, scoped_files
from madsim_tpu_torch.analysis.findings import (
    Finding,
    baseline_growth,
    filter_suppressed,
    sarif_doc,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(REPO, "tests", "torch_lint_fixtures")


def ns(**kw):
    # repo_root=None + tmp victims: find_repo_root sees no package above
    # /tmp, so the whole-program passes stay out of these CLI tests
    # (they have their own tests against mini-repos and scratch copies)
    base = dict(
        paths=[], rules=None, json=False, github=False, fix=False,
        baseline=None, update_baseline=False, no_import_check=True,
        repo_root=None, verbose=False, sarif=None, cache=False, force=False,
    )
    base.update(kw)
    return argparse.Namespace(**base)


def mini_repo(tmp_path, files):
    """Materialize {relpath: source} under tmp and return the root."""
    root = tmp_path / "repo"
    for rel, src in files.items():
        p = root / rel
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(src)
    return root


def model_of(tmp_path, files):
    return projectmodel.build_model(str(mini_repo(tmp_path, files)))


def tagged_lines(path, tag):
    with open(path) as fh:
        return sorted(
            i for i, line in enumerate(fh.read().splitlines(), start=1)
            if tag in line
        )


# -- pass 1: the program model ------------------------------------------------


def test_model_import_classification(tmp_path):
    model = model_of(tmp_path, {
        "madsim_tpu_torch/mod.py": (
            "import os\n"
            "from . import kinds\n"
            "def f():\n"
            "    import torch\n"
            "def g():\n"
            "    try:\n"
            "        import torch.nn\n"
            "    except ImportError:\n"
            "        pass\n"
        ),
        "madsim_tpu_torch/kinds.py": "X = 1\n",
        "madsim_tpu_torch/__init__.py": "",
    })
    mi = model.modules["madsim_tpu_torch.mod"]
    by_target = {e.target: e for e in mi.imports}
    assert not by_target["os"].lazy
    assert by_target["madsim_tpu_torch.kinds"].target == "madsim_tpu_torch.kinds"
    assert by_target["torch"].lazy and not by_target["torch"].guarded
    assert by_target["torch"].func == "f"
    assert by_target["torch.nn"].lazy and by_target["torch.nn"].guarded


def test_model_nested_functions_and_resolution(tmp_path):
    model = model_of(tmp_path, {
        "madsim_tpu_torch/mod.py": (
            "class C:\n"
            "    def outer(self):\n"
            "        def inner(x):\n"
            "            return x\n"
            "        return inner(1)\n"
            "def top():\n"
            "    return 2\n"
        ),
        "madsim_tpu_torch/__init__.py": "",
    })
    mi = model.modules["madsim_tpu_torch.mod"]
    outer = mi.functions["C.outer"]
    assert outer.locals_fns == {"inner": "C.outer.<locals>.inner"}
    assert "C.outer.<locals>.inner" in mi.functions
    assert "top" in mi.functions
    assert model.split_function("madsim_tpu_torch.mod.top") == (
        "madsim_tpu_torch.mod", "top"
    )


def test_model_eager_torch_chain(tmp_path):
    model = model_of(tmp_path, {
        "madsim_tpu_torch/__init__.py": "",
        "madsim_tpu_torch/a.py": "from . import b\n",
        "madsim_tpu_torch/b.py": "import torch\n",
        "madsim_tpu_torch/c.py": "import os\n",
    })
    chain = model.eager_torch_chain("madsim_tpu_torch.a")
    assert chain == ["madsim_tpu_torch.a", "madsim_tpu_torch.b", "torch"]
    assert model.eager_torch_chain("madsim_tpu_torch.c") is None


# -- L-rules ------------------------------------------------------------------


_INIT = {"madsim_tpu_torch/__init__.py": "", "madsim_tpu_torch/fleet/__init__.py": ""}


def l_rules(model):
    return layers.check_model(model)


def test_l001_direct_closed_import(tmp_path):
    model = model_of(tmp_path, {
        **_INIT,
        "madsim_tpu_torch/fleet/store.py": "import os\nimport torch\n",
    })
    [f] = [x for x in l_rules(model) if x.rule == "L001"]
    assert f.path == "madsim_tpu_torch/fleet/store.py" and f.line == 2
    assert "closed module `torch`" in f.message


def test_l001_ops_is_closed_without_torch_in_scratch(tmp_path):
    # engine.core/ops are closed by NAME — the rule fires even when the
    # scratch copy doesn't contain them (no closure walk needed)
    model = model_of(tmp_path, {
        **_INIT,
        "madsim_tpu_torch/fleet/store.py": "from ..ops import coverage\n",
    })
    [f] = [x for x in l_rules(model) if x.rule == "L001"]
    assert "madsim_tpu_torch.ops" in f.message


def test_l002_transitive_chain_named(tmp_path):
    model = model_of(tmp_path, {
        **_INIT,
        "madsim_tpu_torch/util.py": "import torch\n",
        "madsim_tpu_torch/fleet/store.py": "from ..util import helper\n",
    })
    [f] = [x for x in l_rules(model) if x.rule == "L002"]
    assert "madsim_tpu_torch.fleet.store -> madsim_tpu_torch.util -> torch" in f.message


def test_l002_parent_init_poisons_zone_module(tmp_path):
    # search/__init__ importing a torch module breaks search.bias without
    # bias.py changing a byte — the parent-package edge
    model = model_of(tmp_path, {
        "madsim_tpu_torch/__init__.py": "",
        "madsim_tpu_torch/search/__init__.py": "from .guided import run\n",
        "madsim_tpu_torch/search/guided.py": "import torch\n",
        "madsim_tpu_torch/search/bias.py": "X = 1\n",
    })
    found = [x for x in l_rules(model) if x.rule == "L002"]
    assert any(
        x.path == "madsim_tpu_torch/search/bias.py"
        and "package ancestor" in x.message
        for x in found
    ), [x.text() for x in found]


def test_l003_lazy_ungated_vs_guarded(tmp_path):
    model = model_of(tmp_path, {
        **_INIT,
        "madsim_tpu_torch/fleet/store.py": (
            "def a():\n"
            "    import torch\n"
            "def b():\n"
            "    try:\n"
            "        import torch\n"
            "    except ImportError:\n"
            "        torch = None\n"
        ),
    })
    found = [x for x in l_rules(model) if x.rule == "L003"]
    assert [f.line for f in found] == [2]  # the guarded one is legal


def test_l003_gate_call_must_pass_false(tmp_path):
    files = {
        **_INIT,
        "madsim_tpu_torch/compile_cache.py": (
            "def cache_subkey(import_jax=True, **kw):\n"
            "    if import_jax:\n"
            "        import torch\n"
            "    return 'k'\n"
        ),
        "madsim_tpu_torch/fleet/store.py": (
            "def subkey():\n"
            "    from ..compile_cache import cache_subkey\n"
            "    return cache_subkey(lanes=8)\n"
        ),
    }
    model = model_of(tmp_path, files)
    found = [x for x in l_rules(model) if x.rule == "L003"]
    assert any("import_jax=False" in f.message for f in found)
    # closing the gate silences it
    files["madsim_tpu_torch/fleet/store.py"] = files[
        "madsim_tpu_torch/fleet/store.py"
    ].replace("cache_subkey(lanes=8)", "cache_subkey(import_jax=False, lanes=8)")
    shutil.rmtree(tmp_path / "repo")
    model = projectmodel.build_model(str(mini_repo(tmp_path, files)))
    assert [x for x in l_rules(model) if x.rule == "L003"] == []


@pytest.fixture(scope="module")
def repo_model():
    return projectmodel.build_model(REPO)


def test_layer_map_head_is_clean(repo_model):
    """The zone claim holds at HEAD: every raw L finding is an inline-
    justified gate (crules' import half), nothing else."""
    raw = layers.check_model(repo_model)
    sources = {
        mi.rel: mi.source for mi in repo_model.modules.values()
    }
    kept = filter_suppressed(raw, sources)
    assert kept == [], [f.text() for f in kept]
    assert all(f.path == "madsim_tpu_torch/analysis/crules.py" for f in raw)


# -- T-rules ------------------------------------------------------------------


def test_t001_handler_called_helpers(tmp_path):
    """The D006-gap satellite: while conditions and ternary tests (and
    `.item()`) inside handler-called helpers, module-level and
    self-method, each finding carrying its chain."""
    src_path = os.path.join(FIXTURES, "t001_helpers.py")
    root = tmp_path / "repo"
    dst = root / "madsim_tpu_torch" / "t001_helpers.py"
    dst.parent.mkdir(parents=True)
    shutil.copy(src_path, dst)
    (root / "madsim_tpu_torch" / "__init__.py").write_text("")
    model = projectmodel.build_model(str(root))
    found = [f for f in trules.check_model(model) if f.rule == "T001"]
    assert sorted({f.line for f in found}) == tagged_lines(
        src_path, "T001 expected"
    )
    assert all("[chain: " in f.message for f in found)
    assert any("on_message" in f.message for f in found)


@pytest.fixture(scope="module")
def texec_model(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("texec")
    root = tmp / "repo"
    dst = root / "madsim_tpu_torch" / "texec_stream.py"
    dst.parent.mkdir(parents=True)
    shutil.copy(os.path.join(FIXTURES, "texec_stream.py"), dst)
    (root / "madsim_tpu_torch" / "__init__.py").write_text("")
    return projectmodel.build_model(str(root))


def texec_findings(texec_model, entry):
    return trules.check_model(
        texec_model,
        executor_entrypoints=(("madsim_tpu_torch.texec_stream", entry),),
    )


def test_texec_clean_executor(texec_model):
    assert texec_findings(texec_model, "MiniEngine.run_clean") == []


def test_texec_item_sink(texec_model):
    found = texec_findings(texec_model, "MiniEngine.run_item_sink")
    assert [f.rule for f in found] == ["T001"]
    assert ".item()" in found[0].message


def test_texec_truthiness_sink(texec_model):
    found = texec_findings(texec_model, "MiniEngine.run_truthy_sink")
    assert [f.rule for f in found] == ["T001"]
    assert "truthiness" in found[0].message


def test_texec_hidden_fetch_is_t002(texec_model):
    found = texec_findings(texec_model, "MiniEngine.run_hidden_fetch")
    assert "T002" in {f.rule for f in found}
    [f] = [x for x in found if x.rule == "T002"]
    assert "dispatch region" in f.message


def test_texec_use_after_donate_is_t003(texec_model):
    found = texec_findings(texec_model, "MiniEngine.run_use_after_donate")
    assert "T003" in {f.rule for f in found}
    [f] = [x for x in found if x.rule == "T003"]
    assert f.severity == "error" and "donated" in f.message


def test_texec_expected_lines_match_tags(texec_model):
    """Every tagged hazard line in the fixture is found by SOME entry
    walk, and nothing untagged fires."""
    path = os.path.join(FIXTURES, "texec_stream.py")
    all_found = set()
    for entry in (
        "MiniEngine.run_clean", "MiniEngine.run_item_sink",
        "MiniEngine.run_truthy_sink", "MiniEngine.run_hidden_fetch",
        "MiniEngine.run_use_after_donate",
    ):
        all_found |= {f.line for f in texec_findings(texec_model, entry)}
    expected = set()
    for tag in ("T001 expected", "T002 expected", "T003 expected"):
        expected |= set(tagged_lines(path, tag))
    assert all_found == expected


def test_t001_real_executor_item_injection(tmp_path):
    """The CI mutation-smoke shape against the REAL executor: inject a
    `.item()` into `_run_stream_impl`'s dispatch loop in a scratch copy
    — T001 must fire naming the chain; the unmutated copy must only
    carry the two inline-allowed designed syncs."""
    root = tmp_path / "repo"
    dst = root / "madsim_tpu_torch" / "engine" / "core.py"
    dst.parent.mkdir(parents=True)
    shutil.copy(os.path.join(REPO, "madsim_tpu_torch", "engine", "core.py"), dst)
    model = projectmodel.build_model(str(root))
    raw = trules.check_model(model)
    sources = {mi.rel: mi.source for mi in model.modules.values()}
    assert filter_suppressed(raw, sources) == [], [
        f.text() for f in filter_suppressed(raw, sources)
    ]

    src = dst.read_text()
    needle = '                stats["dispatches"] += 1\n                in_flight += 1'
    assert needle in src, "executor anchor moved; update this test"
    dst.write_text(src.replace(
        needle,
        '                stats["dispatches"] += 1\n'
        '                stats["done"] = carry.completed.item()\n'
        '                in_flight += 1',
    ))
    model = projectmodel.build_model(str(root))
    found = [f for f in trules.check_model(model) if f.rule == "T001"]
    assert found and ".item()" in found[0].message
    assert "Engine._run_stream_impl" in found[0].message


# -- R-rules ------------------------------------------------------------------

_R_FILES = (
    "madsim_tpu_torch/ops/step_rng.py",
    "madsim_tpu_torch/ops/rng_layout.manifest",
    "madsim_tpu_torch/engine/core.py",
)


@pytest.fixture()
def r_repo(tmp_path):
    root = tmp_path / "repo"
    for rel in _R_FILES:
        dst = root / rel
        dst.parent.mkdir(parents=True, exist_ok=True)
        shutil.copy(os.path.join(REPO, rel), dst)
    return root


def _mutate(root, rel, old, new):
    p = root / rel
    src = p.read_text()
    assert old in src, f"mutation anchor not found in {rel}: {old!r}"
    p.write_text(src.replace(old, new))


def test_r_head_is_clean(r_repo):
    assert rrules.check_repo(str(r_repo)) == []


def test_r003_cursor_walk_reorder(r_repo):
    _mutate(
        r_repo, "madsim_tpu_torch/ops/step_rng.py",
        "    drop_off = None\n"
        "    if loss_possible:\n"
        "        drop_off = cursor\n"
        "        cursor += m\n"
        "    spike_off = None\n"
        "    if spike_possible:\n"
        "        spike_off = cursor\n"
        "        cursor += 2 * m\n",
        "    spike_off = None\n"
        "    if spike_possible:\n"
        "        spike_off = cursor\n"
        "        cursor += 2 * m\n"
        "    drop_off = None\n"
        "    if loss_possible:\n"
        "        drop_off = cursor\n"
        "        cursor += m\n",
    )
    found = rrules.check_repo(str(r_repo))
    assert [f.rule for f in found] == ["R003"]
    assert "corpus" in found[0].message or "rng_stream version" in found[0].message


def test_r002_read_past_section(r_repo):
    _mutate(
        r_repo, "madsim_tpu_torch/engine/core.py",
        "drop_bits = words[:, layout.drop_off : layout.drop_off + m.MAX_MSGS]",
        "drop_bits = words[:, layout.drop_off : layout.drop_off + 2 * m.MAX_MSGS]",
    )
    found = rrules.check_repo(str(r_repo))
    assert [f.rule for f in found] == ["R002"]
    assert "drop" in found[0].message and "NEXT section" in found[0].message


def test_r001_unrecorded_section_and_ghost_row(r_repo):
    # a new cursor section nobody recorded
    _mutate(
        r_repo, "madsim_tpu_torch/ops/step_rng.py",
        "    torn_off = None\n    if torn_possible:\n        torn_off = cursor\n        cursor += 1\n",
        "    torn_off = None\n    if torn_possible:\n        torn_off = cursor\n        cursor += 1\n"
        "    gray_off = None\n    if torn_possible:\n        gray_off = cursor\n        cursor += 2\n",
    )
    found = rrules.check_repo(str(r_repo))
    assert any(f.rule == "R001" and "gray" in f.message for f in found)
    # recording it makes the growth legal (tail append)
    manifest = r_repo / "madsim_tpu_torch/ops/rng_layout.manifest"
    manifest.write_text(manifest.read_text() + "gray\n")
    assert rrules.check_repo(str(r_repo)) == []
    # a manifest row with no code section is a ghost ledger entry
    manifest.write_text(manifest.read_text() + "phantom\n")
    found = rrules.check_repo(str(r_repo))
    assert any(
        f.rule == "R001" and "phantom" in f.message and "no longer derives" in f.message
        for f in found
    )


# -- the model cache ----------------------------------------------------------


def test_cache_replays_and_invalidates(tmp_path, monkeypatch):
    root = mini_repo(tmp_path, {
        "madsim_tpu_torch/foo.py": "import time\nts = time.time()\n",
    })
    calls = {"d": 0, "g": 0}
    from madsim_tpu_torch.analysis import cli as cli_mod, drules, grules

    real_d, real_g = drules.check_module, grules.check_repo
    monkeypatch.setattr(
        drules, "check_module",
        lambda *a, **k: calls.__setitem__("d", calls["d"] + 1) or real_d(*a, **k),
    )
    monkeypatch.setattr(
        grules, "check_repo",
        lambda *a, **k: calls.__setitem__("g", calls["g"] + 1) or real_g(*a, **k),
    )

    def lint():
        findings, _ = run_lint(
            [str(root / "madsim_tpu_torch")], repo_root=str(root),
            import_check=False, use_cache=True,
        )
        return findings

    first = lint()
    assert calls == {"d": 1, "g": 1}
    assert any(f.rule == "D001" for f in first)
    assert os.path.exists(
        str(root / lintcache.CACHE_DIR / lintcache.CACHE_FILE)
    )
    second = lint()
    # full replay: neither the per-file nor the repo pass re-ran
    assert calls == {"d": 1, "g": 1}
    assert [f.json_dict() for f in second] == [f.json_dict() for f in first]
    # touching the file invalidates both halves
    (root / "madsim_tpu_torch" / "foo.py").write_text(
        "import time\nts = time.time()\nts2 = time.time()\n"
    )
    third = lint()
    assert calls == {"d": 2, "g": 2}
    assert sum(1 for f in third if f.rule == "D001") == 2


def test_cache_version_skew_degrades_to_cold(tmp_path, monkeypatch):
    root = mini_repo(tmp_path, {"madsim_tpu_torch/foo.py": "x = 1\n"})
    run_lint([str(root / "madsim_tpu_torch")], repo_root=str(root),
             import_check=False, use_cache=True)
    cache_path = root / lintcache.CACHE_DIR / lintcache.CACHE_FILE
    doc = json.loads(cache_path.read_text())
    assert doc["version"] == lintcache.RULES_VERSION
    monkeypatch.setattr(lintcache, "RULES_VERSION", "lint-v999")
    cache = lintcache.LintCache(str(root))
    assert cache.doc["files"] == {}  # stale cache ignored, not served


# -- baseline ratchet ---------------------------------------------------------


def test_update_baseline_ratchet(tmp_path, capsys):
    victim = tmp_path / "victim.py"
    victim.write_text("import time\na = time.time()\nb = time.time()\n")
    baseline = str(tmp_path / "baseline.json")

    # first write: no baseline yet, anything goes
    rc = lint_main(ns(paths=[str(victim)], baseline=baseline,
                      update_baseline=True))
    assert rc == 0
    capsys.readouterr()

    # shrink is always legal
    victim.write_text("import time\na = time.time()\n")
    rc = lint_main(ns(paths=[str(victim)], baseline=baseline,
                      update_baseline=True))
    assert rc == 0
    capsys.readouterr()

    # growth refuses, names the escape hatch, and leaves the file alone
    victim.write_text(
        "import time\na = time.time()\nc = time.time()\nd = time.time()\n"
    )
    rc = lint_main(ns(paths=[str(victim)], baseline=baseline,
                      update_baseline=True))
    err = capsys.readouterr().err
    assert rc == 2
    assert "refusing to GROW" in err and "--force" in err
    assert len(json.loads(open(baseline).read())["findings"]) == 1

    # --force grandfathers deliberately
    rc = lint_main(ns(paths=[str(victim)], baseline=baseline,
                      update_baseline=True, force=True))
    assert rc == 0
    assert len(json.loads(open(baseline).read())["findings"]) == 3


def test_baseline_growth_is_count_aware():
    entry = {"rule": "D001", "path": "x.py", "message": "m"}
    f = Finding("D001", "error", "x.py", 1, 0, "m")
    assert baseline_growth([entry], [f]) == []
    assert baseline_growth([entry], [f, f]) == [f]  # second copy is growth


# -- SARIF --------------------------------------------------------------------


def test_sarif_output_schema_pinned(tmp_path, capsys):
    victim = tmp_path / "victim.py"
    victim.write_text("import time\nts = time.time()\n")
    out = str(tmp_path / "lint.sarif")
    rc = lint_main(ns(paths=[str(victim)], sarif=out))
    assert rc == 1
    doc = json.loads(open(out).read())
    assert doc["version"] == "2.1.0"
    assert doc["$schema"].endswith("sarif-schema-2.1.0.json")
    [run] = doc["runs"]
    driver = run["tool"]["driver"]
    assert driver["name"] == "madsim-tpu-torch-lint"
    rule_ids = [r["id"] for r in driver["rules"]]
    assert "D001" in rule_ids and "T003" in rule_ids and "R002" in rule_ids
    assert all(
        r["shortDescription"]["text"] for r in driver["rules"]
    )
    [res] = run["results"]
    assert res["ruleId"] == "D001" and res["level"] == "error"
    assert rule_ids[res["ruleIndex"]] == "D001"
    [loc] = res["locations"]
    region = loc["physicalLocation"]["region"]
    assert region["startLine"] == 2 and region["startColumn"] >= 1
    assert loc["physicalLocation"]["artifactLocation"]["uri"].endswith(
        "victim.py"
    )


def test_sarif_empty_run_is_valid(tmp_path):
    victim = tmp_path / "clean.py"
    victim.write_text("x = 1\n")
    out = str(tmp_path / "clean.sarif")
    rc = lint_main(ns(paths=[str(victim)], sarif=out))
    assert rc == 0
    doc = json.loads(open(out).read())
    assert doc["runs"][0]["results"] == []


def test_sarif_severity_mapping():
    doc = sarif_doc(
        [
            Finding("T001", "warning", "a.py", 3, 1, "w"),
            Finding("T003", "error", "a.py", 4, 0, "e"),
        ],
        "test",
    )
    levels = {r["ruleId"]: r["level"] for r in doc["runs"][0]["results"]}
    assert levels == {"T001": "warning", "T003": "error"}


# -- S-rules (lane-axis sharding readiness) -----------------------------------

_MINI_COLLECTIVES = {
    "mini-done-any": srules.Collective("any", ("segment",), "fixture"),
    "mini-count": srules.Collective("sum", ("segment",), "fixture"),
}
_MINI_AXES = {
    "FakeCarry": {"state": "lane", "count": "global"},
    "MiniState": {"done": "lane", "step": "lane"},
}


@pytest.fixture(scope="module")
def saxes_model(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("saxes")
    root = tmp / "repo"
    dst = root / "madsim_tpu_torch" / "saxes_stream.py"
    dst.parent.mkdir(parents=True)
    shutil.copy(os.path.join(FIXTURES, "saxes_stream.py"), dst)
    (root / "madsim_tpu_torch" / "__init__.py").write_text("")
    return projectmodel.build_model(str(root))


_S_ENTRIES = (
    ("MiniStream.seg_clean", "segment"),
    ("MiniStream.seg_unannotated_sum", "segment"),
    ("MiniStream.seg_scan_carry_leak", "step"),
    ("MiniStream.seg_reshape_drops_lane", "segment"),
    ("MiniStream.seg_rebuild_leaf", "segment"),
    ("MiniStream.seg_host_if", "segment"),
    ("MiniStream.seg_unregistered", "segment"),
)


def s_findings(model, entries, audit=False):
    return srules.check_model(
        model,
        entrypoints=[
            EntryPoint("madsim_tpu_torch.saxes_stream", qual, region, {"c": CARRY})
            for qual, region in entries
        ],
        collectives=_MINI_COLLECTIVES,
        carry_axes=_MINI_AXES,
        audited_classes=(),
        carry_classes={"FakeCarry", "MiniState"},
        carry_fields={"state"},
        region_overrides={},
        audit_registry=audit,
    )


def test_saxes_clean_entry_stays_clean(saxes_model):
    """Scan-carry threading keeps the lane axis through the while_loop
    AND the annotated folds stay silent; `where` on mixed-axis operands
    is lane-parallel (no finding)."""
    assert s_findings(saxes_model, _S_ENTRIES[:1]) == []


def test_saxes_unannotated_sum_is_s001(saxes_model):
    found = s_findings(saxes_model, [_S_ENTRIES[1]])
    assert [f.rule for f in found] == ["S001"]
    assert "chain:" in found[0].message


def test_saxes_scan_carry_leak_is_s001_and_s004(saxes_model):
    """The fold smuggled into the while-loop body: undeclared (S001)
    and misplaced in the per-event region (S004), on the same line."""
    found = s_findings(saxes_model, [_S_ENTRIES[2]])
    assert sorted(f.rule for f in found) == ["S001", "S004"]
    assert len({f.line for f in found}) == 1


def test_saxes_reshape_drops_lane_is_s001(saxes_model):
    found = s_findings(saxes_model, [_S_ENTRIES[3]])
    assert [f.rule for f in found] == ["S001"]
    assert "reshape" in found[0].message


def test_saxes_rebuild_global_leaf_is_s002(saxes_model):
    """The donated-rebuild hazard: a lane-axis value fed into a
    global-declared carry leaf at a rebuild site."""
    found = s_findings(saxes_model, [_S_ENTRIES[4]])
    assert [f.rule for f in found] == ["S002"]
    assert "count" in found[0].message and "global" in found[0].message


def test_saxes_host_if_is_s003(saxes_model):
    found = s_findings(saxes_model, [_S_ENTRIES[5]])
    assert [f.rule for f in found] == ["S003"]


def test_saxes_unregistered_annotation_is_s001(saxes_model):
    found = s_findings(saxes_model, [_S_ENTRIES[6]])
    assert [f.rule for f in found] == ["S001"]
    assert "no entry in the registry" in found[0].message


def test_saxes_expected_lines_match_tags(saxes_model):
    """Every tagged line is flagged with exactly its rule, nothing
    untagged fires, and the registry audit is clean when every entry
    context runs (both fixture collectives are consumed)."""
    path = os.path.join(FIXTURES, "saxes_stream.py")
    found = s_findings(saxes_model, _S_ENTRIES, audit=True)
    by_rule = {}
    for f in found:
        by_rule.setdefault(f.rule, set()).add(f.line)
    for rule in ("S001", "S002", "S003", "S004"):
        assert by_rule.get(rule, set()) == set(
            tagged_lines(path, f"{rule} expected")
        ), (rule, sorted(by_rule.get(rule, set())))


_S_CORE_FILES = (
    "madsim_tpu_torch/__init__.py",
    "madsim_tpu_torch/kinds.py",
    "madsim_tpu_torch/utils.py",
    "madsim_tpu_torch/engine/__init__.py",
    "madsim_tpu_torch/engine/core.py",
    "madsim_tpu_torch/engine/machine.py",
    "madsim_tpu_torch/parallel/__init__.py",
    "madsim_tpu_torch/parallel/multihost.py",
    "madsim_tpu_torch/ops/__init__.py",
    # the cov-map-or collective is ops/coverage.cov_fold_words and the
    # ring appends parallel.compact: the interprocedural walk must reach
    # them or their registry rows read as stale
    "madsim_tpu_torch/ops/coverage.py",
    "madsim_tpu_torch/ops/kernels.py",
    "madsim_tpu_torch/ops/step_rng.py",
    "madsim_tpu_torch/ops/u32.py",
)


@pytest.fixture()
def s_core_repo(tmp_path):
    root = tmp_path / "repo"
    for rel in _S_CORE_FILES:
        dst = root / rel
        dst.parent.mkdir(parents=True, exist_ok=True)
        shutil.copy(os.path.join(REPO, rel), dst)
    return root


def test_s_real_executor_clean_then_mutated(s_core_repo):
    """The mutation-smoke shape against the REAL executor: the unmutated
    scratch copy is clean (every cross-lane op annotated and
    registered); injecting a lane-axis `sum(dim=0)` into the per-event
    segment loop fires S001 with the propagation chain AND S004 for the
    placement; stripping a designed collective's annotation fires S001
    at the now-undeclared op plus the stale-registry-row error."""
    model = projectmodel.build_model(str(s_core_repo))
    assert srules.check_model(model) == [], [
        f.text() for f in srules.check_model(model)
    ]

    p = s_core_repo / "madsim_tpu_torch" / "engine" / "core.py"
    src = p.read_text()
    needle = "                state = self.step_batch(state, running, go)\n"
    assert needle in src, "executor anchor moved; update this test"
    p.write_text(src.replace(
        needle,
        "                _probe = state.msg_count.to(torch.int64).sum(dim=0)\n" + needle,
    ))
    found = srules.check_model(projectmodel.build_model(str(s_core_repo)))
    s001 = [f for f in found if f.rule == "S001"]
    assert s001 and "chain: Engine.run_segment" in s001[0].message
    assert any(f.rule == "S004" for f in found)

    # stripping either designed collective's annotation — the early-exit
    # done-any or the refill's rank scan — fires S001 at the
    # now-undeclared op plus the stale-registry-row error for its name
    for ann, reg_name in (
        ("# madsim: collective(segment-done-any, reduce=any)",
         "segment-done-any"),
        ("# madsim: collective(refill-ranks, reduce=scan)",
         "refill-ranks"),
    ):
        assert ann in src, "annotation anchor moved; update this test"
        p.write_text(src.replace(ann, "# (stripped)"))
        found = srules.check_model(projectmodel.build_model(str(s_core_repo)))
        assert any(f.rule == "S001" and f.line > 0 for f in found)
        assert any(
            f.rule == "S001" and reg_name in f.message and f.line == 0
            for f in found
        )


def test_s_head_is_clean(repo_model):
    """The sharding-readiness contract holds at HEAD: every cross-lane
    op in the step/harvest paths is either lane-parallel by analysis or
    carries a registered collective annotation; the registry has no
    stale rows; every carry leaf is axis-declared."""
    assert srules.check_model(repo_model) == [], [
        f.text() for f in srules.check_model(repo_model)
    ]


# -- lint --changed (git-diff scoping) ----------------------------------------


def test_scoped_files_reverse_dependents(tmp_path):
    model = model_of(tmp_path, {
        "madsim_tpu_torch/__init__.py": "",
        "madsim_tpu_torch/base.py": "X = 1\n",
        "madsim_tpu_torch/mid.py": "from .base import X\n",
        "madsim_tpu_torch/top.py": "from .mid import X\n",
        "madsim_tpu_torch/other.py": "Y = 2\n",
    })
    root = str(tmp_path / "repo")
    scope = scoped_files(model, root, ["madsim_tpu_torch/base.py"])
    rels = {os.path.relpath(p, root) for p in scope}
    # the changed module + everything that (transitively) imports it;
    # the unrelated module stays out of scope
    assert {"madsim_tpu_torch/base.py", "madsim_tpu_torch/mid.py",
            "madsim_tpu_torch/top.py"} <= rels
    assert "madsim_tpu_torch/other.py" not in rels


# -- the D006 fixture keeps passing (satellite pin) ---------------------------


def test_d006_fixture_unchanged_by_t_pass():
    """T001 subsumes the helper gap but must not change what D006
    reports on its own fixture (the file-local contract is pinned)."""
    from madsim_tpu_torch.analysis import drules
    import ast as _ast

    path = os.path.join(FIXTURES, "d006_truthiness.py")
    src = open(path).read()
    found = [
        f for f in drules.check_module(_ast.parse(src), src, path)
        if f.rule == "D006"
    ]
    assert [f.line for f in found] == [15, 18, 20, 26]
