"""`python -m madsim_tpu_torch lint` — the port's determinism & contract
analyzer (`madsim_tpu_torch/analysis/`), case for case the mirror of
tests/test_lint.py on the port.

Covers: every D/C rule against a deliberately-broken fixture (exact
rule ID + line; the plain-python fixtures are the JAX package's own in
tests/lint_fixtures/, the torch ones their twins in
tests/torch_lint_fixtures/), honest shipped models lint clean,
suppression and baseline round-trips, the stable --json schema, the
G-rule mirror cross-checks against injected drift in scratch copies of
the port's files, the RNG-layout manifest audit, and the two --fix
rewrites.

The D/G passes are AST-only (no torch); the C import half runs on the
contract fixture and the shipped models.
"""

import argparse
import ast
import json
import os
import shutil

import pytest

from madsim_tpu_torch.analysis import crules, drules, grules
from madsim_tpu_torch.analysis.cli import main as lint_main, run_lint
from madsim_tpu_torch.analysis.findings import (
    Finding,
    Suppressions,
    apply_baseline,
    filter_suppressed,
    load_baseline,
    save_baseline,
)
from madsim_tpu_torch.analysis.fixes import fix_source

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(REPO, "tests", "lint_fixtures")
TORCH_FIXTURES = os.path.join(REPO, "tests", "torch_lint_fixtures")


def lint_paths(*paths, import_check=False, rules=None, fixtures=FIXTURES):
    findings, sources = run_lint(
        [os.path.join(fixtures, p) if not os.path.isabs(p) else p for p in paths],
        rules=rules,
        import_check=import_check,
        repo_root=REPO,
    )
    return findings


def rule_lines(findings, rule):
    return sorted(
        (os.path.basename(f.path), f.line)
        for f in findings
        if f.rule == rule
    )


def ns(**kw):
    # repo_root=None: tmp-file victims stay out of the whole-program
    # passes (find_repo_root sees nothing above /tmp); tests that lint
    # real package paths still auto-discover the root
    base = dict(
        paths=[], rules=None, json=False, github=False, fix=False,
        baseline=None, update_baseline=False, no_import_check=True,
        repo_root=None, verbose=False, sarif=None, cache=False, force=False,
    )
    base.update(kw)
    return argparse.Namespace(**base)


# -- D-rules: one broken fixture per rule, exact ID + line -------------------


def test_d001_wallclock_flagged():
    f = lint_paths("d001_wallclock.py", rules=["D001"])
    assert rule_lines(f, "D001") == [
        ("d001_wallclock.py", 9),
        ("d001_wallclock.py", 13),
        ("d001_wallclock.py", 17),
    ]
    assert all("madsim_tpu_torch.time" in x.message for x in f)


def test_d002_entropy_flagged_seeded_ok():
    f = lint_paths("d002_entropy.py", rules=["D002"])
    assert rule_lines(f, "D002") == [
        ("d002_entropy.py", 10),
        ("d002_entropy.py", 14),
        ("d002_entropy.py", 18),
        ("d002_entropy.py", 22),
    ]


def test_d003_set_iteration_flagged_sorted_ok():
    f = lint_paths("d003_set_iter.py", rules=["D003"])
    assert rule_lines(f, "D003") == [
        ("d003_set_iter.py", 6),
        ("d003_set_iter.py", 12),
    ]
    assert all(x.fixable for x in f)


def test_d004_id_hash_flagged_dunder_hash_ok():
    f = lint_paths("d004_id_hash.py", rules=["D004"])
    assert rule_lines(f, "D004") == [
        ("d004_id_hash.py", 5),
        ("d004_id_hash.py", 9),
    ]


def test_d005_unordered_callbacks_flagged():
    f = lint_paths("d005_callback.py", rules=["D005"])
    assert rule_lines(f, "D005") == [
        ("d005_callback.py", 8),
        ("d005_callback.py", 13),
    ]
    assert all(x.fixable for x in f)


def test_d006_traced_truthiness_flagged_static_ok():
    f = lint_paths("d006_truthiness.py", rules=["D006"], fixtures=TORCH_FIXTURES)
    assert rule_lines(f, "D006") == [
        ("d006_truthiness.py", 15),
        ("d006_truthiness.py", 18),
        ("d006_truthiness.py", 20),
        ("d006_truthiness.py", 26),
    ]
    assert all(x.severity == "warning" for x in f)


# -- C-rules -----------------------------------------------------------------


def test_c001_handler_self_mutation():
    f = lint_paths("c001_mutation.py", rules=["C001"])
    assert rule_lines(f, "C001") == [
        ("c001_mutation.py", 13),
        ("c001_mutation.py", 17),
        ("c001_mutation.py", 18),
        ("c001_mutation.py", 22),
    ]


def test_c005_bitmask_cap():
    f = lint_paths("c005_bitmask.py", rules=["C005"])
    assert rule_lines(f, "C005") == [("c005_bitmask.py", 12)]
    msgs = [x.message for x in f]
    assert "UncappedVoteMachine" in msgs[0]


def test_c_contract_import_half():
    """C002/C003/C004 via real instantiation at one lane on the CPU —
    anchored to the method that states the broken contract; the honest
    twin stays clean."""
    f = lint_paths("c_contracts.py", import_check=True, rules=["C"], fixtures=TORCH_FIXTURES)
    by_rule = {x.rule: x for x in f}
    assert set(by_rule) == {"C002", "C003", "C004"}
    src = open(os.path.join(TORCH_FIXTURES, "c_contracts.py")).read()
    tree = ast.parse(src)
    method_line = {
        (cls.name, fn.name): fn.lineno
        for cls in ast.walk(tree) if isinstance(cls, ast.ClassDef)
        for fn in cls.body if isinstance(fn, ast.FunctionDef)
    }
    assert by_rule["C002"].line == method_line[("BadDurableSpecMachine", "durable_spec")]
    assert by_rule["C003"].line == method_line[("BadTornSpecMachine", "torn_spec")]
    assert by_rule["C004"].line == method_line[("VectorProjectionMachine", "coverage_projection")]
    assert "(1, 3)" in by_rule["C004"].message
    assert not [x for x in f if "HonestContractMachine" in x.message]


def test_shipped_models_lint_clean():
    """Every honest model in madsim_tpu_torch/models passes all three
    rule families, import half included — the authoring contract holds."""
    findings, sources = run_lint(
        [os.path.join(REPO, "madsim_tpu_torch", "models")],
        import_check=True,
        repo_root=REPO,
        # per-file families only: the whole-program passes run once in
        # test_whole_package_self_run_clean (they are root-wide anyway)
        rules=["D", "C"],
    )
    findings = filter_suppressed(findings, sources)
    assert findings == [], [f.text() for f in findings]


def test_whole_package_self_run_clean():
    """The acceptance gate: `lint madsim_tpu_torch/` exits 0 with the
    port's checked-in (empty) baseline — every shipped suppression is
    inline and justified."""
    rc = lint_main(ns(
        paths=[os.path.join(REPO, "madsim_tpu_torch")], github=True,
        no_import_check=False,
    ))
    assert rc == 0


def test_perf_package_self_lints_clean():
    """The perf package's CONTRACT is reading the wall clock (host
    timelines, A/B rep timing, history timestamps) — exactly what D001
    bans elsewhere. Its modules carry file-level allowances with a
    written justification, and the package must lint clean (rc 0)."""
    perf_dir = os.path.join(REPO, "madsim_tpu_torch", "perf")
    rc = lint_main(ns(paths=[perf_dir], rules="D"))
    assert rc == 0
    for fname in ("recorder.py", "ab.py", "history.py", "xprof.py"):
        with open(os.path.join(perf_dir, fname)) as f:
            src = f.read()
        assert "madsim: allow-file(D001)" in src, fname
        allow_line = [
            l for l in src.splitlines() if "allow-file(D001)" in l
        ][0]
        assert "—" in allow_line or "--" in allow_line, (
            f"{fname}: allow-file needs its justification on the line"
        )


def test_fleet_events_allowance_and_zone():
    """The fleet event log's CONTRACT is wall timestamps, so
    fleet/events.py carries the justified file-level D001 allowance,
    lints clean under it, and is claimed in the torch-free zone."""
    path = os.path.join(REPO, "madsim_tpu_torch", "fleet", "events.py")
    with open(path) as f:
        src = f.read()
    assert "madsim: allow-file(D001)" in src
    allow_line = [
        l for l in src.splitlines() if "allow-file(D001)" in l
    ][0]
    assert "—" in allow_line or "--" in allow_line, (
        "events.py: allow-file needs its justification on the line"
    )
    assert lint_main(ns(paths=[path], rules="D")) == 0
    from madsim_tpu_torch.analysis.layers import TORCH_FREE_ZONE

    assert "madsim_tpu_torch.fleet.events" in TORCH_FREE_ZONE


# -- suppressions + baseline -------------------------------------------------


def test_inline_suppression_roundtrip(tmp_path):
    victim = tmp_path / "victim.py"
    victim.write_text(
        "import time\n"
        "\n"
        "def a():\n"
        "    return time.time()  # madsim: allow(D001) -- frozen clock\n"
        "\n"
        "def b():\n"
        "    # madsim: allow(D001) -- covered by the comment line\n"
        "    return time.time()\n"
        "\n"
        "def c():\n"
        "    return time.time()\n"
    )
    findings, sources = run_lint([str(victim)], import_check=False)
    kept = filter_suppressed(findings, sources)
    assert [f.line for f in findings if f.rule == "D001"] == [4, 8, 11]
    assert [f.line for f in kept if f.rule == "D001"] == [11]
    assert Suppressions(victim.read_text()).line_allows[8] == {"D001"}


def test_file_level_suppression(tmp_path):
    victim = tmp_path / "realmode.py"
    victim.write_text(
        "# madsim: allow-file(D001) -- real-mode shim\n"
        "import time\n"
        "\n"
        "def a():\n"
        "    return time.time()\n"
    )
    findings, sources = run_lint([str(victim)], import_check=False)
    assert [f for f in filter_suppressed(findings, sources) if f.rule == "D001"] == []


def test_baseline_roundtrip(tmp_path):
    f1 = Finding("D001", "error", "x.py", 4, 0, "wall-clock read")
    f2 = Finding("D003", "error", "y.py", 9, 2, "set iteration")
    path = str(tmp_path / "baseline.json")
    save_baseline(path, [f1, f2])
    entries = load_baseline(path)
    fresh, consumed = apply_baseline([f1, f2], entries)
    assert fresh == [] and len(consumed) == 2
    # a NEW finding is not grandfathered; line drift alone is
    moved = Finding("D001", "error", "x.py", 40, 0, "wall-clock read")
    novel = Finding("D002", "error", "x.py", 5, 0, "entropy")
    fresh, _ = apply_baseline([moved, novel], entries)
    assert fresh == [novel]


def test_shipped_baseline_is_empty():
    """The port's own baseline, shipped empty; the JAX package's file is
    not the port's default."""
    from madsim_tpu_torch.analysis.findings import DEFAULT_BASELINE_NAME

    assert DEFAULT_BASELINE_NAME == ".madsim-torch-lint-baseline.json"
    doc = json.load(open(os.path.join(REPO, DEFAULT_BASELINE_NAME)))
    assert doc == {"version": 1, "findings": []}


# -- output formats ----------------------------------------------------------


def test_json_schema_stability(tmp_path, capsys):
    victim = tmp_path / "victim.py"
    victim.write_text("import time\nts = time.time()\n")
    rc = lint_main(ns(paths=[str(victim)], json=True))
    out = json.loads(capsys.readouterr().out)
    assert rc == 1
    assert set(out) == {"version", "findings", "counts"}
    assert out["version"] == 1
    assert set(out["counts"]) == {"error", "warning", "baselined"}
    [f] = out["findings"]
    assert set(f) == {
        "rule", "severity", "path", "line", "col", "message", "fixable"
    }
    assert (f["rule"], f["severity"], f["line"]) == ("D001", "error", 2)


def test_github_annotations(tmp_path, capsys):
    victim = tmp_path / "victim.py"
    victim.write_text("import time\nts = time.time()\n")
    rc = lint_main(ns(paths=[str(victim)], github=True))
    out = capsys.readouterr().out
    assert rc == 1
    assert out.startswith("::error file=")
    assert "title=D001" in out


def test_exit_codes(tmp_path, capsys):
    clean = tmp_path / "clean.py"
    clean.write_text("x = 1\n")
    assert lint_main(ns(paths=[str(clean)])) == 0
    assert lint_main(ns(paths=[str(tmp_path / "missing.py")])) == 2


# -- --fix -------------------------------------------------------------------


def test_fix_set_iteration_and_callbacks(tmp_path):
    src = (
        "import jax\n"
        "def f(names, x):\n"
        "    out = [n for n in set(names)]\n"
        "    for n in {1, 2}:\n"
        "        out.append(n)\n"
        "    jax.debug.callback(print, x)\n"
        "    jax.debug.callback(print, x, ordered=False)\n"
        "    return out\n"
    )
    fixed, n = fix_source(src, "f.py")
    assert n == 4
    assert "sorted(set(names))" in fixed
    assert "sorted({1, 2})" in fixed
    assert "jax.debug.callback(print, x, ordered=True)" in fixed
    assert fixed.count("ordered=True") == 2
    # fixed source lints clean on those rules
    tree = ast.parse(fixed)
    f = [
        x for x in drules.check_module(tree, fixed, "f.py")
        if x.rule in ("D003", "D005")
    ]
    assert f == []
    assert crules.check_module(tree, fixed, "f.py") == []


# -- G-rules: mirror drift injection -----------------------------------------

_G_FILES = (
    "madsim_tpu_torch/kinds.py",
    "madsim_tpu_torch/__main__.py",
    "madsim_tpu_torch/engine/core.py",
    "madsim_tpu_torch/engine/shrink.py",
    "madsim_tpu_torch/runtime/metrics.py",
    "madsim_tpu_torch/runtime/coverage.py",
    "madsim_tpu_torch/ops/coverage.py",
    "madsim_tpu_torch/ops/step_rng.py",
    "madsim_tpu_torch/ops/rng_layout.manifest",
    "madsim_tpu_torch/search/bias.py",
    "tests/test_torch_gates.py",
    "tests/test_torch_rng.py",
)


@pytest.fixture()
def repo_copy(tmp_path):
    root = tmp_path / "repo"
    for rel in _G_FILES:
        dst = root / rel
        dst.parent.mkdir(parents=True, exist_ok=True)
        shutil.copy(os.path.join(REPO, rel), dst)
    return root


def _mutate(root, rel, old, new):
    path = root / rel
    src = path.read_text()
    assert old in src, f"mutation anchor not found in {rel}: {old!r}"
    path.write_text(src.replace(old, new))


def g_rules(root):
    return sorted({f.rule for f in grules.check_repo(str(root))})


def test_g_head_is_clean(repo_copy):
    assert grules.check_repo(str(repo_copy)) == []


def test_g001_fr_mirror_drift(repo_copy):
    _mutate(
        repo_copy, "madsim_tpu_torch/runtime/metrics.py",
        "from ..kinds import FAULT_KIND_NAMES as FR_FAULT_KINDS",
        "FR_FAULT_KINDS = ('pair', 'kill')",
    )
    assert "G001" in g_rules(repo_copy)


def test_g002_band_mirror_drift(repo_copy):
    _mutate(
        repo_copy, "madsim_tpu_torch/ops/coverage.py",
        "COV_BAND_NAMES_V2 = _kinds.COV_BAND_NAMES_V2",
        "COV_BAND_NAMES_V2 = COV_BAND_NAMES + ('pause', 'skew')",
    )
    assert "G002" in g_rules(repo_copy)


def test_g003_ablation_kind_deleted(repo_copy):
    _mutate(
        repo_copy, "madsim_tpu_torch/engine/shrink.py",
        '"torn", "heal-asym", "delay",',
        '"heal-asym", "delay",',
    )
    found = grules.check_repo(str(repo_copy))
    assert [f.rule for f in found] == ["G003"]
    assert "torn" in found[0].message


def test_g004_cli_vocabulary_detached(repo_copy):
    _mutate(
        repo_copy, "madsim_tpu_torch/__main__.py",
        "from .kinds import CLI_KIND_TO_FLAG",
        "CLI_KIND_TO_FLAG = ()",
    )
    assert "G004" in g_rules(repo_copy)


def test_g005_gate_matrix_missing_flag(repo_copy):
    _mutate(
        repo_copy, "tests/test_torch_gates.py",
        "allow_pause", "allow_paws",
    )
    assert "G005" in g_rules(repo_copy)


def test_g006_golden_pin_missing_flag(repo_copy):
    _mutate(
        repo_copy, "tests/test_torch_rng.py",
        "allow_torn", "allow_tornado",
    )
    assert "G006" in g_rules(repo_copy)


def test_g007_kind_index_or_new_kind_drift(repo_copy):
    # a new kind appended to the table but nowhere else: every mirror
    # that must learn it reports (the "a PR adds a kind" checklist)
    _mutate(
        repo_copy, "madsim_tpu_torch/kinds.py",
        '    "torn", "heal-asym",\n)',
        '    "torn", "heal-asym", "gray-failure",\n)',
    )
    rules = g_rules(repo_copy)
    assert "G007" in rules  # no K_GRAY_FAILURE / KIND_TO_FLAG entry
    _mutate(
        repo_copy, "madsim_tpu_torch/engine/core.py",
        "K_HEAL_ASYM = 9", "K_HEAL_ASYM = 12",
    )
    assert any(
        "K_HEAL_ASYM" in f.message for f in grules.check_repo(str(repo_copy))
    )


def test_g008_rng_layout_manifest(repo_copy):
    # unrecorded tail growth: a new *_off field appended but no
    # manifest line
    _mutate(
        repo_copy, "madsim_tpu_torch/ops/step_rng.py",
        "    torn_off: Optional[int] = None",
        "    torn_off: Optional[int] = None\n"
        "    gray_off: Optional[int] = None",
    )
    found = grules.check_repo(str(repo_copy))
    assert [f.rule for f in found] == ["G008"]
    assert "gray" in found[0].message
    # recording it in the manifest makes tail growth legal
    path = repo_copy / "madsim_tpu_torch/ops/rng_layout.manifest"
    path.write_text(path.read_text() + "gray\n")
    assert grules.check_repo(str(repo_copy)) == []
    # but REORDERING sections is a corpus-breaking event
    _mutate(
        repo_copy, "madsim_tpu_torch/ops/rng_layout.manifest",
        "lat\ndrop\n", "drop\nlat\n",
    )
    found = grules.check_repo(str(repo_copy))
    assert [f.rule for f in found] == ["G008"]
    assert "inserted, removed or reordered" in found[0].message


def test_g009_escalation_ladder_literal_mirror(repo_copy):
    """A hand-maintained kind-name literal in the escalation ladder is
    exactly the drift class the kinds table exists to prevent."""
    _mutate(
        repo_copy, "madsim_tpu_torch/search/bias.py",
        "ESCALATION_LADDER = (\n"
        "    FAULT_KIND_NAMES[:6],\n"
        "    FAULT_KIND_NAMES[:8],\n"
        "    FAULT_KIND_NAMES[:10],\n"
        "    FAULT_KIND_NAMES + (\"dup\",),\n"
        ")",
        "ESCALATION_LADDER = (\n"
        '    ("pair", "kill", "dir", "group", "storm", "delay"),\n'
        '    ("pair", "kill", "dir", "group", "storm", "delay",\n'
        '     "pause", "skew"),\n'
        '    ("pair", "kill", "dir", "group", "storm", "delay",\n'
        '     "pause", "skew", "torn", "heal-asym"),\n'
        '    ("pair", "kill", "dir", "group", "storm", "delay",\n'
        '     "pause", "skew", "torn", "heal-asym", "dup"),\n'
        ")",
    )
    found = grules.check_repo(str(repo_copy))
    assert [f.rule for f in found] == ["G009"]
    assert "bind" in found[0].message


def test_g009_ladder_must_widen_and_cover(repo_copy):
    # a rung that narrows (slice shrinks) breaks strict widening
    _mutate(
        repo_copy, "madsim_tpu_torch/search/bias.py",
        "FAULT_KIND_NAMES[:8],", "FAULT_KIND_NAMES[:4],",
    )
    found = grules.check_repo(str(repo_copy))
    assert "G009" in {f.rule for f in found}
    assert any("widen" in f.message for f in found)


def test_g009_ladder_final_rung_must_cover_palette(repo_copy):
    _mutate(
        repo_copy, "madsim_tpu_torch/search/bias.py",
        'FAULT_KIND_NAMES + ("dup",),\n', "FAULT_KIND_NAMES,\n",
    )
    found = grules.check_repo(str(repo_copy))
    assert "G009" in {f.rule for f in found}
    assert any("full CLI" in f.message for f in found)


def test_lint_cli_catches_injected_drift(repo_copy, capsys):
    """End to end: drift in one mirror must fail `lint --rules G`
    nonzero and name the rule."""
    _mutate(
        repo_copy, "madsim_tpu_torch/engine/shrink.py",
        '"pause", "skew", "dup",', '"pause", "skew",',
    )
    rc = lint_main(ns(
        paths=[str(repo_copy / "madsim_tpu_torch" / "kinds.py")],
        rules="G", repo_root=str(repo_copy),
    ))
    out = capsys.readouterr().out
    assert rc == 1
    assert "G003" in out and "dup" in out
