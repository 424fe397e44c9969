"""The port's linter (`madsim_tpu_torch/analysis/`) held against the JAX
package's (`madsim_tpu/analysis/`), rule for rule.

(a) D001-D005, C001 and C005 on the JAX package's own plain-python
    fixtures: equal (rule, line, col, severity), and equal messages once
    package names are mapped.
(b) D006, C002-C004, T001-T003 and S001-S004: the JAX linter on its
    fixture, the port's on the torch twin (tests/torch_lint_fixtures/,
    every expectation tag on the same line): equal (rule, line) sets.
(c) Every G and R mutation of tests/test_lint.py and
    tests/test_lint_v2.py, applied to scratch copies of both packages'
    files: the same rule IDs on both, step by step, and both heads
    clean.
(d) `fix_source` gives byte-equal output on both.
(e) The JSON and SARIF documents are equal for equal findings, apart
    from the tool's name (and its version, the rules version).
"""

import argparse
import ast
import json
import os
import shutil

import pytest

from madsim_tpu.analysis import (
    cli as jax_cli, crules as jax_crules, drules as jax_drules, findings as jax_findings,
    fixes as jax_fixes, grules as jax_grules, projectmodel as jax_pm, rrules as jax_rrules,
    srules as jax_srules, trules as jax_trules,
)
from madsim_tpu.analysis.axes import CARRY as JAX_CARRY, EntryPoint as JaxEntryPoint
from madsim_tpu_torch.analysis import (
    cli, crules, drules, findings, fixes, grules, projectmodel, rrules, srules, trules,
)
from madsim_tpu_torch.analysis.axes import CARRY, EntryPoint

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_FIXTURES = os.path.join(REPO, "tests", "lint_fixtures")
TORCH_FIXTURES = os.path.join(REPO, "tests", "torch_lint_fixtures")


def _map_names(message: str) -> str:
    return message.replace("madsim_tpu_torch", "madsim_tpu")


# -- (a) the plain-python fixtures, linted by both -----------------------------

_PLAIN = [
    ("d001_wallclock.py", "D001"), ("d002_entropy.py", "D002"), ("d003_set_iter.py", "D003"),
    ("d004_id_hash.py", "D004"), ("d005_callback.py", "D005"), ("c001_mutation.py", "C001"),
    ("c005_bitmask.py", "C005"),
]


@pytest.mark.parametrize("fixture,rule", _PLAIN, ids=[r for _f, r in _PLAIN])
def test_plain_fixture_findings_equal(fixture, rule):
    path = os.path.join(JAX_FIXTURES, fixture)
    src = open(path).read()
    tree = ast.parse(src)

    def rows(dmod, cmod):
        found = dmod.check_module(tree, src, path) + cmod.check_module(tree, src, path)
        return sorted((f.rule, f.line, f.col, f.severity, f.fixable, _map_names(f.message)) for f in found)

    want, got = rows(jax_drules, jax_crules), rows(drules, crules)
    assert got == want
    assert any(r[0] == rule for r in got), rule


# -- (b) the torch twins against the JAX fixtures -------------------------------


def _rule_lines(found, prefix):
    return sorted({(f.rule, f.line) for f in found if f.rule.startswith(prefix)})


@pytest.mark.parametrize("fixture,import_check,family", [
    ("d006_truthiness.py", False, "D006"),
    ("c_contracts.py", True, "C"),
], ids=["D006", "C002-C004"])
def test_twin_fixture_rule_lines_equal(fixture, import_check, family):
    want, _ = jax_cli.run_lint([os.path.join(JAX_FIXTURES, fixture)], import_check=import_check,
                               repo_root=REPO, rules=[family])
    got, _ = cli.run_lint([os.path.join(TORCH_FIXTURES, fixture)], import_check=import_check,
                          repo_root=REPO, rules=[family])
    assert _rule_lines(got, family) == _rule_lines(want, family) != []


def _fixture_model(tmp_path, pm, package, fixture_dir, fixture):
    root = tmp_path / package
    dst = root / package / fixture
    dst.parent.mkdir(parents=True)
    shutil.copy(os.path.join(fixture_dir, fixture), dst)
    (root / package / "__init__.py").write_text("")
    return pm.build_model(str(root))


def _both_models(tmp_path, fixture):
    return (_fixture_model(tmp_path, jax_pm, "madsim_tpu", JAX_FIXTURES, fixture),
            _fixture_model(tmp_path, projectmodel, "madsim_tpu_torch", TORCH_FIXTURES, fixture))


def test_t001_handler_helpers_rule_lines_equal(tmp_path):
    jax_model, model = _both_models(tmp_path, "t001_helpers.py")
    want = _rule_lines(jax_trules.check_model(jax_model), "T")
    assert _rule_lines(trules.check_model(model), "T") == want != []


_TEXEC_ENTRIES = ("MiniEngine.run_clean", "MiniEngine.run_item_sink", "MiniEngine.run_truthy_sink",
                  "MiniEngine.run_hidden_fetch", "MiniEngine.run_use_after_donate")


@pytest.mark.parametrize("entry", _TEXEC_ENTRIES)
def test_texec_rule_lines_equal(tmp_path, entry):
    jax_model, model = _both_models(tmp_path, "texec_stream.py")
    want = jax_trules.check_model(jax_model, executor_entrypoints=(("madsim_tpu.texec_stream", entry),))
    got = trules.check_model(model, executor_entrypoints=(("madsim_tpu_torch.texec_stream", entry),))
    assert _rule_lines(got, "T") == _rule_lines(want, "T")


_S_ENTRIES = (
    ("MiniStream.seg_clean", "segment"),
    ("MiniStream.seg_unannotated_sum", "segment"),
    ("MiniStream.seg_scan_carry_leak", "step"),
    ("MiniStream.seg_reshape_drops_lane", "segment"),
    ("MiniStream.seg_rebuild_leaf", "segment"),
    ("MiniStream.seg_host_if", "segment"),
    ("MiniStream.seg_unregistered", "segment"),
)


def _s_findings(mod, axes_carry, entry_point, model, package, entries):
    return mod.check_model(
        model,
        entrypoints=[entry_point(f"{package}.saxes_stream", qual, region, {"c": axes_carry})
                     for qual, region in entries],
        collectives={
            "mini-done-any": mod.Collective("any", ("segment",), "fixture"),
            "mini-count": mod.Collective("sum", ("segment",), "fixture"),
        },
        carry_axes={"FakeCarry": {"state": "lane", "count": "global"}, "MiniState": {"done": "lane", "step": "lane"}},
        audited_classes=(),
        carry_classes={"FakeCarry", "MiniState"},
        carry_fields={"state"},
        region_overrides={},
        audit_registry=len(entries) > 1,
    )


@pytest.mark.parametrize("entry", [*_S_ENTRIES, None], ids=[q for q, _r in _S_ENTRIES] + ["all"])
def test_saxes_rule_lines_equal(tmp_path, entry):
    jax_model, model = _both_models(tmp_path, "saxes_stream.py")
    entries = _S_ENTRIES if entry is None else (entry,)
    want = _s_findings(jax_srules, JAX_CARRY, JaxEntryPoint, jax_model, "madsim_tpu", entries)
    got = _s_findings(srules, CARRY, EntryPoint, model, "madsim_tpu_torch", entries)
    assert _rule_lines(got, "S") == _rule_lines(want, "S")


# -- (c) G and R drift injected into both packages' files ----------------------

_G_FILES = {
    "madsim_tpu": (
        "madsim_tpu/kinds.py", "madsim_tpu/__main__.py", "madsim_tpu/engine/core.py",
        "madsim_tpu/engine/shrink.py", "madsim_tpu/runtime/metrics.py", "madsim_tpu/runtime/coverage.py",
        "madsim_tpu/ops/coverage.py", "madsim_tpu/ops/step_rng.py", "madsim_tpu/ops/rng_layout.manifest",
        "madsim_tpu/search/bias.py", "tests/test_step_gates.py", "tests/test_golden_streams.py",
    ),
}
_G_FILES["madsim_tpu_torch"] = tuple(
    rel.replace("madsim_tpu/", "madsim_tpu_torch/")
       .replace("tests/test_step_gates.py", "tests/test_torch_gates.py")
       .replace("tests/test_golden_streams.py", "tests/test_torch_rng.py")
    for rel in _G_FILES["madsim_tpu"]
)

_LADDER = ("ESCALATION_LADDER = (\n    FAULT_KIND_NAMES[:6],\n    FAULT_KIND_NAMES[:8],\n"
           "    FAULT_KIND_NAMES[:10],\n    FAULT_KIND_NAMES + (\"dup\",),\n)")
_LADDER_LITERAL = (
    "ESCALATION_LADDER = (\n"
    '    ("pair", "kill", "dir", "group", "storm", "delay"),\n'
    '    ("pair", "kill", "dir", "group", "storm", "delay",\n     "pause", "skew"),\n'
    '    ("pair", "kill", "dir", "group", "storm", "delay",\n     "pause", "skew", "torn", "heal-asym"),\n'
    '    ("pair", "kill", "dir", "group", "storm", "delay",\n     "pause", "skew", "torn", "heal-asym", "dup"),\n'
    ")"
)

# each mutation: steps of (file, old, new), or (file, None, appended
# text); "{pkg}" is the package directory, "{gates}" / "{golden}" the
# gate matrix and golden pins of that package
G_MUTATIONS = {
    "G001": [("{pkg}/runtime/metrics.py", "from ..kinds import FAULT_KIND_NAMES as FR_FAULT_KINDS",
              "FR_FAULT_KINDS = ('pair', 'kill')")],
    "G002": [("{pkg}/ops/coverage.py", "COV_BAND_NAMES_V2 = _kinds.COV_BAND_NAMES_V2",
              "COV_BAND_NAMES_V2 = COV_BAND_NAMES + ('pause', 'skew')")],
    "G003": [("{pkg}/engine/shrink.py", '"torn", "heal-asym", "delay",', '"heal-asym", "delay",')],
    "G003-dup": [("{pkg}/engine/shrink.py", '"pause", "skew", "dup",', '"pause", "skew",')],
    "G004": [("{pkg}/__main__.py", "from .kinds import CLI_KIND_TO_FLAG", "CLI_KIND_TO_FLAG = ()")],
    "G005": [("{gates}", "allow_pause", "allow_paws")],
    "G006": [("{golden}", "allow_torn", "allow_tornado")],
    "G007": [("{pkg}/kinds.py", '    "torn", "heal-asym",\n)', '    "torn", "heal-asym", "gray-failure",\n)'),
             ("{pkg}/engine/core.py", "K_HEAL_ASYM = 9", "K_HEAL_ASYM = 12")],
    "G008": [("{pkg}/ops/step_rng.py", "    torn_off: Optional[int] = None",
              "    torn_off: Optional[int] = None\n    gray_off: Optional[int] = None"),
             ("{pkg}/ops/rng_layout.manifest", None, "gray\n"),
             ("{pkg}/ops/rng_layout.manifest", "lat\ndrop\n", "drop\nlat\n")],
    "G009-literal": [("{pkg}/search/bias.py", _LADDER, _LADDER_LITERAL)],
    "G009-widen": [("{pkg}/search/bias.py", "FAULT_KIND_NAMES[:8],", "FAULT_KIND_NAMES[:4],")],
    "G009-cover": [("{pkg}/search/bias.py", 'FAULT_KIND_NAMES + ("dup",),\n', "FAULT_KIND_NAMES,\n")],
}

_R_FILES = ("{pkg}/ops/step_rng.py", "{pkg}/ops/rng_layout.manifest", "{pkg}/engine/core.py")
_DROP_READ = {
    "madsim_tpu": "step_words[layout.drop_off : layout.drop_off + {w}m.MAX_MSGS]",
    "madsim_tpu_torch": "words[:, layout.drop_off : layout.drop_off + {w}m.MAX_MSGS]",
}
_WALK = ("    drop_off = None\n    if loss_possible:\n        drop_off = cursor\n        cursor += m\n",
         "    spike_off = None\n    if spike_possible:\n        spike_off = cursor\n        cursor += 2 * m\n")
_TORN = "    torn_off = None\n    if torn_possible:\n        torn_off = cursor\n        cursor += 1\n"
R_MUTATIONS = {
    "R003": [("{pkg}/ops/step_rng.py", _WALK[0] + _WALK[1], _WALK[1] + _WALK[0])],
    "R002": [("{pkg}/engine/core.py", "{drop}", "{drop2}")],
    "R001": [("{pkg}/ops/step_rng.py", _TORN,
              _TORN + "    gray_off = None\n    if torn_possible:\n        gray_off = cursor\n        cursor += 2\n"),
             ("{pkg}/ops/rng_layout.manifest", None, "gray\n"),
             ("{pkg}/ops/rng_layout.manifest", None, "phantom\n")],
}


def _fill(text, pkg):
    if text is None:
        return None
    return (text.replace("{pkg}", pkg)
            .replace("{gates}", "tests/test_step_gates.py" if pkg == "madsim_tpu" else "tests/test_torch_gates.py")
            .replace("{golden}", "tests/test_golden_streams.py" if pkg == "madsim_tpu" else "tests/test_torch_rng.py")
            .replace("{drop2}", _DROP_READ[pkg].format(w="2 * "))
            .replace("{drop}", _DROP_READ[pkg].format(w="")))


def _copy(tmp_path, pkg, files):
    root = tmp_path / pkg
    for rel in files:
        rel = _fill(rel, pkg)
        dst = root / rel
        dst.parent.mkdir(parents=True, exist_ok=True)
        shutil.copy(os.path.join(REPO, rel), dst)
    return root


def _apply(root, pkg, step):
    rel, old, new = (_fill(x, pkg) for x in step)
    path = root / rel
    src = path.read_text()
    if old is None:
        path.write_text(src + new)
        return
    assert old in src, f"mutation anchor not found in {rel}: {old!r}"
    path.write_text(src.replace(old, new))


def _rules(found):
    return sorted({f.rule for f in found})


@pytest.mark.parametrize("family", ["G", "R"])
def test_heads_clean_on_both(tmp_path, family):
    if family == "G":
        for pkg, check in (("madsim_tpu", jax_grules.check_repo), ("madsim_tpu_torch", grules.check_repo)):
            assert check(str(_copy(tmp_path, pkg, _G_FILES[pkg]))) == []
    else:
        for pkg, check in (("madsim_tpu", jax_rrules.check_repo), ("madsim_tpu_torch", rrules.check_repo)):
            assert check(str(_copy(tmp_path, pkg, _R_FILES))) == []


@pytest.mark.parametrize("name", sorted(G_MUTATIONS) + sorted(R_MUTATIONS))
def test_mutation_gives_the_same_rules(tmp_path, name):
    g = name in G_MUTATIONS
    steps = G_MUTATIONS[name] if g else R_MUTATIONS[name]
    roots = {
        pkg: _copy(tmp_path, pkg, _G_FILES[pkg] if g else _R_FILES)
        for pkg in ("madsim_tpu", "madsim_tpu_torch")
    }
    checks = ({"madsim_tpu": jax_grules.check_repo, "madsim_tpu_torch": grules.check_repo} if g
              else {"madsim_tpu": jax_rrules.check_repo, "madsim_tpu_torch": rrules.check_repo})
    for step in steps:
        got = {}
        for pkg, root in roots.items():
            _apply(root, pkg, step)
            got[pkg] = _rules(checks[pkg](str(root)))
        assert got["madsim_tpu_torch"] == got["madsim_tpu"], (name, step)
    assert got["madsim_tpu_torch"], name  # the last step is a drift


# -- (d) --fix --------------------------------------------------------------------


@pytest.mark.parametrize("source", [
    "import jax\ndef f(names, x):\n    out = [n for n in set(names)]\n    for n in {1, 2}:\n"
    "        out.append(n)\n    jax.debug.callback(print, x)\n    jax.debug.callback(print, x, ordered=False)\n"
    "    return out\n",
    open(os.path.join(JAX_FIXTURES, "d003_set_iter.py")).read(),
    open(os.path.join(JAX_FIXTURES, "d005_callback.py")).read(),
], ids=["mixed", "d003", "d005"])
def test_fix_source_byte_equal(source):
    want = jax_fixes.fix_source(source, "f.py")
    got = fixes.fix_source(source, "f.py")
    assert got == want and got[1] > 0


# -- (e) JSON and SARIF ------------------------------------------------------------


def _ns(**kw):
    base = dict(
        paths=[], rules=None, json=False, github=False, fix=False, baseline=None, update_baseline=False,
        no_import_check=True, repo_root=None, verbose=False, sarif=None, cache=False, force=False,
    )
    base.update(kw)
    return argparse.Namespace(**base)


def test_json_and_sarif_documents_equal(tmp_path, capsys):
    victim = tmp_path / "victim.py"
    victim.write_text(
        "import time, os\n"
        "def f(names, x):\n"
        "    for n in {1, 2}:\n"
        "        print(n)\n"
        "    return id(x), os.urandom(4), time.time()\n"
    )
    docs = {}
    for name, main in (("jax", jax_cli.main), ("port", cli.main)):
        sarif = str(tmp_path / f"{name}.sarif")
        assert main(_ns(paths=[str(victim)], json=True, sarif=sarif)) == 1
        out = json.loads(capsys.readouterr().out)
        for f in out["findings"]:
            f["message"] = _map_names(f["message"])
        doc = json.loads(open(sarif).read())
        driver = doc["runs"][0]["tool"]["driver"]
        docs[name] = (out, doc, driver.pop("name"), driver.pop("version"))
        for res in doc["runs"][0]["results"]:
            res["message"]["text"] = _map_names(res["message"]["text"])
    (want, want_sarif, want_name, _), (got, got_sarif, got_name, got_version) = docs["jax"], docs["port"]
    assert got == want and len(got["findings"]) == 4
    assert got_sarif == want_sarif
    assert (want_name, got_name) == ("madsim-tpu-lint", "madsim-tpu-torch-lint")
    from madsim_tpu_torch.analysis.lintcache import RULES_VERSION

    assert got_version == RULES_VERSION
    fs = [findings.Finding("T001", "warning", "a.py", 3, 1, "w"), findings.Finding("S002", "error", "b.py", 0, 0, "e")]
    jfs = [jax_findings.Finding(*dataclass_row(f)) for f in fs]
    want_doc, got_doc = jax_findings.sarif_doc(jfs, "v"), findings.sarif_doc(fs, "v")
    for d in (want_doc, got_doc):
        d["runs"][0]["tool"]["driver"].pop("name")
    assert got_doc == want_doc
    assert [f.json_dict() for f in fs] == [f.json_dict() for f in jfs]


def dataclass_row(f):
    return (f.rule, f.severity, f.path, f.line, f.col, f.message, f.fixable)
