"""Finding model, inline suppressions, and the checked-in baseline.

A `Finding` is one rule violation at one source location. Three ways to
silence one, in decreasing order of preference:

* fix it;
* an inline ``# madsim: allow(D003)`` on the flagged line (or a
  comment-only line directly above it) — for deliberate, justified
  exceptions; always pair it with a human reason in the comment;
* a file-level ``# madsim: allow-file(D001,D002)`` comment line — for
  modules whose whole *contract* is the exception (the real-mode
  shims: wall clocks and OS entropy are their job);
* the baseline file — for grandfathered findings when the linter is
  introduced to an existing codebase. The port ships an EMPTY baseline
  of its own (.madsim-torch-lint-baseline.json) on purpose: CI starts
  strict. It never reads or writes the JAX package's
  .madsim-lint-baseline.json.

Baseline entries match on (rule, path, message) rather than line
numbers, so unrelated edits above a grandfathered finding don't
resurrect it; duplicate findings consume duplicate entries.
"""

from __future__ import annotations

import dataclasses
import json
import re
from typing import Dict, List, Optional, Sequence, Tuple


class Severity:
    ERROR = "error"
    WARNING = "warning"


@dataclasses.dataclass(frozen=True)
class Finding:
    rule: str  # stable ID: D001..., C001..., G001...
    severity: str  # Severity.*
    path: str  # as given to the linter (repo-relative in CI)
    line: int  # 1-based; 0 = whole-file/repo finding
    col: int  # 0-based
    message: str
    fixable: bool = False  # `lint --fix` knows a mechanical rewrite

    def text(self) -> str:
        tag = " [fixable]" if self.fixable else ""
        return (
            f"{self.path}:{self.line}:{self.col + 1}: "
            f"{self.rule} [{self.severity}]{tag} {self.message}"
        )

    def github(self) -> str:
        # GitHub workflow-command annotation; error/warning map directly
        kind = "error" if self.severity == Severity.ERROR else "warning"
        return (
            f"::{kind} file={self.path},line={max(self.line, 1)},"
            f"col={self.col + 1},title={self.rule}::{self.message}"
        )

    def json_dict(self) -> dict:
        return {
            "rule": self.rule,
            "severity": self.severity,
            "path": self.path,
            "line": self.line,
            "col": self.col,
            "message": self.message,
            "fixable": self.fixable,
        }


# -- inline suppressions -----------------------------------------------------

_ALLOW_RE = re.compile(r"#\s*madsim:\s*allow\(([A-Z]\d{3}(?:\s*,\s*[A-Z]\d{3})*)\)")
_ALLOW_FILE_RE = re.compile(
    r"#\s*madsim:\s*allow-file\(([A-Z]\d{3}(?:\s*,\s*[A-Z]\d{3})*)\)"
)


def _ids(match: re.Match) -> set:
    return {part.strip() for part in match.group(1).split(",")}


class Suppressions:
    """Per-file suppression map parsed from comments.

    `line_allows[n]` holds rule IDs allowed on line n (1-based). A
    comment-only line's allowance also covers the next line, so long
    flagged expressions can carry the justification above them.
    """

    def __init__(self, source: str):
        self.file_allows: set = set()
        self.line_allows: Dict[int, set] = {}
        lines = source.splitlines()
        for lineno, text in enumerate(lines, start=1):
            m = _ALLOW_FILE_RE.search(text)
            if m:
                self.file_allows |= _ids(m)
                continue
            m = _ALLOW_RE.search(text)
            if not m:
                continue
            ids = _ids(m)
            self.line_allows.setdefault(lineno, set()).update(ids)
            if text.lstrip().startswith("#"):
                # comment-only: the allowance extends through the rest
                # of the comment block to the first code line below it
                target = lineno + 1
                while target <= len(lines) and lines[target - 1].lstrip().startswith("#"):
                    target += 1
                self.line_allows.setdefault(target, set()).update(ids)

    def allows(self, finding: Finding) -> bool:
        if finding.rule in self.file_allows:
            return True
        return finding.rule in self.line_allows.get(finding.line, set())


def filter_suppressed(
    findings: Sequence[Finding], source_by_path: Dict[str, str]
) -> List[Finding]:
    """Drop findings an inline/file suppression in their source allows.
    Repo-level findings (G-rules, line 0) have no inline channel — the
    mirrors they guard span files, so only the baseline can grandfather
    them."""
    out: List[Finding] = []
    cache: Dict[str, Suppressions] = {}
    for f in findings:
        src = source_by_path.get(f.path)
        if src is not None and f.line > 0:
            sup = cache.get(f.path)
            if sup is None:
                sup = cache[f.path] = Suppressions(src)
            if sup.allows(f):
                continue
        out.append(f)
    return out


# -- SARIF -------------------------------------------------------------------

SARIF_VERSION = "2.1.0"
SARIF_SCHEMA = (
    "https://raw.githubusercontent.com/oasis-tcs/sarif-spec/master/"
    "Schemata/sarif-schema-2.1.0.json"
)

# one-line descriptions for the SARIF rules table (and future docs);
# family entries cover IDs without a specific row. The JAX package's
# table word for word: a rule ID means the same in both linters, and
# their SARIF documents differ only in the tool (in the port, "jax"
# reads torch: the L zone is torch-free, T's traced values are tensors)
RULE_CATALOG: Dict[str, str] = {
    "D001": "wall-clock read in sim code",
    "D002": "OS/global entropy draw",
    "D003": "iteration over a set (hash-order leak)",
    "D004": "id()/builtin hash() (process-varying value)",
    "D005": "unordered host callback",
    "D006": "python truthiness on a traced value in a Machine handler",
    "C001": "self.* mutation inside a pure handler",
    "C002": "durable_spec() not congruent with init()",
    "C003": "torn_spec() not a legal refinement of durable_spec()",
    "C004": "coverage_projection must return one scalar integer word",
    "C005": "voter/ack bitmask without the 31-node cap",
    "G001": "flight-recorder counter mirror drift",
    "G002": "coverage band mirror drift",
    "G003": "shrink ablation table drift",
    "G004": "CLI fault-kind vocabulary drift",
    "G005": "chaos flag missing from the gate-off matrix",
    "G006": "chaos flag missing from the golden-stream pins",
    "G007": "K_* index / FaultPlan flag / enabled_kinds ladder drift",
    "G008": "RNG-layout manifest order violation",
    "G009": "guided-search escalation ladder drift",
    "L001": "jax-free module imports a closed module directly",
    "L002": "jax-free module transitively imports jax",
    "L003": "ungated lazy jax import / open import_jax gate",
    "T001": "sync-forcing sink on a traced value (with chain)",
    "T002": "device fetch inside the per-segment dispatch region",
    "T003": "use of a donated argument after the donating call",
    "R001": "RNG word section without a manifest row (or ghost row)",
    "R002": "consumption site reads past its RNG section",
    "R003": "RNG cursor walk out of manifest order",
    "S001": "cross-lane op outside the collective registry (or registry drift)",
    "S002": "carry leaf without a lane-axis declaration / lane data into a global leaf",
    "S003": "lane-axis-dependent python control flow in the step path",
    "S004": "collective placed in the per-event inner loop",
}


def sarif_doc(findings: Sequence[Finding], tool_version: str) -> dict:
    """Minimal-but-valid SARIF 2.1.0 for CI artifact upload and editor
    ingestion. Paths pass through as given (repo-relative in CI)."""
    rule_ids = sorted({f.rule for f in findings} | set(RULE_CATALOG))
    rules = [
        {
            "id": rid,
            "shortDescription": {
                "text": RULE_CATALOG.get(rid, f"madsim lint rule {rid}")
            },
        }
        for rid in rule_ids
    ]
    results = []
    for f in findings:
        results.append({
            "ruleId": f.rule,
            "ruleIndex": rule_ids.index(f.rule),
            "level": "error" if f.severity == Severity.ERROR else "warning",
            "message": {"text": f.message},
            "locations": [{
                "physicalLocation": {
                    "artifactLocation": {"uri": f.path.replace("\\", "/")},
                    "region": {
                        "startLine": max(f.line, 1),
                        "startColumn": f.col + 1,
                    },
                },
            }],
        })
    return {
        "$schema": SARIF_SCHEMA,
        "version": SARIF_VERSION,
        "runs": [{
            "tool": {
                "driver": {
                    "name": "madsim-tpu-torch-lint",
                    "informationUri": "https://github.com/madsim-rs/madsim",
                    "version": tool_version,
                    "rules": rules,
                },
            },
            "results": results,
        }],
    }


# -- baseline ----------------------------------------------------------------

BASELINE_VERSION = 1
DEFAULT_BASELINE_NAME = ".madsim-torch-lint-baseline.json"


def _key(entry: dict) -> Tuple[str, str, str]:
    return (entry["rule"], entry["path"], entry["message"])


def load_baseline(path: str) -> List[dict]:
    with open(path, "r", encoding="utf-8") as fh:
        doc = json.load(fh)
    if doc.get("version") != BASELINE_VERSION:
        raise ValueError(
            f"{path}: unsupported baseline version {doc.get('version')!r}"
        )
    return list(doc.get("findings", []))


def save_baseline(path: str, findings: Sequence[Finding]) -> None:
    doc = {
        "version": BASELINE_VERSION,
        "findings": [
            {"rule": f.rule, "path": f.path, "message": f.message}
            for f in sorted(findings, key=lambda f: (f.path, f.rule, f.line))
        ],
    }
    with open(path, "w", encoding="utf-8") as fh:
        json.dump(doc, fh, indent=2, sort_keys=True)
        fh.write("\n")


def baseline_growth(
    baseline: Sequence[dict], findings: Sequence[Finding]
) -> List[Finding]:
    """Findings NOT already covered by the baseline — the entries a
    `--update-baseline` would ADD. The ratchet is shrink-only: a
    baseline exists to grandfather the past, never to absorb new debt,
    so growth refuses without `--force` (count-aware, like
    apply_baseline: a second identical finding is growth)."""
    budget: Dict[Tuple[str, str, str], int] = {}
    for entry in baseline:
        budget[_key(entry)] = budget.get(_key(entry), 0) + 1
    grown: List[Finding] = []
    for f in findings:
        k = (f.rule, f.path, f.message)
        if budget.get(k, 0) > 0:
            budget[k] -= 1
        else:
            grown.append(f)
    return grown


def apply_baseline(
    findings: Sequence[Finding], baseline: Sequence[dict]
) -> Tuple[List[Finding], List[dict]]:
    """Split findings into (fresh, grandfathered-entries-consumed).
    Matching is by (rule, path, message), count-aware: two identical
    findings need two baseline entries."""
    budget: Dict[Tuple[str, str, str], int] = {}
    for entry in baseline:
        budget[_key(entry)] = budget.get(_key(entry), 0) + 1
    fresh: List[Finding] = []
    consumed: List[dict] = []
    for f in findings:
        k = (f.rule, f.path, f.message)
        if budget.get(k, 0) > 0:
            budget[k] -= 1
            consumed.append({"rule": f.rule, "path": f.path, "message": f.message})
        else:
            fresh.append(f)
    return fresh, consumed
