"""The AST/model cache — `.madsim-torch-lint-cache/` under the repo root
(the port's own: the JAX package's linter keeps `.madsim-lint-cache/`,
and two linters sharing one cache file would evict each other on every
run).

The v2 analyzer parses every package file twice (per-file passes + the
program model) and the C import half instantiates models under torch;
cold that is tens of seconds on a small host, which is too slow for a
pre-commit hook. The cache stores RAW findings (before
suppression/baseline policy — policy is cheap and must always run
fresh, so an edited `# madsim: allow(...)` comment takes effect even
on a full cache hit) at two granularities:

* per-file: the D/C findings of one source file, keyed by
  (sha256(source), import_check). Sound because those passes read
  nothing but the file. The C import half additionally reads the
  engine contract, so the rules-version salt below MUST be bumped when
  contract semantics change — that is what `RULES_VERSION` is for.
* whole-program: the G/L/T/R findings, keyed by the sha256 of every
  input the repo passes read (the package file set plus the G-pass's
  named test files and the RNG manifest). Any changed byte anywhere
  re-runs the whole-program half; only a byte-identical repo replays.

A no-change whole-package re-run is therefore a hash walk plus a JSON
read — the `make lint-fast` / pre-commit path. The cache is opt-in
(`--cache`); CI stays cold on purpose. Version skew (a new rules
version, a corrupt file) degrades to a cold run, never to stale
findings.
"""

from __future__ import annotations

import hashlib
import json
import os
from typing import Dict, List, Optional, Sequence, Tuple

from .findings import Finding

# Bump whenever any rule's behavior changes — the cache must never
# serve findings computed by older rule semantics.
RULES_VERSION = "torch-lint-v1"  # the port's rules, retargeted at torch

CACHE_DIR = ".madsim-torch-lint-cache"
CACHE_FILE = "cache.json"


def _finding_to_dict(f: Finding) -> dict:
    return {
        "rule": f.rule, "severity": f.severity, "path": f.path,
        "line": f.line, "col": f.col, "message": f.message,
        "fixable": f.fixable,
    }


def _finding_from_dict(d: dict) -> Finding:
    return Finding(
        rule=d["rule"], severity=d["severity"], path=d["path"],
        line=d["line"], col=d["col"], message=d["message"],
        fixable=bool(d.get("fixable", False)),
    )


def sha256_text(text: str) -> str:
    return hashlib.sha256(text.encode("utf-8")).hexdigest()


def sha256_file(path: str) -> Optional[str]:
    try:
        with open(path, "rb") as fh:
            return hashlib.sha256(fh.read()).hexdigest()
    except OSError:
        return None


class LintCache:
    def __init__(self, root: str):
        self.root = root
        self.path = os.path.join(root, CACHE_DIR, CACHE_FILE)
        self.doc: dict = {"version": RULES_VERSION, "files": {}, "repo": None}
        self.dirty = False
        self.hits = 0
        self.misses = 0
        self._load()

    def _load(self) -> None:
        try:
            with open(self.path, "r", encoding="utf-8") as fh:
                doc = json.load(fh)
            if doc.get("version") == RULES_VERSION:
                self.doc = doc
        except (OSError, ValueError):
            pass  # cold start

    def save(self) -> None:
        if not self.dirty:
            return
        os.makedirs(os.path.dirname(self.path), exist_ok=True)
        tmp = self.path + ".tmp"
        with open(tmp, "w", encoding="utf-8") as fh:
            json.dump(self.doc, fh, sort_keys=True)
        os.replace(tmp, self.path)

    # -- per-file ------------------------------------------------------------

    def file_key(self, source: str, import_check: bool) -> str:
        return f"{sha256_text(source)}:{int(import_check)}"

    def get_file(self, path: str, key: str) -> Optional[List[Finding]]:
        entry = self.doc["files"].get(path)
        if entry is None or entry.get("key") != key:
            self.misses += 1
            return None
        self.hits += 1
        return [_finding_from_dict(d) for d in entry["findings"]]

    def put_file(self, path: str, key: str, findings: Sequence[Finding]) -> None:
        self.doc["files"][path] = {
            "key": key,
            "findings": [_finding_to_dict(f) for f in findings],
        }
        self.dirty = True

    # -- whole-program -------------------------------------------------------

    def repo_fileset_key(self, files: Sequence[str]) -> str:
        """sha over (relpath, sha256) of every whole-program input, in
        sorted order."""
        h = hashlib.sha256()
        for path in sorted(set(files)):
            rel = os.path.relpath(path, self.root)
            h.update(rel.encode())
            h.update(b"\0")
            digest = sha256_file(path)
            h.update((digest or "missing").encode())
            h.update(b"\0")
        return h.hexdigest()

    def get_repo(self, key: str) -> Optional[List[Finding]]:
        entry = self.doc.get("repo")
        if entry is None or entry.get("key") != key:
            return None
        return [_finding_from_dict(d) for d in entry["findings"]]

    def put_repo(self, key: str, findings: Sequence[Finding]) -> None:
        self.doc["repo"] = {
            "key": key,
            "findings": [_finding_to_dict(f) for f in findings],
        }
        self.dirty = True


def repo_input_files(root: str) -> List[str]:
    """Every file the whole-program (G/L/T/R) passes read: the package
    tree plus the G-pass's named test files and the RNG manifest."""
    from . import grules

    out: List[str] = []
    pkg = os.path.join(root, "madsim_tpu_torch")
    for dirpath, dirnames, filenames in os.walk(pkg):
        dirnames[:] = sorted(
            d for d in dirnames
            if d not in ("__pycache__", ".git", ".venv", "node_modules")
        )
        for fn in sorted(filenames):
            if fn.endswith(".py"):
                out.append(os.path.join(dirpath, fn))
    for rel in (grules.GATES_TEST, grules.GOLDEN_TEST, grules.MANIFEST):
        out.append(os.path.join(root, rel))
    return out
