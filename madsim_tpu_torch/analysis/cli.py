"""`python -m madsim_tpu_torch lint` — driver, output formats, exit codes.

Exit codes (pre-commit friendly):
  0  clean (or everything suppressed/baselined)
  1  findings
  2  usage / internal error (bad paths, unparseable baseline)

The D/C-AST/G/L/T/R/S passes are stdlib-only; the C import half (model
contracts) imports torch and runs by default when any linted file
defines a Machine subclass — `--no-import-check` keeps a pre-commit
hook torch-free and fast. The port's own baseline and cache
(`.madsim-torch-lint-baseline.json`, `.madsim-torch-lint-cache/`) are
never the JAX package's.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Dict, List, Optional, Sequence

from . import crules, drules, grules, layers, lintcache, rrules, srules, trules
from .findings import (
    DEFAULT_BASELINE_NAME,
    Finding,
    apply_baseline,
    baseline_growth,
    filter_suppressed,
    load_baseline,
    sarif_doc,
    save_baseline,
)

JSON_SCHEMA_VERSION = 1

# directories never worth descending into
_SKIP_DIRS = {"__pycache__", ".git", ".venv", "node_modules", ".claude"}


def add_lint_args(p: argparse.ArgumentParser) -> None:
    p.add_argument(
        "paths", nargs="*", default=None,
        help="files/directories to lint (default: the madsim_tpu_torch package "
             "of the enclosing repo)",
    )
    p.add_argument(
        "--rules", default=None,
        help="comma list of rule families or IDs to run (e.g. D,G or "
             "D003,C001); default all",
    )
    p.add_argument("--json", action="store_true", help="machine-readable output")
    p.add_argument(
        "--github", action="store_true",
        help="GitHub workflow-command annotations (::error file=...)",
    )
    p.add_argument(
        "--sarif", default=None, metavar="OUT.sarif",
        help="also write a SARIF 2.1.0 report to this path (composable "
             "with any output mode)",
    )
    p.add_argument(
        "--changed", action="store_true",
        help="git-diff-scoped run: lint only files git reports changed "
             "(staged + unstaged + untracked) plus their reverse "
             "import-graph dependents; the whole-program passes scope "
             "to the zones the change can reach (T handler walks to "
             "the changed files, the T-executor/S step-path walks only "
             "when engine/ops/parallel/utils changed). The pre-commit "
             "path — a no-change run exits immediately",
    )
    p.add_argument(
        "--cache", action="store_true",
        help="reuse .madsim-torch-lint-cache/ under the repo root: unchanged "
             "files replay their findings, a byte-identical repo "
             "replays the whole-program passes (the lint-fast / "
             "pre-commit path; CI stays cold)",
    )
    p.add_argument(
        "--force", action="store_true",
        help="with --update-baseline: allow the baseline to GROW "
             "(default is the shrink-only ratchet)",
    )
    p.add_argument(
        "--fix", action="store_true",
        help="apply the mechanical fixes (sorted() set iteration, "
             "ordered=True callbacks) in place, then re-lint",
    )
    p.add_argument(
        "--baseline", default=None,
        help=f"baseline file (default: {DEFAULT_BASELINE_NAME} at the "
             f"repo root when present)",
    )
    p.add_argument(
        "--update-baseline", action="store_true",
        help="write all current findings to the baseline file and exit 0",
    )
    p.add_argument(
        "--no-import-check", action="store_true",
        help="skip the C-rule import half (no torch import; AST-only run)",
    )
    p.add_argument(
        "--repo-root", default=None,
        help="repo root for the G-pass cross-checks (default: walk up "
             "from the first path)",
    )
    p.add_argument("-v", "--verbose", action="store_true")


def _collect_files(paths: Sequence[str]) -> List[str]:
    out: List[str] = []
    for p in paths:
        if os.path.isfile(p):
            out.append(p)
        elif os.path.isdir(p):
            for dirpath, dirnames, filenames in os.walk(p):
                dirnames[:] = sorted(
                    d for d in dirnames if d not in _SKIP_DIRS
                )
                for fn in sorted(filenames):
                    if fn.endswith(".py"):
                        out.append(os.path.join(dirpath, fn))
        else:
            raise FileNotFoundError(p)
    return out


def _rule_selected(rule: str, selector: Optional[Sequence[str]]) -> bool:
    if not selector:
        return True
    return any(rule == s or rule.startswith(s) for s in selector)


def projectmodel_build(root: str, notes: List[str]):
    from . import projectmodel

    if not os.path.isdir(os.path.join(root, projectmodel.PACKAGE)):
        notes.append(f"{root}: no {projectmodel.PACKAGE}/ package; "
                     f"L/T passes skipped")
        return None
    model = projectmodel.build_model(root)
    for rel, err in model.broken:
        notes.append(f"{rel}: unparseable for the program model ({err})")
    return model


# -- git-diff scoping (`lint --changed`) --------------------------------------

# A change under these prefixes can move the step path's lane-axis /
# taint behavior — the T-executor and S walks re-run; anything else
# leaves the step path byte-identical and those walks are skipped.
STEP_PATH_PREFIXES = (
    "madsim_tpu_torch/engine/", "madsim_tpu_torch/ops/", "madsim_tpu_torch/parallel/",
    "madsim_tpu_torch/utils",
)


def git_changed_files(root: str) -> Optional[List[str]]:
    """Repo-relative paths git reports as changed (staged, unstaged and
    untracked). None when git is unavailable or `root` is not a work
    tree — callers fall back to a full run."""
    import subprocess

    try:
        proc = subprocess.run(
            ["git", "-C", root, "status", "--porcelain"],
            capture_output=True, text=True, timeout=30,
        )
    except (OSError, subprocess.SubprocessError):
        return None
    if proc.returncode != 0:
        return None
    out: List[str] = []
    for line in proc.stdout.splitlines():
        if len(line) < 4:
            continue
        path = line[3:]
        if " -> " in path:  # rename: the new side is the linted one
            path = path.split(" -> ")[-1]
        out.append(path.strip().strip('"'))
    return out


def scoped_files(model, root: str, changed: Sequence[str]) -> List[str]:
    """Absolute paths of the changed package files PLUS their reverse
    import-graph dependents (a change to a module can move findings in
    every module that imports it — eagerly or lazily)."""
    rev: Dict[str, set] = {}
    for mi in model.modules.values():
        for edge in mi.imports:
            for target in model._project_targets(edge.target):
                rev.setdefault(target, set()).add(mi.name)
    by_rel = {mi.rel: mi for mi in model.modules.values()}
    queue = [by_rel[rel].name for rel in changed if rel in by_rel]
    seen = set(queue)
    while queue:
        cur = queue.pop()
        for dep in rev.get(cur, ()):
            if dep not in seen:
                seen.add(dep)
                queue.append(dep)
    return sorted(model.modules[name].path for name in seen)


def run_lint(
    paths: Sequence[str],
    *,
    rules: Optional[Sequence[str]] = None,
    import_check: bool = True,
    repo_root: Optional[str] = None,
    verbose: bool = False,
    notes: Optional[List[str]] = None,
    use_cache: bool = False,
    changed: Optional[Sequence[str]] = None,
) -> tuple:
    """Run the passes. Returns (findings, source_by_path) BEFORE
    suppression/baseline filtering — the caller owns policy (the cache
    also stores raw findings, so an edited suppression takes effect on
    a full cache hit). `changed` (repo-relative paths, the --changed
    scope) restricts the per-file passes to changed files + their
    reverse import-graph dependents and scopes the whole-program
    walks; None = everything."""
    import ast as _ast

    files = _collect_files(paths)
    findings: List[Finding] = []
    source_by_path: Dict[str, str] = {}
    notes = notes if notes is not None else []
    selector = [s.strip() for s in rules] if rules else None

    def family_selected(fam: str) -> bool:
        return selector is None or any(s and s[0] == fam for s in selector)

    root = repo_root or (grules.find_repo_root(files[0]) if files else None)
    cache = (
        lintcache.LintCache(root) if use_cache and root is not None else None
    )

    model = None
    if changed is not None and root is not None:
        model = projectmodel_build(root, notes)
        if model is not None:
            scope = set(scoped_files(model, root, changed))
            before = len(files)
            files = [f for f in files if os.path.abspath(f) in scope]
            notes.append(
                f"--changed: {len(files)}/{before} file(s) in scope "
                f"({len(changed)} changed)"
            )

    for path in files:
        try:
            with open(path, "r", encoding="utf-8") as fh:
                source = fh.read()
        except (OSError, UnicodeDecodeError) as exc:
            notes.append(f"{path}: unreadable ({exc!r})")
            continue
        source_by_path[path] = source
        if cache is not None:
            key = cache.file_key(source, import_check)
            cached = cache.get_file(path, key)
            if cached is not None:
                findings.extend(cached)
                continue
        per_file: List[Finding] = []
        try:
            tree = _ast.parse(source, filename=path)
        except SyntaxError as exc:
            findings.append(Finding(
                rule="D000", severity="error", path=path,
                line=exc.lineno or 0, col=(exc.offset or 1) - 1,
                message=f"syntax error: {exc.msg}",
            ))
            continue
        per_file.extend(drules.check_module(tree, source, path))
        per_file.extend(crules.check_module(tree, source, path))
        if import_check:
            from .astutils import machine_classes

            if machine_classes(tree):
                c_findings, skipped = crules.check_module_contracts(
                    tree, source, path
                )
                per_file.extend(c_findings)
                notes.extend(skipped)
        if cache is not None:
            cache.put_file(path, key, per_file)
        findings.extend(per_file)

    if root is None and files:
        notes.append(
            "no madsim_tpu_torch repo root found above the linted paths; "
            "repo passes (G mirror cross-checks, L layer map, T taint, "
            "R RNG ledger) skipped"
        )
    elif root is not None:
        repo_findings: Optional[List[Finding]] = None
        repo_key = None
        # the repo cache only serves the FULL run (no selector, no
        # --changed scope): a partial run would poison it
        if cache is not None and selector is None and changed is None:
            repo_key = cache.repo_fileset_key(lintcache.repo_input_files(root))
            repo_findings = cache.get_repo(repo_key)
        if repo_findings is None:
            repo_findings = []
            # --changed scope for the expensive walks: the T-executor
            # and S step-path contexts only move when the step-path
            # zone moved; T handler walks scope to the changed files
            step_zone_touched = changed is None or any(
                rel.startswith(STEP_PATH_PREFIXES) for rel in changed
            )
            if family_selected("G"):
                repo_findings.extend(grules.check_repo(root))
            if family_selected("L") or family_selected("T") \
                    or family_selected("S"):
                if model is None:
                    model = projectmodel_build(root, notes)
                if model is not None:
                    if family_selected("L"):
                        repo_findings.extend(layers.check_model(model))
                    if family_selected("T"):
                        if changed is None:
                            repo_findings.extend(trules.check_model(model))
                        else:
                            repo_findings.extend(trules.check_model(
                                model,
                                executor_entrypoints=(
                                    trules.EXECUTOR_ENTRYPOINTS
                                    if step_zone_touched else ()
                                ),
                                handler_files=set(changed),
                            ))
                    if family_selected("S") and step_zone_touched:
                        repo_findings.extend(srules.check_model(model))
            if family_selected("R"):
                repo_findings.extend(rrules.check_repo(root))
            if cache is not None and repo_key is not None:
                cache.put_repo(repo_key, repo_findings)
        # repo passes report repo-relative paths; qualify with the root
        # when linting from elsewhere so editors can open them
        if os.path.abspath(root) != os.path.abspath(os.getcwd()):
            repo_findings = [
                Finding(
                    rule=f.rule, severity=f.severity,
                    path=os.path.join(root, f.path), line=f.line,
                    col=f.col, message=f.message, fixable=f.fixable,
                )
                for f in repo_findings
            ]
        findings.extend(repo_findings)
        # line-anchored repo findings (L/T/R) support inline
        # suppressions — make their sources visible to the filter
        for f in repo_findings:
            if f.line > 0 and f.path not in source_by_path:
                candidate = (
                    f.path if os.path.isabs(f.path)
                    else os.path.join(root, f.path)
                )
                try:
                    with open(candidate, "r", encoding="utf-8") as fh:
                        source_by_path[f.path] = fh.read()
                except OSError:
                    pass

    if cache is not None:
        cache.save()
        if verbose:
            notes.append(
                f"cache: {cache.hits} file hit(s), {cache.misses} miss(es)"
            )

    findings = [f for f in findings if _rule_selected(f.rule, selector)]

    # dedup (the taint pass can flag one expression through two node
    # shapes) and order stably for output + baseline
    seen = set()
    unique: List[Finding] = []
    for f in sorted(findings, key=lambda f: (f.path, f.line, f.col, f.rule)):
        # positional dedup for source findings (the taint pass can flag
        # one expression through two node shapes); repo-level findings
        # all sit at line 0, so their identity is the message
        key = (
            (f.rule, f.path, f.line, f.col) if f.line
            else (f.rule, f.path, f.message)
        )
        if key in seen:
            continue
        seen.add(key)
        unique.append(f)
    return unique, source_by_path


def main(args: argparse.Namespace) -> int:
    paths = list(args.paths or [])
    repo_root = args.repo_root
    if not paths:
        root = grules.find_repo_root(os.getcwd())
        if root is None:
            print(
                "lint: no paths given and no madsim_tpu_torch repo above cwd",
                file=sys.stderr,
            )
            return 2
        paths = [os.path.join(root, "madsim_tpu_torch")]
        repo_root = repo_root or root

    rules = args.rules.split(",") if args.rules else None
    notes: List[str] = []

    try:
        files_exist = _collect_files(paths)
    except FileNotFoundError as exc:
        print(f"lint: no such path: {exc}", file=sys.stderr)
        return 2
    del files_exist

    if args.fix:
        from .fixes import fix_source

        fixed_total = 0
        for path in _collect_files(paths):
            with open(path, "r", encoding="utf-8") as fh:
                src = fh.read()
            try:
                new_src, n = fix_source(src, path)
            except SyntaxError:
                continue
            if n:
                with open(path, "w", encoding="utf-8") as fh:
                    fh.write(new_src)
                fixed_total += n
                if not args.json:
                    print(f"fixed {n} finding(s) in {path}")
        if fixed_total and not args.json:
            print(f"--fix applied {fixed_total} edit(s); re-linting")

    changed = None
    if getattr(args, "changed", False):
        git_root = repo_root or grules.find_repo_root(
            paths[0] if paths else os.getcwd()
        )
        changed = git_changed_files(git_root) if git_root else None
        if changed is None:
            notes.append("--changed: git unavailable here; full run")
        else:
            # lint-relevant inputs: package sources plus the repo-pass
            # cross-check files (golden/gate test pins, the RNG manifest)
            changed = [
                r for r in changed
                if (r.startswith("madsim_tpu_torch/") and r.endswith(".py"))
                or r in (grules.GATES_TEST, grules.GOLDEN_TEST, grules.MANIFEST)
            ]
            if not changed:
                if not args.json and not args.github:
                    print("lint: --changed: no lint-relevant files changed")
                return 0

    try:
        findings, sources = run_lint(
            paths,
            rules=rules,
            import_check=not args.no_import_check,
            repo_root=repo_root,
            verbose=args.verbose,
            notes=notes,
            use_cache=getattr(args, "cache", False),
            changed=changed,
        )
    except FileNotFoundError as exc:
        print(f"lint: no such path: {exc}", file=sys.stderr)
        return 2

    findings = filter_suppressed(findings, sources)

    baseline_path = args.baseline
    if baseline_path is None:
        root = repo_root or grules.find_repo_root(
            paths[0] if paths else os.getcwd()
        )
        if root is not None:
            candidate = os.path.join(root, DEFAULT_BASELINE_NAME)
            if os.path.exists(candidate):
                baseline_path = candidate

    if args.update_baseline:
        target = baseline_path or os.path.join(
            repo_root or os.getcwd(), DEFAULT_BASELINE_NAME
        )
        # the ratchet: a baseline may SHRINK freely (debt paid down) but
        # refuses to grow — new findings are new debt, and absorbing
        # them silently is how a strict baseline rots into a landfill
        if os.path.exists(target) and not getattr(args, "force", False):
            try:
                old_entries = load_baseline(target)
            except (OSError, ValueError, KeyError) as exc:
                print(f"lint: bad baseline {target}: {exc}", file=sys.stderr)
                return 2
            grown = baseline_growth(old_entries, findings)
            if grown:
                print(
                    f"lint: refusing to GROW the baseline ({len(grown)} "
                    f"new finding(s) not in {target}) — the ratchet is "
                    f"shrink-only. Fix or inline-suppress them, or pass "
                    f"--force to grandfather deliberately:",
                    file=sys.stderr,
                )
                for f in grown:
                    print(f"  + {f.text()}", file=sys.stderr)
                return 2
        save_baseline(target, findings)
        print(f"baseline: wrote {len(findings)} finding(s) to {target}")
        return 0

    baselined = 0
    if baseline_path:
        try:
            entries = load_baseline(baseline_path)
        except (OSError, ValueError, KeyError) as exc:
            print(f"lint: bad baseline {baseline_path}: {exc}", file=sys.stderr)
            return 2
        findings, consumed = apply_baseline(findings, entries)
        baselined = len(consumed)

    if args.verbose:
        for note in notes:
            print(f"note: {note}", file=sys.stderr)

    if getattr(args, "sarif", None):
        from .lintcache import RULES_VERSION

        doc = sarif_doc(findings, RULES_VERSION)
        with open(args.sarif, "w", encoding="utf-8") as fh:
            json.dump(doc, fh, indent=2, sort_keys=True)
            fh.write("\n")
        if not args.json:
            print(f"sarif: wrote {len(findings)} result(s) to {args.sarif}")

    if args.json:
        doc = {
            "version": JSON_SCHEMA_VERSION,
            "findings": [f.json_dict() for f in findings],
            "counts": {
                "error": sum(1 for f in findings if f.severity == "error"),
                "warning": sum(1 for f in findings if f.severity == "warning"),
                "baselined": baselined,
            },
        }
        print(json.dumps(doc, indent=2, sort_keys=True))
    elif args.github:
        for f in findings:
            print(f.github())
    else:
        for f in findings:
            print(f.text())

    if not args.json and not args.github:
        if findings:
            n_err = sum(1 for f in findings if f.severity == "error")
            tail = f", {baselined} baselined" if baselined else ""
            print(f"lint: {n_err} error(s), {len(findings) - n_err} "
                  f"warning(s){tail}")
        else:
            tail = f" ({baselined} baselined)" if baselined else ""
            print(f"lint: clean{tail}")

    return 1 if findings else 0
