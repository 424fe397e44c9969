"""L-rules: torch-free layer enforcement over the import graph.

The hunt farm's control plane (`fleet serve` / `submit` / `status`),
the guided-search bias math, the bench-history renderer and this
analysis package all ship a hard promise: **importing them never
imports torch**. That promise lives in docstring sentences ("Pure
host-side stdlib — no torch import anywhere in this module") and a few
subprocess tests; a single careless `from ..engine import shrink` at
the top of a fleet module would break `fleet serve`'s startup cost, the
chaos harness's synthetic workers, and every torch-less deployment —
and nothing static would say so. These rules make the layer map
declarative and the check whole-program:

L001  a torch-free module *directly* imports a closed module at module
      level (torch itself, `engine.core`, or anything under `ops/` —
      the two torch-hosting subsystems the zone must never see)
L002  a torch-free module eagerly imports a PROJECT module whose eager
      transitive closure reaches torch — the finding names the full
      chain, including package `__init__` hops (`from .guided import
      ...` in `search/__init__.py` would drag torch into `search.bias`
      through the parent-package edge)
L003  gated-import discipline: a *function-local* (lazy) import of a
      torch-reaching module from a torch-free module is only legal
      through a recorded gate — either a `try:/except ImportError`
      optional-dependency probe (`perf/history.py`'s version stamp and
      kernel-source hash) or an inline justified allowance; and any call
      from the zone to an `import_jax`-gated helper must pass the
      literal `import_jax=False`. The port has no such helper (its fleet
      store copies the compile-cache subkey and calls no compile cache),
      so that half stays dormant, kept as the JAX package's linter has
      it.

The zone below is the layer map. Adding a module to the zone is a
claim reviewers can hold you to; removing one is a visible contract
change in this file's diff, not a silent drift.
"""

from __future__ import annotations

import ast
from typing import List, Optional

from .findings import Finding, Severity
from .projectmodel import (
    FunctionInfo,
    ProjectModel,
    is_torch_module,
    iter_calls,
    resolve_callee,
)

# -- the layer map -----------------------------------------------------------

# Modules (exact dotted name) or whole subpackages (prefix) that must be
# importable without torch. Keep sorted; every entry is a public contract.
TORCH_FREE_ZONE = (
    "madsim_tpu_torch.analysis",  # the linter lints itself torch-free (C import half is gated)
    "madsim_tpu_torch.fleet.allocator",
    "madsim_tpu_torch.fleet.api",
    "madsim_tpu_torch.fleet.chaos",
    "madsim_tpu_torch.fleet.client",
    "madsim_tpu_torch.fleet.events",
    "madsim_tpu_torch.fleet.fsck",
    "madsim_tpu_torch.fleet.httpd",
    "madsim_tpu_torch.fleet.scheduler",
    "madsim_tpu_torch.fleet.store",
    "madsim_tpu_torch.kinds",
    "madsim_tpu_torch.perf.history",
    "madsim_tpu_torch.search.bias",
)

# Closed modules: importing these from the zone is an L001 even before
# the transitive closure is consulted (they are torch by definition).
CLOSED_PREFIXES = (
    "torch",
    "madsim_tpu_torch.engine.core",
    "madsim_tpu_torch.ops",
)

# The gate keyword: a project function carrying this parameter promises
# to stay free of the compile stack when it is passed False (the JAX
# package's compile_cache.cache_subkey; no port function has one).
GATE_KWARG = "import_jax"


def in_zone(module: str) -> bool:
    return any(
        module == z or module.startswith(z + ".") for z in TORCH_FREE_ZONE
    )


def _is_closed(target: str) -> bool:
    return any(
        target == p or target.startswith(p + ".") for p in CLOSED_PREFIXES
    )


def _finding(rule: str, mi, lineno: int, message: str) -> Finding:
    return Finding(
        rule=rule, severity=Severity.ERROR, path=mi.rel, line=lineno,
        col=0, message=message,
    )


def _torch_reaching(model: ProjectModel, target: str) -> Optional[List[str]]:
    """Does importing `target` (an absolute dotted edge target) execute
    a torch import?  Returns the module chain to torch, or None."""
    if is_torch_module(target) or _is_closed(target):
        return [target]
    for mod in model._project_targets(target):
        chain = model.eager_torch_chain(mod)
        if chain is not None:
            return chain
    return None


def _gated_functions(model: ProjectModel) -> set:
    """(module, qualname) of every project function with an
    `import_jax` parameter — the recorded gates."""
    out = set()
    for mi in model.modules.values():
        for fn in mi.functions.values():
            if GATE_KWARG in fn.params:
                out.add((fn.module, fn.qualname))
    return out


def check_model(model: ProjectModel) -> List[Finding]:
    findings: List[Finding] = []
    gates = _gated_functions(model)

    for name in sorted(model.modules):
        if not in_zone(name):
            continue
        mi = model.modules[name]

        # importing a.b.c executes a/__init__ and a/b/__init__ first:
        # the zone module's own package ancestors must be torch-free too
        # (`from .guided import ...` in search/__init__.py would poison
        # search.bias without bias.py changing a byte)
        parts = name.split(".")
        for cut in range(1, len(parts)):
            anc = ".".join(parts[:cut])
            if anc not in model.modules or in_zone(anc):
                continue  # zone ancestors report their own findings
            chain = model.eager_torch_chain(anc)
            if chain is not None:
                findings.append(_finding(
                    "L002", mi, 1,
                    f"torch-free module {name} cannot be imported without "
                    f"torch: its package ancestor executes "
                    f"{' -> '.join(chain)} at import time — break the "
                    f"chain in {chain[0]}'s __init__ or amend the "
                    f"layer map",
                ))
                break

        for edge in mi.imports:
            if edge.lazy:
                if edge.guarded:
                    # try/except ImportError: the optional-dependency
                    # probe idiom — legal, the module works without torch
                    continue
                chain = _torch_reaching(model, edge.target)
                if chain is not None:
                    via = (
                        f" (imports torch via {' -> '.join(chain)})"
                        if len(chain) > 1 or not is_torch_module(chain[0])
                        else ""
                    )
                    findings.append(_finding(
                        "L003", mi, edge.lineno,
                        f"torch-free module {name} lazily imports "
                        f"`{edge.target}`{via} inside "
                        f"`{edge.func or '?'}` without a gate — wrap in "
                        f"try/except ImportError if torch is optional "
                        f"here, or carry a justified inline allowance "
                        f"if this function IS the gate",
                    ))
                continue
            # eager edges
            if _is_closed(edge.target):
                findings.append(_finding(
                    "L001", mi, edge.lineno,
                    f"torch-free module {name} imports closed module "
                    f"`{edge.target}` at module level — the layer map "
                    f"(analysis/layers.py TORCH_FREE_ZONE) pins this "
                    f"module torch-free; move the import behind a "
                    f"function gate or move the code out of the zone",
                ))
                continue
            chain = _torch_reaching(model, edge.target)
            if chain is not None:
                findings.append(_finding(
                    "L002", mi, edge.lineno,
                    f"torch-free module {name} transitively imports torch: "
                    f"{name} -> {' -> '.join(chain)} — every module on "
                    f"that chain executes at import time, so "
                    f"`import {name}` now pays (and requires) torch; "
                    f"break the chain or amend the layer map",
                ))

        # L003 half two: calls to import_jax-gated helpers must close
        # the gate with the literal False
        for fn in mi.functions.values():
            for call in iter_calls(fn):
                kind, target = resolve_callee(call, fn, model)
                if kind != "project":
                    continue
                assert isinstance(target, FunctionInfo)
                if (target.module, target.qualname) not in gates:
                    continue
                if target.module == mi.name:
                    continue  # the gate's own module may use it freely
                ok = any(
                    kw.arg == GATE_KWARG
                    and isinstance(kw.value, ast.Constant)
                    and kw.value.value is False
                    for kw in call.keywords
                )
                if not ok:
                    findings.append(_finding(
                        "L003", mi, call.lineno,
                        f"torch-free module {name} calls gated helper "
                        f"`{target.module}.{target.qualname}` without "
                        f"`{GATE_KWARG}=False` — the gate defaults to "
                        f"importing its heavy stack; the zone must close it "
                        f"explicitly (the `job_subkey` idiom)",
                    ))
    return findings
