"""D-rules: determinism hazards, pure AST (stdlib only, no torch).

The failure mode these guard against is the silent kind: the code runs,
the hunt finds a seed, and the seed stops reproducing on another box,
another day, or another PYTHONHASHSEED — corpus rot. Each rule names a
nondeterminism source the Rust reference intercepts at runtime behind
`cfg(madsim)` and Python cannot:

D001  wall-clock reads (`time.time`, `perf_counter`, `datetime.now`…)
D002  OS/global entropy (`random.*` module functions, legacy
      `np.random.*` globals, unseeded `default_rng()`, `os.urandom`,
      `uuid.uuid1/4`, `secrets.*`)
D003  iteration over a set (hash-order leaks; strings vary per process
      with PYTHONHASHSEED) — fixable: wrap in `sorted(...)`
D004  `id()` / builtin `hash()` (CPython process addresses /
      PYTHONHASHSEED; both differ across runs)
D005  unordered host callbacks (`jax.debug.callback` without
      `ordered=True`, `io_callback(ordered=False)`) — the compiler may
      reorder or elide them, so observable side effects lose their
      deterministic interleaving — fixable: `ordered=True`. Kept as the
      JAX package has it: the port emits no such callback, but the rule
      is syntax and still fires on such code in any file it lints
D006  python truthiness on a tensor inside a Machine handler
      (`if`/`while`/`bool()`/`assert` on names derived from
      `nodes`/`payload`/`torch.*` expressions) — a handler runs once for
      the whole lane batch, so a python branch on a tensor is a blocking
      device->host sync and a branch that cannot differ between lanes

Rules fire on direct syntax only (see astutils). Severity: D006 is a
heuristic taint pass, so it reports as warning; the rest are errors.
"""

from __future__ import annotations

import ast
from typing import List, Optional, Set

from .astutils import (
    ImportMap,
    TRACED_METHODS,
    dotted_name,
    machine_classes,
    resolve_call,
)
from .findings import Finding, Severity

WALL_CLOCK_CALLS = {
    "time.time", "time.time_ns",
    "time.monotonic", "time.monotonic_ns",
    "time.perf_counter", "time.perf_counter_ns",
    "time.process_time", "time.process_time_ns",
    "time.localtime", "time.gmtime",
    "datetime.datetime.now", "datetime.datetime.utcnow",
    "datetime.datetime.today", "datetime.date.today",
}

ENTROPY_CALLS = {
    "os.urandom", "uuid.uuid1", "uuid.uuid4",
    "secrets.token_bytes", "secrets.token_hex", "secrets.token_urlsafe",
    "secrets.randbits", "secrets.choice", "secrets.randbelow",
    "random.random", "random.randint", "random.randrange",
    "random.choice", "random.choices", "random.shuffle",
    "random.sample", "random.uniform", "random.getrandbits",
    "random.gauss", "random.normalvariate", "random.expovariate",
    "random.betavariate", "random.triangular", "random.vonmisesvariate",
    "numpy.random.rand", "numpy.random.randn", "numpy.random.randint",
    "numpy.random.random", "numpy.random.random_sample",
    "numpy.random.ranf", "numpy.random.sample",
    "numpy.random.choice", "numpy.random.shuffle",
    "numpy.random.permutation", "numpy.random.uniform",
    "numpy.random.normal", "numpy.random.bytes", "numpy.random.seed",
}

# seeded-generator constructors: fine WITH a seed argument, OS entropy
# without one
SEEDED_CTORS = {"numpy.random.default_rng", "random.Random", "numpy.random.RandomState"}

UNORDERED_CALLBACKS = {"jax.debug.callback"}
IO_CALLBACKS = {"jax.experimental.io_callback"}

# attribute reads that turn a traced value back into static python
STATIC_ATTRS = {"shape", "ndim", "dtype", "size", "at"}
# calls that return static python regardless of argument taint
STATIC_CALLS = {"len", "range", "isinstance", "type", "getattr", "hasattr", "repr", "str"}


def _find(findings: List[Finding], rule: str, sev: str, path: str,
          node: ast.AST, message: str, fixable: bool = False) -> None:
    findings.append(Finding(
        rule=rule, severity=sev, path=path,
        line=getattr(node, "lineno", 0), col=getattr(node, "col_offset", 0),
        message=message, fixable=fixable,
    ))


def _is_set_expr(node: ast.expr, imports: ImportMap) -> bool:
    if isinstance(node, (ast.Set, ast.SetComp)):
        return True
    if isinstance(node, ast.Call):
        name = resolve_call(node, imports)
        if name in ("set", "frozenset"):
            return True
    return False


def _callback_ordered_kw(node: ast.Call) -> Optional[bool]:
    """The `ordered=` keyword's constant value, None when absent or
    non-constant."""
    for kw in node.keywords:
        if kw.arg == "ordered":
            if isinstance(kw.value, ast.Constant):
                return bool(kw.value.value)
            return True  # non-constant: assume the author thought about it
    return None


def check_module(tree: ast.Module, source: str, path: str) -> List[Finding]:
    imports = ImportMap(tree)
    findings: List[Finding] = []

    in_hash_method: Set[int] = set()  # line spans of __hash__/__eq__ bodies
    for node in ast.walk(tree):
        if isinstance(node, ast.FunctionDef) and node.name in ("__hash__", "__eq__"):
            in_hash_method.update(range(node.lineno, (node.end_lineno or node.lineno) + 1))

    for node in ast.walk(tree):
        if isinstance(node, ast.Call):
            name = resolve_call(node, imports)
            if name in WALL_CLOCK_CALLS:
                _find(findings, "D001", Severity.ERROR, path, node,
                      f"wall-clock read `{name}` — virtual time only; use the "
                      f"sim clock (madsim_tpu_torch.time) or gate behind real mode")
            elif name in ENTROPY_CALLS:
                _find(findings, "D002", Severity.ERROR, path, node,
                      f"OS/global entropy `{name}` — draw from the seeded "
                      f"stream (madsim_tpu_torch.rand / handler rand_u32 words)")
            elif name in SEEDED_CTORS:
                unseeded = not node.args or (
                    isinstance(node.args[0], ast.Constant) and node.args[0].value is None
                )
                if unseeded and not node.keywords:
                    _find(findings, "D002", Severity.ERROR, path, node,
                          f"`{name}()` without a seed draws OS entropy — pass "
                          f"an explicit seed derived from the lane seed")
            elif name == "id":
                _find(findings, "D004", Severity.ERROR, path, node,
                      "`id()` is a process address — varies across runs; key "
                      "on an explicit stable identifier instead")
            elif name == "hash" and node.lineno not in in_hash_method:
                arg_const = node.args and isinstance(node.args[0], ast.Constant)
                if not arg_const:
                    _find(findings, "D004", Severity.ERROR, path, node,
                          "builtin `hash()` is PYTHONHASHSEED-dependent for "
                          "str/bytes — use a content hash (core.digest_fold "
                          "family) for anything that can reach sim state")
            elif name in UNORDERED_CALLBACKS:
                if _callback_ordered_kw(node) is not True:
                    _find(findings, "D005", Severity.ERROR, path, node,
                          f"`{name}` is unordered by default — the compiler "
                          f"may reorder or drop it; pass ordered=True",
                          fixable=True)
            elif name in IO_CALLBACKS:
                if _callback_ordered_kw(node) is not True:
                    _find(findings, "D005", Severity.ERROR, path, node,
                          f"`{name}` without ordered=True may be reordered "
                          f"or elided by the compiler", fixable=True)

        iter_expr = None
        if isinstance(node, ast.For):
            iter_expr = node.iter
        elif isinstance(node, ast.comprehension):
            iter_expr = node.iter
        if iter_expr is not None and _is_set_expr(iter_expr, imports):
            _find(findings, "D003", Severity.ERROR, path, iter_expr,
                  "iteration over a set — hash order can leak into "
                  "simulation state (and varies with PYTHONHASHSEED for "
                  "strings); iterate sorted(...)", fixable=True)

    findings.extend(_check_traced_truthiness(tree, path))
    return findings


# -- D006: truthiness on traced values inside handlers -----------------------


def _taint_expr(node: ast.expr, tainted: Set[str]) -> bool:
    """Conservative 'does this expression carry a traced value'."""
    if isinstance(node, ast.Name):
        return node.id in tainted
    if isinstance(node, ast.Attribute):
        if node.attr in STATIC_ATTRS:
            return False
        # self.X is static config; anything_else.attr inherits taint
        base = node.value
        if isinstance(base, ast.Name) and base.id == "self":
            return False
        return _taint_expr(base, tainted)
    if isinstance(node, ast.Subscript):
        return _taint_expr(node.value, tainted)
    if isinstance(node, ast.Call):
        name = dotted_name(node.func)
        if name:
            head = name.split(".")[0]
            if name.split(".")[-1] in STATIC_CALLS or head in STATIC_CALLS:
                return False
            if head == "torch":
                return True
        return any(_taint_expr(a, tainted) for a in node.args) or any(
            _taint_expr(kw.value, tainted) for kw in node.keywords
        )
    if isinstance(node, (ast.BinOp,)):
        return _taint_expr(node.left, tainted) or _taint_expr(node.right, tainted)
    if isinstance(node, ast.UnaryOp):
        return _taint_expr(node.operand, tainted)
    if isinstance(node, ast.Compare):
        return _taint_expr(node.left, tainted) or any(
            _taint_expr(c, tainted) for c in node.comparators
        )
    if isinstance(node, ast.BoolOp):
        return any(_taint_expr(v, tainted) for v in node.values)
    if isinstance(node, (ast.Tuple, ast.List)):
        return any(_taint_expr(e, tainted) for e in node.elts)
    if isinstance(node, ast.IfExp):
        return (_taint_expr(node.body, tainted)
                or _taint_expr(node.orelse, tainted))
    return False


def _check_traced_truthiness(tree: ast.Module, path: str) -> List[Finding]:
    findings: List[Finding] = []
    for cls in machine_classes(tree).values():
        for fn in cls.body:
            if not isinstance(fn, ast.FunctionDef):
                continue
            if fn.name not in TRACED_METHODS:
                continue
            tainted: Set[str] = {
                a.arg for a in fn.args.args + fn.args.kwonlyargs
                if a.arg != "self"
            }

            def flag(expr: ast.expr, what: str) -> None:
                findings.append(Finding(
                    rule="D006", severity=Severity.WARNING, path=path,
                    line=expr.lineno, col=expr.col_offset,
                    message=f"python truthiness on a likely tensor value in "
                            f"handler `{fn.name}` ({what}) — a host sync and "
                            f"one branch for every lane of the batch; use "
                            f"torch.where / masked writes",
                ))

            for node in ast.walk(fn):
                # propagate taint through simple assignments, in source
                # order (ast.walk is BFS by nesting, close enough for
                # straight-line handler bodies)
                if isinstance(node, ast.Assign) and _taint_expr(node.value, tainted):
                    for tgt in node.targets:
                        for n in ast.walk(tgt):
                            if isinstance(n, ast.Name):
                                tainted.add(n.id)
                elif isinstance(node, ast.If) and _taint_expr(node.test, tainted):
                    flag(node.test, "if")
                elif isinstance(node, ast.While) and _taint_expr(node.test, tainted):
                    flag(node.test, "while")
                elif isinstance(node, ast.Assert) and _taint_expr(node.test, tainted):
                    flag(node.test, "assert")
                elif isinstance(node, ast.IfExp) and _taint_expr(node.test, tainted):
                    flag(node.test, "conditional expression")
                elif (isinstance(node, ast.Call)
                      and isinstance(node.func, ast.Name)
                      and node.func.id == "bool"
                      and node.args
                      and _taint_expr(node.args[0], tainted)):
                    flag(node, "bool()")
                elif isinstance(node, ast.BoolOp) and _taint_expr(node, tainted):
                    flag(node, "and/or")
    return findings
