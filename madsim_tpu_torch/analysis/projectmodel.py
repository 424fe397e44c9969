"""Pass 1 of the v2 analyzer: the whole-program model (stdlib-only).

The D/C rule packs are per-file and syntactic; the properties the
port leans on — "the fleet control plane is torch-free", "the hot
streaming path has no hidden host syncs", "nobody touches a donated
carry" — are whole-program, flow-sensitive claims. This module builds
the shared substrate the L/T passes spend:

* a **module import graph** over the package, with each edge classified
  *eager* (module/class level — executed at import time) vs *lazy*
  (function-local — executed at call time) and *guarded* (directly
  inside a ``try`` whose handler catches ImportError — the
  optional-dependency idiom, e.g. `perf/history.py`'s version probe).
  Importing `a.b.c` also executes `a/__init__.py` and `a/b/__init__.py`,
  so every edge to a project module fans out to its package ancestors —
  the exact channel through which an innocent-looking
  ``from .guided import ...`` in `search/__init__.py` would drag torch
  into the "torch-free" `search.bias`.
* a **per-module symbol table** — module-level functions, classes and
  their methods, plus nested function defs (run_stream's `poll`/`drain`
  helpers are nested, and the taint pass must see through them).
* **call resolution** from a call site to a project FunctionInfo where
  the target is syntactically evident (import-alias chains, `self.`
  methods, same-module names, nested defs). Runtime indirection
  (getattr strings, callables in dicts) stays out of scope, same
  honesty bar as `astutils`.

The model is built once per lint run from the repo root (the same root
the G-pass uses) and handed to `layers.check_model` / `trules` /
`rrules`. Nothing here imports torch.
"""

from __future__ import annotations

import ast
import dataclasses
import os
from typing import Dict, List, Optional, Sequence, Tuple

from .astutils import ImportMap, dotted_name

PACKAGE = "madsim_tpu_torch"

_SKIP_DIRS = {"__pycache__", ".git", ".venv", "node_modules", ".claude"}


@dataclasses.dataclass
class ImportEdge:
    target: str  # absolute dotted target ("torch.nn", "madsim_tpu_torch.ops")
    lineno: int
    lazy: bool  # inside a function body (deferred to call time)
    guarded: bool  # directly under a try: catching ImportError/Exception
    func: Optional[str] = None  # enclosing function qualname when lazy


@dataclasses.dataclass
class FunctionInfo:
    qualname: str  # "foo" / "Cls.meth" / "outer.<locals>.inner"
    module: str  # dotted module name
    node: ast.AST  # FunctionDef / AsyncFunctionDef
    class_name: Optional[str]
    params: List[str]
    lineno: int
    # nested defs visible from this function's body: local name -> qualname
    locals_fns: Dict[str, str] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class ModuleInfo:
    name: str  # dotted
    path: str  # absolute
    rel: str  # repo-relative (finding path)
    tree: ast.Module
    source: str
    imports: List[ImportEdge]
    functions: Dict[str, FunctionInfo]
    classes: Dict[str, ast.ClassDef]
    importmap: ImportMap


class ProjectModel:
    def __init__(self, root: str):
        self.root = root
        self.modules: Dict[str, ModuleInfo] = {}
        self.broken: List[Tuple[str, str]] = []  # (rel, error) — unparseable

    # -- queries -------------------------------------------------------------

    def module_of_path(self, path: str) -> Optional[ModuleInfo]:
        ap = os.path.abspath(path)
        for m in self.modules.values():
            if m.path == ap:
                return m
        return None

    def split_function(self, dotted: str) -> Optional[Tuple[str, str]]:
        """Longest-module-prefix split of an absolute dotted name into
        (module, symbol) — "madsim_tpu_torch.fleet.store.job_subkey" ->
        ("madsim_tpu_torch.fleet.store", "job_subkey")."""
        parts = dotted.split(".")
        for cut in range(len(parts) - 1, 0, -1):
            mod = ".".join(parts[:cut])
            if mod in self.modules:
                return mod, ".".join(parts[cut:])
        return None

    def function(self, module: str, qualname: str) -> Optional[FunctionInfo]:
        mi = self.modules.get(module)
        return mi.functions.get(qualname) if mi else None

    def eager_targets(self, name: str) -> List[ImportEdge]:
        mi = self.modules.get(name)
        if mi is None:
            return []
        return [e for e in mi.imports if not e.lazy]

    def eager_torch_chain(self, start: str) -> Optional[List[str]]:
        """BFS over eager project edges from `start`; returns the module
        chain ending at the first direct torch import, or None when the
        eager closure is torch-free. The chain includes the torch module
        itself as its last element."""
        seen = {start}
        queue: List[str] = [start]
        parent: Dict[str, str] = {}
        while queue:
            cur = queue.pop(0)
            for edge in self.eager_targets(cur):
                if is_torch_module(edge.target):
                    chain = [edge.target, cur]
                    while cur != start:
                        cur = parent[cur]
                        chain.append(cur)
                    return list(reversed(chain))
                for nxt in self._project_targets(edge.target):
                    if nxt not in seen:
                        seen.add(nxt)
                        parent[nxt] = cur
                        queue.append(nxt)
        return None

    def _project_targets(self, target: str) -> List[str]:
        """A resolved import edge target, expanded to every project
        module it executes: the module itself (or the package when a
        `from pkg import name` edge points at a non-module symbol) plus
        all package ancestors present in the model."""
        out: List[str] = []
        probe = target
        while probe and probe not in self.modules:
            probe = probe.rpartition(".")[0]
        if not probe:
            return out
        anc = probe.split(".")
        for cut in range(1, len(anc) + 1):
            name = ".".join(anc[:cut])
            if name in self.modules:
                out.append(name)
        return out


def is_torch_module(dotted: str) -> bool:
    head = dotted.split(".")[0]
    return head == "torch"


# -- construction ------------------------------------------------------------


def _module_name(root: str, path: str) -> str:
    rel = os.path.relpath(path, root).replace(os.sep, "/")
    parts = rel[:-3].split("/")  # strip .py
    if parts[-1] == "__init__":
        parts = parts[:-1]
    return ".".join(parts)


def _resolve_relative(module: str, is_pkg_init: bool, level: int, target: str) -> str:
    """Absolute dotted name of a level-`level` relative import from
    `module` (`from ..runtime import atomicio` in madsim_tpu_torch.fleet.store
    -> madsim_tpu_torch.runtime[.atomicio])."""
    parts = module.split(".")
    # a package __init__'s own package counts as the first level
    base = parts if is_pkg_init else parts[:-1]
    if level > 1:
        base = base[: len(base) - (level - 1)]
    return ".".join(base + ([target] if target else [])).strip(".")


class _ImportCollector(ast.NodeVisitor):
    def __init__(self, module: str, is_pkg_init: bool, module_names: set):
        self.module = module
        self.is_pkg_init = is_pkg_init
        self.module_names = module_names
        self.edges: List[ImportEdge] = []
        self._fn_stack: List[str] = []
        self._try_guard = 0

    def _add(self, target: str, lineno: int) -> None:
        self.edges.append(ImportEdge(
            target=target, lineno=lineno,
            lazy=bool(self._fn_stack),
            guarded=self._try_guard > 0,
            func=".".join(self._fn_stack) if self._fn_stack else None,
        ))

    def visit_Import(self, node: ast.Import) -> None:
        for alias in node.names:
            self._add(alias.name, node.lineno)

    def visit_ImportFrom(self, node: ast.ImportFrom) -> None:
        if node.level:
            base = _resolve_relative(
                self.module, self.is_pkg_init, node.level, node.module or ""
            )
        else:
            base = node.module or ""
        # `from X import a`: an edge to X.a when X.a is a module in the
        # project (importing a submodule), else to X itself
        for alias in node.names:
            if alias.name != "*" and f"{base}.{alias.name}" in self.module_names:
                self._add(f"{base}.{alias.name}", node.lineno)
            elif base:
                self._add(base, node.lineno)

    def visit_FunctionDef(self, node: ast.FunctionDef) -> None:
        self._fn_stack.append(node.name)
        self.generic_visit(node)
        self._fn_stack.pop()

    visit_AsyncFunctionDef = visit_FunctionDef  # type: ignore[assignment]

    def visit_Try(self, node: ast.Try) -> None:
        catches_import = any(
            h.type is None
            or any(
                n in ("ImportError", "ModuleNotFoundError", "Exception")
                for n in _handler_names(h)
            )
            for h in node.handlers
        )
        if catches_import:
            self._try_guard += 1
        for stmt in node.body:
            self.visit(stmt)
        if catches_import:
            self._try_guard -= 1
        for part in (node.handlers, node.orelse, node.finalbody):
            for stmt in part:
                self.visit(stmt)


def _handler_names(handler: ast.ExceptHandler) -> List[str]:
    t = handler.type
    nodes = t.elts if isinstance(t, ast.Tuple) else [t]
    out = []
    for n in nodes:
        name = dotted_name(n) if n is not None else None
        if name:
            out.append(name.split(".")[-1])
    return out


def _collect_functions(tree: ast.Module, module: str) -> Tuple[Dict[str, FunctionInfo], Dict[str, ast.ClassDef]]:
    functions: Dict[str, FunctionInfo] = {}
    classes: Dict[str, ast.ClassDef] = {}

    def params_of(fn) -> List[str]:
        a = fn.args
        out = [p.arg for p in a.posonlyargs + a.args]
        if a.vararg:
            out.append(a.vararg.arg)
        out.extend(p.arg for p in a.kwonlyargs)
        if a.kwarg:
            out.append(a.kwarg.arg)
        return out

    def add_fn(fn, qual: str, cls: Optional[str]) -> FunctionInfo:
        info = FunctionInfo(
            qualname=qual, module=module, node=fn, class_name=cls,
            params=params_of(fn), lineno=fn.lineno,
        )
        functions[qual] = info
        # nested defs (run_stream's poll/drain/_dispatch): registered as
        # their own analyzable units, resolvable by local name from the
        # enclosing body
        for child in ast.walk(fn):
            if child is fn:
                continue
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                # only register DIRECTLY nested defs here; deeper ones
                # register when their enclosing def is processed
                if _encloses_directly(fn, child):
                    nested_q = f"{qual}.<locals>.{child.name}"
                    info.locals_fns[child.name] = nested_q
                    nested = add_fn(child, nested_q, cls)
                    # a nested fn sees its siblings too
                    nested.locals_fns.setdefault(child.name, nested_q)
        # siblings resolve each other (drain calls reset via closure)
        for child_name, child_q in list(info.locals_fns.items()):
            child_info = functions[child_q]
            for sib, sib_q in info.locals_fns.items():
                child_info.locals_fns.setdefault(sib, sib_q)
        return info

    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            add_fn(node, node.name, None)
        elif isinstance(node, ast.ClassDef):
            classes[node.name] = node
            for item in node.body:
                if isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    add_fn(item, f"{node.name}.{item.name}", node.name)
    return functions, classes


def _encloses_directly(outer, inner) -> bool:
    """inner is nested in outer with no intermediate FunctionDef."""
    for node in ast.walk(outer):
        if node in (outer, inner):
            continue
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            if any(n is inner for n in ast.walk(node)):
                return False
    return True


def build_model(root: str, package_dir: Optional[str] = None) -> ProjectModel:
    """Parse every .py under `<root>/madsim_tpu_torch` (or `package_dir`) into
    the project model. Unreadable/unparseable files are recorded in
    `model.broken` and skipped — the per-file D-pass already reports
    the syntax error."""
    model = ProjectModel(root)
    pkg = package_dir or os.path.join(root, PACKAGE)
    paths: List[str] = []
    for dirpath, dirnames, filenames in os.walk(pkg):
        dirnames[:] = sorted(d for d in dirnames if d not in _SKIP_DIRS)
        for fn in sorted(filenames):
            if fn.endswith(".py"):
                paths.append(os.path.join(dirpath, fn))

    names = {_module_name(root, p) for p in paths}
    for path in paths:
        rel = os.path.relpath(path, root).replace(os.sep, "/")
        name = _module_name(root, path)
        try:
            with open(path, "r", encoding="utf-8") as fh:
                source = fh.read()
            tree = ast.parse(source, filename=path)
        except (OSError, UnicodeDecodeError, SyntaxError) as exc:
            model.broken.append((rel, repr(exc)))
            continue
        is_pkg_init = os.path.basename(path) == "__init__.py"
        coll = _ImportCollector(name, is_pkg_init, names)
        coll.visit(tree)
        functions, classes = _collect_functions(tree, name)
        model.modules[name] = ModuleInfo(
            name=name, path=os.path.abspath(path), rel=rel, tree=tree,
            source=source, imports=coll.edges, functions=functions,
            classes=classes, importmap=ImportMap(tree),
        )
    return model


# -- call resolution ---------------------------------------------------------


def resolve_dotted(dotted: str, mi: ModuleInfo) -> str:
    """Absolute form of a dotted reference inside module `mi`, following
    the file's import aliases; relative origins (".store.Job") resolve
    against the module's package."""
    resolved = mi.importmap.resolve(dotted)
    if resolved.startswith("."):
        level = len(resolved) - len(resolved.lstrip("."))
        is_pkg_init = mi.rel.endswith("__init__.py")
        return _resolve_relative(
            mi.name, is_pkg_init, level, resolved.lstrip(".")
        )
    return resolved


def resolve_callee(
    call: ast.Call, fn: FunctionInfo, model: ProjectModel
) -> Tuple[str, object]:
    """Resolve a call site to one of:
    ("project", FunctionInfo) — a function/method in the model;
    ("extern", dotted) — a syntactically-known external name;
    ("opaque", None) — not resolvable (call of a call, subscript, ...).
    """
    mi = model.modules[fn.module]
    name = dotted_name(call.func)
    if name is None:
        return "opaque", None
    parts = name.split(".")

    # nested def in the enclosing function chain
    if len(parts) == 1 and parts[0] in fn.locals_fns:
        target = mi.functions.get(fn.locals_fns[parts[0]])
        if target is not None:
            return "project", target

    # self.method -> same class (single-file hierarchies only)
    if parts[0] == "self" and fn.class_name and len(parts) == 2:
        target = mi.functions.get(f"{fn.class_name}.{parts[1]}")
        if target is not None:
            return "project", target
        return "extern", f"self.{parts[1]}"

    # same-module function / Class.method
    if len(parts) == 1 and parts[0] in mi.functions:
        return "project", mi.functions[parts[0]]
    if len(parts) == 2 and f"{parts[0]}.{parts[1]}" in mi.functions:
        return "project", mi.functions[f"{parts[0]}.{parts[1]}"]

    absolute = resolve_dotted(name, mi)
    split = model.split_function(absolute)
    if split is not None:
        mod, sym = split
        target = model.function(mod, sym)
        if target is not None:
            return "project", target
        # `Cls()` constructor or attr of a project module we can't see
        return "extern", absolute
    return "extern", absolute


def own_body_nodes(fn: FunctionInfo):
    """Nodes in `fn`'s own body, excluding nested function defs (those
    are separate FunctionInfos)."""
    nested_ids = set()
    for n in ast.walk(fn.node):
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef)) and n is not fn.node:
            for x in ast.walk(n):
                # madsim: allow(D004) — AST node identity within ONE
                # lint process (membership test only); nothing derived
                # from the address reaches findings or sim state
                nested_ids.add(id(x))
    for node in ast.walk(fn.node):
        if id(node) not in nested_ids or node is fn.node:  # madsim: allow(D004) — same membership test
            yield node


def iter_calls(fn: FunctionInfo):
    for node in own_body_nodes(fn):
        if isinstance(node, ast.Call):
            yield node


def functions_with_param(model: ProjectModel, param: str) -> List[FunctionInfo]:
    return [
        f
        for mi in model.modules.values()
        for f in mi.functions.values()
        if param in f.params
    ]
