"""Shared stdlib-`ast` helpers for the lint passes (no torch here).

The resolvers are deliberately *syntactic*: they track import aliases
(`import time as wall` → `wall.perf_counter` resolves to
`time.perf_counter`) and nothing else. A hazard reachable only through
runtime indirection (getattr strings, callables in dicts) is out of
scope — the runtime interception madsim has and Python lacks is exactly
what this layer cannot rebuild, so it aims at the honest 95%: direct
calls, direct iteration, direct truthiness.
"""

from __future__ import annotations

import ast
from typing import Dict, Iterator, List, Optional, Tuple


def parse_source(source: str, path: str) -> ast.Module:
    return ast.parse(source, filename=path)


class ImportMap:
    """local name -> dotted origin ("wall" -> "time",
    "io_callback" -> "jax.experimental.io_callback"). Relative imports
    resolve to ".<module>" so they can never collide with stdlib
    names (the package's own `time`/`rand` modules are the point)."""

    def __init__(self, tree: ast.Module):
        self.names: Dict[str, str] = {}
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                for alias in node.names:
                    local = alias.asname or alias.name.split(".")[0]
                    # `import a.b` binds `a`; `import a.b as c` binds a.b
                    self.names[local] = alias.name if alias.asname else alias.name.split(".")[0]
            elif isinstance(node, ast.ImportFrom):
                mod = ("." * node.level) + (node.module or "")
                for alias in node.names:
                    if alias.name == "*":
                        continue
                    local = alias.asname or alias.name
                    # `from .. import x` binds "..x": the dots are the
                    # level, not a separator
                    sep = "" if mod.endswith(".") else "."
                    self.names[local] = f"{mod}{sep}{alias.name}" if mod else alias.name

    def resolve(self, dotted: str) -> str:
        head, _, rest = dotted.partition(".")
        origin = self.names.get(head)
        if origin is None:
            return dotted
        return f"{origin}.{rest}" if rest else origin


def dotted_name(node: ast.AST) -> Optional[str]:
    """`a.b.c` for Name/Attribute chains, else None."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if not isinstance(node, ast.Name):
        return None
    parts.append(node.id)
    return ".".join(reversed(parts))


def resolve_call(node: ast.Call, imports: ImportMap) -> Optional[str]:
    name = dotted_name(node.func)
    return imports.resolve(name) if name else None


# -- Machine subclass detection ----------------------------------------------

# Handler methods the authoring contract requires to be pure traced
# functions of their inputs (state lives in the `nodes` pytree).
PURE_HANDLERS = (
    "on_message", "on_timer", "invariant", "is_done", "summary",
    "coverage_projection",
)
# All methods whose parameters are lane-batched tensors when the engine
# calls them (the D006 truthiness scope).
TRACED_METHODS = PURE_HANDLERS + (
    "init", "init_node", "restart_if", "amnesia_restart_if",
    "torn_restart_if",
)


def machine_classes(tree: ast.Module) -> Dict[str, ast.ClassDef]:
    """Classes that look like Machine subclasses: a base named
    `Machine`, `*Machine`, or another machine-like class defined in the
    same file (fixed point, so local hierarchies resolve)."""
    classes = {
        n.name: n for n in ast.walk(tree) if isinstance(n, ast.ClassDef)
    }
    machine_like: Dict[str, ast.ClassDef] = {}

    def base_names(cls: ast.ClassDef) -> List[str]:
        out = []
        for b in cls.bases:
            name = dotted_name(b)
            if name:
                out.append(name.split(".")[-1])
        return out

    changed = True
    while changed:
        changed = False
        for name, cls in classes.items():
            if name in machine_like:
                continue
            for base in base_names(cls):
                if base == "Machine" or base.endswith("Machine") or base in machine_like:
                    machine_like[name] = cls
                    changed = True
                    break
    return machine_like


def class_methods(cls: ast.ClassDef) -> Iterator[ast.FunctionDef]:
    for node in cls.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            yield node


def walk_with_parents(
    tree: ast.AST,
) -> Iterator[Tuple[ast.AST, List[ast.AST]]]:
    """(node, ancestor-stack) pairs, outermost ancestor first."""
    stack: List[ast.AST] = []

    def visit(node: ast.AST):
        yield node, list(stack)
        stack.append(node)
        for child in ast.iter_child_nodes(node):
            yield from visit(child)
        stack.pop()

    yield from visit(tree)
