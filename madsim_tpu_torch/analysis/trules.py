"""T-rules: interprocedural traced-value taint (v2 of D006's pass).

D006 asks one file-local question — "is there python truthiness on a
tensor inside a Machine handler?" — and stops at the handler's edge.
The properties the streaming executor actually depends on are
interprocedural: `run_stream`'s steady state must have ZERO blocking
host syncs between segments apart from the designed ones (every
hidden `.item()` or `.cpu()` stalls the host's launch queue on the
card), and a donated carry is CONSUMED by the dispatch that takes it.
This pass builds per-function taint summaries over the project call
graph (pass 1's model) and walks entry contexts with real propagation
chains:

T001  a sync-forcing sink on a tensor — python truthiness
      (`if`/`while`/`assert`/ternary/`bool()`/`and`/`or`), `int()`,
      `float()`, `.item()`, `.tolist()`, `np.asarray()`/`np.array()` —
      reachable from `run_stream`'s executor loop or from a Machine
      handler *through helper calls* (the scope D006's file-local taint
      misses). In eager PyTorch each is a blocking device->host sync
      and, in a handler, a branch that diverges across lanes. Each
      finding names the propagation chain.
T002  a blocking fetch inside the per-segment dispatch region (the
      executor's loops and the helpers they call): `.cpu()`,
      `.numpy()`, `torch.cuda.synchronize()`, an event's or stream's
      `.synchronize()`. The two designed syncs — the counters poll and
      the ring drain — carry justified inline allowances; anything else
      is a hidden sync the A/B harness would only find after it
      shipped. An event's `.query()` is not a sync and is not flagged.
T003  use of a donated argument after the donating call site. Donation
      is resolved statically with the JAX package's matcher:
      `jax.jit(f, donate_argnums=...)` (also through `**kw` dicts and
      tuple-returning factories), including the wrapper idiom where the
      donating fn is passed through a dispatch helper (`_dispatch(what,
      fn, *args)` — the args after `fn` are the donated ones). The
      port's executor accepts `donate` and only reports it (eager
      PyTorch keeps one carry alive either way), so T003 finds nothing
      in the port's own code; it still fires on code that donates.

Taint model (documented because findings are only as good as it):
*sources* are `torch.*` expressions (bar the host-side API: `torch.cuda`,
`torch.distributed`, the profiler, dtype/device queries), calls to
jitted/donating fns, tensor-returning project calls (their summaries),
and (in handler contexts) the handler's params; `.cpu()` and `.numpy()`
are the *sanitizers* — their result is host memory — and a call that
receives a bound `.cpu`/`.numpy` method as an argument is treated as
sanitized too (the retry/span wrapper idiom); `int()`/`float()`/
`bool()`/`np.asarray()`/`.item()`/`.tolist()` sanitize their result
while SINKING their argument. An identity test (`x is None`) is host
python and never a sink. Everything else propagates conservatively.
Heuristic, like D006 — T001/T002 report as warnings; T003 (a
correctness bug, not a perf bug) as error.
"""

from __future__ import annotations

import ast
import dataclasses
from typing import Dict, FrozenSet, List, Optional, Sequence, Set, Tuple

from .astutils import TRACED_METHODS, dotted_name, machine_classes
from .findings import Finding, Severity
from .projectmodel import (
    FunctionInfo,
    ProjectModel,
    own_body_nodes,
    resolve_callee,
    resolve_dotted,
)

# Entry points whose bodies ARE the per-segment dispatch region. Walks
# start here with intrinsic sources only (no tainted params).
EXECUTOR_ENTRYPOINTS = (
    ("madsim_tpu_torch.engine.core", "Engine._run_stream_impl"),
)

# namespaces whose calls produce tensors
_TRACED_PREFIXES = ("torch.",)
# ... except torch's host-side API: these return python values, devices,
# dtypes, context managers, events or None, never a tensor
_HOST_TORCH_PREFIXES = (
    "torch.cuda.", "torch.distributed.", "torch.profiler.",
    "torch.autograd.", "torch.backends.", "torch.utils.",
    "torch.is_", "torch.are_", "torch.get_", "torch.set_",
    "torch.device", "torch.dtype", "torch.iinfo", "torch.finfo",
    "torch.Size", "torch.inference_mode", "torch.no_grad",
    "torch.manual_seed", "torch.use_deterministic_algorithms",
)
# references that turn a function into a tensor producer (`jax.jit` is
# the donation matcher's, kept as the JAX package has it)
_TRACED_FN_MAKERS = {
    "jax.jit", "torch.compile", "torch.vmap", "torch.func.vmap",
    "torch.jit.script", "torch.jit.trace",
}
# the sanitizers: explicit, designed device->host transfers (methods)
_SANITIZER_METHODS = {"cpu", "numpy"}
# blocking waits on the card (T002 in the dispatch region)
_SYNC_CALLS = {"torch.cuda.synchronize"}
_SYNC_METHODS = {"synchronize"}
# host-returning builtins that are ALSO T001 sinks when their arg is traced
_SINK_CASTS = {"int", "float", "bool"}
_SINK_NP = {"np.asarray", "numpy.asarray", "np.array", "numpy.array"}
# methods that return host python off a tensor and SINK it (T001)
_SINK_METHODS = {"item", "tolist"}
# host-returning, never sinks
_HOST_CALLS = {
    "len", "range", "isinstance", "type", "getattr", "hasattr", "repr",
    "str", "print", "enumerate", "id", "format", "callable",
    "dataclasses.is_dataclass", "dataclasses.fields",
}
# attribute reads that return static python off a tensor
_STATIC_ATTRS = {
    "shape", "ndim", "dtype", "size", "at", "device", "is_cuda", "is_cpu",
    "layout", "requires_grad",
}

_INTRINSIC = "*"  # origin marker for "a traced source in this body"


# -- donation registry -------------------------------------------------------


def _donate_positions(call: ast.Call, mi) -> Optional[Tuple[int, ...]]:
    """`jax.jit(f, ...)` -> donated argnums, or None if not a jit call /
    no donation. `**kw` dicts resolve through one module/local
    assignment (`donate_kw = {"donate_argnums": (0,)} if donate else
    {}` counts as donating — the static pass must assume the donating
    configuration)."""
    name = dotted_name(call.func)
    if name is None:
        return None
    resolved = mi.importmap.resolve(name)
    if resolved not in ("jax.jit", "jit", "pjit", "jax.experimental.pjit.pjit"):
        return None
    for kw in call.keywords:
        if kw.arg == "donate_argnums":
            return _tuple_of_ints(kw.value) or (0,)
        if kw.arg is None and _mentions_donate(kw.value, mi):
            return (0,)
    return None


def _tuple_of_ints(node: ast.expr) -> Optional[Tuple[int, ...]]:
    if isinstance(node, ast.Constant) and isinstance(node.value, int):
        return (node.value,)
    if isinstance(node, ast.Tuple) and all(
        isinstance(e, ast.Constant) and isinstance(e.value, int)
        for e in node.elts
    ):
        return tuple(e.value for e in node.elts)
    return None


def _mentions_donate(node: ast.expr, mi) -> bool:
    """A `**kwargs` operand donates when its expression — or the
    assignment of the Name it references, anywhere in the module —
    contains a 'donate_argnums' key."""
    def has_key(n) -> bool:
        return any(
            isinstance(x, ast.Constant) and x.value == "donate_argnums"
            for x in ast.walk(n)
        )

    if has_key(node):
        return True
    if isinstance(node, ast.Name):
        for n in ast.walk(mi.tree):
            if isinstance(n, ast.Assign) and any(
                isinstance(t, ast.Name) and t.id == node.id
                for t in n.targets
            ):
                if has_key(n.value):
                    return True
    return False


@dataclasses.dataclass
class Summary:
    """What a function does with taint, independent of call site."""
    prop: Set[str] = dataclasses.field(default_factory=set)  # params -> return
    always: bool = False  # returns a traced value regardless of args
    donates: Set[str] = dataclasses.field(default_factory=set)  # params it donates
    # return positions (tuple returns) that are donating jitted fns;
    # None key = "the return value itself is a donating fn"
    returns_donating: Dict[Optional[int], Tuple[int, ...]] = dataclasses.field(
        default_factory=dict
    )
    returns_traced_fn: bool = False  # returns a jitted fn (calls of it are traced)


class TaintEngine:
    def __init__(self, model: ProjectModel):
        self.model = model
        self.summaries: Dict[Tuple[str, str], Summary] = {}
        self.findings: List[Finding] = []
        self._context_memo: Set[Tuple[str, str, FrozenSet[str]]] = set()
        self._context_budget = 800

    def summary(self, fn: FunctionInfo) -> Summary:
        return self.summaries.setdefault((fn.module, fn.qualname), Summary())

    # -- fixed-point summaries ----------------------------------------------

    def compute_summaries(self) -> None:
        fns = [
            f for mi in self.model.modules.values()
            for f in mi.functions.values()
        ]
        for _ in range(4):  # call-graph cycles converge fast in practice
            changed = False
            for fn in fns:
                s = self._summarize(fn)
                old = self.summary(fn)
                if (
                    s.prop != old.prop or s.always != old.always
                    or s.donates != old.donates
                    or s.returns_donating != old.returns_donating
                    or s.returns_traced_fn != old.returns_traced_fn
                ):
                    self.summaries[(fn.module, fn.qualname)] = s
                    changed = True
            if not changed:
                break

    def _summarize(self, fn: FunctionInfo) -> Summary:
        walk = _BodyWalk(self, fn, tainted_params=set(fn.params),
                         symbolic=True, report=None)
        walk.run()
        s = Summary(
            prop={p for p in walk.return_origins if p != _INTRINSIC},
            always=_INTRINSIC in walk.return_origins,
            donates=walk.donated_params,
        )
        s.returns_donating = walk.returns_donating
        s.returns_traced_fn = walk.returns_traced_fn
        return s

    # -- entry walks ---------------------------------------------------------

    def run(
        self,
        executor_entrypoints: Sequence[Tuple[str, str]] = EXECUTOR_ENTRYPOINTS,
        handler_files: Optional[Set[str]] = None,
    ) -> List[Finding]:
        self.compute_summaries()

        # (a) executor contexts: no tainted params, intrinsic sources,
        # all sink kinds, T002 dispatch-region scope, T003 donation
        for mod, qual in executor_entrypoints:
            fn = self.model.function(mod, qual)
            if fn is None:
                continue
            self._walk_context(
                fn, tainted_params=frozenset(), chain=(),
                truthiness=True, executor=True,
            )

        # (b) Machine handler contexts: params tainted; depth-0
        # truthiness stays D006's (file-local, fixture-pinned) — this
        # pass takes the helpers D006 cannot see plus the cast/item
        # sinks D006 never covered
        for mi in self.model.modules.values():
            if handler_files is not None and mi.rel not in handler_files:
                continue
            for cls_name, cls in machine_classes(mi.tree).items():
                for item in cls.body:
                    if not isinstance(item, ast.FunctionDef):
                        continue
                    if item.name not in TRACED_METHODS:
                        continue
                    fn = mi.functions.get(f"{cls_name}.{item.name}")
                    if fn is None:
                        continue
                    params = frozenset(p for p in fn.params if p != "self")
                    self._walk_context(
                        fn, tainted_params=params, chain=(),
                        truthiness=False, executor=False,
                    )
        return self.findings

    def _walk_context(
        self,
        fn: FunctionInfo,
        tainted_params: FrozenSet[str],
        chain: Tuple[str, ...],
        truthiness: bool,
        executor: bool,
    ) -> None:
        key = (fn.module, fn.qualname, tainted_params)
        if key in self._context_memo or len(chain) > 6:
            return
        if self._context_budget <= 0:
            return
        self._context_budget -= 1
        self._context_memo.add(key)
        walk = _BodyWalk(
            self, fn, tainted_params=set(tainted_params), symbolic=False,
            report=_Reporter(self, fn, chain + (fn.qualname,),
                             truthiness=truthiness, executor=executor),
        )
        walk.run()


@dataclasses.dataclass
class _Reporter:
    engine: TaintEngine
    fn: FunctionInfo
    chain: Tuple[str, ...]
    truthiness: bool  # flag truthiness sinks at this depth
    executor: bool  # T002/T003 scope + all-sinks-on

    def rel(self) -> str:
        return self.engine.model.modules[self.fn.module].rel

    def emit(self, rule: str, sev: str, node: ast.AST, message: str) -> None:
        via = " -> ".join(self.chain)
        self.engine.findings.append(Finding(
            rule=rule, severity=sev, path=self.rel(),
            line=getattr(node, "lineno", 0),
            col=getattr(node, "col_offset", 0),
            message=f"{message} [chain: {via}]",
        ))

    def descend(self, callee: FunctionInfo, tainted_params: FrozenSet[str]) -> None:
        self.engine._walk_context(
            callee, tainted_params, self.chain,
            truthiness=True,  # helpers get the full sink set (the D006 gap)
            executor=self.executor,
        )


class _BodyWalk:
    """One pass over a function body in document order, twice (the
    second round approximates loop-carried flows). Tracks, per local
    name, the set of taint origins (param names and/or the intrinsic
    marker) plus donation state."""

    def __init__(self, engine: TaintEngine, fn: FunctionInfo,
                 tainted_params: Set[str], symbolic: bool, report):
        self.engine = engine
        self.fn = fn
        self.mi = engine.model.modules[fn.module]
        self.symbolic = symbolic  # summary mode: origins are param names
        self.report: Optional[_Reporter] = report
        self.env: Dict[str, Set[str]] = {
            p: {p} for p in tainted_params
        }
        # names bound to donating jitted fns: name -> donated positions
        self.donating_fns: Dict[str, Tuple[int, ...]] = {}
        # names bound to (plain) jitted fns — calls of them are traced
        self.traced_fns: Set[str] = set()
        self.return_origins: Set[str] = set()
        self.donated_params: Set[str] = set()
        self.returns_donating: Dict[Optional[int], Tuple[int, ...]] = {}
        self.returns_traced_fn: bool = False
        # name -> lineno where it was donated (T003 state)
        self.donated_at: Dict[str, int] = {}
        # names bound to tuple literals (positional `*name` expansion)
        self.tuple_lits: Dict[str, ast.Tuple] = {}
        self._reported: Set[Tuple[str, int, int]] = set()
        # While-loop spans of THIS body: the dispatch region for T002
        self._loop_spans: List[Tuple[int, int]] = [
            (n.lineno, n.end_lineno or n.lineno)
            for n in own_body_nodes(fn)
            if isinstance(n, (ast.While, ast.For))
        ]

    # -- driver --------------------------------------------------------------

    def run(self) -> None:
        body = list(self.fn.node.body)
        for _round in (1, 2):
            self._stmts(body)

    def _stmts(self, stmts) -> None:
        for stmt in stmts:
            self._stmt(stmt)

    def _stmt(self, node: ast.stmt) -> None:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            return  # separate FunctionInfo
        if isinstance(node, ast.Return):
            if node.value is not None:
                o = self._origins(node.value)
                self.return_origins |= o
                self._note_return_shape(node.value)
            return
        if isinstance(node, ast.Assign):
            o = self._origins(node.value)
            self._bind_fns(node.targets, node.value)
            for tgt in node.targets:
                self._assign_target(tgt, o, node.value)
            if (
                len(node.targets) == 1 and isinstance(node.targets[0], ast.Name)
                and isinstance(node.value, ast.Tuple)
                and not any(isinstance(e, ast.Starred) for e in node.value.elts)
            ):
                # `*name` of a tuple literal expands positionally at calls
                self.tuple_lits[node.targets[0].id] = node.value
            return
        if isinstance(node, ast.AugAssign):
            o = self._origins(node.value) | self._origins(node.target)
            self._assign_target(node.target, o, node.value)
            return
        if isinstance(node, ast.AnnAssign):
            if node.value is not None:
                o = self._origins(node.value)
                self._assign_target(node.target, o, node.value)
            return
        if isinstance(node, ast.For):
            o = self._origins(node.iter)
            rows = _literal_rows(node.target, node.iter)
            if rows is None:
                self._assign_target(node.target, o, node.iter)
            else:
                # a loop over a literal table of tuples: each target
                # name takes its own column's origins
                for k, tgt in enumerate(node.target.elts):
                    col: Set[str] = set()
                    for row in rows:
                        col |= self._origins_quiet(row.elts[k])
                    self._assign_target(tgt, col, node.iter)
            self._stmts(node.body)
            self._stmts(node.orelse)
            return
        if isinstance(node, ast.While):
            self._truthiness_sink(node.test, "while")
            self._origins(node.test)
            self._stmts(node.body)
            self._stmts(node.orelse)
            return
        if isinstance(node, ast.If):
            self._truthiness_sink(node.test, "if")
            self._origins(node.test)
            self._stmts(node.body)
            self._stmts(node.orelse)
            return
        if isinstance(node, ast.Assert):
            self._truthiness_sink(node.test, "assert")
            self._origins(node.test)
            return
        if isinstance(node, (ast.With, ast.AsyncWith)):
            for item in node.items:
                self._origins(item.context_expr)
                if item.optional_vars is not None:
                    self._assign_target(
                        item.optional_vars,
                        self._origins(item.context_expr),
                        item.context_expr,
                    )
            self._stmts(node.body)
            return
        if isinstance(node, ast.Try):
            self._stmts(node.body)
            for h in node.handlers:
                self._stmts(h.body)
            self._stmts(node.orelse)
            self._stmts(node.finalbody)
            return
        if isinstance(node, ast.Expr):
            self._origins(node.value)
            return
        # fallthrough (Raise, Delete, Global, ...): evaluate contained
        # expressions for sinks
        for child in ast.iter_child_nodes(node):
            if isinstance(child, ast.expr):
                self._origins(child)

    def _assign_target(self, tgt: ast.expr, origins: Set[str], value) -> None:
        if isinstance(tgt, ast.Name):
            self.env[tgt.id] = set(origins)
            self.tuple_lits.pop(tgt.id, None)
            self.donated_at.pop(tgt.id, None)  # rebind clears donation
        elif isinstance(tgt, (ast.Tuple, ast.List)):
            for e in tgt.elts:
                self._assign_target(e, origins, value)
        elif isinstance(tgt, (ast.Attribute, ast.Subscript)):
            self._origins(tgt.value)

    def _bind_fns(self, targets, value) -> None:
        """Track names bound to jitted/donating fns: direct jax.jit
        assignment, or tuple-unpack of a factory whose summary records
        donating return positions (`self._stream_fns(...)`)."""
        names: List[Optional[str]] = []
        if len(targets) == 1 and isinstance(targets[0], ast.Name):
            names = [targets[0].id]
        elif len(targets) == 1 and isinstance(targets[0], (ast.Tuple, ast.List)):
            names = [
                e.id if isinstance(e, ast.Name) else None
                for e in targets[0].elts
            ]
        if not names:
            return

        if isinstance(value, ast.Call):
            pos = _donate_positions(value, self.mi)
            resolved = None
            name = dotted_name(value.func)
            if name is not None:
                resolved = self.mi.importmap.resolve(name)
            if pos is not None and len(names) == 1 and names[0]:
                self.donating_fns[names[0]] = pos
                self.traced_fns.add(names[0])
                return
            if resolved in _TRACED_FN_MAKERS and len(names) == 1 and names[0]:
                self.traced_fns.add(names[0])
                return
            # factory unpack: summaries know which tuple slots donate
            kind, target = resolve_callee(value, self.fn, self.engine.model)
            if kind == "project":
                s = self.engine.summary(target)
                if s.returns_traced_fn:
                    for n in names:
                        if n:
                            self.traced_fns.add(n)
                for slot, dpos in s.returns_donating.items():
                    if slot is None and len(names) == 1 and names[0]:
                        self.donating_fns[names[0]] = dpos
                        self.traced_fns.add(names[0])
                    elif slot is not None and slot < len(names) and names[slot]:
                        self.donating_fns[names[slot]] = dpos
                        self.traced_fns.add(names[slot])
        elif isinstance(value, ast.Name):
            if value.id in self.donating_fns and len(names) == 1 and names[0]:
                self.donating_fns[names[0]] = self.donating_fns[value.id]
            if value.id in self.traced_fns and len(names) == 1 and names[0]:
                self.traced_fns.add(names[0])

    def _note_return_shape(self, value: ast.expr) -> None:
        """Record donating/jitted fns escaping through the return value
        (the `_stream_fns` factory shape)."""
        def jit_info(e: ast.expr) -> Optional[Tuple[int, ...]]:
            if isinstance(e, ast.Call):
                pos = _donate_positions(e, self.mi)
                if pos is not None:
                    return pos
                name = dotted_name(e.func)
                if name and self.mi.importmap.resolve(name) in _TRACED_FN_MAKERS:
                    return ()
            if isinstance(e, ast.Name):
                if e.id in self.donating_fns:
                    return self.donating_fns[e.id]
                if e.id in self.traced_fns:
                    return ()
                # one Name hop: `fns = (...); return fns`
                for n in ast.walk(self.fn.node):
                    if (
                        isinstance(n, ast.Assign)
                        and len(n.targets) == 1
                        and isinstance(n.targets[0], ast.Name)
                        and n.targets[0].id == e.id
                        and isinstance(n.value, ast.Tuple)
                    ):
                        return None  # handled by the tuple branch below
            return None

        expr: ast.expr = value
        if isinstance(expr, ast.Name):
            for n in ast.walk(self.fn.node):
                if (
                    isinstance(n, ast.Assign)
                    and len(n.targets) == 1
                    and isinstance(n.targets[0], ast.Name)
                    and n.targets[0].id == expr.id
                    and isinstance(n.value, (ast.Tuple, ast.Call))
                ):
                    expr = n.value
                    break
        if isinstance(expr, ast.Tuple):
            for i, e in enumerate(expr.elts):
                info = jit_info(e)
                if info is not None:
                    self.returns_traced_fn = True
                    if info:
                        self.returns_donating[i] = info
        else:
            info = jit_info(expr)
            if info is not None:
                self.returns_traced_fn = True
                if info:
                    self.returns_donating[None] = info

    # -- expression origins (and sinks) --------------------------------------

    def _origins(self, node: ast.expr) -> Set[str]:
        if isinstance(node, ast.Name):
            self._check_donated_use(node)
            if node.id in self.traced_fns:
                return set()  # the fn object itself is host
            return set(self.env.get(node.id, ()))
        if isinstance(node, ast.Constant):
            return set()
        if isinstance(node, ast.Attribute):
            base = self._origins(node.value)
            if node.attr in _STATIC_ATTRS:
                return set()
            if isinstance(node.value, ast.Name) and node.value.id == "self":
                return set()  # static config, matches D006
            return base
        if isinstance(node, ast.Subscript):
            self._origins(node.slice)
            return self._origins(node.value)
        if isinstance(node, ast.Call):
            return self._call_origins(node)
        if isinstance(node, ast.BinOp):
            return self._origins(node.left) | self._origins(node.right)
        if isinstance(node, ast.UnaryOp):
            return self._origins(node.operand)
        if isinstance(node, ast.Compare):
            out = self._origins(node.left)
            for c in node.comparators:
                out |= self._origins(c)
            if all(isinstance(op, (ast.Is, ast.IsNot)) for op in node.ops):
                return set()  # an identity test is host python
            if any(
                isinstance(x, ast.Constant) and isinstance(x.value, str)
                for x in [node.left, *node.comparators]
            ):
                return set()  # a tensor never compares with a str
            return out
        if isinstance(node, ast.BoolOp):
            out: Set[str] = set()
            for v in node.values:
                out |= self._origins(v)
            return out
        if isinstance(node, ast.IfExp):
            self._truthiness_sink(node.test, "conditional expression")
            self._origins(node.test)
            return self._origins(node.body) | self._origins(node.orelse)
        if isinstance(node, (ast.Tuple, ast.List, ast.Set)):
            out = set()
            for e in node.elts:
                out |= self._origins(e)
            return out
        if isinstance(node, ast.Dict):
            out = set()
            for k in node.keys:
                if k is not None:
                    out |= self._origins(k)
            for v in node.values:
                out |= self._origins(v)
            return out
        if isinstance(node, ast.Starred):
            return self._origins(node.value)
        if isinstance(node, ast.Lambda):
            return self._origins(node.body)
        # a comprehension's elements carry what their expression carries:
        # the iterable's origins reach them through the target names
        if isinstance(node, (ast.ListComp, ast.SetComp, ast.GeneratorExp)):
            for gen in node.generators:
                o = self._origins(gen.iter)
                self._assign_target(gen.target, o, gen.iter)
                for cond in gen.ifs:
                    self._origins(cond)
            return self._origins(node.elt)
        if isinstance(node, ast.DictComp):
            for gen in node.generators:
                o = self._origins(gen.iter)
                self._assign_target(gen.target, o, gen.iter)
                for cond in gen.ifs:
                    self._origins(cond)
            return self._origins(node.key) | self._origins(node.value)
        if isinstance(node, ast.JoinedStr):
            for v in node.values:
                if isinstance(v, ast.FormattedValue):
                    self._origins(v.value)
            return set()
        if isinstance(node, (ast.Slice,)):
            for part in (node.lower, node.upper, node.step):
                if part is not None:
                    self._origins(part)
            return set()
        if isinstance(node, (ast.NamedExpr,)):
            o = self._origins(node.value)
            self._assign_target(node.target, o, node.value)
            return o
        if isinstance(node, ast.Await):
            return self._origins(node.value)
        return set()

    def _call_origins(self, node: ast.Call) -> Set[str]:
        name = dotted_name(node.func)
        resolved = self.mi.importmap.resolve(name) if name else None
        arg_origins: Set[str] = set()
        for a in node.args:
            arg_origins |= self._origins(a)
        for kw in node.keywords:
            arg_origins |= self._origins(kw.value)

        # the wrapper idiom: a call handed a bound `.cpu`/`.numpy` is a
        # designed transfer — host result, and a T002 blocking fetch
        sanitizer_arg = any(
            self._is_sanitizer_ref(a) for a in node.args
        )

        # sinks first (they fire whether or not the result is used)
        if self.report is not None:
            self._call_sinks(node, resolved, arg_origins, sanitizer_arg)

        if sanitizer_arg:
            return set()
        # .cpu()/.numpy() results are host memory; .item()/.tolist()
        # return host python (and sank above)
        method = node.func.attr if isinstance(node.func, ast.Attribute) else None
        if method in _SANITIZER_METHODS or method in _SINK_METHODS:
            self._origins(node.func.value)
            return set()
        if resolved is not None:
            if resolved in _SINK_CASTS:
                return set()
            if resolved in _SINK_NP:
                return set()
            if resolved in _HOST_CALLS or (
                "." not in resolved and resolved in _HOST_CALLS
            ):
                return set()
            if any(resolved.startswith(p) for p in _HOST_TORCH_PREFIXES):
                return set()
            if any(resolved.startswith(p) for p in _TRACED_PREFIXES):
                return {_INTRINSIC}
            if resolved in _TRACED_FN_MAKERS:
                return {_INTRINSIC}

        # call of a name bound to a jitted/donating fn -> traced; the
        # donated positional args are consumed
        if isinstance(node.func, ast.Name):
            nm = node.func.id
            if nm in self.donating_fns:
                self._mark_donated(node, node.args, self.donating_fns[nm])
                return {_INTRINSIC}
            if nm in self.traced_fns:
                return {_INTRINSIC}
            if self.env.get(nm):
                # call of a value that may be a traced fn
                return {_INTRINSIC} if not self.symbolic else set(self.env[nm])

        # the dispatch-wrapper idiom: a donating fn passed BY NAME as an
        # argument — the args after it ride through to the donated call,
        # and the wrapper's result is the jitted call's result (traced)
        wrapper_traced = False
        for i, a in enumerate(node.args):
            if isinstance(a, ast.Name) and a.id in self.donating_fns:
                tail_args = node.args[i + 1:]
                self._mark_donated(node, tail_args, self.donating_fns[a.id])
                arg_origins |= {_INTRINSIC}
                wrapper_traced = True
            elif isinstance(a, ast.Name) and a.id in self.traced_fns:
                arg_origins |= {_INTRINSIC}
                wrapper_traced = True

        kind, target = resolve_callee(node, self.fn, self.engine.model)
        if kind == "project":
            s = self.engine.summary(target)
            mapped = self._map_args(node, target)
            out: Set[str] = set()
            if s.always or wrapper_traced:
                out |= {_INTRINSIC}
            for pname, origins in mapped.items():
                if pname in s.prop:
                    out |= origins
                if pname in s.donates:
                    # interprocedural donation: args bound to donating
                    # params are consumed at this call site
                    for anode, pn in self._arg_nodes(node, target):
                        if pn == pname and isinstance(anode, ast.Name):
                            self._donate_name(anode.id, node.lineno)
            # descend for sink detection inside the callee with this
            # call's taint (context-sensitive, memoized)
            if self.report is not None:
                tainted = frozenset(
                    p for p, o in mapped.items() if o
                )
                if tainted:
                    self.report.descend(target, tainted)
            return out

        # extern / opaque: conservative propagation
        return arg_origins

    @staticmethod
    def _is_sanitizer_ref(node: ast.expr) -> bool:
        """A bound `.cpu`/`.numpy` method handed over as a value."""
        return isinstance(node, ast.Attribute) and node.attr in _SANITIZER_METHODS

    def _map_args(self, call: ast.Call, target: FunctionInfo) -> Dict[str, Set[str]]:
        mapped: Dict[str, Set[str]] = {}
        for anode, pname in self._arg_nodes(call, target):
            if pname is None:
                continue
            mapped.setdefault(pname, set()).update(self._origins_quiet(anode))
        return mapped

    def _origins_quiet(self, node: ast.expr) -> Set[str]:
        """Origins without re-firing sinks (args were already walked)."""
        report, self.report = self.report, None
        try:
            return self._origins(node)
        finally:
            self.report = report

    def _arg_nodes(self, call: ast.Call, target: FunctionInfo):
        params = [p for p in target.params if p != "self"]
        out = []
        args: List[ast.expr] = []
        for a in call.args:
            lit = (
                self.tuple_lits.get(a.value.id)
                if isinstance(a, ast.Starred) and isinstance(a.value, ast.Name)
                else None
            )
            args.extend(lit.elts if lit is not None else [a])
        for i, a in enumerate(args):
            if isinstance(a, ast.Starred):
                # map the starred bundle onto every remaining param
                for p in params[i:]:
                    out.append((a.value, p))
                break
            out.append((a, params[i] if i < len(params) else None))
        for kw in call.keywords:
            if kw.arg is not None and kw.arg in params:
                out.append((kw.value, kw.arg))
        return out

    # -- sinks ---------------------------------------------------------------

    def _truthiness_sink(self, test: ast.expr, what: str) -> None:
        if self.report is None or not self.report.truthiness:
            return
        if self._origins_quiet(test):
            self._emit(
                "T001", Severity.WARNING, test,
                f"python truthiness on a tensor ({what}) in "
                f"`{self.fn.qualname}` — an implicit blocking "
                f"device->host sync, and in a handler a branch that "
                f"diverges across lanes",
            )

    def _call_sinks(self, node: ast.Call, resolved, arg_origins, sanitizer_arg) -> None:
        assert self.report is not None
        tainted = bool(arg_origins)
        method = node.func.attr if isinstance(node.func, ast.Attribute) else None
        if resolved in _SINK_CASTS and tainted and self.report.truthiness:
            self._emit(
                "T001", Severity.WARNING, node,
                f"`{resolved}()` on a tensor in `{self.fn.qualname}` "
                f"— forces a blocking device->host sync; fetch through "
                f"the designed sync points (the counters poll, the ring "
                f"drain) instead",
            )
        if resolved in _SINK_NP and tainted:
            self._emit(
                "T001", Severity.WARNING, node,
                f"`{resolved}()` on a tensor in `{self.fn.qualname}` "
                f"— an implicit device->host transfer outside the "
                f"designed sync points",
            )
        if method in _SINK_METHODS and self._origins_quiet(node.func.value):
            self._emit(
                "T001", Severity.WARNING, node,
                f"`.{method}()` on a tensor in `{self.fn.qualname}` — "
                f"one hidden blocking sync per call; batch the read "
                f"through the counters poll",
            )
        # T002: blocking fetches and waits in the dispatch region
        if self.report.executor and self._in_loop_span(node):
            what = None
            if method in _SANITIZER_METHODS:
                what = f"blocking fetch `.{method}()`"
            elif sanitizer_arg:
                what = "blocking fetch (a bound `.cpu`/`.numpy`)"
            elif resolved in _SYNC_CALLS or method in _SYNC_METHODS:
                what = f"blocking wait `{resolved or '.' + method}()`"
            if what is not None:
                self._emit(
                    "T002", Severity.WARNING, node,
                    f"{what} inside the per-segment dispatch region of "
                    f"`{self.fn.qualname}` — the pipelined executor's "
                    f"contract is zero blocking syncs between segments; "
                    f"if this IS a designed sync point, say so with an "
                    f"inline allowance",
                )

    def _in_loop_span(self, node: ast.AST) -> bool:
        # nested helper bodies (poll/drain) count as dispatch region in
        # their entirety: they exist to be called from the loop
        if self.fn.qualname.count("<locals>"):
            return True
        line = getattr(node, "lineno", 0)
        return any(lo <= line <= hi for lo, hi in self._loop_spans)

    # -- donation (T003) -----------------------------------------------------

    def _mark_donated(self, call: ast.Call, args, positions: Tuple[int, ...]) -> None:
        for p in positions:
            if p < len(args) and isinstance(args[p], ast.Name):
                self._donate_name(args[p].id, call.lineno)

    def _donate_name(self, name: str, lineno: int) -> None:
        if self.symbolic and name in self.fn.params:
            self.donated_params.add(name)
        self.donated_at[name] = lineno

    def _check_donated_use(self, node: ast.Name) -> None:
        if self.report is None:
            return
        at = self.donated_at.get(node.id)
        if at is None or node.lineno <= at:
            return
        self._emit(
            "T003", Severity.ERROR, node,
            f"`{node.id}` is used after being donated at line {at} of "
            f"`{self.fn.qualname}` — a donated buffer is CONSUMED by "
            f"the call that takes it (it is aliased in place); read "
            f"counters/rings BEFORE donating, or rebind the name to "
            f"the call's result",
        )

    def _emit(self, rule: str, sev: str, node: ast.AST, message: str) -> None:
        key = (rule, getattr(node, "lineno", 0), getattr(node, "col_offset", 0))
        if key in self._reported:
            return
        self._reported.add(key)
        assert self.report is not None
        self.report.emit(rule, sev, node, message)


def _literal_rows(target: ast.expr, it: ast.expr) -> Optional[List[ast.Tuple]]:
    """The rows of `for a, b in ((x, y), ...)`: a literal sequence of
    tuples, each as wide as the target tuple; else None."""
    if not isinstance(target, ast.Tuple) or not isinstance(it, (ast.Tuple, ast.List)):
        return None
    rows = it.elts
    if not rows or not all(
        isinstance(r, ast.Tuple) and len(r.elts) == len(target.elts)
        and not any(isinstance(e, ast.Starred) for e in r.elts)
        for r in rows
    ):
        return None
    return rows


def check_model(
    model: ProjectModel,
    executor_entrypoints: Sequence[Tuple[str, str]] = EXECUTOR_ENTRYPOINTS,
    handler_files: Optional[Set[str]] = None,
) -> List[Finding]:
    """`handler_files` (repo-relative paths) restricts the Machine
    handler context walks — the `lint --changed` scope; None = all."""
    engine = TaintEngine(model)
    findings = engine.run(
        executor_entrypoints=executor_entrypoints,
        handler_files=handler_files,
    )
    # stable order + dedup across the two-round body walks
    seen = set()
    out: List[Finding] = []
    for f in sorted(findings, key=lambda f: (f.path, f.line, f.col, f.rule)):
        key = (f.rule, f.path, f.line, f.col)
        if key in seen:
            continue
        seen.add(key)
        out.append(f)
    return out
