"""Lane-axis abstract interpretation — the substrate of the S-rules.

The port shards `run_stream` over `torch.distributed` ranks along the
lane axis of `StreamCarry` (`parallel/`): rank r holds a contiguous
slice of the lanes. That is only cheap while per-lane state never
crosses ranks except at a few designed collectives — a whole-program
claim. This module is the machine that checks it: an abstract
interpreter over the `projectmodel` call graph that tracks, for every
value in the streaming step path, whether it still carries the LANE
(batch-leading) axis:

* **LANE** — a lane-leading tensor (`[L, ...]`): shards for free; any
  op that reduces/gathers/reshapes ACROSS dim 0 becomes a cross-rank
  collective under the mesh.
* **CARRY** — a struct of classified leaves (`StreamCarry`,
  `LaneState`, `BatchResult`): attribute reads classify by the field
  tables the S-rules declare (`srules.LANE_FIELDS` / `FREE_FIELDS`).
* **FREE** — no lane axis (scalars, ring buffers, the global coverage
  map): replicated under the mesh, crossing ranks costs nothing.
* tuples of the above (`("tuple", [...])`) and host containers
  (`("list", ...)`) so tuple carries and lists of tensors thread
  element-wise.

Propagation is torch's op semantics as the step path uses them: the
port has no `vmap`, so the batched per-lane step is walked like any
other code and must show its lane-parallelism. Elementwise ops and
`torch.where` join their operands, and a tensor method not in the
tables below keeps its receiver's axis; reductions (`x.sum()`,
`torch.any`, `x.amax()`, `np.<ufunc>.reduce`) consult their `dim`
argument — minor-dim reductions (`dim=1`, `dim=-1`) are lane-parallel,
dim-0 and dim-less ones (`x.any()` reduces everything) are CROSS-LANE,
as are scans over dim 0 (`torch.cumsum(x, 0)`); gathers (`x[i]`,
`x[-1]`, `x[mask]`, `searchsorted`, `index_select(0, ...)`,
`torch.gather(x, 0, ...)`) along the lane axis are cross-lane,
leading-slice/`[:, k]`/`take_along_dim(..., dim=1)`/`gather(1, ...)`
are not; `view`/`reshape`/`flatten`/`permute` on a lane value drop the
axis (the sharding would not survive, so it counts as cross-lane)
unless their arguments show dim 0 kept (`flatten(1)`, `permute(0,
...)`, `x.reshape(x.shape + (1,))`); a `torch.distributed` collective
of a lane value crosses ranks. The port's pytree combinator
(`utils.tree_map`) applies its leaf function to the leaves' axes;
`torch.vmap(f)(...)` produces a LANE result and its body is per-lane
code (never walked at batch level). Helper calls descend
context-sensitively with real argument axes, memoized; findings carry
the propagation chain, same shape as `trules`.

A cross-lane op is not automatically a finding: the step path NEEDS a
few (the done-mask, the harvest folds, the ring appends). Each designed
one carries an inline

    # madsim: collective(<name>, reduce=or|sum|any|max|min|gather|scan)

annotation (on the flagged line, or a comment-only line directly above
— same placement semantics as `# madsim: allow`). The annotation
*sanitizes* the op's result (a reduced/gathered value no longer
carries the lane axis) and must name an entry in the committed
registry (`srules.COLLECTIVES`) — which is exactly the collective plan
`parallel/` implements. Everything else the S-rules refuse; the rule
semantics themselves live in `srules.py`.

Honesty bar matches `astutils`: syntactic resolution only. Runtime
indirection (getattr strings, fn tables) is out of scope; `vmap`
bodies, the CUDA kernels (reached only as pointers through ctypes), and
modules outside the entry closures are never walked. Nothing here
imports torch.
"""

from __future__ import annotations

import ast
import dataclasses
import re
from typing import Callable, Dict, List, Optional, Sequence, Set, Tuple

from .findings import Finding
from .projectmodel import (
    FunctionInfo,
    ModuleInfo,
    ProjectModel,
    resolve_callee,
    resolve_dotted,
)
from .astutils import dotted_name

# -- the axis lattice ---------------------------------------------------------

FREE = "free"
LANE = "lane"
CARRY = "carry"

Axis = object  # FREE | LANE | CARRY | ("tuple", [Axis, ...]) | ("list", Axis)


def is_tuple(ax) -> bool:
    return isinstance(ax, tuple) and len(ax) == 2 and ax[0] == "tuple"


def is_list(ax) -> bool:
    """A HOST container of arrays (python list/set literal, list
    concatenation, the list `pallas_call` returns): iterating or
    int-indexing it is host-side plumbing, NOT lane-axis traffic —
    only its ELEMENTS carry (or don't carry) the lane axis."""
    return isinstance(ax, tuple) and len(ax) == 2 and ax[0] == "list"


def elem_of(ax) -> Axis:
    return ax[1] if is_list(ax) else collapse(ax)


def join(*axes) -> Axis:
    """Least upper bound; LANE dominates (a value that MIGHT carry the
    lane axis must be treated as carrying it), CARRY beats FREE.
    Tuples join element-wise when shapes agree, lists join on their
    element axis, mixed forms collapse."""
    if axes and all(is_list(a) for a in axes):
        return ("list", join(*(a[1] for a in axes)))
    tuples = [a for a in axes if is_tuple(a)]
    if tuples:
        n = len(tuples[0][1])
        if all(is_tuple(a) and len(a[1]) == n for a in axes):
            return ("tuple", [
                join(*(a[1][i] for a in axes)) for i in range(n)
            ])
    axes = [collapse(a) for a in axes]
    if LANE in axes:
        return LANE
    if CARRY in axes:
        return CARRY
    return FREE


def collapse(ax) -> Axis:
    """A tuple/list axis flattened to one scalar verdict (used when a
    structured value flows somewhere structure-unaware)."""
    if is_tuple(ax):
        return join(*(collapse(a) for a in ax[1])) if ax[1] else FREE
    if is_list(ax):
        return collapse(ax[1])
    return ax


def laneish(ax) -> bool:
    """Does the value (or any element of it) still carry the lane axis?"""
    return collapse(ax) in (LANE, CARRY)


# -- collective annotations ---------------------------------------------------

_COLLECTIVE_RE = re.compile(
    r"#\s*madsim:\s*collective\(\s*([A-Za-z0-9_-]+)\s*,\s*reduce=([a-z]+)\s*\)"
)


@dataclasses.dataclass
class Annotation:
    name: str
    reduce: str
    lineno: int  # the comment's own line


class CollectiveAnnotations:
    """Per-file `# madsim: collective(...)` map. `line_map[n]` is the
    annotation governing code line n (1-based). A comment-only line's
    annotation extends through the comment block to the first code line
    below it — same placement contract as inline `allow(...)`."""

    def __init__(self, source: str):
        self.line_map: Dict[int, Annotation] = {}
        self.all: List[Annotation] = []
        lines = source.splitlines()
        for lineno, text in enumerate(lines, start=1):
            m = _COLLECTIVE_RE.search(text)
            if not m:
                continue
            ann = Annotation(m.group(1), m.group(2), lineno)
            self.all.append(ann)
            self.line_map.setdefault(lineno, ann)
            if text.lstrip().startswith("#"):
                target = lineno + 1
                while (
                    target <= len(lines)
                    and lines[target - 1].lstrip().startswith("#")
                ):
                    target += 1
                self.line_map.setdefault(target, ann)


# -- op tables ----------------------------------------------------------------

# reductions over a `dim` argument, called as `torch.X(x, dim)` or as
# the method `x.X(dim)`; with no dim they reduce every axis
_REDUCE_OPS = {
    "sum", "prod", "mean", "max", "min", "amax", "amin", "any", "all",
    "argmin", "argmax", "count_nonzero", "cumsum", "cumprod", "cummax",
    "cummin", "logcumsumexp", "median", "nansum", "nanmean", "std", "var",
    "logsumexp", "norm", "aminmax",
}
# ... whose dim defaults to the minor axis instead (-1)
_MINOR_DEFAULT_OPS = {"sort", "argsort", "topk", "softmax", "log_softmax", "kthvalue"}
# ... and folds that flatten their input whatever the arguments
_FLAT_OPS = {"bincount", "nonzero", "unique", "unique_consecutive", "histc"}
# scans among them (S-rule reduce kind "scan")
_SCAN_OPS = {"cumsum", "cumprod", "cummax", "cummin", "logcumsumexp"}
# the binary elementwise forms `torch.max(a, b)` / `x.min(y)`
_BINARY_FORM_OPS = {"max", "min"}
# namespaces whose dotted calls are the function forms above (numpy
# keeps the host-side folds of the harvest: `np.bitwise_or.reduce`)
_REDUCE_PREFIXES = ("torch.", "np.", "numpy.")
# indexed gathers / scatters along a `dim` argument: (dim position in
# the function form, in the method form)
_DIM_GATHERS = {
    "gather": (1, 0), "index_select": (1, 0), "scatter": (1, 0),
    "scatter_add": (1, 0), "scatter_reduce": (1, 0), "index_add": (1, 0),
    "index_copy": (1, 0), "index_fill": (1, 0),
    "take_along_dim": (2, 1),
}
# gathers that index along the lane axis of their first operand
_LANE_GATHERS = {"take", "searchsorted", "compress", "masked_select"}
# shifts / flips along `dims` (every axis when absent)
_DIMS_SHIFTS = {"roll": (2, 1), "flip": (1, 0)}
# reshapes: the sharded axis survives only where the arguments show it
_RESHAPE_OPS = {
    "reshape", "view", "flatten", "ravel", "permute", "transpose",
    "swapaxes", "swapdims", "movedim", "moveaxis", "unflatten", "t",
}
# splits into a host tuple of tensors along `dim` (position: function
# form, method form; the default dim 0 is the lane axis)
_SPLITS = {"unbind": (1, 0), "split": (2, 1), "chunk": (2, 1), "tensor_split": (2, 1)}
# tensor methods that return host python (shape queries, pointers)
_HOST_METHODS = {
    "dim", "numel", "nelement", "size", "data_ptr", "is_contiguous",
    "stride", "element_size", "get_device", "is_floating_point",
    "is_complex", "untyped_storage", "storage_offset", "type",
}
# pytree containers' host iteration
_CONTAINER_METHODS = {"items", "keys", "values"}
# python sinks that force the lane axis through host control flow
_HOST_SINKS = {"len", "int", "float", "bool", "list", "tuple", "sorted",
               "enumerate", "sum", "max", "min", "any", "all"}
# calls that return static python whatever their arguments carry
_STATIC_CALLS = {
    "isinstance", "type", "hasattr", "callable", "repr", "str",
    "dataclasses.is_dataclass", "dataclasses.fields",
}
# attribute reads returning static python regardless of the base's axis
_STATIC_ATTRS = {
    "shape", "ndim", "dtype", "size", "itemsize", "nbytes", "device",
    "is_cuda", "is_cpu", "layout", "requires_grad",
}
# the pytree combinators: `fn` applied leaf by leaf over congruent trees
# (the port's own `utils.tree_map`, the analogue of jax.tree.map)
TREE_MAPS = {("madsim_tpu_torch.utils", "tree_map")}
# torch.distributed calls that move lanes across ranks (collectives)
_DIST_COLLECTIVES = {
    "all_gather": "gather", "all_gather_into_tensor": "gather",
    "all_to_all": "gather", "all_to_all_single": "gather",
    "all_reduce": "?", "reduce_scatter": "?",
    "reduce_scatter_tensor": "?", "broadcast": "gather",
}


def _int_const(node: Optional[ast.expr]):
    """An int literal (negative ones included) as a python int, else None."""
    if isinstance(node, ast.Constant) and isinstance(node.value, int) \
            and not isinstance(node.value, bool):
        return node.value
    if isinstance(node, ast.UnaryOp) and isinstance(node.op, ast.USub):
        inner = _int_const(node.operand)
        return -inner if inner is not None else None
    return None


def _arg(call: ast.Call, positional: Optional[int], *names: str):
    """The argument node given by keyword (any of `names`) or at
    `positional`, else None."""
    for kw in call.keywords:
        if kw.arg in names:
            return kw.value
    if positional is not None and len(call.args) > positional:
        a = call.args[positional]
        return None if isinstance(a, ast.Starred) else a
    return None


def _axis_kw(call: ast.Call, positional: Optional[int] = None):
    """The reduction's dim argument as a python value: int, tuple of
    ints, None (explicit dim=None or absent), or "?" when dynamic."""
    node = _arg(call, positional, "dim", "dims", "axis")
    if node is None:
        return None
    if isinstance(node, ast.Constant) and node.value is None:
        return None
    value = _int_const(node)
    if value is not None:
        return value
    if isinstance(node, (ast.Tuple, ast.List)):
        out = []
        for e in node.elts:
            v = _int_const(e)
            if v is None:
                return "?"
            out.append(v)
        return tuple(out)
    return "?"


def axis_hits_lane(axis_val) -> bool:
    """Does this reduction dim touch dim 0 (the lane axis)? None =
    reduce everything = yes. Negative literals are minor-axis by
    convention (rank >= 2 on the step path's [L, Q]/[L, N] planes) —
    EXCEPT the common 1-D case has no minor axis, so a bare `.sum()`
    with no dim on a 1-D mask is the caller's (frequent) cross-lane
    fold; `None` covers it."""
    if axis_val is None:
        return True
    if axis_val == "?":
        return True  # dynamic dim: assume the worst
    if isinstance(axis_val, int):
        return axis_val == 0
    if isinstance(axis_val, tuple):
        return 0 in axis_val or not axis_val
    return True


def _keeps_lane_reshape(op: str, call: ast.Call, recv: Optional[ast.expr],
                        method: bool) -> bool:
    """Does this reshape provably keep dim 0 in place? `flatten(d)` and
    `unflatten(d, ...)` from d >= 1, `permute(0, ...)`, `transpose` /
    `movedim` of two minor dims, and `reshape` / `view` of
    `<x>.shape + (...)` (trailing dims appended to the receiver's own)."""
    off = 0 if method else 1  # the function form's first arg is the tensor
    if op in ("flatten", "unflatten"):
        start = _int_const(_arg(call, off, "start_dim", "dim"))
        return start is not None and start >= 1
    if op == "permute":
        dims = call.args[off:]
        if len(dims) == 1 and isinstance(dims[0], (ast.Tuple, ast.List)):
            dims = dims[0].elts
        return bool(dims) and _int_const(dims[0]) == 0
    if op in ("transpose", "swapaxes", "swapdims", "movedim", "moveaxis"):
        a, b = _arg(call, off, "dim0", "source"), _arg(call, off + 1, "dim1", "destination")
        va, vb = _int_const(a), _int_const(b)
        return va is not None and vb is not None and va != 0 and vb != 0
    if op in ("reshape", "view") and method and recv is not None:
        shape = call.args[0] if len(call.args) == 1 else None
        if isinstance(shape, ast.BinOp) and isinstance(shape.op, ast.Add):
            head = shape.left
            if isinstance(head, ast.Attribute) and head.attr == "shape":
                return ast.dump(head.value) == ast.dump(recv)
    return False


# -- cross-lane events --------------------------------------------------------


@dataclasses.dataclass
class CrossLaneOp:
    """One cross-lane op the interpreter met, annotated or not. The
    S-rules turn these into findings and the registry audit."""

    kind: str  # reduce | gather | scan | reshape | iterate
    reduce: str  # or|sum|any|max|min|gather|scan|? — best-effort op class
    module: str
    rel: str
    line: int
    col: int
    region: str
    chain: Tuple[str, ...]
    detail: str
    annotation: Optional[Annotation]  # the governing collective(...) if any


@dataclasses.dataclass
class HostSink:
    """Python control flow / iteration / len() on a lane-carrying value
    (S003 raw material)."""

    what: str
    module: str
    rel: str
    line: int
    col: int
    region: str
    chain: Tuple[str, ...]


@dataclasses.dataclass
class RebuildKwarg:
    """One keyword at a carry rebuild site (`StreamCarry(...)` or
    `.replace(...)`) with the computed axis of its value (S002 raw
    material)."""

    cls: str
    field: str
    axis: Axis
    module: str
    rel: str
    line: int
    col: int
    chain: Tuple[str, ...]


# -- the interpreter ----------------------------------------------------------


@dataclasses.dataclass
class EntryPoint:
    module: str
    qualname: str
    region: str  # step | segment | init | final
    params: Dict[str, Axis]
    pinned: Dict[str, Axis] = dataclasses.field(default_factory=dict)


class AxisEngine:
    """Walk entry contexts, descending through project calls with real
    argument axes. Collects CrossLaneOp / HostSink / RebuildKwarg
    events; rule policy lives in srules."""

    def __init__(
        self,
        model: ProjectModel,
        *,
        lane_fields: Set[str],
        free_fields: Set[str],
        carry_fields: Set[str],
        carry_classes: Set[str],
        region_overrides: Dict[Tuple[str, str], str],
        reduce_name: Callable[[str], str] = lambda fn: fn,
    ):
        self.model = model
        self.lane_fields = lane_fields
        self.free_fields = free_fields
        self.carry_fields = carry_fields
        self.carry_classes = carry_classes
        self.region_overrides = region_overrides
        self.cross_ops: List[CrossLaneOp] = []
        self.host_sinks: List[HostSink] = []
        self.rebuilds: List[RebuildKwarg] = []
        self.walked_modules: Set[str] = set()
        self.consumed_annotations: Set[Tuple[str, int]] = set()  # (rel, lineno)
        self._annotations: Dict[str, CollectiveAnnotations] = {}
        self._memo: Dict[Tuple, Axis] = {}
        self._in_progress: Set[Tuple] = set()
        self._budget = 4000

    # -- entry ----------------------------------------------------------------

    def run(self, entrypoints: Sequence[EntryPoint]) -> None:
        for ep in entrypoints:
            fn = self.model.function(ep.module, ep.qualname)
            if fn is None:
                continue
            self._walk(
                fn, args={**ep.params}, region=ep.region, chain=(),
                closure=None, pinned=dict(ep.pinned),
            )

    def annotations_of(self, mi: ModuleInfo) -> CollectiveAnnotations:
        ann = self._annotations.get(mi.name)
        if ann is None:
            ann = self._annotations[mi.name] = CollectiveAnnotations(mi.source)
        return ann

    # -- function walks -------------------------------------------------------

    def _walk(
        self,
        fn: FunctionInfo,
        args: Dict[str, Axis],
        region: str,
        chain: Tuple[str, ...],
        closure: Optional[Dict[str, Axis]],
        pinned: Optional[Dict[str, Axis]] = None,
    ) -> Axis:
        region = self.region_overrides.get((fn.module, fn.qualname), region)
        nested = "<locals>" in fn.qualname
        key = None
        if not nested and closure is None:
            key = (
                fn.module, fn.qualname, region,
                tuple(sorted((k, repr(v)) for k, v in args.items())),
            )
            if key in self._memo:
                return self._memo[key]
            if key in self._in_progress:
                return FREE  # recursion: converge to bottom
            self._in_progress.add(key)
        if len(chain) > 10 or self._budget <= 0:
            if key is not None:
                self._in_progress.discard(key)
            return FREE
        self._budget -= 1
        self.walked_modules.add(fn.module)
        env: Dict[str, Axis] = {}
        if closure is not None:
            env.update(closure)
        for p in fn.params:
            env[p] = args.get(p, FREE)
        walk = _AxisWalk(
            self, fn, env=env, region=region,
            chain=chain + (fn.qualname,), pinned=pinned or {},
        )
        walk.run()
        result = walk.return_axis()
        if key is not None:
            self._in_progress.discard(key)
            self._memo[key] = result
        return result


class _AxisWalk:
    """One function body, walked twice in document order (round 2
    approximates loop-carried flows), tracking per-name axis state."""

    def __init__(self, engine: AxisEngine, fn: FunctionInfo,
                 env: Dict[str, Axis], region: str,
                 chain: Tuple[str, ...], pinned: Dict[str, Axis]):
        self.engine = engine
        self.fn = fn
        self.mi: ModuleInfo = engine.model.modules[fn.module]
        self.env = env
        self.region = region
        self.chain = chain
        self.pinned = pinned
        self.returns: List[Axis] = []
        self._seen_events: Set[Tuple[str, int, int, str]] = set()
        # loop names bound to str keys (`for k in ("a", "b")`): indexing
        # a lane-carrying dict with one is a field read, not a gather
        self.str_names: Set[str] = set()

    # -- driver ---------------------------------------------------------------

    def run(self) -> None:
        body = list(self.fn.node.body)
        for _round in (1, 2):
            self.returns = []
            self._stmts(body)

    def return_axis(self) -> Axis:
        return join(*self.returns) if self.returns else FREE

    # -- events ---------------------------------------------------------------

    def _cross(self, node: ast.AST, kind: str, reduce: str, detail: str) -> Axis:
        """Record a cross-lane op at `node`; consult the annotation map.
        Returns the result axis: sanitized FREE either way (the value no
        longer lane-indexes after a reduce/gather, and cascading LANE
        through an already-reported op would only duplicate findings)."""
        line = getattr(node, "lineno", 0)
        col = getattr(node, "col_offset", 0)
        dedup = (self.mi.rel, line, col, kind)
        if dedup not in self._seen_events:
            self._seen_events.add(dedup)
            ann = self.engine.annotations_of(self.mi).line_map.get(line)
            if ann is not None:
                self.engine.consumed_annotations.add((self.mi.rel, ann.lineno))
            self.engine.cross_ops.append(CrossLaneOp(
                kind=kind, reduce=reduce, module=self.fn.module,
                rel=self.mi.rel, line=line, col=col, region=self.region,
                chain=self.chain, detail=detail, annotation=ann,
            ))
        return FREE

    def _host_sink(self, node: ast.AST, what: str) -> None:
        self.engine.host_sinks.append(HostSink(
            what=what, module=self.fn.module, rel=self.mi.rel,
            line=getattr(node, "lineno", 0),
            col=getattr(node, "col_offset", 0),
            region=self.region, chain=self.chain,
        ))

    def _rebuild(self, call: ast.Call, cls: str, skip_first: bool = False) -> None:
        for kw in call.keywords:
            if kw.arg is None:
                self._axis(kw.value)
                continue
            self.engine.rebuilds.append(RebuildKwarg(
                cls=cls, field=kw.arg, axis=self._axis(kw.value),
                module=self.fn.module, rel=self.mi.rel,
                line=kw.value.lineno, col=kw.value.col_offset,
                chain=self.chain,
            ))
        for a in call.args[1 if skip_first else 0:]:
            self._axis(a)

    # -- statements -----------------------------------------------------------

    def _stmts(self, stmts) -> None:
        for stmt in stmts:
            self._stmt(stmt)

    def _stmt(self, node: ast.stmt) -> None:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            return  # nested defs walk when called, with the closure env
        if isinstance(node, ast.Return):
            if node.value is not None:
                self.returns.append(self._axis(node.value))
            else:
                self.returns.append(FREE)
            return
        if isinstance(node, ast.Assign):
            ax = self._axis(node.value)
            for tgt in node.targets:
                self._assign(tgt, ax)
            return
        if isinstance(node, ast.AugAssign):
            ax = join(self._axis(node.value), self._axis(node.target))
            self._assign(node.target, ax)
            return
        if isinstance(node, ast.AnnAssign):
            if node.value is not None:
                self._assign(node.target, self._axis(node.value))
            return
        if isinstance(node, ast.For):
            it = self._axis(node.iter)
            self._note_str_target(node.target, node.iter)
            if is_list(it) or is_tuple(it):
                self._assign(node.target, _row_of(it))
            elif laneish(it):
                self._host_sink(node.iter, "for-loop iteration")
                self._assign(node.target, FREE)
            else:
                self._assign(node.target, FREE)
            self._stmts(node.body)
            self._stmts(node.orelse)
            return
        if isinstance(node, ast.While):
            self._test_sink(node.test, "while")
            self._stmts(node.body)
            self._stmts(node.orelse)
            return
        if isinstance(node, ast.If):
            self._test_sink(node.test, "if")
            narrowed = _container_guard(node.test)
            saved = None
            if narrowed is not None and narrowed in self.env:
                # `if isinstance(x, (tuple, list, dict)):` — inside, x
                # is a host container of what it carried
                saved = self.env[narrowed]
                self.env[narrowed] = ("list", collapse(saved))
            self._stmts(node.body)
            if saved is not None and is_list(self.env.get(narrowed)):
                self.env[narrowed] = saved
            self._stmts(node.orelse)
            return
        if isinstance(node, ast.Assert):
            self._test_sink(node.test, "assert")
            return
        if isinstance(node, (ast.With, ast.AsyncWith)):
            for item in node.items:
                ax = self._axis(item.context_expr)
                if item.optional_vars is not None:
                    self._assign(item.optional_vars, ax)
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
            self._axis(node.value)
            return
        for child in ast.iter_child_nodes(node):
            if isinstance(child, ast.expr):
                self._axis(child)

    def _note_str_target(self, target: ast.expr, it: ast.expr) -> None:
        """Mark a loop name that iterates str keys only: a literal tuple
        of strs, or a module constant (here, imported from the project,
        or read as `alias.NAME`) that is one, `+`-concatenations
        included."""
        if not isinstance(target, ast.Name):
            return
        model, mi = self.engine.model, self.mi
        if isinstance(it, ast.Attribute) and isinstance(it.value, ast.Name):
            # `_kinds.FR_EXTRA_NAMES`: a project module's constant
            mi = model.modules.get(resolve_dotted(it.value.id, self.mi))
            it = _module_constant(model, mi, it.attr) if mi is not None else None
        elif isinstance(it, ast.Name) and it.id in self.env:
            return  # a local, not a module constant
        if it is not None and _str_literals(it, model, mi, 0):
            self.str_names.add(target.id)

    def _test_sink(self, test: ast.expr, what: str) -> None:
        ax = self._axis(test)
        if laneish(ax) and not is_list(ax):
            self._host_sink(test, f"python `{what}` on a lane-axis value")

    def _assign(self, tgt: ast.expr, ax: Axis) -> None:
        if isinstance(tgt, ast.Name):
            self.str_names.discard(tgt.id)
            if tgt.id in self.pinned:
                self.env[tgt.id] = self.pinned[tgt.id]
            else:
                self.env[tgt.id] = ax
        elif isinstance(tgt, (ast.Tuple, ast.List)):
            if is_tuple(ax) and len(ax[1]) == len(tgt.elts):
                elems = ax[1]
            else:
                elems = [elem_of(ax)] * len(tgt.elts)
            for e, a in zip(tgt.elts, elems):
                self._assign(e, a)
        elif isinstance(tgt, (ast.Attribute, ast.Subscript)):
            self._axis(tgt.value)

    # -- expressions ----------------------------------------------------------

    def _axis(self, node: ast.expr) -> Axis:
        if isinstance(node, ast.Name):
            return self.env.get(node.id, FREE)
        if isinstance(node, ast.Constant):
            return FREE
        if isinstance(node, ast.Attribute):
            return self._attr_axis(node)
        if isinstance(node, ast.Subscript):
            return self._subscript_axis(node)
        if isinstance(node, ast.Call):
            return self._call_axis(node)
        if isinstance(node, ast.BinOp):
            left, right = self._axis(node.left), self._axis(node.right)
            if is_list(left) or is_list(right):
                # python list concatenation keeps the container form
                return ("list", join(elem_of(left), elem_of(right)))
            return join(left, right)
        if isinstance(node, ast.UnaryOp):
            return self._axis(node.operand)
        if isinstance(node, ast.Compare):
            out = self._axis(node.left)
            for c in node.comparators:
                out = join(out, self._axis(c))
            if all(isinstance(op, (ast.Is, ast.IsNot)) for op in node.ops):
                return FREE  # an identity test is host python
            if any(
                isinstance(x, ast.Constant) and isinstance(x.value, str)
                for x in [node.left, *node.comparators]
            ):
                return FREE  # a tensor never compares with a str
            return out
        if isinstance(node, ast.BoolOp):
            return join(*(self._axis(v) for v in node.values))
        if isinstance(node, ast.IfExp):
            self._test_sink(node.test, "conditional expression")
            return join(self._axis(node.body), self._axis(node.orelse))
        if isinstance(node, ast.Tuple):
            return ("tuple", [self._axis(e) for e in node.elts])
        if isinstance(node, (ast.List, ast.Set)):
            elems = [self._axis(e) for e in node.elts]
            return ("list", join(*(elem_of(a) for a in elems)) if elems else FREE)
        if isinstance(node, ast.Dict):
            out: Axis = FREE
            for v in node.values:
                out = join(out, self._axis(v))
            for k in node.keys:
                if k is not None:
                    self._axis(k)
            return out
        if isinstance(node, ast.Starred):
            return self._axis(node.value)
        if isinstance(node, ast.Lambda):
            return FREE  # a function object; its body walks when applied
        if isinstance(node, (ast.ListComp, ast.SetComp, ast.GeneratorExp)):
            for gen in node.generators:
                it = self._axis(gen.iter)
                if is_list(it) or is_tuple(it):
                    self._assign(gen.target, elem_of(it))
                elif laneish(it):
                    self._host_sink(gen.iter, "comprehension over the lane axis")
                    self._assign(gen.target, FREE)
                else:
                    self._assign(gen.target, FREE)
                self._note_str_target(gen.target, gen.iter)
                for cond in gen.ifs:
                    self._axis(cond)
            return ("list", elem_of(self._axis(node.elt)))
        if isinstance(node, ast.DictComp):
            for gen in node.generators:
                it = self._axis(gen.iter)
                if is_list(it) or is_tuple(it):
                    self._assign(gen.target, elem_of(it))
                elif laneish(it):
                    self._host_sink(gen.iter, "comprehension over the lane axis")
                    self._assign(gen.target, FREE)
                else:
                    self._assign(gen.target, FREE)
            return join(self._axis(node.key), self._axis(node.value))
        if isinstance(node, ast.JoinedStr):
            for v in node.values:
                if isinstance(v, ast.FormattedValue):
                    self._axis(v.value)
            return FREE
        if isinstance(node, ast.NamedExpr):
            ax = self._axis(node.value)
            self._assign(node.target, ax)
            return ax
        if isinstance(node, ast.Await):
            return self._axis(node.value)
        if isinstance(node, ast.Slice):
            for part in (node.lower, node.upper, node.step):
                if part is not None:
                    self._axis(part)
            return FREE
        return FREE

    def _attr_axis(self, node: ast.Attribute) -> Axis:
        if node.attr in _STATIC_ATTRS:
            self._axis(node.value)
            return FREE
        if isinstance(node.value, ast.Name) and node.value.id == "self":
            return FREE  # engine config / cached fns: static host state
        base = self._axis(node.value)
        base_c = collapse(base)
        if base_c == CARRY:
            if node.attr in self.engine.carry_fields:
                return CARRY
            if node.attr in self.engine.lane_fields:
                return LANE
            if node.attr in self.engine.free_fields:
                return FREE
            return FREE
        if base_c == LANE:
            # degraded carry: field classification is lost, every leaf
            # reads as lane-leading (sound for LaneState, whose leaves
            # all are; `.at` property rides through unchanged)
            return LANE
        return FREE

    def _subscript_axis(self, node: ast.Subscript) -> Axis:
        base = self._axis(node.value)
        sl = node.slice
        # host containers index host-side: element pick / sub-container
        if is_list(base):
            self._axis(sl)
            return base if isinstance(sl, ast.Slice) else base[1]
        if is_tuple(base):
            self._axis(sl)
            if isinstance(sl, ast.Constant) and isinstance(sl.value, int) \
                    and 0 <= sl.value < len(base[1]):
                return base[1][sl.value]
            return elem_of(base)
        base_c = collapse(base)
        if base_c not in (LANE, CARRY):
            self._axis(sl)
            return base_c
        # lane-carrying base: classify the index
        if isinstance(sl, ast.Constant) and isinstance(sl.value, str):
            return base_c  # dict-of-lane-arrays access ({"map": ...})
        if isinstance(sl, ast.Name) and sl.id in self.str_names:
            return base_c  # the same, keyed by a loop over str keys
        if isinstance(sl, ast.Slice):
            self._axis(sl)
            return base_c  # leading slice keeps the lane axis
        if isinstance(sl, ast.Tuple) and sl.elts and isinstance(
            sl.elts[0], (ast.Slice, ast.Constant)
        ) and (
            isinstance(sl.elts[0], ast.Slice)
            or sl.elts[0].value is Ellipsis
        ):
            for e in sl.elts:
                self._axis(e)
            return base_c  # [:, k] / [..., None]: lane axis intact
        if isinstance(sl, ast.Constant) and sl.value is Ellipsis:
            return base_c
        # anything else — int literal, negative index, mask, array —
        # indexes ALONG the lane axis: a cross-lane gather
        self._axis(sl)
        return self._cross(
            node, "gather", "gather",
            "lane-axis indexed gather (`x[i]`/`x[mask]` drops or "
            "permutes the sharded axis)",
        )

    # -- calls ----------------------------------------------------------------

    def _call_axis(self, node: ast.Call) -> Axis:
        name = dotted_name(node.func)
        resolved = self.mi.importmap.resolve(name) if name else None
        method = node.func.attr if isinstance(node.func, ast.Attribute) else None

        # torch.vmap(f)(...): the mapped result is lane-leading; the body
        # is per-lane code — never walked here
        if isinstance(node.func, ast.Call):
            inner = dotted_name(node.func.func)
            inner_res = self.mi.importmap.resolve(inner) if inner else None
            if inner_res in ("torch.vmap", "torch.func.vmap"):
                for a in node.args:
                    self._axis(a)
                return LANE
        # call of a call we can't see (cached runners, `load()[stem]`
        # entry points): a host container of results whose elements
        # join the outer args
        if isinstance(node.func, ast.Call):
            self._axis(node.func)
            out: Axis = FREE
            for a in node.args:
                out = join(out, elem_of(self._axis(a))
                           if not isinstance(a, ast.Starred)
                           else elem_of(self._axis(a.value)))
            return ("list", collapse(out))

        # static python whatever the arguments carry
        if resolved in _STATIC_CALLS:
            for a in node.args:
                self._axis(a)
            return FREE

        # np.<ufunc>.reduce(x, axis=...) — the host-side fold idiom
        if resolved and resolved.endswith(".reduce") and resolved.split(".")[0] in (
            "np", "numpy"
        ):
            operand = self._axis(node.args[0]) if node.args else FREE
            for a in node.args[1:]:
                self._axis(a)
            for kw in node.keywords:
                self._axis(kw.value)
            if laneish(operand) and axis_hits_lane(_axis_kw(node, positional=1)):
                ufunc = resolved.split(".")[-2]
                return self._cross(
                    node, "reduce",
                    {"bitwise_or": "or", "logical_or": "or", "add": "sum"}.get(
                        ufunc, "?"
                    ),
                    f"`{resolved}` over the lane axis",
                )
            return operand

        # torch.distributed collectives: a lane operand crosses ranks
        if resolved and resolved.startswith("torch.distributed."):
            kind = _DIST_COLLECTIVES.get(resolved.rsplit(".", 1)[-1])
            axes_ = [self._axis(a) for a in node.args]
            for kw in node.keywords:
                axes_.append(self._axis(kw.value))
            if kind is not None and any(laneish(a) for a in axes_):
                return self._cross(
                    node, "gather" if kind == "gather" else "reduce", kind,
                    f"`{resolved}` of a lane-axis value across ranks",
                )
            return FREE

        # project calls: the pytree combinator applies its leaf fn;
        # everything else descends with real argument axes
        kind, target = resolve_callee(node, self.fn, self.engine.model)
        if kind == "project":
            assert isinstance(target, FunctionInfo)
            if (target.module, target.qualname) in TREE_MAPS:
                return self._tree_map_axis(node)
            args = self._map_args(node, target)
            closure = None
            if "<locals>" in target.qualname and target.module == self.fn.module:
                closure = dict(self.env)  # nested def: python closure
            return self.engine._walk(
                target, args=args, region=self.region, chain=self.chain,
                closure=closure,
            )

        # the op vocabulary, as a function (`torch.X(x, ...)`) or as a
        # method on the receiver (`x.X(...)`; a module alias's function
        # is no method)
        op, recv_node, off = None, None, 0
        if resolved:
            head, _, tail = resolved.rpartition(".")
            if (head + ".").startswith(_REDUCE_PREFIXES) and node.args:
                op, recv_node, off = tail, node.args[0], 1
        if op is None and method is not None and not (
            isinstance(node.func.value, ast.Name)
            and node.func.value.id in self.mi.importmap.names
        ):
            op, recv_node, off = method, node.func.value, 0
        if op is not None:
            handled = self._op_axis(node, op, recv_node, off)
            if handled is not None:
                return handled

        # python host sinks on lane values (S003 raw material); host
        # containers (len of a list of arrays) are plumbing, not traffic
        if resolved in _HOST_SINKS and "." not in (resolved or "."):
            args_ax = [self._axis(a) for a in node.args]
            if any(
                laneish(a) and not is_list(a) and not is_tuple(a)
                for a in args_ax
            ):
                self._host_sink(node, f"`{resolved}()` on a lane-axis value")
            return FREE
        if resolved == "zip":
            elems = []
            for a in node.args:
                ax = self._axis(a.value if isinstance(a, ast.Starred) else a)
                if laneish(ax) and not is_list(ax) and not is_tuple(ax) \
                        and collapse(ax) == LANE:
                    self._host_sink(a, "`zip()` over the lane axis")
                elems.append(elem_of(ax))
            return ("list", ("tuple", elems))

        # `dataclasses.replace(carry, ...)`: a carry rebuild site (S002)
        if resolved == "dataclasses.replace" and node.args:
            recv = self._axis(node.args[0])
            if collapse(recv) == CARRY:
                cls = self._carry_class_of(node.args[0])
                self._rebuild(node, cls or "replace", skip_first=True)
                return CARRY
            for kw in node.keywords:
                self._axis(kw.value)
            return recv

        # carry constructors (rebuild sites)
        if resolved:
            tail = resolved.split(".")[-1]
            if tail in self.engine.carry_classes:
                self._rebuild(node, tail)
                return CARRY

        # unknown methods keep the receiver's axis (a tensor method is
        # elementwise or keeps the leading axis unless the tables above
        # say otherwise); unknown functions join their arguments
        out = FREE
        if method is not None:
            out = collapse(self._axis(node.func.value))
        for a in node.args:
            out = join(out, self._axis(a))
        for kw in node.keywords:
            out = join(out, self._axis(kw.value))
        return collapse(out)

    def _op_axis(self, node: ast.Call, op: str, recv_node: ast.expr,
                 off: int) -> Optional[Axis]:
        """The axis of one vocabulary op on `recv_node` (the tensor: the
        receiver of a method, or the function form's first argument),
        its other arguments starting at positional `off`. None when `op`
        is not in the vocabulary."""
        method = off == 0

        def operand_and_rest() -> Axis:
            """The tensor's axis, the other arguments walked (their axes
            in `rest`)."""
            rest.clear()
            recv = self._axis(recv_node)
            for a in node.args[off:]:
                rest.append(self._axis(a.value if isinstance(a, ast.Starred) else a))
            for kw in node.keywords:
                rest.append(self._axis(kw.value))
            return recv

        rest: List[Axis] = []

        if op in _HOST_METHODS and method:
            operand_and_rest()
            return FREE
        if op in ("item", "tolist") and method:
            operand_and_rest()
            return FREE
        if op in _CONTAINER_METHODS and method:
            recv = operand_and_rest()
            if op == "keys":
                return ("list", FREE)
            if op == "values":
                return ("list", elem_of(recv))
            return ("list", ("tuple", [FREE, elem_of(recv)]))
        if op in _BINARY_FORM_OPS:
            dim_node = _arg(node, off, "dim")
            if dim_node is not None and _int_const(dim_node) is None \
                    and not isinstance(dim_node, (ast.Tuple, ast.List)):
                # torch.max(a, b) / x.min(y): elementwise
                out = self._axis(recv_node)
                for a in node.args[off:]:
                    out = join(out, self._axis(a))
                return collapse(out)
        if op in _REDUCE_OPS or op in _MINOR_DEFAULT_OPS or op in _FLAT_OPS:
            recv = operand_and_rest()
            if not laneish(recv):
                return FREE
            if op in _FLAT_OPS:
                dim = None
            else:
                dim = _axis_kw(node, positional=off)
                if dim is None and op in _MINOR_DEFAULT_OPS:
                    dim = -1
            if axis_hits_lane(dim):
                return self._cross(
                    node, "scan" if op in _SCAN_OPS else "reduce",
                    {"sum": "sum", "nansum": "sum", "any": "any",
                     "all": "any", "max": "max", "amax": "max",
                     "min": "min", "amin": "min", "bincount": "sum",
                     **{s: "scan" for s in _SCAN_OPS}}.get(op, "?"),
                    f"`{op}` over the lane axis",
                )
            return recv
        if op in _DIM_GATHERS:
            fn_pos, m_pos = _DIM_GATHERS[op]
            pos = m_pos if method else fn_pos
            recv = operand_and_rest()
            # no dim (`take_along_dim(x, i)`): the flattened gather
            if laneish(recv) and axis_hits_lane(_axis_kw(node, positional=pos)):
                return self._cross(
                    node, "gather", "gather",
                    f"`{op}` along the lane axis",
                )
            return collapse(join(recv, *rest))
        if op in _LANE_GATHERS:
            recv = operand_and_rest()
            if laneish(recv):
                return self._cross(
                    node, "gather", "gather",
                    f"`{op}` indexes along the lane axis",
                )
            return FREE
        if op in _DIMS_SHIFTS:
            fn_pos, m_pos = _DIMS_SHIFTS[op]
            recv = operand_and_rest()
            if laneish(recv) and axis_hits_lane(
                _axis_kw(node, positional=m_pos if method else fn_pos)
            ):
                return self._cross(
                    node, "gather", "gather",
                    f"`{op}` along the lane axis",
                )
            return recv
        if op in _SPLITS:
            fn_pos, m_pos = _SPLITS[op]
            recv = operand_and_rest()
            dim = _axis_kw(node, positional=m_pos if method else fn_pos)
            if op == "unbind" and dim is None:
                dim = 0
            if laneish(recv) and (dim is None or axis_hits_lane(dim)):
                return self._cross(
                    node, "gather", "gather",
                    f"`{op}` splits the lane axis",
                )
            return ("list", collapse(recv))
        if op in _RESHAPE_OPS:
            recv = operand_and_rest()
            if not laneish(recv):
                return FREE
            if _keeps_lane_reshape(op, node, recv_node, method):
                return recv
            return self._cross(
                node, "reshape", "?",
                f"`{op}` on a lane-axis value — the sharded axis does not "
                f"survive",
            )
        if op == "replace" and method:
            recv = self._axis(recv_node)
            if collapse(recv) == CARRY:
                # a struct's own rebuild: same S002 site as a constructor
                cls = self._carry_class_of(recv_node)
                self._rebuild(node, cls or "replace")
                return CARRY
            return None
        return None

    def _tree_map_axis(self, node: ast.Call) -> Axis:
        """`tree_map(fn, tree, *rest)`: `fn` applied to the trees' leaf
        axes (its body is walked once with them), the result shaped as
        `tree`."""
        if not node.args:
            return FREE
        trees = [
            self._axis(a.value if isinstance(a, ast.Starred) else a)
            for a in node.args[1:]
        ]
        leaf = self._apply_branch(node.args[0], [collapse(t) for t in trees])
        if trees and collapse(trees[0]) == CARRY:
            return CARRY
        return collapse(join(leaf, *trees)) if trees else FREE

    def _carry_class_of(self, node: ast.expr) -> Optional[str]:
        """Best-effort class name for a rebuild's receiver: `c` -> look
        for the nearest carry constructor assigned to that name in this
        body, or the parameter's annotation; falls back to None
        (reported as `replace`)."""
        if not isinstance(node, ast.Name):
            return None
        for n in ast.walk(self.fn.node):
            if isinstance(n, ast.Assign) and len(n.targets) == 1 and \
                    isinstance(n.targets[0], ast.Name) and \
                    n.targets[0].id == node.id and isinstance(n.value, ast.Call):
                cname = dotted_name(n.value.func)
                if cname and cname.split(".")[-1] in self.engine.carry_classes:
                    return cname.split(".")[-1]
        args = self.fn.node.args
        for p in args.posonlyargs + args.args + args.kwonlyargs:
            if p.arg == node.id and p.annotation is not None:
                ann = dotted_name(p.annotation)
                if ann and ann.split(".")[-1] in self.engine.carry_classes:
                    return ann.split(".")[-1]
        return None

    # -- combinators ----------------------------------------------------------

    def _branch_fn(self, node: ast.expr) -> Optional[FunctionInfo]:
        if isinstance(node, ast.Name) and node.id in self.fn.locals_fns:
            return self.mi.functions.get(self.fn.locals_fns[node.id])
        name = dotted_name(node)
        if name is not None:
            call = ast.Call(func=node, args=[], keywords=[])
            ast.copy_location(call, node)
            kind, target = resolve_callee(call, self.fn, self.engine.model)
            if kind == "project":
                return target  # type: ignore[return-value]
        return None

    def _apply_branch(self, branch: ast.expr, args: List[Axis]) -> Axis:
        if isinstance(branch, ast.Lambda):
            lam_env = dict(self.env)
            params = [p.arg for p in branch.args.args]
            for p, a in zip(params, args):
                lam_env[p] = a
            sub = _AxisWalk(
                self.engine, self.fn, env=lam_env, region=self.region,
                chain=self.chain, pinned={},
            )
            # lambdas have an expression body; evaluate it directly
            return sub._axis(branch.body)
        target = self._branch_fn(branch)
        if target is None:
            return join(*args) if args else FREE
        params = [p for p in target.params if p != "self"]
        mapped = {p: a for p, a in zip(params, args)}
        closure = None
        if "<locals>" in target.qualname and target.module == self.fn.module:
            closure = dict(self.env)
        return self.engine._walk(
            target, args=mapped, region=self.region, chain=self.chain,
            closure=closure,
        )

    # -- argument mapping -----------------------------------------------------

    def _map_args(self, call: ast.Call, target: FunctionInfo) -> Dict[str, Axis]:
        params = [p for p in target.params if p != "self"]
        out: Dict[str, Axis] = {}
        # positional axes, a starred tuple of known length expanded
        # element-wise (`step_megakernel(*queue, ...)`)
        axes_: List[Axis] = []
        opaque: Optional[Axis] = None
        for a in call.args:
            if isinstance(a, ast.Starred):
                ax = self._axis(a.value)
                if is_tuple(ax):
                    axes_.extend(ax[1])
                    continue
                opaque = collapse(ax)
                break
            axes_.append(self._axis(a))
        for i, ax in enumerate(axes_):
            if i < len(params):
                out[params[i]] = ax
        if opaque is not None:
            for p in params[len(axes_):]:
                out[p] = opaque
        for kw in call.keywords:
            if kw.arg is not None and kw.arg in params:
                out[kw.arg] = self._axis(kw.value)
            else:
                self._axis(kw.value)
        return out


def _module_constant(model: ProjectModel, mi: ModuleInfo, name: str) -> Optional[ast.expr]:
    """The value of a module-level `name = <expr>` in `mi`, or in the
    project module `name` is imported from."""
    for m, sym in ((mi, name), *_import_origin(model, mi, name)):
        for stmt in m.tree.body:
            if (isinstance(stmt, ast.Assign) and len(stmt.targets) == 1
                    and isinstance(stmt.targets[0], ast.Name)
                    and stmt.targets[0].id == sym):
                return stmt.value
    return None


def _str_literals(node: ast.expr, model: ProjectModel, mi: ModuleInfo, depth: int) -> bool:
    """A tuple/list of str literals, `+`-concatenations and names of
    such constants in module `mi` included."""
    if depth > 6:
        return False
    if isinstance(node, (ast.Tuple, ast.List)):
        return bool(node.elts) and all(
            isinstance(e, ast.Constant) and isinstance(e.value, str) for e in node.elts
        )
    if isinstance(node, ast.BinOp) and isinstance(node.op, ast.Add):
        return (_str_literals(node.left, model, mi, depth + 1)
                and _str_literals(node.right, model, mi, depth + 1))
    if isinstance(node, ast.Name):
        value = _module_constant(model, mi, node.id)
        return value is not None and _str_literals(value, model, mi, depth + 1)
    return False


def _import_origin(model: ProjectModel, mi: ModuleInfo, name: str):
    """[(module, symbol)] of a name imported from a project module."""
    origin = mi.importmap.names.get(name)
    if origin is None:
        return []
    split = model.split_function(resolve_dotted(origin, mi))
    if split is None or split[0] not in model.modules:
        return []
    return [(model.modules[split[0]], split[1])]


def _row_of(it) -> Axis:
    """The loop variable's axis over a host container: a table of tuples
    of one width (`for name, t, dtype in ((...), ...)`) threads column by
    column, anything else joins its elements."""
    if is_tuple(it) and it[1] and all(
        is_tuple(r) and len(r[1]) == len(it[1][0][1]) for r in it[1]
    ):
        return ("tuple", [join(*(r[1][k] for r in it[1])) for k in range(len(it[1][0][1]))])
    return elem_of(it)


def _container_guard(test: ast.expr) -> Optional[str]:
    """`x` when `test` is `isinstance(x, T)` with T among tuple, list and
    dict (or a tuple of them)."""
    if not (isinstance(test, ast.Call) and dotted_name(test.func) == "isinstance"
            and len(test.args) == 2 and isinstance(test.args[0], ast.Name)):
        return None
    kinds = test.args[1].elts if isinstance(test.args[1], ast.Tuple) else [test.args[1]]
    if kinds and all(isinstance(k, ast.Name) and k.id in ("tuple", "list", "dict") for k in kinds):
        return test.args[0].id
    return None


def make_finding(rule: str, severity: str, rel: str, line: int, col: int,
                 message: str) -> Finding:
    return Finding(
        rule=rule, severity=severity, path=rel, line=line, col=col,
        message=message,
    )
