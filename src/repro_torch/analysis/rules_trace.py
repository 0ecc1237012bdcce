"""Capture-safety lint rule of the port, the counterpart of
``repro.analysis.rules_trace`` (DESIGN.md §analysis).

A CUDA graph replays the kernels a runner launched while it was
captured, and nothing of its Python: a host read, a branch on a device
value or a host copy inside a captured region either fails the capture
or is frozen into the graph. Two steps, as in the reference:

1. **Region finding** — which function defs are *captured regions*? A
   def is captured when it is

   * passed by name (or as a lambda) as the body of
     ``runtime.graphs.capture`` (its ``host=`` function runs outside),
   * returned from a ``make_*``/``build_*`` factory or a ``*_runner``
     method (``make_eps_fn``, ``make_packed_step_fn``,
     ``FlexiPipeline._static_runner``: their callers capture the
     result),
   * marked ``# repro: traced`` on its ``def`` line (functions only ever
     called from inside a capture: ``dit_forward`` and friends), or
   * nested inside a captured region.

2. **Taint tracking** — inside a region every parameter (except
   ``self``/``cls``/``cfg``/``config``/``parallel``/``mesh`` and those
   annotated as host containers or scalars) and every value derived from
   one, or from any ``torch.``/``F.`` call, is a *device value*.
   Shape-space attributes (``.shape``/``.ndim``/``.dtype``/
   ``.device``/``.size``) escape the taint. The rule flags
   ``int()``/``float()``/``bool()``/``.item()``/``.cpu()``/``.tolist()``/
   ``.numpy()`` of a device value (``trace-host-cast``: a sync, which
   fails a capture), a host copy (``torch.from_numpy(...).to(...)``,
   ``torch.as_tensor``/``torch.tensor`` with a ``device=``:
   ``trace-host-copy``, a pageable copy that syncs), ``if``/``while`` on
   a *derived* device value (``trace-python-branch``; a bare parameter is
   the static-flag idiom and stays legal), ``for`` over a device value
   (``trace-python-loop``), ``len()`` (``trace-len``, a warning),
   f-strings of device values (``trace-fstring``), and host ``np.``
   calls on device values (``trace-host-np``).

Outside regions the ``hot-host-sync`` rule applies: a
``float()``/``int()``/``bool()``/``.item()``/``.cpu()``/``.tolist()`` of
a ``torch.``-derived value inside a ``for``/``while`` loop is one
blocking device-to-host read per iteration.

Heuristics err toward silence (bare-parameter branches, shape
attributes, ``is None`` checks are exempt); what they still over-flag is
handled by ``# repro: ignore[rule]`` with a justification or by the
baseline.
"""
from __future__ import annotations

import ast
import re
from typing import Dict, List, Optional, Set, Tuple

from repro_torch.analysis.engine import Finding

#: `def f(...):  # repro: traced` force-marks a def as a captured region —
#: for functions only ever CALLED from inside a capture (dit_forward and
#: friends), which no file-local heuristic can see.
_TRACED_MARK = re.compile(r"#\s*repro:\s*traced\b")

#: calls whose FIRST positional argument is a captured body
TRACING_CALLS = {"capture", "Captured"}
STATIC_PARAM_NAMES = {"self", "cls", "cfg", "config", "parallel", "mesh"}

#: annotation outer types that make a parameter a *host container* — the
#: repo passes phase lists / group tuples / per-group tensor lists as
#: Python structures that stay static inside a capture (lengths, indices
#: and iteration over them are host work even though elements may be
#: tensors)
CONTAINER_ANNS = ("Sequence", "List", "Tuple", "Dict", "Mapping",
                  "Iterable", "tuple", "list", "dict")
SHAPE_ATTRS = {"shape", "ndim", "dtype", "size", "device", "is_cuda"}
ARRAY_MODULES = {"torch", "F"}
HOST_NP_NAMES = {"np", "numpy", "onp"}
FACTORY_PREFIXES = ("make_", "build_")
#: methods that read a device value to the host
HOST_READS = {"item", "cpu", "tolist", "numpy"}


def _call_name(func: ast.AST) -> str:
    """Last dotted component of a call target ('graphs.capture' ->
    'capture')."""
    while isinstance(func, ast.Attribute):
        if isinstance(func.value, ast.Call):   # f(...)(g): the outer call
            break
        return func.attr
    if isinstance(func, ast.Name):
        return func.id
    return ""


def _root_name(node: ast.AST) -> str:
    while isinstance(node, (ast.Attribute, ast.Subscript)):
        node = node.value
    return node.id if isinstance(node, ast.Name) else ""


class _RegionFinder(ast.NodeVisitor):
    """Collect function defs and decide which are traced regions."""

    def __init__(self):
        self.defs: List[Tuple[ast.AST, Optional[ast.AST]]] = []
        self.traced_names: Set[str] = set()
        self._stack: List[ast.AST] = []

    def _visit_def(self, node):
        self.defs.append((node, self._stack[-1] if self._stack else None))
        self._stack.append(node)
        self.generic_visit(node)
        self._stack.pop()

    visit_FunctionDef = _visit_def
    visit_AsyncFunctionDef = _visit_def
    visit_Lambda = _visit_def

    def visit_Call(self, node: ast.Call):
        if _call_name(node.func) in TRACING_CALLS and node.args:
            # the body; a ``host=`` function runs outside the capture
            arg = node.args[0]
            if isinstance(arg, ast.Name):
                self.traced_names.add(arg.id)
            elif isinstance(arg, ast.Lambda):
                arg._repro_traced = True           # mark the lambda itself
        self.generic_visit(node)

    def visit_Return(self, node: ast.Return):
        # `return step` inside make_*/build_* factories: `step` is traced
        if isinstance(node.value, ast.Name) and self._stack:
            fn = self._stack[-1]
            name = getattr(fn, "name", "")
            if name.startswith(FACTORY_PREFIXES) or name.endswith("_runner"):
                self.traced_names.add(node.value.id)
        self.generic_visit(node)


def find_traced_regions(tree: ast.AST,
                        marked_lines: Optional[Set[int]] = None
                        ) -> List[ast.AST]:
    """All function/lambda nodes whose bodies a CUDA graph captures.
    ``marked_lines``: line numbers carrying a ``# repro: traced`` mark."""
    marked_lines = marked_lines or set()
    finder = _RegionFinder()
    finder.visit(tree)
    traced: Set[int] = set()
    by_node = {id(n): (n, parent) for n, parent in finder.defs}

    def _touches_torch(node) -> bool:
        for sub in ast.walk(node):
            if isinstance(sub, ast.Name) and sub.id in ARRAY_MODULES:
                return True
        return False

    def is_traced(node) -> bool:
        if id(node) in traced:
            return True
        if getattr(node, "_repro_traced", False):
            return True
        if getattr(node, "lineno", -1) in marked_lines:
            return True
        name = getattr(node, "name", None)
        if name is not None and name in finder.traced_names:
            # name-based evidence (factory returns, capture args) is weak —
            # require the body to actually touch torch, so host-side
            # factories (data loaders etc.) stay out of scope
            return _touches_torch(node)
        return False

    # propagate: nested defs inside traced regions are traced
    changed = True
    while changed:
        changed = False
        for node, parent in finder.defs:
            if id(node) in traced:
                continue
            if is_traced(node) or (parent is not None
                                   and id(parent) in traced):
                traced.add(id(node))
                changed = True
    return [by_node[i][0] for i in traced]


# ---------------------------------------------------------------------------
# Taint analysis inside one region

class _Taint:
    """Set-of-names taint with derived-expression queries."""

    def __init__(self, tainted: Set[str]):
        self.names = set(tainted)

    def expr(self, node: ast.AST) -> bool:
        """Is this expression's VALUE traced?"""
        if isinstance(node, ast.Name):
            return node.id in self.names
        if isinstance(node, ast.Attribute):
            if node.attr in SHAPE_ATTRS:
                return False
            return self.expr(node.value)
        if isinstance(node, ast.Subscript):
            return self.expr(node.value)
        if isinstance(node, (ast.Tuple, ast.List)):
            return any(self.expr(e) for e in node.elts)
        if isinstance(node, ast.Starred):
            return self.expr(node.value)
        if isinstance(node, ast.BinOp):
            return self.expr(node.left) or self.expr(node.right)
        if isinstance(node, ast.UnaryOp):
            return self.expr(node.operand)
        if isinstance(node, ast.BoolOp):
            return any(self.expr(v) for v in node.values)
        if isinstance(node, ast.IfExp):
            return (self.expr(node.body) or self.expr(node.orelse)
                    or self.expr(node.test))
        if isinstance(node, ast.Compare):
            # `x is None` / isinstance-style structure checks are host-legal
            if all(isinstance(op, (ast.Is, ast.IsNot)) for op in node.ops):
                return False
            return (self.expr(node.left)
                    or any(self.expr(c) for c in node.comparators))
        if isinstance(node, ast.Call):
            name = _call_name(node.func)
            root = _root_name(node.func)
            if name in ("len", "isinstance", "hasattr", "getattr", "range",
                        "enumerate", "zip", "sorted", "type", "id", "print"):
                return False
            if name in ("int", "float", "bool"):
                return False              # result is host (flagged elsewhere)
            if root in ARRAY_MODULES:
                return True               # torch. results are device values
            if isinstance(node.func, ast.Attribute) \
                    and self.expr(node.func.value):
                return True               # method of a device value
            return any(self.expr(a) for a in node.args) \
                or any(self.expr(kw.value) for kw in node.keywords)
        if isinstance(node, (ast.GeneratorExp, ast.ListComp, ast.SetComp)):
            return any(self.expr(g.iter) for g in node.generators) \
                or self.expr(getattr(node, "elt", node))
        if isinstance(node, ast.JoinedStr):
            return any(self.expr(v.value) for v in node.values
                       if isinstance(v, ast.FormattedValue))
        return False

    def assign(self, target: ast.AST, tainted: bool) -> None:
        if isinstance(target, ast.Name):
            (self.names.add if tainted else self.names.discard)(target.id)
        elif isinstance(target, (ast.Tuple, ast.List)):
            for e in target.elts:
                self.assign(e, tainted)
        elif isinstance(target, ast.Starred):
            self.assign(target.value, tainted)


def _ann_is_static(ann: Optional[ast.AST]) -> bool:
    """Annotation says this parameter is host-side data: a container
    (Sequence/Tuple/... — element arrays are traced, but the container
    itself, its length and indices are static) or a non-Array scalar /
    config type. No annotation, ``Any``, or a Tensor-bearing non-container
    annotation keeps the parameter tainted."""
    if ann is None:
        return False
    text = ast.unparse(ann)
    while text.startswith("Optional["):
        text = text[len("Optional["):-1]
    if text.split("[", 1)[0].split(".")[-1] in CONTAINER_ANNS:
        return True
    return "Tensor" not in text and "Any" not in text


def _params(fn: ast.AST, tainted_only: bool = False) -> List[str]:
    a = fn.args
    pairs = [(p.arg, getattr(p, "annotation", None))
             for p in a.posonlyargs + a.args + a.kwonlyargs]
    if a.vararg:
        pairs.append((a.vararg.arg, getattr(a.vararg, "annotation", None)))
    if a.kwarg:
        pairs.append((a.kwarg.arg, getattr(a.kwarg, "annotation", None)))
    if tainted_only:
        return [n for n, ann in pairs if not _ann_is_static(ann)]
    return [n for n, _ in pairs]


class _RegionChecker(ast.NodeVisitor):
    """Flag trace-safety violations inside ONE traced region (does not
    descend into nested defs — they are checked as their own regions)."""

    def __init__(self, path: str, symbol: str, region: ast.AST,
                 hot_loops: bool = False, taint: Optional[_Taint] = None):
        self.path = path
        self.symbol = symbol
        self.region = region
        self.hot = hot_loops        # hot-host-sync mode (host code in loops)
        self.loop_depth = 0
        self.findings: List[Finding] = []
        if taint is not None:
            self.taint = taint
        elif hot_loops:
            self.taint = _Taint(set())   # only torch-derived values taint
        else:
            self.taint = _Taint(
                {p for p in _params(region, tainted_only=True)
                 if p not in STATIC_PARAM_NAMES}
                if isinstance(region, (ast.FunctionDef,
                                       ast.AsyncFunctionDef, ast.Lambda))
                else set())

    def _emit(self, rule: str, severity: str, node: ast.AST, msg: str):
        self.findings.append(Finding(rule, severity, self.path,
                                     getattr(node, "lineno", 0), msg,
                                     self.symbol))

    def run(self) -> List[Finding]:
        body = self.region.body
        if isinstance(body, ast.AST):          # lambda
            body = [ast.Expr(value=body)]
        # two passes so taint assigned late in a loop body is seen by
        # earlier statements on the second sweep
        for _ in range(2):
            self.findings = []
            self.loop_depth = 0
            for stmt in body:
                self.visit(stmt)
        return self.findings

    # -- statements -------------------------------------------------------

    def visit_FunctionDef(self, node):   # nested defs: own region
        return

    visit_AsyncFunctionDef = visit_FunctionDef

    def visit_Lambda(self, node):
        return

    def visit_Assign(self, node: ast.Assign):
        self.visit(node.value)
        t = self.taint.expr(node.value)
        for target in node.targets:
            self.taint.assign(target, t)

    def visit_AugAssign(self, node: ast.AugAssign):
        self.visit(node.value)
        if self.taint.expr(node.value):
            self.taint.assign(node.target, True)

    def visit_AnnAssign(self, node: ast.AnnAssign):
        if node.value is not None:
            self.visit(node.value)
            self.taint.assign(node.target, self.taint.expr(node.value))

    def visit_For(self, node: ast.For):
        if not self.hot and self.taint.expr(node.iter):
            self._emit("trace-python-loop", "warning", node,
                       "for-loop over a device value inside a captured "
                       "region iterates on the host (a read per element)")
            self.taint.assign(node.target, True)
        self.visit(node.iter)
        self.loop_depth += 1
        for stmt in node.body + node.orelse:
            self.visit(stmt)
        self.loop_depth -= 1

    def visit_While(self, node: ast.While):
        self._check_branch(node, "while")
        self.visit(node.test)
        self.loop_depth += 1
        for stmt in node.body + node.orelse:
            self.visit(stmt)
        self.loop_depth -= 1

    def visit_If(self, node: ast.If):
        self._check_branch(node, "if")
        self.visit(node.test)
        for stmt in node.body + node.orelse:
            self.visit(stmt)

    def _check_branch(self, node, kw: str):
        if self.hot:
            return
        test = node.test
        # bare-parameter flags (`if guided:` / `if not cached:`) are the
        # standard static-switch idiom — only DERIVED traced tests leak
        bare = isinstance(test, ast.Name) or (
            isinstance(test, ast.UnaryOp) and isinstance(test.op, ast.Not)
            and isinstance(test.operand, ast.Name))
        if not bare and self.taint.expr(test):
            self._emit("trace-python-branch", "error", node,
                       f"Python `{kw}` on a device value inside a captured "
                       f"region (a host read, frozen at capture); use "
                       f"torch.where, or decide it in the runner's host "
                       f"function")

    # -- expressions ------------------------------------------------------

    def visit_Call(self, node: ast.Call):
        name = _call_name(node.func)
        root = _root_name(node.func)
        arg_tainted = (any(self.taint.expr(a) for a in node.args)
                       or any(self.taint.expr(kw.value)
                              for kw in node.keywords))
        if name in ("int", "float", "bool") and node.args and arg_tainted:
            self._flag_sync(node, f"{name}() reads a device value")
        elif isinstance(node.func, ast.Attribute) \
                and node.func.attr in HOST_READS \
                and self.taint.expr(node.func.value):
            self._flag_sync(node, f".{node.func.attr}() reads a device "
                                  f"value")
        elif not self.hot and _is_host_copy(node):
            self._emit("trace-host-copy", "error", node,
                       f"host-to-device copy `{ast.unparse(node)[:60]}` "
                       f"inside a captured region (a pageable copy syncs, "
                       f"which fails the capture); build the tensor once "
                       f"outside or pass it in")
        elif not self.hot and name == "len" and node.args \
                and self.taint.expr(node.args[0]):
            self._emit("trace-len", "warning", node,
                       "len() of a device value (use .shape[0])")
        elif not self.hot and root in HOST_NP_NAMES and arg_tainted:
            self._emit("trace-host-np", "error", node,
                       f"host numpy call `{ast.unparse(node.func)}` on "
                       f"device values inside a captured region")
        self.generic_visit(node)

    def _flag_sync(self, node, what: str):
        if self.hot:
            if self.loop_depth > 0:
                self._emit("hot-host-sync", "error", node,
                           f"{what} inside a host loop — one blocking "
                           f"device->host transfer per iteration; batch "
                           f"or hoist it")
        else:
            self._emit("trace-host-cast", "error", node,
                       f"{what} inside a captured region (a sync: the "
                       f"capture fails)")

    def visit_JoinedStr(self, node: ast.JoinedStr):
        if not self.hot and self.taint.expr(node):
            self._emit("trace-fstring", "error", node,
                       "f-string formats a device value inside a captured "
                       "region (a host read)")
        self.generic_visit(node)


def _is_host_copy(node: ast.Call) -> bool:
    """``torch.from_numpy(...).to(...)`` / ``.cuda()``, or
    ``torch.as_tensor`` / ``torch.tensor`` given a ``device=``."""
    if isinstance(node.func, ast.Attribute) \
            and node.func.attr in ("to", "cuda"):
        inner = node.func.value
        return isinstance(inner, ast.Call) \
            and _call_name(inner.func) == "from_numpy"
    name = _call_name(node.func)
    if name in ("as_tensor", "tensor") \
            and _root_name(node.func) in ARRAY_MODULES:
        return any(kw.arg == "device" for kw in node.keywords)
    return False


# ---------------------------------------------------------------------------
# The rule object

class TraceSafetyRule:
    """Source rule: capture safety + hot-loop host syncs for one file."""

    name = "trace-safety"

    def check(self, path: str, tree: ast.AST, text: str) -> List[Finding]:
        findings: List[Finding] = []
        marked = {i for i, line in enumerate(text.splitlines(), start=1)
                  if _TRACED_MARK.search(line)}
        regions = find_traced_regions(tree, marked)
        region_ids = {id(r) for r in regions}
        for region in regions:
            symbol = getattr(region, "name", "<lambda>")
            findings.extend(_RegionChecker(path, symbol, region).run())
        # hot-host-sync over every NON-traced function body
        for node in ast.walk(tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                    and id(node) not in region_ids:
                findings.extend(
                    _RegionChecker(path, node.name, node,
                                   hot_loops=True).run())
        return findings
