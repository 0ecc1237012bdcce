"""Resilience lint rules (DESIGN.md §resilience, §analysis) — the port of
``repro.analysis.rules_resilience``.

Two statically-provable contracts keep the fault-injection layer from
regressing the serving invariants it exists to test:

* ``resilience-host-pure`` — ``resilience/faults.py`` (the scripted
  injector: event heap, windows, seeded RNG) and
  ``resilience/journal.py`` (the write-ahead request journal) are pure
  host bookkeeping. They run inside the fleet tick and the engine pack
  loop; the day one of them imports torch/numpy or syncs a device value,
  a *disarmed* run stops being free and the byte-identical-transparency
  guarantee silently erodes. Same shape as ``fleet-host-pure``.

* ``resilience-armed-guard`` — every call on an injection seam
  attribute (``self._faults`` / ``self.faults`` in the engine and
  replica, ``self._injector`` in the fleet) must be lexically guarded
  by an ``is not None`` test on that same attribute. The seams sit on
  the hot pack/dispatch/tick paths; an unguarded call is either an
  ``AttributeError`` on every disarmed run or — worse — a fault seam
  that quietly activates without a plan. Accepted guard shapes::

      if self._faults is not None:
          self._faults.take_poison(...)          # guarded body

      if self._faults is not None and self._faults.take_poison(...):
          ...                                    # short-circuit And

      inj = self._injector
      if inj is None:
          return                                 # early return: the
      inj.due(now)                               # local alias is armed

  (Calls through a local alias after an early-return guard are not
  self-prefixed and therefore never flagged; the rule polices the
  direct-attribute form only — the alias pattern is the documented
  alternative for long armed-only helpers.)
"""
from __future__ import annotations

import ast
from typing import List, Set

from repro_torch.analysis.engine import Finding
from repro_torch.analysis.rules_fleet import (BANNED_IMPORT_ROOTS, DEVICE_ROOTS,
                                             SYNC_CALLS, SYNC_METHODS)

#: host-pure resilience modules (suffix match, like ``fleet-host-pure``)
HOST_PURE_FILES = ("resilience/faults.py", "resilience/journal.py")

#: files whose injection seams must be armed-guarded
ARMED_FILES = ("serving/scheduler.py", "fleet/fleet.py",
               "fleet/replica.py")

#: the seam attributes (``self.<attr>.<method>(...)``)
SEAM_ATTRS = ("_faults", "_injector", "faults")


def _dotted(func: ast.AST) -> List[str]:
    parts: List[str] = []
    while isinstance(func, ast.Attribute):
        parts.append(func.attr)
        func = func.value
    if isinstance(func, ast.Name):
        parts.append(func.id)
    return parts[::-1]


class ResilienceHostPureRule:
    """faults.py / journal.py: no device libraries, no syncs."""

    def check(self, path: str, tree: ast.AST, text: str) -> List[Finding]:
        posix = path.replace("\\", "/")
        if not any(posix.endswith(f) for f in HOST_PURE_FILES):
            return []
        findings: List[Finding] = []
        for node in ast.walk(tree):
            mods = []
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                mods = [node.module]
            for mod in mods:
                if mod.split(".")[0] in BANNED_IMPORT_ROOTS:
                    findings.append(Finding(
                        "resilience-host-pure", "error", path, node.lineno,
                        f"resilience host module imports `{mod}` — the "
                        f"injector and journal run inside the fleet tick "
                        f"and pack loop; device libraries here make even "
                        f"*disarmed* runs pay for the harness", "<module>"))
        stack: List[str] = []

        class V(ast.NodeVisitor):
            def visit_FunctionDef(self, node):
                stack.append(node.name)
                self.generic_visit(node)
                stack.pop()

            visit_AsyncFunctionDef = visit_FunctionDef

            def visit_Call(self, node):
                parts = _dotted(node.func)
                name = parts[-1] if parts else ""
                sym = stack[-1] if stack else "<module>"
                is_dev = len(parts) >= 2 and parts[0] in DEVICE_ROOTS
                is_sync = name in SYNC_CALLS
                is_item = (isinstance(node.func, ast.Attribute)
                           and node.func.attr in SYNC_METHODS)
                if is_dev or is_sync or is_item:
                    findings.append(Finding(
                        "resilience-host-pure", "error", path, node.lineno,
                        f"`{'.'.join(parts) or 'item'}` in a resilience "
                        f"host module — fault scheduling and journaling "
                        f"must stay pure host bookkeeping (no device "
                        f"values, no syncs)", sym))
                self.generic_visit(node)

        V().visit(tree)
        return findings


def _not_none_attrs(test: ast.AST) -> Set[str]:
    """Seam attrs proven armed by ``test`` (``self.X is not None``,
    possibly inside an ``and`` chain)."""
    out: Set[str] = set()
    if isinstance(test, ast.BoolOp) and isinstance(test.op, ast.And):
        for v in test.values:
            out |= _not_none_attrs(v)
    elif (isinstance(test, ast.Compare) and len(test.ops) == 1
          and isinstance(test.ops[0], ast.IsNot)
          and isinstance(test.comparators[0], ast.Constant)
          and test.comparators[0].value is None
          and isinstance(test.left, ast.Attribute)
          and isinstance(test.left.value, ast.Name)
          and test.left.value.id == "self"
          and test.left.attr in SEAM_ATTRS):
        out.add(test.left.attr)
    return out


def _is_none_attrs(test: ast.AST) -> Set[str]:
    """Seam attrs proven *disarmed* by a simple ``self.X is None``."""
    if (isinstance(test, ast.Compare) and len(test.ops) == 1
            and isinstance(test.ops[0], ast.Is)
            and isinstance(test.comparators[0], ast.Constant)
            and test.comparators[0].value is None
            and isinstance(test.left, ast.Attribute)
            and isinstance(test.left.value, ast.Name)
            and test.left.value.id == "self"
            and test.left.attr in SEAM_ATTRS):
        return {test.left.attr}
    return set()


class ResilienceArmedGuardRule:
    """Every ``self.<seam>.*()`` call sits under an armed guard."""

    def check(self, path: str, tree: ast.AST, text: str) -> List[Finding]:
        posix = path.replace("\\", "/")
        if not any(posix.endswith(f) for f in ARMED_FILES):
            return []
        findings: List[Finding] = []
        stack: List[str] = []

        def check_expr(expr: ast.AST, armed: Set[str]) -> None:
            if expr is None:
                return
            if isinstance(expr, ast.BoolOp) and isinstance(expr.op,
                                                           ast.And):
                cur = set(armed)
                for v in expr.values:
                    check_expr(v, cur)
                    cur |= _not_none_attrs(v)
                return
            for node in ast.walk(expr):
                if not isinstance(node, ast.Call):
                    continue
                parts = _dotted(node.func)
                if (len(parts) >= 3 and parts[0] == "self"
                        and parts[1] in SEAM_ATTRS
                        and parts[1] not in armed):
                    sym = stack[-1] if stack else "<module>"
                    findings.append(Finding(
                        "resilience-armed-guard", "error", path,
                        node.lineno,
                        f"`{'.'.join(parts)}(...)` outside an "
                        f"`is not None` guard on `self.{parts[1]}` — "
                        f"injection seams are Optional and sit on the "
                        f"hot path; an unguarded call breaks every "
                        f"disarmed run", sym))

        def scan(stmts, armed: Set[str]) -> None:
            armed = set(armed)
            for st in stmts:
                if isinstance(st, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    stack.append(st.name)
                    scan(st.body, set())
                    stack.pop()
                elif isinstance(st, ast.ClassDef):
                    scan(st.body, set())
                elif isinstance(st, ast.If):
                    check_expr(st.test, armed)
                    scan(st.body, armed | _not_none_attrs(st.test))
                    scan(st.orelse, armed)
                    # `if self.X is None: return` arms the rest
                    if (_is_none_attrs(st.test) and not st.orelse
                            and st.body
                            and isinstance(st.body[-1],
                                           (ast.Return, ast.Raise,
                                            ast.Continue))):
                        armed |= _is_none_attrs(st.test)
                elif isinstance(st, (ast.For, ast.AsyncFor)):
                    check_expr(st.iter, armed)
                    scan(st.body, armed)
                    scan(st.orelse, armed)
                elif isinstance(st, ast.While):
                    check_expr(st.test, armed)
                    scan(st.body, armed)
                    scan(st.orelse, armed)
                elif isinstance(st, (ast.With, ast.AsyncWith)):
                    for item in st.items:
                        check_expr(item.context_expr, armed)
                    scan(st.body, armed)
                elif isinstance(st, ast.Try):
                    scan(st.body, armed)
                    for h in st.handlers:
                        scan(h.body, armed)
                    scan(st.orelse, armed)
                    scan(st.finalbody, armed)
                else:
                    check_expr(st, armed)

        scan(tree.body, set())
        return findings
