"""Fleet control-plane host-purity lint (DESIGN.md §fleet, §analysis) —
the port of ``repro.analysis.rules_fleet``.

The fleet's routing decision runs once per scheduling round on the
serving hot path, and its three control modules — ``fleet/router.py``,
``fleet/membership.py``, ``fleet/health.py`` — are pure host
bookkeeping: generators and wall times arrive as opaque objects and
plain floats, and any array arithmetic is delegated to
``runtime.straggler``. The ``fleet-host-pure`` rule statically rejects
the whole category of regressions:

* importing ``torch``/``numpy`` (or ``jax``) in a control module — the
  day someone "just inspects" a request's generator or batches scores
  through numpy, placement acquires a device dependency and, worse, a
  possible per-round host sync;
* calling ``torch.*``/``np.*``, or a method that reads a device value
  back (``.item()``, ``.cpu()``, ``.tolist()``, ``.numpy()``, and the
  reference's ``device_get``/``block_until_ready``) there — the sync
  itself.

The data-plane modules (``replica.py``, ``fleet.py``, ``warmup.py``)
legitimately touch torch.
"""
from __future__ import annotations

import ast
from typing import List

from repro_torch.analysis.engine import Finding

#: the control-plane modules under the host-purity contract
HOST_PURE_FILES = ("fleet/router.py", "fleet/membership.py",
                   "fleet/health.py")

BANNED_IMPORT_ROOTS = ("torch", "numpy", "np", "jax", "jaxlib")

#: call roots of a device library, and the calls that read a device
#: value back to the host
DEVICE_ROOTS = ("torch", "np", "numpy", "jnp", "jax")
SYNC_CALLS = ("device_get", "block_until_ready", "synchronize")
SYNC_METHODS = ("item", "cpu", "tolist", "numpy")


def _dotted(func: ast.AST) -> List[str]:
    parts: List[str] = []
    while isinstance(func, ast.Attribute):
        parts.append(func.attr)
        func = func.value
    if isinstance(func, ast.Name):
        parts.append(func.id)
    return parts[::-1]


class FleetHostPureRule:
    """Per-file source rule over the fleet control plane."""

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
                        "fleet-host-pure", "error", path, node.lineno,
                        f"fleet control plane imports `{mod}` — "
                        f"routing/membership/health are pure host "
                        f"bookkeeping on the per-round hot path; device "
                        f"libraries are banned here", "<module>"))
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
                        "fleet-host-pure", "error", path, node.lineno,
                        f"`{'.'.join(parts) or 'item'}` in a fleet "
                        f"control module — placement must stay pure "
                        f"host bookkeeping (no device values, no "
                        f"syncs); delegate array math to "
                        f"runtime.straggler", sym))
                self.generic_visit(node)

        V().visit(tree)
        return findings
