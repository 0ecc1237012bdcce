"""Telemetry data-only lint rules (DESIGN.md §telemetry, §analysis) —
the port of ``repro.analysis.rules_telemetry``.

The telemetry layer's contract is **observability must be data, not
structure**: taps ride along as extra outputs of already-built packed
steps, and the host sees their values only at the aggregate/export sink.
Three rules keep that contract honest as the code grows:

* ``telemetry-host-callback`` — telemetry source must never call a host
  callback (the reference's ``jax.debug.print``/``debug.callback``,
  ``pure_callback``, ``io_callback``, ``host_callback``): a callback in
  a tap helper would run on every tapped step.
* ``telemetry-tap-host-sync`` — in ``telemetry/taps.py``, host
  materialization of tap values (``np.*`` calls, ``.item()``,
  ``.cpu()``, ``.tolist()``, ``.numpy()``, a device sync) is legal ONLY
  inside the declared export-time sinks (``TapAggregator.aggregate`` /
  ``counter_series``). Anywhere else — the tap helpers, ``TapSample``
  construction, ``TapAggregator.add`` — it would block the dispatch path
  on the device.
* ``telemetry-attribution-device`` — ``telemetry/attribution.py`` runs
  per dispatch on the serving hot path and is pure host integer
  arithmetic (DESIGN.md §profiling): importing torch or numpy, or
  calling any device-sync primitive there, would let an innocent edit
  add a hidden per-dispatch host sync. The rule statically rejects the
  whole category.

All are scoped to ``src/repro_torch/telemetry/``.
"""
from __future__ import annotations

import ast
from typing import List

from repro_torch.analysis.engine import Finding
from repro_torch.analysis.rules_fleet import (BANNED_IMPORT_ROOTS, DEVICE_ROOTS,
                                             SYNC_CALLS, SYNC_METHODS)

#: call names (last dotted component) that reach back into Python from
#: compiled code
CALLBACK_NAMES = {"pure_callback", "io_callback", "host_callback",
                  "debug_callback", "call_tpu", "id_tap", "id_print"}

#: host materialization of a (possibly device) value
HOST_SYNC_CALLS = {"asarray", "array", "concatenate", "percentile",
                   "device_get", "block_until_ready"}
HOST_CASTS = {"float", "int", "bool"}

#: the only functions allowed to pull tap values to the host
TAP_SINKS = ("aggregate", "counter_series")


def _dotted(func: ast.AST) -> List[str]:
    parts: List[str] = []
    while isinstance(func, ast.Attribute):
        parts.append(func.attr)
        func = func.value
    if isinstance(func, ast.Name):
        parts.append(func.id)
    return parts[::-1]


class TelemetryRule:
    """Per-file source rule over ``src/repro/telemetry/``."""

    def check(self, path: str, tree: ast.AST, text: str) -> List[Finding]:
        if "repro_torch/telemetry/" not in path.replace("\\", "/"):
            return []
        findings: List[Finding] = []
        is_taps = path.endswith("taps.py")
        is_attr = path.endswith("attribution.py")
        if is_attr:
            for node in ast.walk(tree):
                mods = []
                if isinstance(node, ast.Import):
                    mods = [a.name for a in node.names]
                elif isinstance(node, ast.ImportFrom) and node.module:
                    mods = [node.module]
                for mod in mods:
                    root = mod.split(".")[0]
                    if root in BANNED_IMPORT_ROOTS:
                        findings.append(Finding(
                            "telemetry-attribution-device", "error", path,
                            node.lineno,
                            f"attribution.py imports `{mod}` — per-request "
                            f"attribution is pure host integer arithmetic "
                            f"on the dispatch hot path; device libraries "
                            f"are banned here", "<module>"))
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
                if name in CALLBACK_NAMES or \
                        (len(parts) >= 2 and parts[-2] == "debug"
                         and name in ("print", "callback")):
                    findings.append(Finding(
                        "telemetry-host-callback", "error", path,
                        node.lineno,
                        f"telemetry code calls `{'.'.join(parts)}` — a "
                        f"host callback would run on every tapped step "
                        f"(taps must be data, not structure)", sym))
                elif is_attr:
                    is_np = len(parts) >= 2 and parts[0] in DEVICE_ROOTS
                    is_sync = name in SYNC_CALLS
                    is_item = (isinstance(node.func, ast.Attribute)
                               and node.func.attr in SYNC_METHODS)
                    if is_np or is_sync or is_item:
                        findings.append(Finding(
                            "telemetry-attribution-device", "error", path,
                            node.lineno,
                            f"`{'.'.join(parts) or 'item'}` in "
                            f"attribution.py — attribution must stay pure "
                            f"host integer arithmetic (no device values, "
                            f"no syncs) on the dispatch hot path", sym))
                elif is_taps and not any(f in TAP_SINKS for f in stack):
                    is_np = (len(parts) >= 2
                             and parts[0] in ("np", "numpy")
                             and name in HOST_SYNC_CALLS)
                    is_sync = name in SYNC_CALLS
                    is_item = (isinstance(node.func, ast.Attribute)
                               and node.func.attr in SYNC_METHODS)
                    if is_np or is_sync or is_item:
                        findings.append(Finding(
                            "telemetry-tap-host-sync", "error", path,
                            node.lineno,
                            f"`{'.'.join(parts) or 'item'}` materializes "
                            f"tap values outside the "
                            f"TapAggregator sinks {TAP_SINKS} — the "
                            f"dispatch path must never block on a tap",
                            sym))
                self.generic_visit(node)

        V().visit(tree)
        return findings
