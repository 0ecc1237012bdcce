"""Mask-parity lint rule (DESIGN.md §analysis) — the port of
``repro.analysis.rules_mask``.

``kernels/attention/mask.py`` is the single owner of segment / window /
causal admissibility — the flash kernel's wrapper (its tile map) and
plain version, the dense path, the blocked long-sequence path, the DiT's
attention and the distributed ring/Ulysses loops all import it, so
backends cannot drift apart on who attends to whom. This rule keeps that
true statically:

* no module outside the canonical one may DEFINE a function with one of
  the canonical mask names;
* no module outside the canonical one may contain the segment-
  admissibility idiom — an ``==``/``!=`` comparison whose both sides
  name segment ids (``q_seg == k_seg``-shaped code) — reimplementing
  the mask inline;
* every attention backend module MUST import the mask module (losing
  the import means the backend grew its own mask logic or dropped
  masking entirely).
"""
from __future__ import annotations

import ast
from typing import Dict, List, Tuple

from repro_torch.analysis.engine import Finding

CANONICAL = "src/repro_torch/kernels/attention/mask.py"

CANONICAL_FNS = {
    "segment_allowed", "position_allowed", "position_allowed_grid",
    "attention_block_map", "block_position_envelope",
}

#: backend modules that must import the shared mask algebra
REQUIRED_IMPORTERS = (
    "src/repro_torch/models/attention.py",          # dense + blocked paths
    "src/repro_torch/models/dit.py",                # DiT dense _mha
    "src/repro_torch/kernels/attention/ops.py",     # the kernel's tile map
    "src/repro_torch/kernels/attention/ref.py",     # its plain version
    "src/repro_torch/distributed/attention.py",     # ring / Ulysses loops
)

_MASK_IMPORT_SUFFIXES = ("kernels.attention.mask", "attention.mask")


def _names_seg(node: ast.AST) -> bool:
    """Does this operand name a segment-id value (identifier containing
    'seg')?"""
    for sub in ast.walk(node):
        if isinstance(sub, ast.Name) and "seg" in sub.id.lower():
            return True
        if isinstance(sub, ast.Attribute) and "seg" in sub.attr.lower():
            return True
    return False


def _imports_mask(tree: ast.AST) -> bool:
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            if any(a.name.endswith(_MASK_IMPORT_SUFFIXES)
                   for a in node.names):
                return True
        elif isinstance(node, ast.ImportFrom):
            mod = node.module or ""
            if mod.endswith(_MASK_IMPORT_SUFFIXES):
                return True
            if mod.endswith("kernels.attention") \
                    and any(a.name == "mask" for a in node.names):
                return True
    return False


class MaskParityRule:
    """Repo rule: single-source segment/window/causal admissibility."""

    name = "mask-parity"

    def check_repo(self, files: Dict[str, Tuple[ast.AST, str]]
                   ) -> List[Finding]:
        findings: List[Finding] = []
        for path, (tree, _text) in files.items():
            if path == CANONICAL:
                continue
            for node in ast.walk(tree):
                if isinstance(node, (ast.FunctionDef,
                                     ast.AsyncFunctionDef)) \
                        and node.name in CANONICAL_FNS:
                    findings.append(Finding(
                        "mask-parity", "error", path, node.lineno,
                        f"`{node.name}` reimplemented outside "
                        f"{CANONICAL}; import the shared mask module",
                        node.name))
                elif isinstance(node, ast.Compare) \
                        and any(isinstance(op, (ast.Eq, ast.NotEq))
                                for op in node.ops) \
                        and _names_seg(node.left) \
                        and all(_names_seg(c) for c in node.comparators):
                    findings.append(Finding(
                        "mask-parity", "error", path, node.lineno,
                        "inline segment-admissibility comparison; use "
                        "kernels.attention.mask.segment_allowed"))
        for path in REQUIRED_IMPORTERS:
            if path not in files:
                continue          # partial lint run (single file / tests)
            tree, _text = files[path]
            if not _imports_mask(tree):
                findings.append(Finding(
                    "mask-parity-import", "error", path, 1,
                    f"attention backend no longer imports "
                    f"{CANONICAL} — mask semantics can drift"))
        return findings
