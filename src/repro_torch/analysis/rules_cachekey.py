"""Cache-key completeness lint rule (DESIGN.md §analysis) — the port of
``repro.analysis.rules_cachekey``.

The no-rebuild contract: every field of ``SamplingPlan`` / ``CacheSpec``
/ ``ParallelSpec`` / ``PackLayout`` is either

* **structural** — it changes what a runner computes, so it (or a
  resolved witness of it, e.g. ``budget`` -> ``schedule.phases``) MUST
  join the ``FlexiPipeline`` runner key or the packed-step key; or
* **data-only** — it only shapes a runner's *inputs* (refresh masks,
  block maps, timestep metas), so it must NOT need to join any key.

A structural field missing from the key is the bug class this rule
exists for: the pipeline would silently replay a stale runner for a plan
that needs another one. The rule:

1. hashes a canonical instance of each keyed dataclass (an unhashable
   spec cannot be a cache key at all);
2. extracts the key texts from ``pipeline/pipeline.py`` (the
   ``sig = (...)`` runner signature + every ``self._lookup(...)`` key,
   and ``packed_step``'s ``key = PackedStepKey(...)`` with the fields of
   the ``PackedStepKey`` class) and checks each structural field's
   witness expression appears in them;
3. cross-checks ``make_packed_step_fn``'s own signature against the
   packed key — a new step-family argument that does not join the key
   is flagged the day it is added;
4. flags any field that appears on a keyed dataclass but in neither the
   structural nor the data-only classification below — forcing every
   future field to take a position.

The classification tables ARE the reviewed contract (the reference's,
field for field); the witnesses are the port's key expressions.
"""
from __future__ import annotations

import ast
import dataclasses
from typing import Dict, Iterable, List, Tuple

from repro_torch.analysis.engine import Finding

PIPELINE_PATH = "src/repro_torch/pipeline/pipeline.py"
PACKED_PATH = "src/repro_torch/pipeline/packed.py"
#: the packed-step key's class in PIPELINE_PATH: its fields are the key
PACKED_KEY_CLASS = "PackedStepKey"

#: SamplingPlan structural fields -> witness expressions that must appear
#: in the runner-key text. A witness is the *resolved* form the key
#: carries (`budget` joins as the resolved `schedule.phases` + the
#: timestep ladder `ts`, `lora` as the cfg-resolved `variant`, `cache`
#: as its structural split, which joins the cached runner's key as
#: `(split,)`).
PLAN_WITNESSES: Dict[str, Tuple[str, ...]] = {
    "T": ("int(t) for t in ts",),     # the ladder joins as a tuple
    "budget": ("schedule.phases",),
    "solver": ("plan.solver",),
    "guidance_scale": ("plan.guidance_scale",),
    "guidance_kind": ("plan.guidance_kind",),
    "weak_mode": ("plan.weak_mode",),
    "lora": ("variant",),
    "weak_last": ("schedule.phases",),    # resolves into the phase split
    "clip_x0": ("plan.clip_x0",),
    "parallel": ("plan.parallel",),
    "cache": ("(split,)",),
    "attn_backend": ("plan.attn_backend",),
}
#: SamplingPlan fields that are data-only (none today — plans are pure
#: structure; budgets resolve to phase splits before compilation).
PLAN_DATA_ONLY: Tuple[str, ...] = ()

#: pipeline state (not plan fields) that must also join the runner key
PIPELINE_STATE_WITNESSES: Tuple[str, ...] = ("mesh_fingerprint",)

#: CacheSpec: only the split changes the traced graph; policy knobs
#: resolve to refresh masks, which are traced scan inputs.
CACHESPEC_STRUCTURAL: Dict[str, Tuple[str, ...]] = {
    "split": ("(split,)", "cache_split"),
}
CACHESPEC_DATA_ONLY: Tuple[str, ...] = ("policy", "interval", "bands",
                                        "threshold")

#: ParallelSpec / PackLayout join their keys whole — every field is
#: structural and witnessed by the object itself.
PARALLEL_WITNESSES: Tuple[str, ...] = ("plan.parallel",)
LAYOUT_WITNESSES: Tuple[str, ...] = ("layout",)

#: make_packed_step_fn args owned by the pipeline instance itself
#: (per-instance runner dict ⇒ they never need to join the key)
PACKED_INSTANCE_ARGS: Tuple[str, ...] = ("cfg", "sched")


def _canonical_instances():
    """One hashable exemplar per keyed dataclass (import deferred so the
    linter core imports no torch until this rule runs)."""
    from repro_torch.cache.policy import CacheSpec
    from repro_torch.distributed.partition import ParallelSpec
    from repro_torch.pipeline.packed import PackLayout
    from repro_torch.pipeline.plan import SamplingPlan
    return {
        "SamplingPlan": SamplingPlan(T=4),
        "CacheSpec": CacheSpec(),
        "ParallelSpec": ParallelSpec(),
        "PackLayout": PackLayout(groups=((0, 1),)),
    }


# ---------------------------------------------------------------------------
# Key-text extraction from the pipeline AST


def _key_texts(tree: ast.AST) -> Dict[str, str]:
    """{'runner': <sig + every _lookup key>, 'packed': <packed_step key
    and the key class's fields>} as concatenated unparsed source of the
    key expressions."""
    runner_parts: List[str] = []
    packed_parts: List[str] = []
    for node in ast.walk(tree):
        if isinstance(node, ast.ClassDef) and node.name == PACKED_KEY_CLASS:
            packed_parts.extend(st.target.id for st in node.body
                                if isinstance(st, ast.AnnAssign)
                                and isinstance(st.target, ast.Name))
        if isinstance(node, ast.FunctionDef):
            in_packed = node.name in ("packed_step", "packed_step_is_warm")
            for sub in ast.walk(node):
                if isinstance(sub, ast.Assign) \
                        and any(isinstance(t, ast.Name)
                                and t.id in ("sig", "key")
                                for t in sub.targets):
                    (packed_parts if in_packed else runner_parts).append(
                        ast.unparse(sub.value))
                elif isinstance(sub, ast.Call) \
                        and isinstance(sub.func, ast.Attribute) \
                        and sub.func.attr == "_lookup" and sub.args:
                    runner_parts.append(ast.unparse(sub.args[0]))
                elif in_packed and isinstance(sub, ast.Return) \
                        and sub.value is not None:
                    packed_parts.append(ast.unparse(sub.value))
    return {"runner": "\n".join(runner_parts),
            "packed": "\n".join(packed_parts)}


def check_witnesses(fields: Iterable[str],
                    witnesses: Dict[str, Tuple[str, ...]],
                    data_only: Iterable[str], key_text: str,
                    owner: str) -> List[Tuple[str, str]]:
    """Pure core (unit-tested directly): returns (field, problem) pairs.
    Witness semantics: EVERY listed witness expression must appear in the
    key text for the field to count as covered."""
    problems: List[Tuple[str, str]] = []
    data_only = set(data_only)
    for f in fields:
        if f in data_only:
            continue
        if f not in witnesses:
            problems.append((f, "unclassified"))
            continue
        missing = [w for w in witnesses[f] if w not in key_text]
        if missing:
            problems.append((f, f"witness {missing} not in key"))
    return problems


# ---------------------------------------------------------------------------
# The rule object


class CacheKeyRule:
    """Repo rule: structural fields must join the executable cache keys."""

    name = "cache-key"

    def check_repo(self, files: Dict[str, Tuple[ast.AST, str]]
                   ) -> List[Finding]:
        if PIPELINE_PATH not in files:
            return []                    # partial lint run
        findings: List[Finding] = []

        # 1 — hashability of every keyed dataclass
        try:
            instances = _canonical_instances()
        except Exception as e:           # import/constructor breakage
            return [Finding("cachekey-hashable", "error", PIPELINE_PATH, 1,
                            f"cannot build canonical plan/spec instances: "
                            f"{type(e).__name__}: {e}")]
        for cls_name, inst in instances.items():
            try:
                hash(inst)
            except TypeError as e:
                findings.append(Finding(
                    "cachekey-hashable", "error", PIPELINE_PATH, 1,
                    f"{cls_name} is not hashable ({e}); it cannot join "
                    f"the runner/packed cache keys", cls_name))

        texts = _key_texts(files[PIPELINE_PATH][0])

        # 2 — field coverage per class
        def fields_of(inst) -> List[str]:
            return [f.name for f in dataclasses.fields(inst)]

        checks = [
            ("SamplingPlan", fields_of(instances["SamplingPlan"]),
             PLAN_WITNESSES, PLAN_DATA_ONLY, texts["runner"]),
            ("CacheSpec", fields_of(instances["CacheSpec"]),
             CACHESPEC_STRUCTURAL, CACHESPEC_DATA_ONLY,
             texts["runner"] + texts["packed"]),
            ("ParallelSpec", fields_of(instances["ParallelSpec"]),
             {f.name: PARALLEL_WITNESSES
              for f in dataclasses.fields(instances["ParallelSpec"])},
             (), texts["runner"]),
            ("PackLayout", fields_of(instances["PackLayout"]),
             {f.name: LAYOUT_WITNESSES
              for f in dataclasses.fields(instances["PackLayout"])},
             (), texts["packed"]),
        ]
        for cls_name, fields, witnesses, data_only, text in checks:
            for field, problem in check_witnesses(fields, witnesses,
                                                  data_only, text, cls_name):
                rule = ("cachekey-unclassified" if problem == "unclassified"
                        else "cachekey-missing")
                msg = (f"{cls_name}.{field} has no structural/data-only "
                       f"classification in rules_cachekey — decide "
                       f"whether it changes the traced graph and add it "
                       f"to the witness tables AND the cache key"
                       if problem == "unclassified" else
                       f"{cls_name}.{field} is structural but its "
                       f"{problem} text — a plan differing only in this "
                       f"field would replay the wrong runner")
                findings.append(Finding(rule, "error", PIPELINE_PATH, 1,
                                        msg, f"{cls_name}.{field}"))

        # pipeline-owned structure (the mesh) must key runners too
        for witness in PIPELINE_STATE_WITNESSES:
            if witness not in texts["runner"]:
                findings.append(Finding(
                    "cachekey-missing", "error", PIPELINE_PATH, 1,
                    f"pipeline state witness `{witness}` missing from the "
                    f"runner key", witness))

        # 3 — make_packed_step_fn signature ⊆ packed key
        if PACKED_PATH in files:
            packed_tree = files[PACKED_PATH][0]
            for node in ast.walk(packed_tree):
                if isinstance(node, ast.FunctionDef) \
                        and node.name == "make_packed_step_fn":
                    args = node.args
                    names = [a.arg for a in (args.posonlyargs + args.args
                                             + args.kwonlyargs)]
                    for name in names:
                        if name in PACKED_INSTANCE_ARGS:
                            continue
                        if name not in texts["packed"]:
                            findings.append(Finding(
                                "cachekey-missing", "error", PACKED_PATH,
                                node.lineno,
                                f"make_packed_step_fn arg `{name}` does "
                                f"not join FlexiPipeline.packed_step's "
                                f"key — two step families would share "
                                f"one runner", f"packed.{name}"))
        return findings
