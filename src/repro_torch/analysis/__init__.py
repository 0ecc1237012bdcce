"""Source analysis of the port — the port of ``repro.analysis``'s AST
lint (DESIGN.md §analysis): repo-specific rules over the Python source
that keep the port's invariants statically true.

* cache-key completeness: every structural field of ``SamplingPlan`` /
  ``CacheSpec`` / ``ParallelSpec`` / ``PackLayout`` joins the
  ``FlexiPipeline`` runner or packed-step cache key;
* mask parity: only ``kernels/attention/mask.py`` defines segment,
  window and causal admissibility;
* host purity: the fleet's control modules, the fault injector and the
  journal, and telemetry's attribution import neither torch nor numpy
  and sync no device value; tap tensors reach the host only in the
  aggregate sink; every fault-injection seam call is armed-guarded;
* capture safety (``rules_trace``, the reference's trace-safety rule):
  no host read, host copy or Python branch on a device value inside a
  region that a CUDA graph captures, and no device read inside a host
  loop elsewhere (``hot-host-sync``);
* the graph audit (``graph_audit``, the reference's jaxpr audit): the
  real step functions traced by ``make_fx`` keep one graph across
  budget, cache-policy and pack-content switches, taps are pure extra
  outputs, no graph reads the host, and every runner the pipeline caches
  goes through ``runtime.graphs``.

Findings can be suppressed inline (``# repro: ignore[rule]``) or
grandfathered in ``src/repro_torch/analysis/baseline.json`` with a
justification. CLI::

    python -m repro_torch.analysis --strict src/repro_torch
"""
from repro_torch.analysis.engine import (Finding, lint_paths, load_baseline,
                                         run_analysis, split_baselined)

__all__ = ["Finding", "lint_paths", "load_baseline", "run_analysis",
           "split_baselined"]
