"""SLA-aware budget control, the port of ``repro.serving.controller``.

FlexiDiT's per-step elasticity gives the scheduler a knob no fixed-
compute model has: under load, requests can be *demoted* to a weaker
(cheaper) sampling plan instead of queueing without bound. The
controller solves, from the analytic FLOPs ledger, for the highest
uniform budget level the current arrival rate sustains:

    highest b  s.t.  lambda * F(b) <= target_util * capacity

where ``F(b)`` is the per-request denoising FLOPs of level ``b``'s plan
(``SamplingPlan.flops``, or ``cached_flops`` under the activation cache)
and ``capacity`` the engine's measured FLOPs/s. Both rates are EWMA
estimates fed by ``observe_*`` hooks, so tests can inject them directly.
``observe_calibration`` (measured wall per analytic FLOP per step family)
switches the solve to seconds-space; the profiling that feeds it in the
engine comes with the telemetry slice. Sequence-parallel pricing
(``sp > 1``) adds the partition's padding FLOPs.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

from repro_torch.cache.policy import CacheSpec
from repro_torch.configs.base import ModelConfig
from repro_torch.pipeline.plan import SamplingPlan


def request_cost_flops(cfg: ModelConfig, plan: SamplingPlan,
                       sp: int = 1,
                       cache: Optional[CacheSpec] = None,
                       num_train_steps: int = 1000,
                       attn_backend: Optional[str] = None) -> float:
    """Analytic FLOPs one request at ``plan`` costs the engine (with
    ``sp > 1``, plus the padding FLOPs of the sequence-parallel
    partition, ``distributed.partition``). With ``cache``
    (the engine's cross-step activation cache) skip steps only pay the
    shallow blocks, so the sustainable-budget solve sees the cheaper
    cache-adjusted cost — caching raises the budget level a given
    arrival rate sustains. ``num_train_steps`` must match the serving
    pipeline's diffusion-schedule length: banded/proxy refresh masks
    depend on the ladder's actual ``t`` values.

    Attention is priced at what the plan's backend issues: under
    'pallas'/'auto' the segment-aware kernel computes block-granular score
    tiles (a pack's cross-segment blocks are skipped, never charged),
    while the dense backend pays the N² convention. Override with
    ``attn_backend``."""
    backend = plan.attn_backend if attn_backend is None else attn_backend
    if cache is not None and plan.cache is None:
        import dataclasses
        plan = dataclasses.replace(plan, cache=cache)
    fl = (plan.cached_flops(cfg, num_train_steps=num_train_steps,
                            attn_backend=backend)
          if plan.cache is not None
          else plan.flops(cfg, attn_backend=backend))
    if sp > 1:
        from repro_torch.distributed.partition import plan_partition
        part = plan_partition(cfg, plan.resolve_schedule(cfg), sp,
                              plan.parallel)
        fl += part.pad_flops(cfg, cfg_scale_active=plan.guidance_active)
    return fl


def plan_mode_flops(cfg: ModelConfig, plan: SamplingPlan,
                    sp: int = 1,
                    cache: Optional[CacheSpec] = None,
                    num_train_steps: int = 1000,
                    attn_backend: Optional[str] = None
                    ) -> Dict[int, float]:
    """``request_cost_flops`` split by step family (patch mode): the
    fraction of a request's cost each mode's NFEs account for, scaled so
    the values sum exactly to the request total (guidance/LoRA/sp-pad
    overheads smear proportionally). This is what seconds-space pricing
    multiplies by per-family wall-per-FLOP calibration factors."""
    backend = plan.attn_backend if attn_backend is None else attn_backend
    if cache is not None and plan.cache is None:
        import dataclasses
        plan = dataclasses.replace(plan, cache=cache)
    total = request_cost_flops(cfg, plan, sp,
                               num_train_steps=num_train_steps,
                               attn_backend=attn_backend)
    if plan.is_adaptive:
        # no static phase split — the probe decides at runtime; price it
        # all at the powerful family
        return {0: total}
    from repro_torch.core.scheduler import dit_nfe_flops
    from repro_torch.diffusion import schedule as sch
    schedule = plan.resolve_schedule(cfg)
    raw: Dict[int, float] = {}
    if plan.cache is not None:
        from repro_torch.cache import ledger as cache_ledger
        from repro_torch.cache import policy as cache_policy
        ts = sch.respaced_timesteps(num_train_steps, plan.T)
        split = plan.cache.resolve_split(cfg.num_layers)
        for mode, tsub in schedule.split_timesteps(ts):
            mask = cache_policy.refresh_mask(plan.cache, tsub)
            fl = sum(cache_ledger.cached_nfe_flops(
                cfg, mode, split, bool(r), attn_backend=backend)
                for r in mask)
            raw[mode] = raw.get(mode, 0.0) + fl
    else:
        for mode, n_steps in schedule.phases:
            if n_steps:
                raw[mode] = (raw.get(mode, 0.0) + n_steps
                             * dit_nfe_flops(cfg, mode,
                                             attn_backend=backend))
    rsum = sum(raw.values())
    if rsum <= 0:
        return {0: total}
    return {m: total * fl / rsum for m, fl in raw.items()}


class BudgetController:
    """Solves for the degradation level; stateless apart from two EWMAs."""

    def __init__(self, cfg: ModelConfig, plans: Dict[float, SamplingPlan], *,
                 target_util: float = 0.85, alpha: float = 0.3, sp: int = 1,
                 cache: Optional[CacheSpec] = None,
                 num_train_steps: int = 1000,
                 attn_backend: Optional[str] = None):
        if not plans:
            raise ValueError("controller needs a non-empty plan menu")
        if not 0.0 < target_util <= 1.0:
            raise ValueError(f"target_util must be in (0, 1], got "
                             f"{target_util}")
        self.levels = tuple(sorted(plans))            # ascending budgets
        self.costs = {b: request_cost_flops(cfg, p, sp, cache=cache,
                                            num_train_steps=num_train_steps,
                                            attn_backend=attn_backend)
                      for b, p in plans.items()}
        self.mode_costs = {b: plan_mode_flops(
            cfg, p, sp, cache=cache, num_train_steps=num_train_steps,
            attn_backend=attn_backend) for b, p in plans.items()}
        self.target_util = target_util
        self.alpha = alpha
        self._interarrival: Optional[float] = None    # EWMA seconds
        self._last_arrival: Optional[float] = None
        self._flops_per_s: Optional[float] = None     # EWMA capacity
        self._wpf: Dict[Any, float] = {}              # wall/FLOP per family
        self._wpf_global: Optional[float] = None

    # ------------------------------------------------------------------
    # Rate estimation

    def observe_arrival(self, now: float) -> None:
        if self._last_arrival is not None:
            gap = max(now - self._last_arrival, 1e-9)
            self._interarrival = (gap if self._interarrival is None else
                                  (1 - self.alpha) * self._interarrival
                                  + self.alpha * gap)
        self._last_arrival = now

    def observe_service(self, flops: float, dt: float) -> None:
        """Feed one completed chunk of work: ``flops`` retired in ``dt``
        seconds of engine time."""
        if dt <= 0:
            return
        rate = flops / dt
        self._flops_per_s = (rate if self._flops_per_s is None else
                             (1 - self.alpha) * self._flops_per_s
                             + self.alpha * rate)

    def observe_calibration(self, family: Optional[Any],
                            analytic_flops: float, wall_s: float) -> None:
        """Feed one measured dispatch: ``wall_s`` of device time for
        ``analytic_flops`` of ledger work. ``family`` is the patch mode
        when the dispatch was single-family, else None (mixed packs
        calibrate only the global factor — their wall is not separable
        by family without the attribution model this factor feeds)."""
        if analytic_flops <= 0 or wall_s <= 0:
            return
        r = wall_s / analytic_flops
        if family is not None:
            prev = self._wpf.get(family)
            self._wpf[family] = (r if prev is None else
                                 (1 - self.alpha) * prev + self.alpha * r)
        self._wpf_global = (r if self._wpf_global is None else
                            (1 - self.alpha) * self._wpf_global
                            + self.alpha * r)

    @property
    def arrival_rate(self) -> Optional[float]:
        return None if not self._interarrival else 1.0 / self._interarrival

    @property
    def capacity_flops_per_s(self) -> Optional[float]:
        return self._flops_per_s

    @property
    def calibration(self) -> Optional[Dict[str, Any]]:
        """Measured wall-per-analytic-FLOP factors (None before any
        ``observe_calibration``)."""
        if self._wpf_global is None:
            return None
        return {"global": self._wpf_global, "per_family": dict(self._wpf)}

    # ------------------------------------------------------------------
    # The solve

    def cost_seconds(self, b: float) -> Optional[float]:
        """Measured seconds of engine time one request at level ``b``
        costs: per-family analytic FLOPs × calibrated wall-per-FLOP
        (global factor for families never seen alone)."""
        if self._wpf_global is None:
            return None
        return sum(fl * self._wpf.get(m, self._wpf_global)
                   for m, fl in self.mode_costs[b].items())

    def solve(self) -> float:
        """Highest budget level sustaining the current arrival rate.
        Calibrated (``observe_calibration`` seen): seconds-space —
        ``cost_seconds(b) <= target_util / λ`` needs no separate
        capacity estimate, the calibration *is* capacity. Uncalibrated:
        the legacy analytic solve, unchanged."""
        if self._wpf_global is not None:
            lam = self.arrival_rate
            if lam is None:
                return self.levels[-1]
            budget_s = self.target_util / lam      # engine-seconds/request
            for b in reversed(self.levels):
                if self.cost_seconds(b) <= budget_s:
                    return b
            return self.levels[0]
        return self.solve_analytic()

    def solve_analytic(self) -> float:
        """The pure-arithmetic solve (pre-calibration behavior): highest
        level sustaining the arrival rate against EWMA FLOPs/s capacity;
        the lowest when even it is overloaded; the highest when either
        rate is unknown (no evidence of pressure yet)."""
        lam = self.arrival_rate
        cap = self.capacity_flops_per_s
        if lam is None or cap is None:
            return self.levels[-1]
        budget_flops = self.target_util * cap / lam    # per-request allowance
        for b in reversed(self.levels):
            if self.costs[b] <= budget_flops:
                return b
        return self.levels[0]

    def assign(self, requested: float) -> float:
        """Demote ``requested`` to the solved sustainable level (never
        promote): the highest menu level <= min(requested, solve())."""
        ceiling = min(requested, self.solve())
        eligible = [b for b in self.levels if b <= ceiling]
        return max(eligible) if eligible else self.levels[0]
