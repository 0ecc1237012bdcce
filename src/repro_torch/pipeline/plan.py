"""Declarative sampling plans — the port of ``repro.pipeline.plan``.

A ``SamplingPlan`` is a frozen, hashable description of one FlexiDiT
inference run: solver, step count, compute budget, guidance and LoRA
handling. A budget is an explicit :class:`FlexiSchedule` or a float
relative-compute fraction in (0, 1], solved to the weak-first schedule
with the fewest weak steps that meets it. FLOPs delegate to
``core.scheduler`` (the paper's reporting convention).

:class:`AdaptiveBudget` plans decide their switch step per sample
(``core/adaptive.py``); flow solvers integrate the rectified-flow ODE
(``diffusion/flow.py``). ``parallel=`` takes a ``ParallelSpec``
(``distributed/partition.py``): sequence-parallel sampling on the
pipeline's mesh. ``cache=`` takes a ``CacheSpec`` (``cache/policy.py``):
the cross-step activation cache.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Union

from repro_torch.cache.policy import CacheSpec
from repro_torch.configs.base import ModelConfig
from repro_torch.core.scheduler import (FlexiSchedule, dit_nfe_flops,
                                        lora_nfe_overhead, schedule_flops)
from repro_torch.distributed.partition import ParallelSpec
from repro_torch.models.attention import ATTN_BACKENDS

CACHED_SOLVERS = ("ddim", "ddpm")    # the packed-step solver family

STATIC_SOLVERS = ("ddpm", "ddim", "dpm2")
FLOW_SOLVERS = ("flow_euler", "flow_heun")
ADAPTIVE_SOLVERS = ("ddim", "ddpm")     # single-eps solvers (probe reuse)


@dataclasses.dataclass(frozen=True)
class AdaptiveBudget:
    """Per-sample adaptive budget: probe both modes every ``probe_every``
    steps and switch weak→powerful once the relative prediction gap
    exceeds ``threshold``."""
    threshold: float = 0.35
    probe_every: int = 2

    def __post_init__(self):
        if self.threshold < 0:
            raise ValueError(f"threshold must be >= 0, got {self.threshold}")
        if self.probe_every < 1:
            raise ValueError(f"probe_every must be >= 1, got {self.probe_every}")


Budget = Union[FlexiSchedule, float, AdaptiveBudget]


@dataclasses.dataclass(frozen=True)
class SamplingPlan:
    """One inference run, declaratively. See the module docstring."""
    T: int                               # denoising steps (ladder length)
    budget: Budget = 1.0
    solver: str = "ddim"
    guidance_scale: float = 1.5          # 0 disables guidance entirely
    guidance_kind: str = "uncond"        # 'uncond' (CFG) | 'weak_cond' (§3.4)
    weak_mode: int = 1                   # patch mode used for weak phases
    lora: str = "merged"                 # 'merged' | 'unmerged' (§3.2, Fig. 5)
    weak_last: bool = False              # App. B.4 ablation (fraction budgets)
    clip_x0: float = 0.0                 # DDPM-only x0 clipping
    parallel: Optional[ParallelSpec] = None   # sequence parallelism
    # cross-step activation cache: its split joins the runner key; its
    # policy only shapes the refresh mask (data)
    cache: Optional[CacheSpec] = None
    # 'pallas' = the Hopper flash kernel; 'auto' resolves per call
    attn_backend: str = "auto"

    def __post_init__(self):
        if isinstance(self.budget, int):        # budget=1 → fraction 1.0
            object.__setattr__(self, "budget", float(self.budget))
        if self.T < 1:
            raise ValueError(f"T must be >= 1, got {self.T}")
        if self.solver not in STATIC_SOLVERS + FLOW_SOLVERS:
            raise ValueError(f"unknown solver {self.solver!r}; "
                             f"known: {STATIC_SOLVERS + FLOW_SOLVERS}")
        if self.guidance_kind not in ("uncond", "weak_cond"):
            raise ValueError(f"unknown guidance_kind {self.guidance_kind!r}")
        if self.attn_backend not in ATTN_BACKENDS:
            raise ValueError(f"unknown attn_backend {self.attn_backend!r}; "
                             f"known: {ATTN_BACKENDS}")
        if self.lora not in ("merged", "unmerged"):
            raise ValueError(f"lora must be 'merged'|'unmerged', got {self.lora!r}")
        if self.weak_mode < 1:
            raise ValueError(f"weak_mode must be >= 1, got {self.weak_mode}")
        if isinstance(self.budget, float) and not 0.0 < self.budget <= 1.0:
            raise ValueError(f"fraction budget must be in (0, 1], got {self.budget}")
        if isinstance(self.budget, FlexiSchedule) \
                and self.budget.total_steps != self.T:
            raise ValueError(f"schedule covers {self.budget.total_steps} steps "
                             f"but plan.T={self.T}")
        if self.is_adaptive and self.solver not in ADAPTIVE_SOLVERS:
            raise ValueError(f"adaptive budgets support solvers "
                             f"{ADAPTIVE_SOLVERS}, got {self.solver!r}")
        if self.is_adaptive and self.weak_last:
            raise ValueError("weak_last only applies to static budgets")
        if self.solver in FLOW_SOLVERS and self.guidance_scale != 0.0:
            raise ValueError("flow solvers are unguided; set guidance_scale=0")
        if self.parallel is not None:
            if not isinstance(self.parallel, ParallelSpec):
                raise ValueError(f"parallel must be a ParallelSpec, got "
                                 f"{type(self.parallel).__name__}")
            if self.is_adaptive:
                raise ValueError("sequence-parallel adaptive plans are not "
                                 "supported yet (the probe loop runs on the "
                                 "host); use a static or fraction budget")
        if self.cache is not None:
            if not isinstance(self.cache, CacheSpec):
                raise ValueError(f"cache must be a CacheSpec, got "
                                 f"{type(self.cache).__name__}")
            if self.solver not in CACHED_SOLVERS:
                raise ValueError(f"the activation cache supports solvers "
                                 f"{CACHED_SOLVERS}, got {self.solver!r}")
            if self.is_adaptive:
                raise ValueError("adaptive plans decide modes per sample; "
                                 "the activation cache needs a static "
                                 "schedule")
            if self.guidance_active and self.guidance_kind != "uncond":
                raise ValueError("the activation cache supports vanilla "
                                 "CFG only (weak_cond mixes patch modes "
                                 "inside one step)")
            if self.parallel is not None:
                raise ValueError("the activation cache does not compose "
                                 "with sequence-parallel plans yet")

    @property
    def is_adaptive(self) -> bool:
        return isinstance(self.budget, AdaptiveBudget)

    @property
    def guidance_active(self) -> bool:
        return self.guidance_scale != 0.0 and self.solver not in FLOW_SOLVERS

    def validate(self, cfg: ModelConfig) -> None:
        """cfg-dependent checks (mode indices, LoRA availability, budgets)."""
        n_modes = 1 + len(cfg.dit.flex_patch_sizes)
        if self.weak_mode >= n_modes:
            raise ValueError(f"weak_mode={self.weak_mode} but the model has "
                             f"{n_modes} patch modes")
        if isinstance(self.budget, FlexiSchedule):
            for mode, _ in self.budget.phases:
                if not 0 <= mode < n_modes:
                    raise ValueError(f"schedule uses mode {mode}; model has "
                                     f"{n_modes} modes")
        if isinstance(self.budget, float):
            floor = self._relative(cfg, self._weak_first(self.T))
            if self.budget < floor:
                raise ValueError(
                    f"fraction budget {self.budget:.3f} below the model's "
                    f"all-weak floor {floor:.3f} at T={self.T}")
        if self.lora == "unmerged" and cfg.dit.lora_rank <= 0 \
                and not self.is_adaptive:
            raise ValueError("lora='unmerged' on a model without LoRA adapters")
        if self.cache is not None:
            self.cache.resolve_split(cfg.num_layers)   # raises when invalid

    # ------------------------------------------------------------------
    # Budget resolution

    def _weak_first(self, t_weak: int) -> FlexiSchedule:
        mk = (FlexiSchedule.powerful_first if self.weak_last
              else FlexiSchedule.weak_first)
        return mk(self.T, t_weak, self.weak_mode)

    def _flop_kwargs(self, cfg: ModelConfig, schedule: FlexiSchedule) -> dict:
        kw: dict = {
            "cfg_scale_active": self.guidance_active,
            "lora_unmerged": (self.lora == "unmerged"
                              and cfg.dit.lora_rank > 0),
        }
        if self.guidance_active and self.guidance_kind == "weak_cond":
            # §3.4: powerful phases take their guidance NFE from the weak mode
            kw["guidance_modes"] = tuple(
                (m, self.weak_mode if m == 0 else m)
                for m, _ in schedule.phases)
        return kw

    def _relative(self, cfg: ModelConfig, schedule: FlexiSchedule) -> float:
        # denominator: the vanilla all-powerful run (plain CFG, no LoRA
        # overhead), not the plan's guidance variant
        base = FlexiSchedule(((0, self.T),))
        base_fl = schedule_flops(cfg, base,
                                 cfg_scale_active=self.guidance_active)
        return (schedule_flops(cfg, schedule, **self._flop_kwargs(cfg, schedule))
                / base_fl)

    def resolve_schedule(self, cfg: ModelConfig) -> FlexiSchedule:
        """Static budgets only: the concrete FlexiSchedule this plan runs."""
        if self.is_adaptive:
            raise ValueError("adaptive plans have no static schedule; the "
                             "switch point is decided per sample")
        if isinstance(self.budget, FlexiSchedule):
            return self.budget
        # fraction: the FEWEST weak steps whose relative compute meets it
        for t_weak in range(self.T + 1):
            s = self._weak_first(t_weak)
            if self._relative(cfg, s) <= self.budget + 1e-12:
                return s
        raise ValueError(f"no weak-first schedule at T={self.T} meets "
                         f"budget {self.budget}")

    # ------------------------------------------------------------------
    # Analytic FLOPs

    def flops(self, cfg: ModelConfig, batch: int = 1,
              attn_backend: str = "dense") -> float:
        """Denoising FLOPs for a ``batch``-sample run (adaptive plans: the
        worst case, never switching plus all probes)."""
        if self.is_adaptive:
            mult = 2.0 if self.guidance_active else 1.0
            f_w = mult * dit_nfe_flops(cfg, self.weak_mode,
                                       attn_backend=attn_backend)
            if self.lora == "unmerged" and cfg.dit.lora_rank > 0:
                f_w += mult * lora_nfe_overhead(cfg, self.weak_mode)
            f_p = mult * dit_nfe_flops(cfg, 0, attn_backend=attn_backend)
            n_probes = len(range(0, self.T, self.budget.probe_every))
            return batch * (self.T * f_w + n_probes * f_p)
        schedule = self.resolve_schedule(cfg)
        total = schedule_flops(cfg, schedule, attn_backend=attn_backend,
                               **self._flop_kwargs(cfg, schedule))
        if self.solver in ("flow_heun", "dpm2"):
            total *= 2.0                 # 2nd-order solvers: 2 NFEs per step
        return batch * total

    def cached_flops(self, cfg: ModelConfig, batch: int = 1,
                     num_train_steps: int = 1000,
                     attn_backend: str = "dense") -> float:
        """Denoising FLOPs with the activation cache applied: skip steps
        pay shallow blocks only (``cache.ledger``); :meth:`flops` when
        the plan carries no cache. ``num_train_steps`` is the diffusion
        schedule the ladder respaces (banded/proxy masks depend on the
        actual t values)."""
        if self.cache is None:
            return self.flops(cfg, batch, attn_backend=attn_backend)
        from repro_torch.cache.ledger import schedule_cached_flops
        from repro_torch.diffusion.schedule import respaced_timesteps
        schedule = self.resolve_schedule(cfg)
        ts = respaced_timesteps(num_train_steps, self.T)
        total, _, _ = schedule_cached_flops(
            cfg, schedule, ts, self.cache,
            cfg_scale_active=self.guidance_active,
            lora_unmerged=(self.lora == "unmerged"
                           and cfg.dit.lora_rank > 0),
            attn_backend=attn_backend)
        return batch * total

    def relative_compute(self, cfg: ModelConfig) -> float:
        """Compute fraction vs the all-powerful baseline with the same T."""
        if self.is_adaptive:
            base = dataclasses.replace(self, budget=1.0)
            return self.flops(cfg) / base.flops(cfg)
        return self._relative(cfg, self.resolve_schedule(cfg))


def solve_t_weak(cfg: ModelConfig, T: int, target: float, *,
                 weak_mode: int = 1, guidance: bool = True) -> int:
    """Smallest ``T_weak`` whose weak-first schedule meets ``target``
    relative compute."""
    plan = SamplingPlan(T=T, budget=float(target), weak_mode=weak_mode,
                        guidance_scale=1.5 if guidance else 0.0)
    plan.validate(cfg)
    return plan.resolve_schedule(cfg).phases[0][1]
