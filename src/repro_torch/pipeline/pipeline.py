"""FlexiPipeline — the FlexiDiT inference entry point of the port.

The pipeline owns ``(params, cfg, diffusion schedule)`` on one device and a
cache of *phase runners*: one per plan signature ``(solver, resolved
schedule, timestep ladder, guidance signature, LoRA variant,
eps_transform, attention backend)``, keyed like the reference's runner
cache, so repeated calls and budget switches between calls reuse what
was built. ``cache_stats()["compiled"]`` counts runners built.

The pipeline runs on CUDA unless the caller passes ``device="cpu"``; it
never falls back to the CPU when CUDA is missing. Static diffusion plans
(ddim, ddpm, dpm2) are ported; adaptive, flow and cached plans come with
later slices and raise ``NotImplementedError``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.flexify import merge_lora
from repro_torch.core.guidance import GuidanceConfig, make_eps_fn
from repro_torch.core.scheduler import FlexiSchedule
from repro_torch.device import resolve_device
from repro_torch.diffusion import sampler
from repro_torch.diffusion import schedule as sch
from repro_torch.models.common import tree_map
from repro_torch.pipeline.plan import FLOW_SOLVERS, SamplingPlan

Params = Dict[str, Any]
# eps_transform(eps, x, t) -> eps — e.g. spectral filtering probes (Fig. 2)
EpsTransform = Callable[[torch.Tensor, torch.Tensor, torch.Tensor], torch.Tensor]


@dataclasses.dataclass
class SampleResult:
    x0: torch.Tensor
    flops: float                  # analytic FLOPs for the whole batch
    relative_compute: float       # vs the all-powerful baseline, same T
    trace: Dict[str, Any]         # schedule / timesteps


class FlexiPipeline:
    """Sampling for a flexified DiT.

    >>> pipe = FlexiPipeline(params, cfg, sched)          # on CUDA
    >>> plan = SamplingPlan(T=20, budget=0.6)
    >>> g = torch.Generator("cuda").manual_seed(0)
    >>> res = pipe.sample(plan, n=16, generator=g)
    """

    def __init__(self, params: Params, cfg: ModelConfig,
                 sched: sch.DiffusionSchedule, device: Any = None):
        assert cfg.family == "dit" and cfg.dit is not None, cfg.name
        self.device = resolve_device(device)
        self.params = tree_map(lambda a: a.to(self.device), params)
        self.cfg = cfg
        self.sched = sched
        self._runners: Dict[Tuple, Callable] = {}
        self._merged: Dict[int, Params] = {}
        self._hits = 0
        self._misses = 0

    def cache_stats(self) -> Dict[str, int]:
        return {"runners": len(self._runners), "hits": self._hits,
                "misses": self._misses, "compiled": self._misses}

    def _lora_variant(self, plan: SamplingPlan) -> str:
        return "none" if self.cfg.dit.lora_rank <= 0 else plan.lora

    def _params_for_mode(self, mode: int, variant: str) -> Params:
        if variant != "merged" or mode == 0:
            return self.params
        if mode not in self._merged:
            self._merged[mode] = merge_lora(self.params, self.cfg, mode)
        return self._merged[mode]

    def _lookup(self, key: Tuple, build: Callable) -> Callable:
        if key in self._runners:
            self._hits += 1
        else:
            self._misses += 1
            self._runners[key] = build()
        return self._runners[key]

    def _default_cond(self, n: int, cond: Any) -> Tuple[Any, Any]:
        dit = self.cfg.dit
        if dit.conditioning == "class":
            y = (torch.arange(n, device=self.device) % dit.num_classes
                 if cond is None else torch.as_tensor(cond, device=self.device))
            return y, torch.full((n,), dit.num_classes, device=self.device)
        if dit.conditioning == "text":
            if cond is None:
                raise ValueError("text-conditioned models need cond "
                                 "embeddings [n, text_len, text_dim]")
            y = torch.as_tensor(cond, device=self.device)
            return y, torch.zeros_like(y)
        return None, None

    def _phase_guidance(self, plan: SamplingPlan, mode: int) -> GuidanceConfig:
        if plan.guidance_active and plan.guidance_kind == "weak_cond" \
                and mode == 0:
            # §3.4: the weak model's *conditional* prediction guides the
            # powerful phase
            return GuidanceConfig(scale=plan.guidance_scale, mode_cond=0,
                                  mode_uncond=plan.weak_mode, kind="weak_cond")
        return GuidanceConfig(scale=plan.guidance_scale, mode_cond=mode,
                              mode_uncond=mode)

    def _param_set_modes(self, plan: SamplingPlan,
                         schedule: FlexiSchedule) -> Tuple[int, ...]:
        """Modes needing their own param tree: with merged LoRA each weak
        mode gets its own merge, including a weak mode serving only as the
        §3.4 guidance call; otherwise everything shares the base."""
        if self._lora_variant(plan) != "merged":
            return (0,)
        modes = {m for m, n in schedule.phases if n}
        if plan.guidance_active and plan.guidance_kind == "weak_cond":
            modes.add(plan.weak_mode)
        return tuple(sorted(modes))

    def _static_runner(self, plan: SamplingPlan, schedule: FlexiSchedule,
                       ts: np.ndarray,
                       transform: Optional[EpsTransform]) -> Callable:
        splits = schedule.split_timesteps(ts)
        set_idx = {m: i for i, m in
                   enumerate(self._param_set_modes(plan, schedule))}
        cfg = self.cfg

        def run(param_sets, x_T, cond, null_cond, generator, text_mask,
                null_text_mask, noise):
            phases = []
            for mode, tsub in splits:
                p = param_sets[set_idx.get(mode, 0)]
                g = self._phase_guidance(plan, mode)
                # the §3.4 guidance call runs at the weak mode: under merged
                # LoRA it must see that mode's merged weights
                gp = (param_sets[set_idx[g.mode_uncond]]
                      if g.kind == "weak_cond" and g.mode_uncond in set_idx
                      else None)
                fn = make_eps_fn(p, cfg, cond, null_cond, g, text_mask,
                                 null_text_mask, guidance_params=gp,
                                 attn_backend=plan.attn_backend)
                if transform is not None:
                    def fn(x, t, _f=fn):
                        eps, lv = _f(x, t)
                        return transform(eps, x, t), lv
                phases.append((fn, tsub))
            return sampler.sample_phased(phases, self.sched, x_T,
                                         solver=plan.solver,
                                         clip_x0=plan.clip_x0,
                                         generator=generator, noise=noise)

        return run

    @torch.inference_mode()
    def sample(self, plan: SamplingPlan, n: int,
               generator: Optional[torch.Generator], *,
               cond: Any = None, x_T: Optional[torch.Tensor] = None,
               text_mask: Optional[torch.Tensor] = None,
               null_text_mask: Optional[torch.Tensor] = None,
               noise: Optional[torch.Tensor] = None,
               eps_transform: Optional[EpsTransform] = None) -> SampleResult:
        """Sample ``n`` latents under ``plan``. ``generator`` (on the
        pipeline's device) draws the prior ``x_T`` unless one is given, and
        the DDPM noise unless ``noise`` ([T, n, *latent_shape]) is given.

        ``eps_transform`` joins the runner key by identity: reuse one
        callable across calls to reuse its runner."""
        plan.validate(self.cfg)
        if plan.is_adaptive:
            raise NotImplementedError("adaptive plans come with the sampling "
                                      "extensions slice (ROADMAP queue 1, "
                                      "item 7)")
        if plan.solver in FLOW_SOLVERS:
            raise NotImplementedError("flow solvers come with the sampling "
                                      "extensions slice (ROADMAP queue 1, "
                                      "item 7)")
        if x_T is None:
            x_T = torch.randn((n,) + tuple(self.cfg.dit.latent_shape),
                              generator=generator, device=self.device)
        x_T = x_T.to(self.device)
        if noise is not None:
            noise = noise.to(self.device)
        y, null = self._default_cond(n, cond)
        variant = self._lora_variant(plan)

        ts = sch.respaced_timesteps(self.sched.num_steps, plan.T)
        schedule = plan.resolve_schedule(self.cfg)
        param_sets = tuple(self._params_for_mode(m, variant)
                           for m in self._param_set_modes(plan, schedule))
        sig = (plan.solver, plan.clip_x0, plan.guidance_scale,
               plan.guidance_kind, plan.weak_mode, variant,
               schedule.phases, tuple(int(t) for t in ts), eps_transform,
               plan.parallel, plan.attn_backend)
        runner = self._lookup(("static",) + sig,
                              lambda: self._static_runner(plan, schedule, ts,
                                                          eps_transform))
        x0 = runner(param_sets, x_T, y, null, generator, text_mask,
                    null_text_mask, noise)
        return SampleResult(
            x0=x0, flops=plan.flops(self.cfg, batch=n),
            relative_compute=plan.relative_compute(self.cfg),
            trace={"schedule": schedule, "timesteps": ts})
