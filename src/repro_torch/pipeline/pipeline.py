"""FlexiPipeline — the FlexiDiT inference entry point of the port.

The pipeline owns ``(params, cfg, diffusion schedule)`` on one device and a
cache of *phase runners*: one per plan signature ``(solver, resolved
schedule, timestep ladder, guidance signature, LoRA variant,
eps_transform, attention backend)``, keyed like the reference's runner
cache, so repeated calls and budget switches between calls reuse what
was built. ``cache_stats()["compiled"]`` counts runners built.

The pipeline runs on CUDA unless the caller passes ``device="cpu"``; it
never falls back to the CPU when CUDA is missing. It samples static
diffusion plans (ddim, ddpm, dpm2), cached plans (the activation cache,
ddim and ddpm), flow plans (``flow_euler``, ``flow_heun``: one runner per
signature, keyed ``("flow",) + sig``) and adaptive plans (``core.adaptive``
over one guided NFE per ``("nfe", mode, scale, LoRA variant, backend)``,
so a budget switch between calls builds nothing).
:meth:`FlexiPipeline.packed_step` hands the serving engine its
step-granular packed runners from the same cache.
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.cache import apply as cache_apply
from repro_torch.configs.base import ModelConfig
from repro_torch.core import adaptive as adaptive_mod
from repro_torch.core.flexify import merge_lora
from repro_torch.core.guidance import GuidanceConfig, make_eps_fn
from repro_torch.core.scheduler import FlexiSchedule
from repro_torch.device import resolve_device
from repro_torch.diffusion import flow, sampler
from repro_torch.diffusion import schedule as sch
from repro_torch.models.common import dtype_of, tree_map
from repro_torch.pipeline.packed import PackLayout, make_packed_step_fn
from repro_torch.pipeline.plan import FLOW_SOLVERS, SamplingPlan

Params = Dict[str, Any]
# eps_transform(eps, x, t) -> eps — e.g. spectral filtering probes (Fig. 2)
EpsTransform = Callable[[torch.Tensor, torch.Tensor, torch.Tensor], torch.Tensor]


class PackedStepKey(NamedTuple):
    """A packed-step runner's key in the pipeline's runner cache: the
    layout and :func:`make_packed_step_fn`'s options."""
    layout: Optional[PackLayout]
    k_steps: int = 1
    solver: str = "ddim"
    guidance_scale: float = 1.5
    clip_x0: float = 0.0
    cache_split: Optional[int] = None
    attn_backend: str = "auto"
    taps: bool = False


@dataclasses.dataclass
class SampleResult:
    x0: torch.Tensor
    flops: float                  # analytic FLOPs for the whole batch
    relative_compute: float       # vs the all-powerful baseline, same T
    trace: Dict[str, Any]         # schedule / timesteps / switch / gaps


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
        self._nfes: Dict[Tuple, Callable] = {}
        self._merged: Dict[int, Params] = {}
        self._hits = 0
        self._misses = 0
        # serializes the miss check and the insert, so a background warm-up
        # thread (fleet.warmup) racing the serving thread on one key builds
        # it once and the counters stay exact
        self._cache_lock = threading.Lock()

    def cache_stats(self) -> Dict[str, int]:
        """Runner-cache counters; ``compiled`` counts every runner and NFE
        function built."""
        with self._cache_lock:
            return {"runners": len(self._runners),
                    "nfe_fns": len(self._nfes), "hits": self._hits,
                    "misses": self._misses, "compiled": self._misses}

    def _lora_variant(self, plan: SamplingPlan) -> str:
        return "none" if self.cfg.dit.lora_rank <= 0 else plan.lora

    def _params_for_mode(self, mode: int, variant: str) -> Params:
        if variant != "merged" or mode == 0:
            return self.params
        if mode not in self._merged:
            self._merged[mode] = merge_lora(self.params, self.cfg, mode)
        return self._merged[mode]

    def _lookup(self, key: Tuple, build: Callable,
                cache: Optional[Dict[Tuple, Callable]] = None) -> Callable:
        cache = self._runners if cache is None else cache
        with self._cache_lock:
            if key in cache:
                self._hits += 1
            else:
                self._misses += 1
                cache[key] = build()
            return cache[key]

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
                       transform: Optional[EpsTransform],
                       cache_split: Optional[int] = None) -> Callable:
        """The runner of a static plan. With ``cache_split`` it carries the
        cross-step activation cache: the per-phase refresh masks are
        inputs (host numpy), so one runner serves every refresh policy at
        this (schedule, split) signature."""
        splits = schedule.split_timesteps(ts)
        set_idx = {m: i for i, m in
                   enumerate(self._param_set_modes(plan, schedule))}
        cfg = self.cfg

        def run(param_sets, x_T, cond, null_cond, generator, text_mask,
                null_text_mask, noise, masks=None):
            phases = []
            for i, (mode, tsub) in enumerate(splits):
                p = param_sets[set_idx.get(mode, 0)]
                g = self._phase_guidance(plan, mode)
                # the §3.4 guidance call runs at the weak mode: under merged
                # LoRA it must see that mode's merged weights
                gp = (param_sets[set_idx[g.mode_uncond]]
                      if g.kind == "weak_cond" and g.mode_uncond in set_idx
                      else None)
                fn = make_eps_fn(p, cfg, cond, null_cond, g, text_mask,
                                 null_text_mask, guidance_params=gp,
                                 attn_backend=plan.attn_backend,
                                 cache_split=cache_split)
                if transform is not None:
                    def fn(x, t, _f=fn):
                        eps, lv = _f(x, t)
                        return transform(eps, x, t), lv
                if cache_split is None:
                    phases.append((fn, tsub))
                    continue
                guided = g.scale != 0.0 and cond is not None
                delta0 = torch.zeros(
                    cache_apply.delta_shape(cfg, mode, x_T.shape[0], guided),
                    dtype=dtype_of(cfg.compute_dtype), device=x_T.device)
                phases.append((fn, tsub, masks[i], delta0))
            return sampler.sample_phased(phases, self.sched, x_T,
                                         solver=plan.solver,
                                         clip_x0=plan.clip_x0,
                                         generator=generator, noise=noise)

        return run

    def _flow_runner(self, plan: SamplingPlan,
                     schedule: FlexiSchedule) -> Callable:
        """The runner of a flow plan: the τ ladder split across the
        schedule's phases, one velocity model per phase."""
        splits = flow.split_tau_ladder(flow.tau_ladder(plan.T),
                                       schedule.phases)
        set_idx = {m: i for i, m in
                   enumerate(self._param_set_modes(plan, schedule))}
        solver = "euler" if plan.solver == "flow_euler" else "heun"
        cfg = self.cfg

        def run(param_sets, x_T, cond):
            phases = [(flow.make_flow_v_fn(param_sets[set_idx.get(mode, 0)],
                                           cfg, cond, mode=mode,
                                           attn_backend=plan.attn_backend),
                       tsub) for mode, tsub in splits]
            return flow.sample_flow_phased(phases, x_T, solver=solver)

        return run

    def _nfe_fn(self, mode: int, scale: float,
                attn_backend: str = "auto") -> Callable:
        """One guided NFE at ``mode`` (adaptive plans)."""
        cfg = self.cfg
        g = GuidanceConfig(scale=scale, mode_cond=mode, mode_uncond=mode)

        def nfe(params, x, t, cond, null_cond, text_mask, null_text_mask):
            return make_eps_fn(params, cfg, cond, null_cond, g, text_mask,
                               null_text_mask,
                               attn_backend=attn_backend)(x, t)

        return nfe

    # ------------------------------------------------------------------
    # Step-granular packed runners (the serving engine's)

    def packed_step(self, layout: PackLayout, **kw: Any) -> Callable:
        """The runner advancing ONE packed engine step (``k_steps``
        micro-steps) at ``layout`` (``pipeline/packed.py``); ``kw``: the
        other fields of :class:`PackedStepKey`. Latents, timesteps, labels,
        noise, deltas and refresh flags are inputs, so the serving engine
        replays a layout across any requests and denoise steps; runners
        share this pipeline's cache, so ``cache_stats()`` counts bucket
        warm-up. ``taps=True`` selects the tapped family: the same latents
        bit for bit plus device tap outputs; its key differs only in
        ``taps``."""
        key = PackedStepKey(layout, **kw)
        return self._lookup(key, lambda: make_packed_step_fn(
            self.cfg, self.sched, **key._asdict()))

    def packed_step_is_warm(self, layout: PackLayout, **kw: Any) -> bool:
        """Whether :meth:`packed_step` would be a cache hit (the serving
        planner prefers runners already built)."""
        return PackedStepKey(layout, **kw) in self._runners

    def warm_packed_layouts(self, **kw: Any) -> Dict[int, List[PackLayout]]:
        """Built packed-step layouts grouped by micro-step depth k, for the
        step family ``kw`` (the fields of :class:`PackedStepKey` but the
        layout and ``k_steps``). A frozen serving engine
        (``allow_cold=False``) restricts its planner to these."""
        probe = PackedStepKey(None, **kw)
        out: Dict[int, List[PackLayout]] = {}
        with self._cache_lock:
            keys = list(self._runners)
        for key in keys:
            if isinstance(key, PackedStepKey) and key._replace(
                    layout=None, k_steps=probe.k_steps) == probe:
                out.setdefault(key.k_steps, []).append(key.layout)
        return out

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
        if eps_transform is not None and plan.cache is not None:
            raise ValueError("eps_transform does not compose with the "
                             "activation cache")
        if eps_transform is not None and (plan.is_adaptive
                                          or plan.solver in FLOW_SOLVERS):
            raise ValueError("eps_transform only applies to static "
                             "diffusion plans")
        if x_T is None:
            x_T = torch.randn((n,) + tuple(self.cfg.dit.latent_shape),
                              generator=generator, device=self.device)
        x_T = x_T.to(self.device)
        if noise is not None:
            noise = noise.to(self.device)
        y, null = self._default_cond(n, cond)
        variant = self._lora_variant(plan)
        if plan.is_adaptive:
            return self._sample_adaptive(plan, x_T, y, null, text_mask,
                                         null_text_mask, generator, noise)

        ts = sch.respaced_timesteps(self.sched.num_steps, plan.T)
        schedule = plan.resolve_schedule(self.cfg)
        param_sets = tuple(self._params_for_mode(m, variant)
                           for m in self._param_set_modes(plan, schedule))
        sig = (plan.solver, plan.clip_x0, plan.guidance_scale,
               plan.guidance_kind, plan.weak_mode, variant,
               schedule.phases, tuple(int(t) for t in ts), eps_transform,
               plan.parallel, plan.attn_backend)
        if plan.cache is not None:
            from repro_torch.cache import ledger as cache_ledger
            from repro_torch.cache import policy as cache_policy
            # masks are runner INPUTS: interval/band/threshold switches
            # replay the same runner with other flags
            masks = tuple(cache_policy.refresh_mask(plan.cache, tsub)
                          for _m, tsub in schedule.split_timesteps(ts))
            split = plan.cache.resolve_split(self.cfg.num_layers)
            runner = self._lookup(
                ("cached",) + sig + (split,),
                lambda: self._static_runner(plan, schedule, ts, None, split))
            x0 = runner(param_sets, x_T, y, null, generator, text_mask,
                        null_text_mask, noise, masks)
            fl, n_refresh, n_steps = cache_ledger.schedule_cached_flops(
                self.cfg, schedule, ts, plan.cache,
                cfg_scale_active=plan.guidance_active,
                lora_unmerged=(variant == "unmerged"))
            return SampleResult(
                x0=x0, flops=n * fl,
                relative_compute=plan.relative_compute(self.cfg),
                trace={"schedule": schedule, "timesteps": ts,
                       "refresh_masks": masks, "cache_refreshes": n_refresh,
                       "cache_steps": n_steps})
        if plan.solver in FLOW_SOLVERS:
            runner = self._lookup(("flow",) + sig,
                                  lambda: self._flow_runner(plan, schedule))
            x0 = runner(param_sets, x_T, y)
        else:
            runner = self._lookup(("static",) + sig,
                                  lambda: self._static_runner(
                                      plan, schedule, ts, eps_transform))
            x0 = runner(param_sets, x_T, y, null, generator, text_mask,
                        null_text_mask, noise)
        return SampleResult(
            x0=x0, flops=plan.flops(self.cfg, batch=n),
            relative_compute=plan.relative_compute(self.cfg),
            trace={"schedule": schedule, "timesteps": ts})

    def _sample_adaptive(self, plan: SamplingPlan, x_T: torch.Tensor, y: Any,
                         null: Any, text_mask, null_text_mask,
                         generator: Optional[torch.Generator],
                         noise: Optional[torch.Tensor]) -> SampleResult:
        ts = sch.respaced_timesteps(self.sched.num_steps, plan.T)
        variant = self._lora_variant(plan)
        fns: List[Callable] = []
        for mode in range(1 + len(self.cfg.dit.flex_patch_sizes)):
            nfe = self._lookup(
                ("nfe", mode, plan.guidance_scale, variant, plan.attn_backend),
                lambda m=mode: self._nfe_fn(m, plan.guidance_scale,
                                            plan.attn_backend),
                self._nfes)
            p = self._params_for_mode(mode, variant)
            fns.append(lambda x, t, _f=nfe, _p=p:
                       _f(_p, x, t, y, null, text_mask, null_text_mask))
        res = adaptive_mod.adaptive_sample(
            fns, self.sched, x_T, ts, self.cfg,
            threshold=plan.budget.threshold,
            probe_every=plan.budget.probe_every,
            weak_mode=plan.weak_mode, solver=plan.solver,
            guided=plan.guidance_active,
            lora_unmerged=(variant == "unmerged"),
            generator=generator, noise=noise)
        return SampleResult(
            x0=res.x0, flops=res.flops,
            relative_compute=res.flops / res.flops_static_powerful,
            trace={"switch_step": res.switch_step, "gaps": res.gaps,
                   "timesteps": ts,
                   "flops_static_powerful": res.flops_static_powerful})
