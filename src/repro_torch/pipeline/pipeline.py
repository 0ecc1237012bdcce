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

Every runner is compiled once, as the reference's are by ``jax.jit``: on
CUDA it goes through ``runtime.graphs`` and is captured as a CUDA graph
on its first call at each input signature, then replayed. Static and
flow plans are captured whole (the timestep ladder is baked, as the
reference's ``jax.jit(run)`` closes over it; the DDPM noise is drawn
outside, before the runner); a cached plan's runner is a host loop over
one captured NFE per phase, keyed by the step's deep/shallow branch, so
one set of graphs serves every refresh policy; an adaptive plan replays
one captured NFE per mode between its host probes; a packed step is a
host loop over one captured micro-step, shared by every depth k of its
layout and keyed by the deep/shallow branch on the cached family. ``cache_stats()`` adds
``captured`` (graphs), ``replays`` and ``graph_pool_bytes`` to
``compiled`` (runners built). Under ``runtime.graphs.disabled()`` every
runner runs eagerly. Runners over a mesh stay eager: their Gloo
collectives cannot be captured.

With a mesh (``FlexiPipeline(..., mesh=...)``, a ``DeviceMesh`` with dims
``("data", "seq")`` from ``launch.mesh.make_inference_mesh``) every rank
runs ``sample`` with the same arguments. Plans carrying a ``ParallelSpec``
run sequence-parallel over the 'seq' axis (``distributed.engine``); the
batch splits over 'data' when it divides (``runtime.sharding.batch_spec``)
and every rank returns the whole batch. Every rank draws the prior and
the DDPM noise for the whole batch and keeps its own rows, so a sample
equals the single-device one by construction. The mesh fingerprint and
the spec join the runner key: a budget switch on a fixed mesh builds
nothing, a new mesh builds fresh runners.
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
from repro_torch.distributed import attention as dist_attn
from repro_torch.distributed.engine import SeqParallel, mesh_fingerprint
from repro_torch.models.common import dtype_of, tree_map
from repro_torch.pipeline.packed import PackLayout, make_packed_step_fn
from repro_torch.pipeline.plan import FLOW_SOLVERS, SamplingPlan
from repro_torch.runtime import graphs
from repro_torch.runtime.sharding import axis_sizes, batch_spec

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
                 sched: sch.DiffusionSchedule, device: Any = None,
                 mesh: Optional[Any] = None):
        assert cfg.family == "dit" and cfg.dit is not None, cfg.name
        self.device = resolve_device(device)
        self.mesh = mesh
        self.params = tree_map(lambda a: a.to(self.device), params)
        self.cfg = cfg
        self.sched = sched
        self._runners: Dict[Tuple, Callable] = {}
        self._nfes: Dict[Tuple, Callable] = {}
        # packed steps' captured micro-steps, by their key at k_steps=1
        self._micro: Dict[PackedStepKey, graphs.Captured] = {}
        self._merged: Dict[int, Params] = {}
        self._hits = 0
        self._misses = 0
        # serializes the miss check and the insert, so a background warm-up
        # thread (fleet.warmup) racing the serving thread on one key builds
        # it once and the counters stay exact
        self._cache_lock = threading.Lock()

    def set_mesh(self, mesh: Optional[Any]) -> None:
        """Attach or swap the device mesh. Runners are keyed by the mesh
        fingerprint: a new mesh builds new runners, a fixed mesh (any
        number of budget switches) builds none."""
        self.mesh = mesh

    def cache_stats(self) -> Dict[str, int]:
        """Runner-cache counters; ``compiled`` counts every runner and NFE
        function built, ``captured`` the CUDA graphs captured from them,
        ``replays`` their replays and ``graph_pool_bytes`` what their
        private memory pools hold."""
        with self._cache_lock:
            runners = list(self._runners.values()) + list(self._nfes.values())
            out = {"runners": len(self._runners),
                   "nfe_fns": len(self._nfes), "hits": self._hits,
                   "misses": self._misses, "compiled": self._misses}
        return {**out, **graphs.stats(runners)}

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
        """The cached runner of ``key``, built by ``build`` on a miss and
        wrapped for capture (``runtime.graphs``; eager over a mesh)."""
        cache = self._runners if cache is None else cache
        with self._cache_lock:
            if key in cache:
                self._hits += 1
            else:
                self._misses += 1
                runner = build()
                if not graphs.pieces(runner):
                    runner = graphs.capture(runner,
                                            eager=self.mesh is not None)
                cache[key] = runner
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

    @staticmethod
    def _phase_guidance(plan: SamplingPlan, mode: int) -> GuidanceConfig:
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
                       cache_split: Optional[int] = None,
                       engine: Optional[SeqParallel] = None) -> Callable:
        """The runner of a static plan: ``run(param_sets, x_T, cond,
        null_cond, text_mask, null_text_mask, noise[, masks])``, the DDPM
        noise drawn by the caller. With ``cache_split`` it carries the
        cross-step activation cache: the per-phase refresh masks are
        inputs (host numpy), so one runner serves every refresh policy at
        this (schedule, split) signature; it is a host loop over one
        captured NFE per phase, keyed by each step's refresh branch."""
        splits = schedule.split_timesteps(ts)
        set_idx = {m: i for i, m in
                   enumerate(self._param_set_modes(plan, schedule))}
        # the runner's closures hold no reference to the pipeline, which
        # holds the runner: a cycle would keep its graph pools alive until
        # the cyclic collector runs
        cfg, sched, guidance = self.cfg, self.sched, self._phase_guidance

        def phase_params(param_sets, mode, g):
            # the §3.4 guidance call runs at the weak mode: under merged
            # LoRA it must see that mode's merged weights
            gp = (param_sets[set_idx[g.mode_uncond]]
                  if g.kind == "weak_cond" and g.mode_uncond in set_idx
                  else None)
            return param_sets[set_idx.get(mode, 0)], gp

        if cache_split is not None:
            return self._cached_runner(plan, splits, phase_params,
                                       cache_split)

        def run(param_sets, x_T, cond, null_cond,  # repro: traced
                text_mask, null_text_mask, noise):
            phases = []
            for mode, tsub in splits:
                g = guidance(plan, mode)
                p, gp = phase_params(param_sets, mode, g)
                fn = make_eps_fn(p, cfg, cond, null_cond, g, text_mask,
                                 null_text_mask, guidance_params=gp,
                                 parallel=engine,
                                 attn_backend=plan.attn_backend)
                if transform is not None:
                    def fn(x, t, _f=fn):
                        eps, lv = _f(x, t)
                        return transform(eps, x, t), lv
                phases.append((fn, tsub))
            return sampler.sample_phased(phases, sched, x_T,
                                         solver=plan.solver,
                                         clip_x0=plan.clip_x0, noise=noise)

        return run

    def _cached_runner(self, plan: SamplingPlan, splits, phase_params,
                       cache_split: int) -> graphs.HostLoop:
        """The cached static runner: the sampler's host loop over one
        captured NFE per phase (``(refresh, (p, gp), x, t, delta, cond,
        null_cond, text_mask, null_text_mask)``, the refresh branch host
        data), the timestep an input."""
        cfg, sched, guidance = self.cfg, self.sched, self._phase_guidance
        eager = self.mesh is not None

        def nfe_of(mode):
            g = guidance(plan, mode)

            def nfe(refresh, pp, x, t, delta, cond,  # repro: traced
                    null_cond, text_mask, null_text_mask):
                fn = make_eps_fn(pp[0], cfg, cond, null_cond, g, text_mask,
                                 null_text_mask, guidance_params=pp[1],
                                 attn_backend=plan.attn_backend,
                                 cache_split=cache_split)
                return fn(x, t, delta, refresh)

            def host(pp, x, t, delta, refresh, *rest):
                return bool(refresh), (pp, x, t, delta) + rest
            return graphs.capture(nfe, host=host, name=f"cached_nfe_m{mode}",
                                  eager=eager)

        nfes = [nfe_of(mode) for mode, _ in splits]

        def loop(param_sets, x_T, cond, null_cond, text_mask, null_text_mask,
                 noise, masks):
            phases = []
            for i, (mode, tsub) in enumerate(splits):
                g = guidance(plan, mode)
                pp = phase_params(param_sets, mode, g)

                def fn(x, t, delta, refresh, _n=nfes[i], _pp=pp):
                    return _n(_pp, x, t, delta, refresh, cond, null_cond,
                              text_mask, null_text_mask)
                guided = g.scale != 0.0 and cond is not None
                delta0 = torch.zeros(
                    cache_apply.delta_shape(cfg, mode, x_T.shape[0], guided),
                    dtype=dtype_of(cfg.compute_dtype), device=x_T.device)
                phases.append((fn, tsub, masks[i], delta0))
            return sampler.sample_phased(phases, sched, x_T,
                                         solver=plan.solver,
                                         clip_x0=plan.clip_x0, noise=noise)

        return graphs.HostLoop(loop, nfes)

    def _flow_runner(self, plan: SamplingPlan, schedule: FlexiSchedule,
                     engine: Optional[SeqParallel] = None) -> Callable:
        """The runner of a flow plan: the τ ladder split across the
        schedule's phases, one velocity model per phase."""
        splits = flow.split_tau_ladder(flow.tau_ladder(plan.T),
                                       schedule.phases)
        set_idx = {m: i for i, m in
                   enumerate(self._param_set_modes(plan, schedule))}
        solver = "euler" if plan.solver == "flow_euler" else "heun"
        cfg = self.cfg

        def run(param_sets, x_T, cond):  # repro: traced
            phases = [(flow.make_flow_v_fn(param_sets[set_idx.get(mode, 0)],
                                           cfg, cond, mode=mode,
                                           parallel=engine,
                                           attn_backend=plan.attn_backend),
                       tsub) for mode, tsub in splits]
            return flow.sample_flow_phased(phases, x_T, solver=solver)

        return run

    def _nfe_fn(self, mode: int, scale: float,
                attn_backend: str = "auto") -> Callable:
        """One guided NFE at ``mode`` (adaptive plans)."""
        cfg = self.cfg
        g = GuidanceConfig(scale=scale, mode_cond=mode, mode_uncond=mode)

        def nfe(params, x, t, cond, null_cond, text_mask,  # repro: traced
                null_text_mask):
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

        def build():
            # one captured micro-step serves the layout at every depth k
            step = make_packed_step_fn(self.cfg, self.sched, **key._asdict())
            micro = self._micro.get(key._replace(k_steps=1))
            if micro is None:
                micro = self._micro[key._replace(k_steps=1)] = graphs.capture(
                    step.micro, host=lambda deep, *a: (deep, a),
                    name="packed_micro_step", eager=self.mesh is not None)

            def run(*args: Any, **kw: Any):
                branches, body_args = step.host(*args, **kw)
                return step.body(branches, *body_args, micro_fn=micro)
            return graphs.HostLoop(run, [micro])
        return self._lookup(key, build)

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
        engine = (SeqParallel.create(self.mesh, plan.parallel, self.cfg,
                                     attn_backend=plan.attn_backend)
                  if plan.parallel is not None else None)
        if noise is None and plan.solver == "ddpm":
            # drawn here, step by step as the sampler would draw them, so a
            # captured runner takes them as an input (and every rank of a
            # mesh draws the whole batch's)
            noise = torch.stack([
                torch.randn(x_T.shape, generator=generator,
                            device=self.device, dtype=x_T.dtype)
                for _ in range(len(ts))])
        rows = self._data_rows(n)
        if rows is not None:
            # every rank drew the whole batch's prior and DDPM noise: keep
            # this rank's rows of each
            if noise is not None:
                noise = noise[:, rows]
            x_T, y, null, text_mask, null_text_mask = (
                None if a is None else a[rows]
                for a in (x_T, y, null, text_mask, null_text_mask))
        # the mesh fingerprint joins the key: budget switches on a fixed
        # mesh reuse runners, a new mesh builds fresh ones
        sig = (plan.solver, plan.clip_x0, plan.guidance_scale,
               plan.guidance_kind, plan.weak_mode, variant,
               schedule.phases, tuple(int(t) for t in ts), eps_transform,
               plan.parallel, mesh_fingerprint(self.mesh), plan.attn_backend)
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
            x0 = self._gather_rows(runner(param_sets, x_T, y, null,
                                          text_mask, null_text_mask, noise,
                                          masks), rows)
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
                                  lambda: self._flow_runner(plan, schedule,
                                                            engine))
            x0 = runner(param_sets, x_T, y)
        else:
            runner = self._lookup(("static",) + sig,
                                  lambda: self._static_runner(
                                      plan, schedule, ts, eps_transform,
                                      engine=engine))
            x0 = runner(param_sets, x_T, y, null, text_mask, null_text_mask,
                        noise)
        x0 = self._gather_rows(x0, rows)
        return SampleResult(
            x0=x0, flops=plan.flops(self.cfg, batch=n),
            relative_compute=plan.relative_compute(self.cfg),
            trace={"schedule": schedule, "timesteps": ts})

    def _data_rows(self, n: int) -> Optional[slice]:
        """This rank's rows of an ``n``-sample batch when the batch splits
        over the mesh's 'data' axis (``batch_spec``: only when it
        divides), else None."""
        if self.mesh is None:
            return None
        axes = batch_spec(n, self.mesh)[0] or ()
        size = axis_sizes(self.mesh).get("data", 1)
        if "data" not in axes or size == 1:
            return None
        per = n // size
        lo = self.mesh.get_local_rank("data") * per
        return slice(lo, lo + per)

    def _gather_rows(self, x0: torch.Tensor,
                     rows: Optional[slice]) -> torch.Tensor:
        """The whole batch on every rank: the 'data' ranks' rows gathered
        in order."""
        if rows is None:
            return x0
        return dist_attn.all_gather(x0, self.mesh.get_group("data"), "x0",
                                    dim=0)

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
