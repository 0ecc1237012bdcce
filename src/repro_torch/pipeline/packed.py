"""Step-granular packed runners, the port of ``repro.pipeline.packed``.

A :class:`PackLayout` is the static shape of ONE engine step: how many
requests of each patch mode advance together, whether CFG doubles each
request into a (conditional, unconditional) segment pair, and the token
capacity of each packed row. :func:`make_packed_step_fn` builds the step
for a layout: embed every segment at its own mode, pack rows with
block-diagonal attention (``core.packing.packed_mixed_forward``), combine
guidance, and apply one solver update per request at that request's own
``(t, t_prev)``. Timesteps, labels, latents, noise and refresh flags are
inputs, so a layout's runner serves any requests at any denoise steps;
``FlexiPipeline.packed_step`` caches runners beside its phase runners so
``cache_stats()`` counts bucket warm-up too.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import packing
from repro_torch.core.guidance import split_model_out
from repro_torch.diffusion import schedule as sch
from repro_torch.models import dit as dit_mod
from repro_torch.telemetry import taps as taps_mod

PACKED_SOLVERS = ("ddim", "ddpm")


@dataclasses.dataclass(frozen=True)
class PackLayout:
    """Static shape of one packed engine step.

    ``groups``: ``((mode, n_requests), ...)`` sorted by mode, all counts
    positive. ``guided``: CFG doubles every request into two segments.
    ``row_capacity``: tokens per packed row; 0 resolves to the mode-0
    sequence length.
    """
    groups: Tuple[Tuple[int, int], ...]
    guided: bool = True
    row_capacity: int = 0

    def __post_init__(self):
        if not self.groups:
            raise ValueError("layout needs at least one (mode, n) group")
        modes = [m for m, _ in self.groups]
        if sorted(modes) != modes or len(set(modes)) != len(modes):
            raise ValueError(f"groups must be mode-sorted and unique, "
                             f"got {self.groups}")
        if any(n < 1 for _, n in self.groups) or any(m < 0 for m in modes):
            raise ValueError(f"modes must be >= 0 and counts >= 1, "
                             f"got {self.groups}")

    @property
    def n_requests(self) -> int:
        return sum(n for _, n in self.groups)

    def capacity_for(self, m: int) -> int:
        """Request slots this layout offers at mode ``m``."""
        return dict(self.groups).get(m, 0)

    def resolve_capacity(self, cfg: ModelConfig) -> int:
        if self.row_capacity:
            return self.row_capacity
        return max([dit_mod.tokens_for_mode(cfg, 0)]
                   + [dit_mod.tokens_for_mode(cfg, m) for m, _ in self.groups])

    def segment_modes(self) -> Tuple[int, ...]:
        """Flat per-segment mode list (CFG doubling applied)."""
        mult = 2 if self.guided else 1
        out = []
        for m, n in self.groups:
            out.extend([m] * (mult * n))
        return tuple(out)

    def cost(self, cfg: ModelConfig,
             attn_backend: str = "dense") -> packing.MixedPackCost:
        """Rows / FLOPs / token ledger of one step at this layout."""
        return packing.mixed_pack_cost(cfg, self.segment_modes(),
                                       self.resolve_capacity(cfg),
                                       attn_backend=attn_backend)

    def attention_block_stats(self, cfg: ModelConfig) -> Tuple[int, int]:
        """(active, total) attention block-tile visits of one step at this
        layout under the segment-aware flash kernel."""
        return packing.pack_attention_block_stats(
            cfg, self.segment_modes(), self.resolve_capacity(cfg))

    @staticmethod
    def for_counts(counts: Dict[int, int], guided: bool = True,
                   row_capacity: int = 0) -> "PackLayout":
        groups = tuple(sorted((m, n) for m, n in counts.items() if n > 0))
        return PackLayout(groups=groups, guided=guided,
                          row_capacity=row_capacity)


def make_packed_step_fn(cfg: ModelConfig, sched: sch.DiffusionSchedule,
                        layout: PackLayout, *, solver: str = "ddim",
                        guidance_scale: float = 1.5,
                        clip_x0: float = 0.0,
                        k_steps: int = 1,
                        cache_split: Optional[int] = None,
                        attn_backend: str = "auto",
                        taps: bool = False) -> Callable:
    """Build ``step(params, xs, metas, noises)`` for a layout.

    Per group ``g`` (one per mode): ``xs[g]`` [n_g, F, H, W, C] latents;
    ``metas[g]`` [k, 3, n_g] int32 on the latents' device, rows ``(t,
    t_prev, cond)`` per micro-step, each request at its OWN denoise step
    (``t_prev = -1``: the final x0 step); ``noises[g]`` [k, n_g, F, H, W,
    C] per-request standard normals for DDPM's ancestral noise (``noises``
    may be None for DDIM). Returns one ``x`` tensor per group after
    ``k_steps`` solver updates, which run as a loop over the step body:
    the engine dispatches K consecutive same-mode denoise steps in one
    call, keeping join/leave at K-step granularity.

    ``cache_split`` enables the cross-step activation cache: the step
    becomes ``step(params, xs, metas, noises, deltas, refreshes) → (xs',
    deltas')`` where ``deltas[g]`` is [n_g, mult, N_mode, d] per-request
    deep-block residuals (mult = 2 under CFG) and ``refreshes[g]`` a host
    bool array [k, n_g]: each request's own staleness clock, so a K-deep
    dispatch refreshes exactly where the request's policy says, and the
    deep blocks of a micro-step run only if some request refreshes there
    (decided on the host, never by reading the device).

    The step is ``host`` then ``body`` (attributes of the returned
    function, with ``micro``, for ``runtime.graphs.capture``): ``host``
    checks the arguments and turns the flags into the branch pattern (one
    deep/shallow bool per micro-step, host data) and one bool tensor on
    the latents' device; ``body`` is a host loop over ``micro(deep,
    params, xs, meta_j, noise_j, deltas, flags_j)``, one micro-step, which
    does not depend on k: the pipeline captures it once per layout (and
    branch, on the cached family) for every depth k and refresh policy.

    ``taps`` appends telemetry outputs as pure extra data: the step
    returns ``(xs'[, deltas'], tap)`` where ``tap = {"eps_norm": ([k, n_g],
    ...), "finite": ([k, n_g], ...), "attn_blocks": (active, total)}`` plus
    ``"drift": ([k, n_g], ...)`` on the cached family (``telemetry/taps.py``).
    The tap tensors stay on the device; latents and deltas equal the
    untapped step's bit for bit (the taps only read them).
    """
    if solver not in PACKED_SOLVERS:
        raise ValueError(f"packed steps support solvers {PACKED_SOLVERS}, "
                         f"got {solver!r}")
    if cfg.dit.conditioning != "class":
        raise ValueError("packed steps currently serve class-conditioned "
                         "DiTs (text conditioning needs per-segment "
                         "cross-attention plumbing)")
    if k_steps < 1:
        raise ValueError(f"k_steps must be >= 1, got {k_steps}")
    if cache_split is not None and not 1 <= cache_split < cfg.num_layers:
        raise ValueError(f"cache_split {cache_split} must leave at least "
                         f"one deep block (model has {cfg.num_layers} "
                         f"layers)")
    guided = layout.guided
    if guided and guidance_scale == 0.0:
        raise ValueError("guided layout with guidance_scale=0; build an "
                         "unguided layout instead")
    null_label = cfg.dit.num_classes
    groups = layout.groups
    cap = layout.resolve_capacity(cfg)
    seg_groups = tuple((m, (2 if guided else 1) * n) for m, n in groups)
    cached = cache_split is not None
    # the kernel ledger's block counts are a layout constant: host ints
    blk_stats = layout.attention_block_stats(cfg) if taps else None

    seg_counts = [n for _m, n in seg_groups]

    def one_step(params, xs, metas, noises, deltas=None, flags=None,  # repro: traced
                 deep=False, tap=None):
        seg_xs, seg_ts, seg_conds = [], [], []
        seg_deltas = []
        for g, (mode, n) in enumerate(groups):
            t_g, cond_g = metas[g][0], metas[g][2]
            if guided:
                seg_xs.append(torch.cat([xs[g], xs[g]], dim=0))
                seg_ts.append(torch.cat([t_g, t_g], dim=0))
                null = torch.full((n,), null_label, dtype=cond_g.dtype,
                                  device=cond_g.device)
                seg_conds.append(torch.cat([cond_g, null], dim=0))
            else:
                seg_xs.append(xs[g])
                seg_ts.append(t_g)
                seg_conds.append(cond_g)
            if cached:
                # [n, mult, N, d] → segment order (all cond, then all
                # uncond) matching seg_xs; both branches share the clock
                d_g = deltas[g]
                seg_deltas.append(torch.cat(
                    [d_g[:, b] for b in range(d_g.shape[1])], dim=0))
        if cached:
            outs, new_seg = packing.packed_mixed_forward(
                params, cfg, seg_groups, seg_xs, seg_ts, seg_conds,
                row_capacity=cap, cache_deltas=seg_deltas,
                cache_refresh=torch.split(flags, seg_counts),
                cache_split=cache_split, cache_deep=deep,
                attn_backend=attn_backend)
            new_deltas = tuple(
                torch.stack(torch.chunk(new_seg[g], deltas[g].shape[1],
                                        dim=0), dim=1)
                for g in range(len(groups)))
        else:
            outs = packing.packed_mixed_forward(
                params, cfg, seg_groups, seg_xs, seg_ts, seg_conds,
                row_capacity=cap, attn_backend=attn_backend)
        x_prevs = []
        for g, (mode, n) in enumerate(groups):
            t_g, tp_g = metas[g][0], metas[g][1]
            eps, logvar = split_model_out(outs[g], cfg)
            if guided:
                e_c, e_u = torch.chunk(eps, 2, dim=0)
                eps_g = e_u + guidance_scale * (e_c - e_u)
                lv = None if logvar is None else torch.chunk(logvar, 2,
                                                             dim=0)[0]
            else:
                eps_g, lv = eps, logvar
            if tap is not None:
                tap["eps_norm"][g].append(taps_mod.eps_norm_tap(eps_g))
            if solver == "ddim":
                x_prev = sch.ddim_step(sched, xs[g], eps_g, t_g, tp_g,
                                       0.0, None)
            else:
                # per-request ancestral noise, as an n=1 pipeline batch
                # draws it
                x_prev = sch.ddpm_step(sched, xs[g], eps_g, t_g, noises[g],
                                       lv, clip_x0)
            x_prevs.append(x_prev)
            if tap is not None:
                tap["finite"][g].append(taps_mod.finite_tap(x_prev))
                if cached:
                    # new_delta is the fresh residual at refresh steps and
                    # the old one at skip steps: the realized replay drift
                    tap["drift"][g].append(
                        taps_mod.drift_tap(new_deltas[g], deltas[g]))
        if cached:
            return tuple(x_prevs), new_deltas
        return tuple(x_prevs)

    def host(params: Any, xs: Sequence[torch.Tensor],
             metas: Sequence[torch.Tensor],
             noises: Optional[Sequence[Optional[torch.Tensor]]] = None,
             deltas: Optional[Sequence[torch.Tensor]] = None,
             refreshes: Optional[Sequence[Any]] = None):
        if solver == "ddpm" and (noises is None
                                 or any(z is None for z in noises)):
            raise ValueError("DDPM packed steps need per-request noise "
                             "[k, n_g, *latent] for every group")
        if cached and (deltas is None or refreshes is None):
            raise ValueError("cached packed steps need deltas and refresh "
                             "flags")
        noises = tuple(noises) if solver == "ddpm" else None
        if not cached:
            return (), (params, tuple(xs), tuple(metas), noises, None, None)
        rf = [packing._host_flags(r).reshape(k_steps, -1) for r in refreshes]
        # segment order: a group's cond segments, then its uncond ones
        # (both branches share the request's clock)
        seg = np.concatenate([np.concatenate([r, r], axis=1) if guided
                              else r for r in rf], axis=1)
        branches = tuple(bool(b) for b in seg.any(axis=1))
        flags = torch.from_numpy(seg).to(xs[0].device)
        return branches, (params, tuple(xs), tuple(metas), noises,
                          tuple(deltas), flags)

    names = ("eps_norm", "finite") + (("drift",) if cached else ())

    def micro(deep, params, xs, m_j, z_j, deltas, flags_j):  # repro: traced
        """One micro-step, at branch ``deep`` on the cached family:
        ``(xs', deltas', taps)`` (deltas None uncached), ``taps`` one
        tensor a group per tap, or None."""
        tap = ({n: [[] for _ in groups] for n in names} if taps else None)
        if cached:
            xs, deltas = one_step(params, xs, m_j, z_j, deltas, flags_j,
                                  deep, tap)
        else:
            xs = one_step(params, xs, m_j, z_j, tap=tap)
        if tap is not None:
            tap = {n: tuple(v[0] for v in tap[n]) for n in names}
        return xs, deltas, tap

    def body(branches, params, xs, metas, noises, deltas, flags,
             micro_fn=micro):
        """The k micro-steps, a host loop over ``micro_fn``."""
        tap = ({n: [[] for _ in groups] for n in names} if taps else None)
        for j in range(k_steps):
            m_j = tuple(m[j] for m in metas)
            z_j = (tuple(z[j] for z in noises) if solver == "ddpm"
                   else None)
            xs, deltas, tap_j = micro_fn(branches[j] if cached else False,
                                         params, xs, m_j, z_j, deltas,
                                         flags[j] if cached else None)
            for n in names if taps else ():
                for g in range(len(groups)):
                    tap[n][g].append(tap_j[n][g])
        out = (xs, deltas) if cached else (xs,)
        if taps:
            # per group, one [k, n_g] tensor per tap (micro-steps stacked)
            tap = {n: tuple(torch.stack(v) for v in tap[n]) for n in names}
            tap["attn_blocks"] = blk_stats
            out += (tap,)
        return out if cached or taps else xs

    def step(*args: Any, **kw: Any):
        branches, body_args = host(*args, **kw)
        return body(branches, *body_args)

    step.host, step.body, step.micro = host, body, micro
    return step
