"""Cached sampling loops, the port of ``repro.cache.apply``.

The activation cache rides on the uncached path: ``core.guidance.
make_eps_fn`` with ``cache_split`` builds the per-phase ``eps_fn_c(x, t,
delta, refresh) → (eps, logvar, new_delta)`` (plain and vanilla-CFG
branches; weak_cond guidance mixes patch modes inside one step and is
refused), and ``diffusion.sampler``'s DDIM/DDPM phase loops carry the
deep-block residual delta from step to step (``sampler.CacheCarry``).
The names below are the reference's.

The refresh mask is host data (numpy bool per step), never part of a
runner's key: one runner serves every policy, interval and threshold, and
each step's deep-block branch is decided on the host. A refresh-every-step
run takes the uncached run's steps and noise draws, so it equals the
uncached pipeline bit for bit.
"""
from __future__ import annotations

from typing import Any, Callable, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.guidance import GuidanceConfig, make_eps_fn
from repro_torch.diffusion import sampler
from repro_torch.diffusion import schedule as sch
from repro_torch.models import dit as dit_mod

# eps_fn_c(x, t[B], delta, refresh) -> (eps, logvar | None, new_delta)
CachedEpsFn = Callable[[torch.Tensor, torch.Tensor, torch.Tensor, bool], Tuple]


def eff_batch(guided: bool, n: int) -> int:
    """Leading dim of the delta carry: CFG doubles the token stream."""
    return 2 * n if guided else n


def delta_shape(cfg: ModelConfig, mode: int, batch: int, guided: bool
                ) -> Tuple[int, int, int]:
    return (eff_batch(guided, batch),
            dit_mod.tokens_for_mode(cfg, mode), cfg.d_model)


def make_cached_eps_fn(params: Any, cfg: ModelConfig, cond: Any,
                       null_cond: Any, g: GuidanceConfig,
                       text_mask: Optional[torch.Tensor],
                       null_text_mask: Optional[torch.Tensor],
                       split: int,
                       attn_backend: str = "auto") -> CachedEpsFn:
    """``make_eps_fn`` with the activation cache split after block
    ``split``."""
    return make_eps_fn(params, cfg, cond, null_cond, g, text_mask,
                       null_text_mask, attn_backend=attn_backend,
                       cache_split=split)


def cached_ddim_phase(eps_fn_c: CachedEpsFn, sched: sch.DiffusionSchedule,
                      x: torch.Tensor, timesteps: np.ndarray,
                      refresh: np.ndarray, delta0: torch.Tensor,
                      t_final: int = -1) -> torch.Tensor:
    return sampler.ddim_phase(eps_fn_c, sched, x, timesteps, t_final=t_final,
                              cache=sampler.CacheCarry(refresh, delta0))


def cached_ddpm_phase(eps_fn_c: CachedEpsFn, sched: sch.DiffusionSchedule,
                      x: torch.Tensor, timesteps: np.ndarray,
                      refresh: np.ndarray, delta0: torch.Tensor,
                      noise: Optional[torch.Tensor] = None,
                      generator: Optional[torch.Generator] = None,
                      clip_x0: float = 0.0) -> torch.Tensor:
    return sampler.ddpm_phase(eps_fn_c, sched, x, timesteps, noise, generator,
                              clip_x0, sampler.CacheCarry(refresh, delta0))


def sample_phased_cached(phases: Sequence[Tuple[CachedEpsFn, np.ndarray,
                                                np.ndarray, torch.Tensor]],
                         sched: sch.DiffusionSchedule, x_T: torch.Tensor,
                         solver: str = "ddim", clip_x0: float = 0.0,
                         generator: Optional[torch.Generator] = None,
                         noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Chain cached phases, each ``(eps_fn_c, timesteps, refresh_mask,
    delta0)``, as ``sampler.sample_phased`` chains uncached ones."""
    if solver not in ("ddim", "ddpm"):
        raise ValueError(f"cached sampling supports ddim|ddpm, got {solver!r}")
    return sampler.sample_phased(phases, sched, x_T, solver=solver,
                                 clip_x0=clip_x0, generator=generator,
                                 noise=noise)
