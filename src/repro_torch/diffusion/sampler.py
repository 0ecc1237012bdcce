"""Sampling loops. A *phase* is (eps_fn, timesteps): the FlexiDiT inference
scheduler (``core.scheduler``) chains a weak phase and a powerful phase,
each a Python loop over its slice of the timestep ladder.

Randomness is explicit: DDPM phases take an optional noise tensor with one
standard-normal draw per step (``[n_steps, *x.shape]``), else draw each
step's noise from the given ``torch.Generator`` on the latents' device.

A DDIM or DDPM phase may carry the cross-step activation cache
(:class:`CacheCarry`): its eps_fn then also takes and returns the
deep-block residual, and each step's refresh flag is host data.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.diffusion import schedule as sch

# eps_fn(x_t, t[B]) -> (eps, logvar_frac | None)
EpsFn = Callable[[torch.Tensor, torch.Tensor],
                 Tuple[torch.Tensor, Optional[torch.Tensor]]]


@dataclasses.dataclass
class CacheCarry:
    """The activation cache's state through one phase: the host refresh
    flag of each step and the deep-block residual ``delta``, which each
    NFE replaces (``core.guidance.make_eps_fn`` with ``cache_split``)."""
    refresh: np.ndarray
    delta: torch.Tensor


def _nfe(eps_fn: Callable, x: torch.Tensor, tb: torch.Tensor, i: int,
         cache: Optional[CacheCarry]):
    if cache is None:
        return eps_fn(x, tb)
    eps, logvar, cache.delta = eps_fn(x, tb, cache.delta,
                                      bool(cache.refresh[i]))
    return eps, logvar


def _full(x: torch.Tensor, t: int) -> torch.Tensor:
    return torch.full((x.shape[0],), int(t), dtype=torch.int64, device=x.device)


def _draw(x: torch.Tensor, generator: Optional[torch.Generator]) -> torch.Tensor:
    return torch.randn(x.shape, generator=generator, device=x.device,
                       dtype=x.dtype)


def ddpm_phase(eps_fn: EpsFn, sched: sch.DiffusionSchedule, x: torch.Tensor,
               timesteps: np.ndarray, noise: Optional[torch.Tensor] = None,
               generator: Optional[torch.Generator] = None,
               clip_x0: float = 0.0,
               cache: Optional[CacheCarry] = None) -> torch.Tensor:
    """DDPM ancestral steps over the given (descending) timesteps."""
    for i, t in enumerate(timesteps):
        tb = _full(x, t)
        eps, logvar = _nfe(eps_fn, x, tb, i, cache)
        z = noise[i] if noise is not None else _draw(x, generator)
        x = sch.ddpm_step(sched, x, eps, tb, z, logvar, clip_x0)
    return x


def ddim_phase(eps_fn: EpsFn, sched: sch.DiffusionSchedule, x: torch.Tensor,
               timesteps: np.ndarray, eta: float = 0.0, t_final: int = -1,
               generator: Optional[torch.Generator] = None,
               cache: Optional[CacheCarry] = None) -> torch.Tensor:
    """``t_final``: the timestep the NEXT phase starts at (-1 = final x0
    step), so chained phases equal one un-split run."""
    ts_prev = list(timesteps[1:]) + [t_final]
    for i, (t, tp) in enumerate(zip(timesteps, ts_prev)):
        tb, tpb = _full(x, t), _full(x, tp)
        eps, _ = _nfe(eps_fn, x, tb, i, cache)
        z = _draw(x, generator) if eta > 0 else None
        x = sch.ddim_step(sched, x, eps, tb, tpb, eta, z)
    return x


def dpm2_phase(eps_fn: EpsFn, sched: sch.DiffusionSchedule, x: torch.Tensor,
               timesteps: np.ndarray, t_final: int = 0) -> torch.Tensor:
    ts_prev = list(timesteps[1:]) + [max(t_final, 0)]

    def eps_only(xx, tb):
        return eps_fn(xx, tb)[0]

    for t, tp in zip(timesteps, ts_prev):
        x = sch.dpm_solver2_step(sched, x, eps_only, _full(x, t), _full(x, tp))
    return x


def sample_phased(phases: Sequence[Tuple],  # repro: traced
                  sched: sch.DiffusionSchedule, x_T: torch.Tensor,
                  solver: str = "ddpm", clip_x0: float = 0.0,
                  generator: Optional[torch.Generator] = None,
                  noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Chain phases, each (eps_fn, its slice of the timestep ladder), or
    with the activation cache (eps_fn, timesteps, refresh mask, delta0).

    ``noise`` (DDPM only): ``[total_steps, *x_T.shape]`` standard-normal
    draws, consumed in step order across the phases."""
    if solver not in ("ddpm", "ddim", "dpm2"):
        raise ValueError(f"unknown solver {solver!r}")
    x = x_T
    active = [p for p in phases if len(p[1])]
    step = 0
    for i, (eps_fn, ts, *carry) in enumerate(active):
        cache = CacheCarry(*carry) if carry else None
        if cache is not None and solver == "dpm2":
            raise ValueError("cached sampling supports ddim|ddpm, got 'dpm2'")
        # boundary: hand the next phase's first timestep to the solver
        t_final = int(active[i + 1][1][0]) if i + 1 < len(active) else -1
        if solver == "ddpm":
            z = None if noise is None else noise[step:step + len(ts)]
            x = ddpm_phase(eps_fn, sched, x, ts, z, generator, clip_x0, cache)
        elif solver == "ddim":
            x = ddim_phase(eps_fn, sched, x, ts, t_final=t_final,
                           generator=generator, cache=cache)
        else:
            x = dpm2_phase(eps_fn, sched, x, ts, t_final=t_final)
        step += len(ts)
    return x
