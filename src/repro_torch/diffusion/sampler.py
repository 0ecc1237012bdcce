"""Sampling loops. A *phase* is (eps_fn, timesteps): the FlexiDiT inference
scheduler (``core.scheduler``) chains a weak phase and a powerful phase,
each a Python loop over its slice of the timestep ladder.

Randomness is explicit: DDPM phases take an optional noise tensor with one
standard-normal draw per step (``[n_steps, *x.shape]``), else draw each
step's noise from the given ``torch.Generator`` on the latents' device.
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.diffusion import schedule as sch

# eps_fn(x_t, t[B]) -> (eps, logvar_frac | None)
EpsFn = Callable[[torch.Tensor, torch.Tensor],
                 Tuple[torch.Tensor, Optional[torch.Tensor]]]


def _full(x: torch.Tensor, t: int) -> torch.Tensor:
    return torch.full((x.shape[0],), int(t), dtype=torch.int64, device=x.device)


def _draw(x: torch.Tensor, generator: Optional[torch.Generator]) -> torch.Tensor:
    return torch.randn(x.shape, generator=generator, device=x.device,
                       dtype=x.dtype)


def ddpm_phase(eps_fn: EpsFn, sched: sch.DiffusionSchedule, x: torch.Tensor,
               timesteps: np.ndarray, noise: Optional[torch.Tensor] = None,
               generator: Optional[torch.Generator] = None,
               clip_x0: float = 0.0) -> torch.Tensor:
    """DDPM ancestral steps over the given (descending) timesteps."""
    for i, t in enumerate(timesteps):
        tb = _full(x, t)
        eps, logvar = eps_fn(x, tb)
        z = noise[i] if noise is not None else _draw(x, generator)
        x = sch.ddpm_step(sched, x, eps, tb, z, logvar, clip_x0)
    return x


def ddim_phase(eps_fn: EpsFn, sched: sch.DiffusionSchedule, x: torch.Tensor,
               timesteps: np.ndarray, eta: float = 0.0, t_final: int = -1,
               generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """``t_final``: the timestep the NEXT phase starts at (-1 = final x0
    step), so chained phases equal one un-split run."""
    ts_prev = list(timesteps[1:]) + [t_final]
    for t, tp in zip(timesteps, ts_prev):
        tb, tpb = _full(x, t), _full(x, tp)
        eps, _ = eps_fn(x, tb)
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


def sample_phased(phases: Sequence[Tuple[EpsFn, np.ndarray]],
                  sched: sch.DiffusionSchedule, x_T: torch.Tensor,
                  solver: str = "ddpm", clip_x0: float = 0.0,
                  generator: Optional[torch.Generator] = None,
                  noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Chain phases, each (eps_fn, its slice of the timestep ladder).

    ``noise`` (DDPM only): ``[total_steps, *x_T.shape]`` standard-normal
    draws, consumed in step order across the phases."""
    if solver not in ("ddpm", "ddim", "dpm2"):
        raise ValueError(f"unknown solver {solver!r}")
    x = x_T
    active = [(f, ts) for f, ts in phases if len(ts)]
    step = 0
    for i, (eps_fn, ts) in enumerate(active):
        # boundary: hand the next phase's first timestep to the solver
        t_final = int(active[i + 1][1][0]) if i + 1 < len(active) else -1
        if solver == "ddpm":
            z = None if noise is None else noise[step:step + len(ts)]
            x = ddpm_phase(eps_fn, sched, x, ts, z, generator, clip_x0)
        elif solver == "ddim":
            x = ddim_phase(eps_fn, sched, x, ts, t_final=t_final,
                           generator=generator)
        else:
            x = dpm2_phase(eps_fn, sched, x, ts, t_final=t_final)
        step += len(ts)
    return x
