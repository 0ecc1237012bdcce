"""DDPM noise schedule and per-step transition math (DiT / ADM conventions:
linear betas, ε-prediction, optional learned variance).

The schedule constants are host numpy (float64), exactly the reference's;
the steps gather them in float32 by a timestep tensor on the latents'
device. Random draws are the caller's: :func:`ddpm_step` and an η > 0
:func:`ddim_step` take their noise as a tensor, since torch cannot replay
the reference's threefry keys.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import numpy as np
import torch

from repro_torch.runtime import graphs


@dataclasses.dataclass(frozen=True)
class DiffusionSchedule:
    betas: np.ndarray                    # [T]

    @property
    def num_steps(self) -> int:
        return len(self.betas)

    @functools.cached_property
    def _derived(self):
        betas = self.betas.astype(np.float64)
        alphas = 1.0 - betas
        acp = np.cumprod(alphas)
        acp_prev = np.concatenate([[1.0], acp[:-1]])
        post_var = betas * (1.0 - acp_prev) / (1.0 - acp)
        return dict(
            alphas=alphas, acp=acp, acp_prev=acp_prev,
            sqrt_acp=np.sqrt(acp), sqrt_1macp=np.sqrt(1.0 - acp),
            post_var=post_var,
            post_log_var=np.log(np.maximum(post_var, 1e-20)),
            post_c0=betas * np.sqrt(acp_prev) / (1.0 - acp),
            post_ct=(1.0 - acp_prev) * np.sqrt(alphas) / (1.0 - acp),
            log_beta=np.log(np.maximum(betas, 1e-20)),
            lam=np.log(np.sqrt(acp) / np.maximum(np.sqrt(1.0 - acp), 1e-20)),
        )

    @functools.cached_property
    def _tables(self):
        return {}

    def table(self, name: str, device: torch.device) -> torch.Tensor:
        """A derived constant as a float32 tensor on ``device`` (cached)."""
        key = (name, str(device))
        if key not in self._tables:
            # a normal tensor even when first asked for under inference
            # mode: a training step may later save it for backward
            with torch.inference_mode(False):
                self._tables[key] = torch.as_tensor(
                    np.asarray(self._derived[name], np.float32), device=device)
        graphs.hold(self._tables[key])
        return self._tables[key]


def linear_schedule(T: int = 1000, beta_start: float = 1e-4,
                    beta_end: float = 0.02) -> DiffusionSchedule:
    return DiffusionSchedule(np.linspace(beta_start, beta_end, T,
                                         dtype=np.float64))


def cosine_schedule(T: int = 1000, s: float = 0.008) -> DiffusionSchedule:
    t = np.arange(T + 1) / T
    f = np.cos((t + s) / (1 + s) * np.pi / 2) ** 2
    acp = f / f[0]
    betas = np.clip(1 - acp[1:] / acp[:-1], 0, 0.999)
    return DiffusionSchedule(betas)


def respaced_timesteps(T: int, num_steps: int) -> np.ndarray:
    """Uniformly spaced subset of [0, T), descending (sampling order)."""
    ts = np.linspace(0, T - 1, num_steps).round().astype(np.int64)
    return ts[::-1].copy()


def _g(sched: DiffusionSchedule, name: str, t: torch.Tensor,
       ndim: int) -> torch.Tensor:
    """Gather a schedule constant at timesteps t [B] → [B, 1, ...]."""
    v = sched.table(name, t.device)[t.long()]
    return v.reshape(v.shape + (1,) * (ndim - v.ndim))


def q_sample(sched: DiffusionSchedule, x0: torch.Tensor, t: torch.Tensor,
             noise: torch.Tensor) -> torch.Tensor:
    """Corrupt x0 to timestep t: sqrt(acp_t)·x0 + sqrt(1 - acp_t)·noise
    (the float32 constants promote bf16 latents to float32, as in the
    reference)."""
    return (_g(sched, "sqrt_acp", t, x0.ndim) * x0
            + _g(sched, "sqrt_1macp", t, x0.ndim) * noise)


def predict_x0_from_eps(sched: DiffusionSchedule, x_t: torch.Tensor,
                        t: torch.Tensor, eps: torch.Tensor) -> torch.Tensor:
    return ((x_t - _g(sched, "sqrt_1macp", t, x_t.ndim) * eps)
            / _g(sched, "sqrt_acp", t, x_t.ndim))


def posterior_mean(sched: DiffusionSchedule, x0: torch.Tensor,
                   x_t: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    return (_g(sched, "post_c0", t, x_t.ndim) * x0
            + _g(sched, "post_ct", t, x_t.ndim) * x_t)


def ddpm_step(sched: DiffusionSchedule, x_t: torch.Tensor, eps: torch.Tensor,
              t: torch.Tensor, noise: torch.Tensor,
              logvar_frac: Optional[torch.Tensor] = None,
              clip_x0: float = 0.0) -> torch.Tensor:
    """One ancestral DDPM step x_t → x_{t-1} with the given standard-normal
    ``noise`` (shape of x_t). ``logvar_frac`` ∈ [-1, 1] (model output)
    interpolates log σ² between β̃ (posterior) and β."""
    x0 = predict_x0_from_eps(sched, x_t, t, eps)
    if clip_x0 > 0:
        x0 = torch.clamp(x0, -clip_x0, clip_x0)
    mean = posterior_mean(sched, x0, x_t, t)
    post_log_var = _g(sched, "post_log_var", t, x_t.ndim)
    if logvar_frac is not None:
        frac = (logvar_frac + 1.0) / 2.0
        logvar = (frac * _g(sched, "log_beta", t, x_t.ndim)
                  + (1 - frac) * post_log_var)
    else:
        logvar = post_log_var
    nonzero = (t > 0).to(x_t.dtype).reshape((-1,) + (1,) * (x_t.ndim - 1))
    return mean + nonzero * torch.exp(0.5 * logvar) * noise.to(x_t.dtype)


def ddim_step(sched: DiffusionSchedule, x_t: torch.Tensor, eps: torch.Tensor,
              t: torch.Tensor, t_prev: torch.Tensor, eta: float = 0.0,
              noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    acp_t = _g(sched, "acp", t, x_t.ndim)
    acp_prev = torch.where(t_prev.reshape(acp_t.shape) >= 0,
                           _g(sched, "acp", torch.clamp(t_prev, min=0), x_t.ndim),
                           1.0)
    x0 = predict_x0_from_eps(sched, x_t, t, eps)
    sigma = eta * torch.sqrt((1 - acp_prev) / (1 - acp_t)
                             * (1 - acp_t / acp_prev))
    dir_xt = torch.sqrt(torch.clamp(1 - acp_prev - sigma ** 2, min=0.0)) * eps
    x_prev = torch.sqrt(acp_prev) * x0 + dir_xt
    if eta > 0 and noise is not None:
        x_prev = x_prev + sigma * noise.to(x_t.dtype)
    return x_prev


def dpm_solver2_step(sched: DiffusionSchedule, x_t: torch.Tensor, eps_fn,
                     t: torch.Tensor, t_prev: torch.Tensor) -> torch.Tensor:
    """DPM-Solver-2 (midpoint) step using λ = log(√acp/√(1−acp))."""
    def at(name, tt):
        return _g(sched, name, torch.clamp(tt, min=0), x_t.ndim)

    lam_t, lam_s = at("lam", t), at("lam", t_prev)
    h = lam_s - lam_t
    # midpoint in λ-space → nearest integer timestep
    lam = sched.table("lam", x_t.device)
    t_mid = torch.argmin(torch.abs(lam[None, :] - (lam_t + h / 2).reshape(-1, 1)),
                         dim=-1)
    eps_t = eps_fn(x_t, t)
    x_mid = (at("sqrt_acp", t_mid) / at("sqrt_acp", t)) * x_t \
        - at("sqrt_1macp", t_mid) * torch.expm1(h / 2) * eps_t
    eps_mid = eps_fn(x_mid, t_mid)
    return (at("sqrt_acp", t_prev) / at("sqrt_acp", t)) * x_t \
        - at("sqrt_1macp", t_prev) * torch.expm1(h) * eps_mid
