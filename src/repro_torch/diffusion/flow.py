"""Rectified flow / flow matching, the port of ``repro.diffusion.flow``.

The paper notes FlexiDiT "is largely agnostic to the diffusion process and
can be applied out of the box for flow matching methods" (App. A). Linear
interpolation path x_τ = (1−τ)·x0 + τ·ε, velocity target v = ε − x0,
Euler/Heun integrators with the same *phased* structure as the diffusion
samplers, so the weak→powerful FlexiSchedule drops straight in.

τ convention: τ ∈ [0,1], τ=1 is pure noise (the diffusion-t direction, so
schedulers transfer unchanged); τ stays float32 and the model is
conditioned on ``τ·1000`` to reuse the timestep-embedding range. Each
phase is a Python loop over its (τ_hi, τ_lo) pairs.
"""
from __future__ import annotations

from typing import Any, Callable, List, Sequence, Tuple

import numpy as np
import torch

# v_fn(x, tau[B]) -> velocity prediction (= eps - x0 target)
VFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


def interpolate(x0: torch.Tensor, eps: torch.Tensor,
                tau: torch.Tensor) -> torch.Tensor:
    tau = tau.reshape((-1,) + (1,) * (x0.ndim - 1))
    return (1.0 - tau) * x0 + tau * eps


def velocity_target(x0: torch.Tensor, eps: torch.Tensor) -> torch.Tensor:
    return eps - x0


def flow_matching_loss(v_pred: torch.Tensor, x0: torch.Tensor,
                       eps: torch.Tensor) -> torch.Tensor:
    v = velocity_target(x0, eps)
    return torch.mean(torch.square(v_pred.float() - v.float()))


def tau_ladder(num_steps: int) -> np.ndarray:
    """Descending τ ladder 1 → 0 (sampling order), num_steps intervals."""
    return np.linspace(1.0, 0.0, num_steps + 1)


def _pairs(taus: np.ndarray) -> List[Tuple[float, float, float]]:
    """(τ_hi, τ_lo, τ_lo − τ_hi) of each interval in float32, as the
    reference feeds its scan; as Python floats they are exact, so the
    steps need no device scalars (products with a bf16 velocity are taken
    in float32, as there)."""
    t = np.asarray(taus, np.float32)
    return [(float(a), float(b), float(b - a)) for a, b in zip(t[:-1], t[1:])]


def _full(x: torch.Tensor, tau: float) -> torch.Tensor:
    return torch.full((x.shape[0],), tau, dtype=torch.float32, device=x.device)


def euler_phase(v_fn: VFn, x: torch.Tensor, taus: np.ndarray) -> torch.Tensor:
    """Integrate dx/dτ = v from taus[0] down to taus[-1] (Euler)."""
    for ta, _tb, dt in _pairs(taus):
        v = v_fn(x, _full(x, ta))
        x = x + dt * v.float()
    return x


def heun_phase(v_fn: VFn, x: torch.Tensor, taus: np.ndarray) -> torch.Tensor:
    """2nd-order Heun integrator (2 NFEs per step)."""
    for ta, tb, dt in _pairs(taus):
        v1 = v_fn(x, _full(x, ta))
        x_pred = x + dt * v1.float()
        v2 = v_fn(x_pred, _full(x, tb))
        # the sum keeps the model's dtype, as in the reference
        x = x + dt * 0.5 * (v1 + v2).float()
    return x


def sample_flow_phased(phases: Sequence[Tuple[VFn, np.ndarray]],  # repro: traced
                       x_T: torch.Tensor, solver: str = "euler") -> torch.Tensor:
    """Chain phases like ``diffusion.sampler.sample_phased``: each phase is
    (v_fn, its τ SUB-LADDER incl. its end point)."""
    fn = euler_phase if solver == "euler" else heun_phase
    x = x_T
    for v_fn, taus in phases:
        if len(taus) >= 2:
            x = fn(v_fn, x, taus)
    return x


def split_tau_ladder(taus: np.ndarray, phases: Sequence[Tuple[int, int]]
                     ) -> List[Tuple[int, np.ndarray]]:
    """Split a τ ladder across (mode, n_steps) phases, duplicating boundary
    points so each phase integrates a contiguous interval."""
    out, i = [], 0
    for mode, n in phases:
        out.append((mode, taus[i:i + n + 1]))
        i += n
    return out


def make_flow_v_fn(params: Any, cfg: Any, cond: Any, mode: int = 0,
                   parallel: Any = None, attn_backend: str = "auto") -> VFn:
    """Wrap a (learn_sigma=False) DiT as a velocity model: the τ∈[0,1] time
    is mapped onto the timestep-embedding range."""
    from repro_torch.models import dit as dit_mod

    def v_fn(x, tau):
        out = dit_mod.dit_forward(params, x, tau * 1000.0, cond, cfg,
                                  mode=mode, parallel=parallel,
                                  attn_backend=attn_backend)
        return dit_mod.eps_prediction(out, cfg)

    return v_fn
