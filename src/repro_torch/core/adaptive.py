"""Adaptive per-sample inference scheduler, the port of
``repro.core.adaptive`` (the extension the paper marks as future work,
App. A: "adapting the inference scheduler ... based on the requirements of
each sample").

At probe steps both modes run on the same latent and the relative
prediction gap ‖ε_w − ε_p‖²/‖ε_p‖² is measured. While the gap stays at or
below ``threshold`` the sampler stays in the weak mode; the first probe
over it switches to powerful for all remaining steps.

The weak loop takes solver steps from the probe's ε (never recomputed), so
the FLOPs ledger matches what ran. Under CFG (``guided=True``) every model
call costs 2 NFEs, and ``flops_static_powerful`` uses the same multiplier.

The probe loop is host control flow. The (t, t_next) ladder goes to the
device once, up front, and each probe reads one device scalar (the gap):
the one host read per probe, as in the reference. DDPM noise comes from a
``torch.Generator`` on the latents' device, or is handed over as
``noise[T, *x.shape]`` (one draw per ladder step; the powerful tail after a
switch consumes the draws of its own steps).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.scheduler import dit_nfe_flops, lora_nfe_overhead
from repro_torch.diffusion import sampler
from repro_torch.diffusion import schedule as sch


def relative_gap(e_w: torch.Tensor, e_p: torch.Tensor) -> torch.Tensor:
    """Relative prediction gap ‖ε_w − ε_p‖²/‖ε_p‖² as one device scalar
    (float32)."""
    e_w, e_p = e_w.float(), e_p.float()
    num = torch.mean(torch.square(e_w - e_p))
    den = torch.clamp(torch.mean(torch.square(e_p)), min=1e-12)
    return num / den


@dataclasses.dataclass
class AdaptiveResult:
    x0: torch.Tensor
    switch_step: int            # index in the ladder where powerful took over
    gaps: List[float]           # measured relative gaps at probe steps
    flops: float                # FLOPs spent (incl. probe overhead)
    flops_static_powerful: float


def adaptive_sample(eps_fns: Sequence[Callable], sched: sch.DiffusionSchedule,
                    x_T: torch.Tensor, timesteps: np.ndarray,
                    cfg: ModelConfig, *, threshold: float = 0.35,
                    probe_every: int = 2, weak_mode: int = 1,
                    solver: str = "ddim", guided: bool = True,
                    lora_unmerged: bool = False,
                    generator: Optional[torch.Generator] = None,
                    noise: Optional[torch.Tensor] = None) -> AdaptiveResult:
    """eps_fns[mode] -> (eps, logvar) at that patch mode.

    ``guided``: the eps_fns implement CFG (two NFEs of compute per call).
    ``lora_unmerged``: the weak NFEs pay the LoRA adapter FLOPs. Solvers:
    'ddim' | 'ddpm' (single-ε steps, so each weak step reuses the probe's
    prediction). Returns the sample plus the decision trace and FLOPs."""
    if solver not in ("ddim", "ddpm"):
        raise ValueError(f"adaptive_sample supports 'ddim'|'ddpm' (single-ε "
                         f"steps, probe reuse), got {solver!r}")
    T = len(timesteps)
    B = x_T.shape[0]
    x = x_T
    gaps: List[float] = []
    switch = T
    mult = 2.0 if guided else 1.0               # CFG: 2 NFEs per model call
    f_weak = mult * dit_nfe_flops(cfg, weak_mode)
    if lora_unmerged:
        f_weak += mult * lora_nfe_overhead(cfg, weak_mode)
    f_pow = mult * dit_nfe_flops(cfg, 0)
    flops = 0.0
    # the whole (t, t_next) ladder goes to the device once, up front: the
    # loop below only indexes it
    ts_host = np.asarray(timesteps, dtype=np.int64)
    tnext_host = np.concatenate([ts_host[1:], np.array([-1], np.int64)])
    ladder = torch.from_numpy(np.stack([ts_host, tnext_host])).to(x.device)
    tb_all = ladder[0][:, None].expand(T, B)
    tnb_all = ladder[1][:, None].expand(T, B)

    def draw(i: int) -> torch.Tensor:
        if noise is not None:
            return noise[i]
        return torch.randn(x.shape, generator=generator, device=x.device,
                           dtype=x.dtype)

    for i in range(T):
        tb = tb_all[i]
        e_w, lv_w = eps_fns[weak_mode](x, tb)
        flops += f_weak * B
        if i % probe_every == 0:
            e_p, _ = eps_fns[0](x, tb)
            flops += f_pow * B
            # one reduction, one host read: the switch is host control flow
            gap = float(relative_gap(e_w, e_p))
            gaps.append(gap)
            if gap > threshold:
                switch = i
                break
        # take the weak step from the ε just computed (probe or not)
        if solver == "ddim":
            x = sch.ddim_step(sched, x, e_w, tb, tnb_all[i])
        else:
            x = sch.ddpm_step(sched, x, e_w, tb, draw(i), lv_w)

    if switch < T:
        tail_noise = None
        if solver == "ddpm":
            tail_noise = (noise[switch:] if noise is not None else
                          torch.stack([draw(i) for i in range(switch, T)]))
        x = sampler.sample_phased([(eps_fns[0], timesteps[switch:])], sched,
                                  x, solver=solver, noise=tail_noise)
        flops += f_pow * B * (T - switch)

    return AdaptiveResult(
        x0=x, switch_step=switch, gaps=gaps, flops=flops,
        flops_static_powerful=f_pow * B * T)


def make_mode_eps_fns(params: Any, cfg: ModelConfig, cond: Any, null_cond: Any,
                      cfg_scale: float = 1.5,
                      attn_backend: str = "auto") -> List[Callable]:
    """Per-mode guided NFEs (one per patch mode, as in §3.3)."""
    from repro_torch.core.guidance import GuidanceConfig, make_eps_fn
    fns = []
    for mode in range(1 + len(cfg.dit.flex_patch_sizes)):
        g = GuidanceConfig(scale=cfg_scale, mode_cond=mode, mode_uncond=mode)
        fns.append(make_eps_fn(params, cfg, cond, null_cond, g,
                               attn_backend=attn_backend))
    return fns
