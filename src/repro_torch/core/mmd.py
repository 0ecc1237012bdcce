"""Bootstrapped MMD distribution-matching loss (App. B.1) — the port of
``repro.core.mmd``.

Corrects weak-model exposure bias for the shared-parameters recipe: run a
short denoising chain from t_start → t_end (first steps with the weak mode,
rest with the powerful mode — mirroring the inference scheduler), and match
the distribution of the chain's output against real images corrupted
directly to t_end, via RBF-kernel maximum mean discrepancy.

Timestep sampling is biased toward small t (where the measured MMD gap is
largest — Fig. 11 left), as in the paper. The losses take their draws as
arguments (``u``, the start and target noises, one noise per chain step);
:func:`draw_mmd` draws them in the reference's shapes and dtypes.

Handed placed parameters, the step is the sharded one
(``optim/adamw.TrainStep``): each rank runs the chains of its rows, and
the MMD is the reference's statistic of the global batch. Both samples
are joined over the data axes (``data_gather``) before the kernel sums,
the default targets are the global batch reversed, and the denoising
term is the global mean (``data_mean``).
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.configs.base import ModelConfig, TrainConfig
from repro_torch.diffusion import schedule as sch
from repro_torch.launch.steps import batch_x0, draw_t_noise
from repro_torch.models import dit as dit_mod
from repro_torch.optim.adamw import TrainStep
from repro_torch.runtime import placement as plc
from repro_torch.runtime.sharding import current_mesh, data_gather, data_mean


def rbf_mmd2(x: torch.Tensor, y: torch.Tensor,
             bandwidths: Sequence[float] = (1.0, 2.0, 4.0, 8.0)
             ) -> torch.Tensor:
    """Unbiased-ish MMD² with a mixture of RBF kernels. x,y: [B, D]."""
    x = x.float()
    y = y.float()

    def pdist2(a, b):
        return (torch.sum(a * a, 1)[:, None] + torch.sum(b * b, 1)[None]
                - 2.0 * a @ b.T)

    dxx, dyy, dxy = pdist2(x, x), pdist2(y, y), pdist2(x, y)
    # median-heuristic bandwidth: not a differentiation target
    flat = torch.sort(dxy.detach().reshape(-1)).values
    med = flat[flat.shape[0] // 2] + 1e-6
    total = 0.0
    n = x.shape[0]
    for bw in bandwidths:
        g = 1.0 / (bw * med)
        kxx = torch.exp(-g * dxx)
        kyy = torch.exp(-g * dyy)
        kxy = torch.exp(-g * dxy)
        total = total + (torch.sum(kxx) - n) / (n * (n - 1)) \
            + (torch.sum(kyy) - n) / (n * (n - 1)) \
            - 2.0 * torch.mean(kxy)
    return total


def _chain_denoise(params: Any, x: torch.Tensor, cond: Any, cfg: ModelConfig,
                   sched: sch.DiffusionSchedule, timesteps: torch.Tensor,
                   modes: Sequence[int],
                   chain_noise: Sequence[torch.Tensor]) -> torch.Tensor:
    """Run len(modes) DDPM steps with per-step (static) patch modes; step
    i adds ``chain_noise[i]``."""
    for i, mode in enumerate(modes):
        t = timesteps[:, i]
        out = dit_mod.dit_forward(params, x, t, cond, cfg, mode=mode)
        eps = dit_mod.eps_prediction(out, cfg)
        logvar = out[..., cfg.dit.latent_shape[-1]:] if cfg.dit.learn_sigma else None
        x = sch.ddpm_step(sched, x, eps, t, chain_noise[i], logvar)
    return x


def draw_mmd(x0: torch.Tensor, generator: torch.Generator,
             n_chain: int) -> Dict[str, Any]:
    """The bootstrap's draws (the reference's ``split(key, 4)`` → u, the
    start noise, the target noise, and ``fold_in(k_c, i)`` per chain
    step): u [B] float32, two noises of x0's shape and dtype, and
    ``n_chain`` noises of the chain's dtype (x0's promoted by the float32
    schedule constants)."""
    dev = x0.device
    u = torch.rand((x0.shape[0],), generator=generator, device=dev)
    noise1 = torch.randn(x0.shape, generator=generator, device=dev,
                         dtype=x0.dtype)
    noise2 = torch.randn(x0.shape, generator=generator, device=dev,
                         dtype=x0.dtype)
    chain_dtype = torch.promote_types(x0.dtype, torch.float32)
    chain = [torch.randn(x0.shape, generator=generator, device=dev,
                         dtype=chain_dtype) for _ in range(n_chain)]
    return {"u": u, "noise1": noise1, "noise2": noise2, "chain_noise": chain}


def bootstrap_mmd_loss(params: Any, batch: Dict[str, torch.Tensor],
                       u: torch.Tensor, noise1: torch.Tensor,
                       noise2: torch.Tensor,
                       chain_noise: Sequence[torch.Tensor], cfg: ModelConfig,
                       sched: sch.DiffusionSchedule, *,
                       n_weak: int = 2, n_powerful: int = 2,
                       weak_mode: int = 1, t_bias: float = 2.0
                       ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Fig. 11 (right): corrupt x̃0 to t_start, denoise n_weak weak steps then
    n_powerful powerful steps down to t_end, and MMD-match against q(x_{t_end}|x0)
    samples of independent reals."""
    x0 = batch_x0(batch, cfg)
    if "x0_target" in batch:
        x0_other = batch["x0_target"].to(x0.dtype)
    else:           # this rank's rows of the global batch reversed
        x0_other = torch.flip(data_gather(x0), [0])
        mesh = current_mesh()
        if mesh is not None:
            x0_other = plc.take_rows(x0_other, x0_other.shape[0], mesh)
    B = x0.shape[0]
    n_chain = n_weak + n_powerful

    # biased sampling of t_end toward 0 (MMD gap grows near x0)
    t_end = (u ** t_bias * (sched.num_steps - n_chain - 1)).to(torch.int32)
    steps = t_end[:, None] + torch.arange(n_chain, 0, -1, device=u.device,
                                          dtype=torch.int32)[None]
    t_start = steps[:, 0]

    x_t = sch.q_sample(sched, x0, t_start, noise1)
    modes = [weak_mode] * n_weak + [0] * n_powerful
    x_pred = _chain_denoise(params, x_t, batch.get("cond"), cfg, sched,
                            steps, modes, chain_noise)

    x_target = sch.q_sample(sched, x0_other, t_end, noise2)

    loss = rbf_mmd2(data_gather(x_pred.reshape(B, -1)),
                    data_gather(x_target.reshape(B, -1)))
    return loss, {"mmd_loss": loss}


def mmd_finetune_loss(params: Any, batch: Dict[str, torch.Tensor],
                      t: torch.Tensor, noise: torch.Tensor, u: torch.Tensor,
                      noise1: torch.Tensor, noise2: torch.Tensor,
                      chain_noise: List[torch.Tensor], cfg: ModelConfig,
                      sched: sch.DiffusionSchedule, *,
                      denoise_weight: float = 1.0, mmd_weight: float = 0.1,
                      weak_mode: int = 1, train_mode: int = 0
                      ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The denoising loss at ``train_mode`` plus the weighted bootstrap."""
    x0 = batch_x0(batch, cfg)
    x_t = sch.q_sample(sched, x0, t, noise)
    out = dit_mod.dit_forward(params, x_t, t, batch.get("cond"), cfg,
                              mode=train_mode)
    eps = dit_mod.eps_prediction(out, cfg).float()
    den = data_mean(torch.mean(torch.square(eps - noise.float())))
    mmd, _ = bootstrap_mmd_loss(params, batch, u, noise1, noise2, chain_noise,
                                cfg, sched, weak_mode=weak_mode)
    loss = denoise_weight * den + mmd_weight * mmd
    return loss, {"denoise_loss": den, "mmd_loss": mmd}


def make_mmd_finetune_step(cfg: ModelConfig, tc: TrainConfig,
                           sched: Optional[sch.DiffusionSchedule] = None,
                           denoise_weight: float = 1.0,
                           mmd_weight: float = 0.1,
                           weak_mode: int = 1, train_mode: int = 0
                           ) -> TrainStep:
    """Shared-params recipe (§4.1): standard denoising loss at a (per-step
    static) patch mode + the bootstrapped MMD correction. Draws in the
    reference's order: t and noise, then the bootstrap's (:func:`draw_mmd`,
    a chain of 2 weak + 2 powerful steps)."""
    sched = sched or sch.linear_schedule(1000)

    def draw(batch, generator):
        x0 = batch_x0(batch, cfg)
        t, noise = draw_t_noise(x0, sched.num_steps, generator)
        return {"t": t, "noise": noise, **draw_mmd(x0, generator, 4)}

    def loss_fn(params, batch, **draws):
        return mmd_finetune_loss(params, batch, cfg=cfg, sched=sched,
                                 denoise_weight=denoise_weight,
                                 mmd_weight=mmd_weight, weak_mode=weak_mode,
                                 train_mode=train_mode, **draws)

    return TrainStep(loss_fn, draw, tc,
                     stacked=plc.stacked_leaves(dit_mod.dit_schema(cfg)))
