"""Builders of the step functions — the port of ``repro.launch.steps``:
the DiT steps and the language models' prefill and decode steps (the
language-model train step comes with the next language-model slice).

Each DiT loss takes its random draws as arguments (``t``, ``noise``); the
step (:class:`repro_torch.optim.adamw.TrainStep`) draws them from a
``torch.Generator`` in the reference's shapes and dtypes, then takes
gradients and applies AdamW. Training runs the dense attention path, as
the reference does at 256 unsegmented tokens (no Pallas kernel of the
JAX package has a backward rule).
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig, TrainConfig
from repro_torch.diffusion import schedule as sch
from repro_torch.models import dit as dit_mod
from repro_torch.models import lm
from repro_torch.models.common import dtype_of
from repro_torch.optim.adamw import TrainStep

Params = Any


def make_train_step(*args: Any, **kw: Any) -> Callable:
    raise NotImplementedError("make_train_step (language-model training) "
                              "comes with the next language-model slice of "
                              "the port")


def make_prefill_step(cfg: ModelConfig, backend: str = "xla") -> Callable:
    """(params, inputs) → (last-position logits [B,V] float32, cache);
    ``inputs["tokens"]``: [B,S] int, with ``inputs["vision"]`` [B,
    vision_tokens, d] for the vision model and ``inputs["frames"]`` [B,
    audio_frames, d] for whisper. ``backend="pallas"`` runs on the flash
    kernel the attention the reference sends to its Pallas kernel (see
    ``models/lm.py``)."""
    def prefill_step(params, inputs):
        return lm.prefill(params, inputs["tokens"], cfg, extra=inputs,
                          backend=backend)
    return prefill_step


def make_decode_step(cfg: ModelConfig) -> Callable:
    """(params, cache, token [B,1], pos [B]) → (logits [B,V] float32,
    cache updated in place)."""
    def decode_step(params, cache, token, pos):
        return lm.decode_step(params, cache, token, pos, cfg)
    return decode_step


# ---------------------------------------------------------------------------
# DiT steps


def batch_x0(batch: Dict[str, torch.Tensor], cfg: ModelConfig) -> torch.Tensor:
    return batch["x0"].to(dtype_of(cfg.compute_dtype))


def draw_t_noise(x0: torch.Tensor, num_steps: int,
                 generator: torch.Generator
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """t ~ U{0..num_steps-1} [B] int32 and noise ~ N(0, 1) of x0's shape
    and dtype (the reference's ``split(key) → k_t, k_n`` draws)."""
    t = torch.randint(0, num_steps, (x0.shape[0],), generator=generator,
                      device=x0.device, dtype=torch.int32)
    noise = torch.randn(x0.shape, generator=generator, device=x0.device,
                        dtype=x0.dtype)
    return t, noise


def dit_loss(params: Params, batch: Dict[str, torch.Tensor], t: torch.Tensor,
             noise: torch.Tensor, cfg: ModelConfig,
             sched: sch.DiffusionSchedule, mode: int = 0
             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The denoising objective at patch ``mode``: ‖ε_θ(x_t, t) − noise‖²."""
    x0 = batch_x0(batch, cfg)
    x_t = sch.q_sample(sched, x0, t, noise)
    out = dit_mod.dit_forward(params, x_t, t, batch.get("cond"), cfg,
                              mode=mode)
    eps = dit_mod.eps_prediction(out, cfg)
    loss = torch.mean(torch.square(eps.float() - noise.float()))
    return loss, {"loss": loss}


def make_dit_train_step(cfg: ModelConfig, tc: TrainConfig,
                        sched: Optional[sch.DiffusionSchedule] = None,
                        mode: int = 0,
                        trainable: Optional[Params] = None) -> TrainStep:
    """Denoising-objective train step at a fixed patch mode. The FlexiDiT
    fine-tuning loop alternates modes across steps (one step object
    each), matching §4.1: 'learn to denoise using one of the available
    patch sizes'."""
    sched = sched or sch.linear_schedule(1000)

    def draw(batch, generator):
        t, noise = draw_t_noise(batch_x0(batch, cfg), sched.num_steps,
                                generator)
        return {"t": t, "noise": noise}

    def loss_fn(params, batch, t, noise):
        return dit_loss(params, batch, t, noise, cfg, sched, mode)

    return TrainStep(loss_fn, draw, tc, trainable)


def make_dit_serve_step(cfg: ModelConfig, mode_cond: int = 0,
                        mode_uncond: Optional[int] = None,
                        cfg_scale: float = 4.0) -> Callable:
    """One guided NFE (the unit of FlexiDiT sampling): conditional at
    ``mode_cond``, guidance at ``mode_uncond`` (paper §3.4)."""
    mode_uncond = mode_cond if mode_uncond is None else mode_uncond

    def serve_step(params, x_t, t, cond, null_cond):
        from repro_torch.core.guidance import GuidanceConfig, make_eps_fn
        kind = "uncond" if mode_cond == mode_uncond else "weak_cond"
        g = GuidanceConfig(scale=cfg_scale, mode_cond=mode_cond,
                           mode_uncond=mode_uncond, kind=kind)
        eps_fn = make_eps_fn(params, cfg, cond, null_cond, g)
        eps, logvar = eps_fn(x_t, t)
        return eps if logvar is None else (eps, logvar)

    return serve_step
