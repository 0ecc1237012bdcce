"""Distillation fine-tuning for the LoRA recipe (§3.2) — the port of
``repro.core.distill``.

Train to minimize  E‖ε_θ(x_t; p_powerful) − ε_θ(x_t; p_weak)‖²  where the
teacher (powerful mode, no LoRAs) is frozen: its pass runs under
``torch.no_grad()`` on the same tensors (the reference's
``stop_gradient(params)``) and contributes no gradient.

Handed placed parameters, the step is the sharded one
(``optim/adamw.TrainStep``): the loss is the mean over the global batch
(``data_mean``), as the reference's ``jnp.mean`` over its sharded batch.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig, TrainConfig
from repro_torch.diffusion import schedule as sch
from repro_torch.launch.steps import batch_x0, draw_t_noise
from repro_torch.models import dit as dit_mod
from repro_torch.optim.adamw import TrainStep
from repro_torch.runtime import placement as plc
from repro_torch.runtime.sharding import data_mean


def distill_loss(params: Any, batch: Dict[str, torch.Tensor],
                 t: torch.Tensor, noise: torch.Tensor, cfg: ModelConfig,
                 sched: sch.DiffusionSchedule, mode_weak: int
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    x0 = batch_x0(batch, cfg)
    x_t = sch.q_sample(sched, x0, t, noise)
    with torch.no_grad():
        teacher = dit_mod.dit_forward(params, x_t, t, batch.get("cond"), cfg,
                                      mode=0)
    student = dit_mod.dit_forward(params, x_t, t, batch.get("cond"), cfg,
                                  mode=mode_weak)
    e_t = dit_mod.eps_prediction(teacher, cfg).float()
    e_s = dit_mod.eps_prediction(student, cfg).float()
    loss = data_mean(torch.mean(torch.square(e_t - e_s)))
    return loss, {"distill_loss": loss}


def make_distill_step(cfg: ModelConfig, tc: TrainConfig,
                      sched: Optional[sch.DiffusionSchedule] = None,
                      mode_weak: int = 1,
                      trainable: Optional[Any] = None) -> TrainStep:
    """(params, opt_state, batch, generator) → (params, opt_state, metrics),
    captured with ``params`` and ``opt_state`` donated (updated in place,
    returned as the caller's objects; ``launch/steps.make_train_step``).
    ``trainable`` comes from ``core.flexify.trainable_mask(params, 'lora')``:
    its Python bools join the graph's key, and a frozen leaf is never
    written."""
    sched = sched or sch.linear_schedule(1000)

    def draw(batch, generator):
        t, noise = draw_t_noise(batch_x0(batch, cfg), sched.num_steps,
                                generator)
        return {"t": t, "noise": noise}

    def loss_fn(params, batch, t, noise):
        return distill_loss(params, batch, t, noise, cfg, sched, mode_weak)

    return TrainStep(loss_fn, draw, tc, trainable,
                     plc.stacked_leaves(dit_mod.dit_schema(cfg)),
                     name=f"distill_step[mode {mode_weak}]")
