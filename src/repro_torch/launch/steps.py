"""Builders of the step functions — the port of ``repro.launch.steps``:
the language models' train, prefill and decode steps and the DiT steps.

The language-model train step takes no draws; with ``n_microbatches``
it splits the batch along B and sums float32 gradients, as the
reference's scan does. Each DiT loss takes its random draws as
arguments (``t``, ``noise``); the step
(:class:`repro_torch.optim.adamw.TrainStep`) draws them from a
``torch.Generator`` in the reference's shapes and dtypes, then takes
gradients and applies AdamW. Training runs the dense attention path, as
the reference does at 256 unsegmented tokens (no Pallas kernel of the
JAX package has a backward rule).

Handed placed parameters (``runtime/placement``), every step here is the
sharded step over their mesh: each rank takes its rows of the global
batch and of the global draws, gathers each layer's weights on use, and
the losses reduce over the data axes (``runtime/sharding.data_mean``), so
the loss and the gradients are the single-device step's.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig, TrainConfig
from repro_torch.diffusion import schedule as sch
from repro_torch.models import dit as dit_mod
from repro_torch.models import lm
from repro_torch.models.common import dtype_of, tree_map
from repro_torch.optim.adamw import TrainStep, value_and_grad
from repro_torch.runtime import graphs
from repro_torch.runtime import placement as plc
from repro_torch.runtime.sharding import data_mean

Params = Any


class _MicrobatchedStep(TrainStep):
    """A train step whose gradients are accumulated over ``n`` equal
    slices of the batch along B: ``acc + g.float() / n`` per leaf (the
    loss likewise), the last slice's metrics, then each gradient cast
    back to its parameter's dtype before AdamW."""

    def __init__(self, loss_fn, tc: TrainConfig, n: int,
                 trainable: Optional[Params] = None, stacked: Any = None):
        super().__init__(loss_fn, _no_draws, tc, trainable, stacked)
        self.n = n

    def loss_and_grads(self, params: Params, batch: Dict
                       ) -> Tuple[Tuple[torch.Tensor, Dict], Params]:
        n = self.n
        g_acc = tree_map(lambda p: plc.map_local(
            lambda l: torch.zeros(l.shape, dtype=torch.float32,
                                  device=l.device), p), params)
        l_acc = torch.zeros((), dtype=torch.float32,
                            device=batch["tokens"].device)
        for i in range(n):
            mb = {k: v.chunk(n)[i] for k, v in batch.items()}
            (loss, metrics), g = value_and_grad(self.loss_fn, params, mb,
                                                stacked=self.stacked)
            g_acc = tree_map(lambda a, b: plc.map_local(
                lambda x, y: x + y.float() / n, a, b), g_acc, g)
            l_acc = l_acc + loss / n
        return (l_acc, metrics), tree_map(lambda g, p: plc.map_local(
            lambda x: x.to(plc.local(p).dtype), g), g_acc, params)


def _no_draws(batch: Dict, generator: Optional[torch.Generator]) -> Dict:
    return {}


def make_train_step(cfg: ModelConfig, tc: TrainConfig,
                    n_microbatches: int = 1,
                    trainable: Optional[Params] = None,
                    backend: str = "xla") -> TrainStep:
    """``(params, opt_state, batch) → (params, opt_state, metrics)``: the
    language-model loss (``lm.lm_loss``), its gradients, AdamW.

    ``batch``: ``tokens`` / ``targets`` [B,S] int, optional ``loss_mask``
    and ``segment_ids``, and ``vision`` / ``frames`` for those families.
    ``n_microbatches > 1`` splits B into that many slices taken one after
    another (bounds activation memory; see DESIGN.md §5). Placed
    parameters (``runtime/placement``) make it a sharded step: see
    :class:`~repro_torch.optim.adamw.TrainStep`."""
    def loss_fn(params, batch):
        return lm.lm_loss(params, batch, cfg, backend=backend)

    stacked = plc.stacked_leaves(lm.lm_schema(cfg))
    if n_microbatches > 1:
        return _MicrobatchedStep(loss_fn, tc, n_microbatches, trainable,
                                 stacked)
    return TrainStep(loss_fn, _no_draws, tc, trainable, stacked)


def make_prefill_step(cfg: ModelConfig, backend: str = "xla"
                      ) -> graphs.Captured:
    """(params, inputs) → (last-position logits [B,V] float32, cache);
    ``inputs["tokens"]``: [B,S] int, with ``inputs["vision"]`` [B,
    vision_tokens, d] for the vision model and ``inputs["frames"]`` [B,
    audio_frames, d] for whisper. ``backend="pallas"`` runs on the flash
    kernel the attention the reference sends to its Pallas kernel (see
    ``models/lm.py``).

    The step is a ``runtime.graphs`` runner, the counterpart of the
    reference's ``jax.jit(make_prefill_step(cfg))``: on the card one CUDA
    graph per (batch, prompt length) and this runner's backend, captured
    at the first call and replayed after it; another batch size or prompt
    length is another graph, as a new shape retraces the reference's
    ``jit``. The cache comes back as the graph's outputs do, cloned: copy
    it into the batch's slot (``runtime.padding.write_kv_slot``)."""
    def prefill_step(params, inputs):  # repro: traced
        return lm.prefill(params, inputs["tokens"], cfg, extra=inputs,
                          backend=backend)
    return graphs.capture(prefill_step, name=f"prefill[{backend}]")


def make_decode_step(cfg: ModelConfig) -> graphs.Captured:
    """(params, cache, token [B,1], pos [B]) → (logits [B,V] float32,
    cache updated in place).

    The step is a ``runtime.graphs`` runner with the cache donated, the
    counterpart of the reference planner's ``jax.jit(make_decode_step(cfg),
    donate_argnums=(1,))``: on the card one CUDA graph per cache (keyed by
    the identity of its tensors: a served batch's slot, ``lm.serve_slot``,
    made once per batch size) and per shape of token and position. A
    replay copies in the token and the position only, writes the K/V
    entry and the SSM state into the caller's cache, and returns that same
    cache object; the graph holds its tensors. A batch of another size
    decodes in another slot, so it is another graph, as a new shape
    retraces the reference's ``jit``."""
    def decode_step(params, cache, token, pos):  # repro: traced
        return lm.decode_step(params, cache, token, pos, cfg)
    return graphs.capture(decode_step, name="decode", donate=(1,))


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
    loss = data_mean(torch.mean(torch.square(eps.float() - noise.float())))
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

    return TrainStep(loss_fn, draw, tc, trainable,
                     plc.stacked_leaves(dit_mod.dit_schema(cfg)))


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
