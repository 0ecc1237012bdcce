"""End-to-end system behaviour of the port, as ``tests/test_system.py``
holds the JAX package: pre-train a tiny DiT on synthetic data, flexify it,
fine-tune with alternating patch modes, and sample weak-first through
``FlexiPipeline.sample``; plus the paper's Fig. 4 claim (the weak vs
powerful prediction gap shrinks at early/noisy timesteps).

Everything runs on the CPU with torch's own initialisation and draws
(seeded generators), so the assertions are the reference's own
statistical ones, not comparisons with it.
"""
import numpy as np
import pytest
import torch
from torch_threads import one_torch_thread  # noqa: F401

from repro_torch.configs.base import AttnConfig, DiTConfig, ModelConfig, TrainConfig
from repro_torch.core import FlexiSchedule, flexify, relative_compute
from repro_torch.data import pipeline as dp
from repro_torch.diffusion import schedule as sch
from repro_torch.launch import steps as st
from repro_torch.models import dit as dit_mod
from repro_torch.optim import adamw
from repro_torch.pipeline import FlexiPipeline, SamplingPlan

CFG = ModelConfig(
    name="sys-dit", family="dit", num_layers=2, d_model=64, d_ff=128,
    vocab_size=0, attn=AttnConfig(4, 4, 16, use_rope=False),
    dit=DiTConfig(latent_shape=(1, 8, 8, 2), patch_size=(1, 2, 2),
                  flex_patch_sizes=(), underlying_patch_size=(1, 2, 2),
                  conditioning="class", num_classes=4, learn_sigma=False),
    mlp_activation="gelu", norm_type="layernorm",
    param_dtype="float32", compute_dtype="float32", remat="none")


def _batch(make_batch, i, seed):
    b = make_batch(i, 0, 1, np.random.default_rng(seed))
    return {"x0": torch.from_numpy(b["x0"]), "cond": torch.from_numpy(b["cond"])}


def _finetune(params, cfg, sched, tc, n, seed0, gen_seed):
    """n steps alternating patch modes 0 and 1 (paper §4.1)."""
    steps = [st.make_dit_train_step(cfg, tc, sched, mode=m) for m in (0, 1)]
    opt = adamw.init_opt_state(params)
    make_batch = dp.make_dit_batch_fn(cfg.dit.latent_shape, 4, 16, 0.1)
    gen = torch.Generator().manual_seed(gen_seed)
    for i in range(n):
        params, opt, _ = steps[i % 2](params, opt,
                                      _batch(make_batch, i, seed0 + i), gen)
    return params


@pytest.fixture(scope="module")
def pretrained():
    """Train a tiny class-conditional DiT for a few hundred steps."""
    torch.manual_seed(0)
    tc = TrainConfig(learning_rate=2e-3, warmup_steps=10, total_steps=300,
                     schedule="cosine", grad_clip=1.0)
    sched = sch.linear_schedule(100)
    params = dit_mod.init_dit(CFG, torch.Generator().manual_seed(0))
    opt = adamw.init_opt_state(params)
    step = st.make_dit_train_step(CFG, tc, sched)
    make_batch = dp.make_dit_batch_fn(CFG.dit.latent_shape, 4, 16,
                                      noise_scale=0.1)
    gen = torch.Generator().manual_seed(1)
    losses = []
    for i in range(300):
        params, opt, m = step(params, opt, _batch(make_batch, i, i), gen)
        losses.append(m["loss"])
    losses = [float(l) for l in losses]
    assert np.mean(losses[-30:]) < np.mean(losses[:30]) * 0.8, \
        "pre-training did not learn"
    return params, sched


def test_pretraining_then_flexify_then_sample(pretrained):
    params, sched = pretrained
    fparams, fcfg = flexify(params, CFG, [(1, 4, 4)])
    # brief flexi fine-tune alternating modes (paper §4.1)
    tc = TrainConfig(learning_rate=1e-3, warmup_steps=5, total_steps=100)
    fparams = _finetune(fparams, fcfg, sched, tc, 100, 1000, 2)

    # sample with the weak→powerful scheduler
    T, B = 20, 8
    fs = FlexiSchedule.weak_first(T, 12)
    y = torch.arange(B) % 4
    pipe = FlexiPipeline(fparams, fcfg, sched, device="cpu")
    res = pipe.sample(SamplingPlan(T=T, budget=fs, solver="ddim",
                                   guidance_scale=1.5), B,
                      torch.Generator().manual_seed(3), cond=y)
    x0n = res.x0.numpy()
    assert x0n.shape == (B, 1, 8, 8, 2) and np.isfinite(x0n).all()

    # samples should correlate with their class patterns more than others'
    pats = np.stack([dp.class_pattern(c, CFG.dit.latent_shape)
                     for c in range(4)])
    own, other = [], []
    for i in range(B):
        for c in range(4):
            corr = np.corrcoef(x0n[i].ravel(), pats[c].ravel())[0, 1]
            (own if c == int(y[i]) else other).append(corr)
    assert np.mean(own) > np.mean(other), (np.mean(own), np.mean(other))
    # and the schedule actually saved >40% compute
    assert relative_compute(fcfg, fs) < 0.6
    assert res.relative_compute < 0.6


def test_weak_powerful_gap_smaller_at_high_noise(pretrained):
    """Fig. 4 (right): ‖ε_weak − ε_powerful‖ grows as t → 0."""
    params, sched = pretrained
    fparams, fcfg = flexify(params, CFG, [(1, 4, 4)])
    # fine-tune both modes in alternation (paper recipe) long enough for the
    # weak mode to be meaningful
    tc = TrainConfig(learning_rate=2e-3, warmup_steps=5, total_steps=200)
    fparams = _finetune(fparams, fcfg, sched, tc, 200, 2000, 5)

    make_batch = dp.make_dit_batch_fn(CFG.dit.latent_shape, 4, 16, 0.1)
    b = _batch(make_batch, 0, 7)
    gen = torch.Generator().manual_seed(6)
    gaps = {}
    with torch.no_grad():
        for t_val in (10, 90):
            t = torch.full((b["x0"].shape[0],), t_val)
            noise = torch.randn(b["x0"].shape, generator=gen)
            x_t = sch.q_sample(sched, b["x0"], t, noise)
            e0, e1 = (dit_mod.eps_prediction(dit_mod.dit_forward(
                fparams, x_t, t.float(), b["cond"], fcfg, mode=m), fcfg)
                for m in (0, 1))
            # relative gap (normalized by prediction energy — magnitudes
            # differ strongly across t at toy scale)
            gaps[t_val] = float(torch.mean(torch.square(e0 - e1))
                                / torch.mean(torch.square(e0)))
    # early denoising steps (large t) → smaller weak/powerful gap (Fig. 4)
    assert gaps[90] < gaps[10], gaps
