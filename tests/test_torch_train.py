"""The port's DiT training path against the JAX package: the denoising
train step at modes 0 and 1 and the LoRA recipe's distillation step, each
fed the reference's own draws (rebuilt here from its keys:
``split(key) → k_t, k_n``), plus the data loader, the trainer's CLI, and
a train step taken after sampling in one process. The MMD fine-tune is
in ``test_torch_mmd.py``.

Tolerances (``torch_train_refs``): the loss within 1e-5 relative and
every gradient leaf within 1e-5 of that leaf's norm; one whole step
within 1e-5. Frozen leaves of the LoRA recipe are held bit for bit.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import TrainConfig as JTrainConfig
from repro.core import distill as jdistill
from repro.data import pipeline as jdp
from repro.diffusion import schedule as jsch
from repro.launch import steps as jsteps
from repro.models import dit as jdit
from repro_torch import convert
from repro_torch.configs.base import TrainConfig
from repro_torch.core import distill as tdistill
from repro_torch.core import trainable_mask
from repro_torch.data import pipeline as tdp
from repro_torch.diffusion import schedule as tsch
from repro_torch.launch import steps as tsteps
from repro_torch.launch import train as ttrain
from repro_torch.models import dit as tdit
from repro_torch.optim import adamw as tadamw
from torch_train_refs import (B, LOSS_TOL, TC, as_torch,  # noqa: F401
                              batch, check_loss_and_grads, check_step,
                              jbatch, jflex, lora, mid_run_state,
                              ref_dit_draws, shared, tbatch, to_torch)

# ---------------------------------------------------------------------------
# The denoising train step


def test_train_config_equal_field_for_field():
    assert dataclasses.asdict(TrainConfig()) == dataclasses.asdict(JTrainConfig())


@pytest.mark.parametrize("mode", [0, 1])
def test_dit_loss_and_grads_match_jax(shared, batch, mode):
    jp, cfg = shared
    sched_j, sched_t = jsch.linear_schedule(1000), tsch.linear_schedule(1000)
    jb = jbatch(batch)
    t, noise = ref_dit_draws(jax.random.PRNGKey(7 + mode), jb["x0"], 1000)

    def jloss(params):      # the reference's loss_fn (launch/steps.py:93)
        x_t = jsch.q_sample(sched_j, jb["x0"], t, noise)
        out = jdit.dit_forward(params, x_t, t, jb["cond"], cfg, mode=mode)
        eps = jdit.eps_prediction(out, cfg)
        return jnp.mean(jnp.square(eps - noise))

    jl, jg = jax.jit(jax.value_and_grad(jloss))(jp)
    (tl, aux), tg = tadamw.value_and_grad(
        tsteps.dit_loss, to_torch(jp), tbatch(batch), as_torch(t), as_torch(noise), cfg,
        sched_t, mode)
    assert float(aux["loss"]) == float(tl)
    check_loss_and_grads(tl, tg, jl, jg)


@pytest.mark.parametrize("mode", [0, 1])
def test_dit_train_step_whole_step_matches_jax(shared, batch, mode):
    """The reference's own make_dit_train_step against the port's step fed
    its draws, from one mid-run AdamW state."""
    jp, cfg = shared
    state = mid_run_state(jp)
    key = jax.random.PRNGKey(21 + mode)
    jstep = jax.jit(jsteps.make_dit_train_step(cfg, JTrainConfig(**TC),
                                               mode=mode))
    jp2, jo2, jm = jstep(jp, jax.tree.map(jnp.asarray, state), jbatch(batch), key)
    t, noise = ref_dit_draws(key, jnp.asarray(batch["x0"]), 1000)
    tstep = tsteps.make_dit_train_step(cfg, TrainConfig(**TC), mode=mode)
    tp2, to2, tm = tstep.with_draws(
        to_torch(jp), convert.opt_state_from_numpy(state, device="cpu"),
        tbatch(batch), t=as_torch(t), noise=as_torch(noise))
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                               rtol=LOSS_TOL)
    np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]),
                               rtol=1e-5)
    assert int(to2["step"]) == int(jo2["step"]) == 6
    check_step(tp2, to2, jp2, jo2)


def test_dit_train_step_draws_reference_shapes(shared, batch):
    """The port's own step draws t [B] int32 in [0, T) and noise of x0's
    shape and dtype from the generator, and is deterministic in it."""
    jp, cfg = shared
    step = tsteps.make_dit_train_step(cfg, TrainConfig(**TC), mode=1)
    d = step.draw(tbatch(batch), torch.Generator().manual_seed(0))
    assert d["t"].dtype == torch.int32 and d["t"].shape == (B,)
    assert 0 <= int(d["t"].min()) and int(d["t"].max()) < 1000
    assert d["noise"].shape == batch["x0"].shape
    assert d["noise"].dtype == torch.float32
    params, opt = to_torch(jp), tadamw.init_opt_state(to_torch(jp))
    outs = [step(params, opt, tbatch(batch), torch.Generator().manual_seed(3))
            for _ in range(2)]
    assert torch.equal(outs[0][0]["blocks"]["attn"]["wq"],
                       outs[1][0]["blocks"]["attn"]["wq"])
    assert float(outs[0][2]["loss"]) > 0


def test_lm_steps_raise_naming_the_slice():
    # the LM train step waits for the next language-model slice; prefill
    # and decode are ported (tests/test_torch_lm.py)
    with pytest.raises(NotImplementedError, match="language-model slice"):
        tsteps.make_train_step(None)
    for fn in (tsteps.make_prefill_step, tsteps.make_decode_step):
        assert callable(fn(None))


# ---------------------------------------------------------------------------
# Distillation (the LoRA recipe)


def test_distill_loss_and_grads_match_jax(lora, batch):
    jp, cfg = lora
    key = jax.random.PRNGKey(31)
    sched = jsch.linear_schedule(1000)
    (jl, _), jg = jax.jit(jax.value_and_grad(
        lambda p, b, k: jdistill.distill_loss(p, b, k, cfg, sched, 1),
        has_aux=True))(jp, jbatch(batch), key)
    t, noise = ref_dit_draws(key, jnp.asarray(batch["x0"]), 1000)
    (tl, aux), tg = tadamw.value_and_grad(
        tdistill.distill_loss, to_torch(jp), tbatch(batch), as_torch(t), as_torch(noise),
        cfg, tsch.linear_schedule(1000), 1)
    assert float(aux["distill_loss"]) == float(tl)
    check_loss_and_grads(tl, tg, jl, jg)


def test_distill_teacher_contributes_no_gradient(lora, batch):
    """The gradients equal those of the student's loss against the
    teacher's output handed in as a constant."""
    jp, cfg = lora
    sched = tsch.linear_schedule(1000)
    tb = tbatch(batch)
    d = tdistill.make_distill_step(cfg, TrainConfig(**TC)).draw(
        tb, torch.Generator().manual_seed(1))
    params = to_torch(jp)
    _, g = tadamw.value_and_grad(tdistill.distill_loss, params, tb, d["t"],
                                 d["noise"], cfg, sched, 1)
    x_t = tsch.q_sample(sched, tb["x0"], d["t"], d["noise"])
    teacher = tdit.eps_prediction(
        tdit.dit_forward(params, x_t, d["t"], tb["cond"], cfg, mode=0), cfg)

    def student_only(p):
        s = tdit.eps_prediction(tdit.dit_forward(p, x_t, d["t"], tb["cond"],
                                                 cfg, mode=1), cfg)
        return torch.mean(torch.square(teacher.float() - s.float())), {}

    _, g_ref = tadamw.value_and_grad(student_only, params)
    jax.tree.map(lambda a, b: np.testing.assert_array_equal(a, b),
                 convert.tree_to_numpy(g), convert.tree_to_numpy(g_ref))


def test_lora_recipe_keeps_frozen_leaves_bit_for_bit(lora, batch):
    jp, cfg = lora
    params = to_torch(jp)
    mask = trainable_mask(params, "lora")
    step = tdistill.make_distill_step(cfg, TrainConfig(**TC), trainable=mask)
    opt = tadamw.init_opt_state(params)
    p, o = params, opt
    gen = torch.Generator().manual_seed(4)
    for _ in range(2):
        p, o, m = step(p, o, tbatch(batch), gen)
        assert np.isfinite(float(m["distill_loss"]))
    flat = lambda tree: dict(jax.tree_util.tree_leaves_with_path(tree))
    fm, fp0, fp1 = flat(mask), flat(params), flat(p)
    fmo, fvo = flat(o["m"]), flat(o["v"])
    n_frozen = n_moved = 0
    for path, on in fm.items():
        if on:
            n_moved += int(not torch.equal(fp1[path], fp0[path]))
        else:
            n_frozen += 1
            assert torch.equal(fp1[path], fp0[path]), path
            assert not fmo[path].any() and not fvo[path].any(), path
    assert n_frozen > 0 and n_moved > 0


def test_distill_whole_step_matches_jax(lora, batch):
    jp, cfg = lora
    state = mid_run_state(jp, seed=10)
    key = jax.random.PRNGKey(41)
    jmask = jflex.trainable_mask(jp, "lora")
    jstep = jax.jit(jdistill.make_distill_step(cfg, JTrainConfig(**TC),
                                               trainable=jmask))
    jp2, jo2, _ = jstep(jp, jax.tree.map(jnp.asarray, state), jbatch(batch), key)
    t, noise = ref_dit_draws(key, jnp.asarray(batch["x0"]), 1000)
    params = to_torch(jp)
    tstep = tdistill.make_distill_step(cfg, TrainConfig(**TC),
                                       trainable=trainable_mask(params, "lora"))
    tp2, to2, _ = tstep.with_draws(params, convert.opt_state_from_numpy(
        state, device="cpu"), tbatch(batch), t=as_torch(t), noise=as_torch(noise))
    check_step(tp2, to2, jp2, jo2)


# ---------------------------------------------------------------------------
# Data, the CLI, and training after sampling


def test_loader_yields_the_reference_arrays(tiny_dit_cfg):
    dit = tiny_dit_cfg.dit
    makers = [
        (jdp.make_dit_batch_fn(dit.latent_shape, dit.num_classes, 6),
         tdp.make_dit_batch_fn(dit.latent_shape, dit.num_classes, 6)),
        (jdp.make_lm_batch_fn(256, 16, 4), tdp.make_lm_batch_fn(256, 16, 4)),
        (jdp.make_text_cond_batch_fn(dit.latent_shape, 8, 32, 4),
         tdp.make_text_cond_batch_fn(dit.latent_shape, 8, 32, 4)),
    ]
    for jmake, tmake in makers:
        jl = jdp.HostShardedLoader(jmake, shard_id=1, n_shards=2, seed=3)
        tl = tdp.HostShardedLoader(tmake, shard_id=1, n_shards=2, seed=3)
        for _ in range(3):
            jb, tb = next(jl), next(tl)
            assert jb.keys() == tb.keys()
            for k in jb:
                assert jb[k].dtype == tb[k].dtype
                np.testing.assert_array_equal(tb[k], jb[k])
        jl.close()
        tl.close()
    np.testing.assert_array_equal(tdp.class_pattern(3, dit.latent_shape),
                                  jdp.class_pattern(3, dit.latent_shape))


def test_train_cli_lora_smoke_leaves_a_restorable_checkpoint(tmp_path):
    from repro_torch.checkpoint.checkpointer import Checkpointer
    out = ttrain.main(["--smoke", "--steps", "3", "--flexi", "--recipe", "lora",
                       "--device", "cpu", "--ckpt-dir", str(tmp_path)])
    ck = Checkpointer(out["ckpt_root"], async_save=False)
    assert ck.all_steps() == [3]
    tree, _ = ck.restore(device="cpu")
    assert int(tree["opt"]["step"]) == 3
    jax.tree.map(lambda a, b: np.testing.assert_array_equal(a, b),
                 convert.tree_to_numpy(tree["params"]),
                 convert.tree_to_numpy(out["params"]))
    assert out["cfg"].dit.lora_rank == 8
    assert all(np.isfinite(l) for _, l in out["losses"])


def test_train_cli_refuses_a_language_model():
    with pytest.raises(NotImplementedError, match="language-model slice"):
        ttrain.main(["--arch", "mamba2-130m", "--smoke", "--device", "cpu"])


def test_train_step_after_sampling_in_one_process(tiny_dit_cfg):
    """Sampling builds the positional embedding and the schedule tables
    under inference mode; a train step afterwards must still save them
    for backward."""
    from repro_torch.core import flexify
    from repro_torch.pipeline import FlexiPipeline, SamplingPlan
    tdit._pos_embed.cache_clear()
    sched = tsch.linear_schedule(1000)
    gen = torch.Generator().manual_seed(0)
    params, cfg = flexify(tdit.init_dit(tiny_dit_cfg, gen), tiny_dit_cfg,
                          [(1, 4, 4)])
    pipe = FlexiPipeline(params, cfg, sched, device="cpu")
    pipe.sample(SamplingPlan(T=3, budget=0.8, solver="ddpm"), 2,
                torch.Generator().manual_seed(1))
    assert tdit._pos_embed.cache_info().currsize > 0
    make = tdp.make_dit_batch_fn(cfg.dit.latent_shape, cfg.dit.num_classes, 2)
    batch = tbatch(make(0, 0, 1, np.random.default_rng(0)))
    for mode in (0, 1):
        step = tsteps.make_dit_train_step(cfg, TrainConfig(**TC), sched,
                                          mode=mode)
        p, _, m = step(params, tadamw.init_opt_state(params), batch,
                       torch.Generator().manual_seed(mode))
        assert np.isfinite(float(m["loss"]))
