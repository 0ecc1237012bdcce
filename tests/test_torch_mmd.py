"""The port's bootstrapped-MMD fine-tune (App. B.1) against the JAX
package: ``rbf_mmd2``, ``bootstrap_mmd_loss`` and the fine-tune step, fed
the reference's own draws, rebuilt here from its keys (the fine-tune's
``split(key, 3)`` → t, noise, k3; the bootstrap's ``split(k3, 4)`` → u,
start noise, target noise, and ``fold_in(k_c, i)`` per chain step).

Tolerances (``torch_train_refs``): the loss within 1e-5 relative and
every gradient leaf within 1e-5 of that leaf's norm; one whole step
within 1e-5; ``rbf_mmd2`` within 1e-6.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_threads import one_torch_thread  # noqa: F401

from repro.configs.base import TrainConfig as JTrainConfig
from repro.core import mmd as jmmd
from repro.diffusion import schedule as jsch
from repro.models import dit as jdit
from repro_torch import convert
from repro_torch.configs.base import TrainConfig
from repro_torch.core import mmd as tmmd
from repro_torch.diffusion import schedule as tsch
from repro_torch.optim import adamw as tadamw
from torch_train_refs import (B, LOSS_TOL, TC, as_torch,  # noqa: F401
                              batch, check_loss_and_grads, check_step,
                              jbatch, mid_run_state, shared, tbatch,
                              to_torch)


def _ref_mmd_draws(key, x0, num_steps, n_chain=4):
    """The reference fine-tune's draws (core/mmd.py:125-129, :83-98, :64)."""
    k1, k2, k3 = jax.random.split(key, 3)
    t = jax.random.randint(k1, (x0.shape[0],), 0, num_steps)
    noise = jax.random.normal(k2, x0.shape, x0.dtype)
    k_t, k_n1, k_n2, k_c = jax.random.split(k3, 4)
    u = jax.random.uniform(k_t, (x0.shape[0],))
    n1 = jax.random.normal(k_n1, x0.shape, x0.dtype)
    n2 = jax.random.normal(k_n2, x0.shape, x0.dtype)
    chain = [jax.random.normal(jax.random.fold_in(k_c, i), x0.shape,
                               jnp.float32) for i in range(n_chain)]
    return {"t": as_torch(t), "noise": as_torch(noise), "u": as_torch(u), "noise1": as_torch(n1),
            "noise2": as_torch(n2), "chain_noise": [as_torch(c) for c in chain]}, k3


def test_mmd_finetune_loss_and_grads_match_jax(shared, batch):
    jp, cfg = shared
    sched_j, sched_t = jsch.linear_schedule(1000), jsch.linear_schedule(1000)
    jb = jbatch(batch)
    key = jax.random.PRNGKey(51)
    draws, k3 = _ref_mmd_draws(key, jb["x0"], 1000)
    t, noise = jnp.asarray(draws["t"].numpy()), jnp.asarray(draws["noise"].numpy())

    def jloss(params):      # the reference's loss_fn (core/mmd.py:122)
        x_t = jsch.q_sample(sched_j, jb["x0"], t, noise)
        out = jdit.dit_forward(params, x_t, t, jb["cond"], cfg, mode=0)
        eps = jdit.eps_prediction(out, cfg)
        den = jnp.mean(jnp.square(eps - noise))
        mmd, _ = jmmd.bootstrap_mmd_loss(params, jb, k3, cfg, sched_j,
                                         weak_mode=1)
        return den + 0.1 * mmd, (den, mmd)

    (jl, (jden, jm)), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(jp)
    (tl, aux), tg = tadamw.value_and_grad(
        tmmd.mmd_finetune_loss, to_torch(jp), tbatch(batch), cfg=cfg,
        sched=tsch.linear_schedule(1000), **draws)
    np.testing.assert_allclose(float(aux["denoise_loss"]), float(jden),
                               rtol=LOSS_TOL)
    np.testing.assert_allclose(float(aux["mmd_loss"]), float(jm), rtol=LOSS_TOL,
                               atol=LOSS_TOL * abs(float(jl)))
    check_loss_and_grads(tl, tg, jl, jg)
    del sched_t


def test_bootstrap_mmd_loss_matches_jax(shared, batch):
    jp, cfg = shared
    key = jax.random.PRNGKey(61)
    jb = jbatch(batch)
    sched = jsch.linear_schedule(1000)
    jl, _ = jax.jit(lambda p, b, k: jmmd.bootstrap_mmd_loss(
        p, b, k, cfg, sched, weak_mode=1))(jp, jb, key)
    k_t, k_n1, k_n2, k_c = jax.random.split(key, 4)
    x0 = jb["x0"]
    tl, aux = tmmd.bootstrap_mmd_loss(
        to_torch(jp), tbatch(batch), as_torch(jax.random.uniform(k_t, (B,))),
        as_torch(jax.random.normal(k_n1, x0.shape)), as_torch(jax.random.normal(k_n2, x0.shape)),
        [as_torch(jax.random.normal(jax.random.fold_in(k_c, i), x0.shape))
         for i in range(4)], cfg, tsch.linear_schedule(1000), weak_mode=1)
    assert float(aux["mmd_loss"]) == float(tl)
    np.testing.assert_allclose(float(tl), float(jl), rtol=LOSS_TOL, atol=1e-6)


def test_mmd_finetune_whole_step_matches_jax(shared, batch):
    jp, cfg = shared
    state = mid_run_state(jp, seed=11)
    key = jax.random.PRNGKey(71)
    jstep = jax.jit(jmmd.make_mmd_finetune_step(cfg, JTrainConfig(**TC)))
    jp2, jo2, jm = jstep(jp, jax.tree.map(jnp.asarray, state), jbatch(batch), key)
    draws, _ = _ref_mmd_draws(key, jnp.asarray(batch["x0"]), 1000)
    tstep = tmmd.make_mmd_finetune_step(cfg, TrainConfig(**TC))
    tp2, to2, tm = tstep.with_draws(to_torch(jp), convert.opt_state_from_numpy(
        state, device="cpu"), tbatch(batch), **draws)
    assert np.isfinite(float(tm["mmd_loss"]))
    check_step(tp2, to2, jp2, jo2)


def test_mmd_step_draws_reference_shapes(shared, batch):
    jp, cfg = shared
    d = tmmd.make_mmd_finetune_step(cfg, TrainConfig(**TC)).draw(
        tbatch(batch), torch.Generator().manual_seed(0))
    assert set(d) == {"t", "noise", "u", "noise1", "noise2", "chain_noise"}
    assert d["u"].shape == (B,) and d["u"].dtype == torch.float32
    assert len(d["chain_noise"]) == 4
    assert all(c.shape == batch["x0"].shape for c in d["chain_noise"])


@pytest.mark.parametrize("n,dim,shift", [(8, 64, 0.0), (6, 200, 0.5), (4, 16, 2.0)])
def test_rbf_mmd2_matches_jax(n, dim, shift):
    rng = np.random.default_rng(n)
    x = rng.normal(size=(n, dim)).astype(np.float32)
    y = (rng.normal(size=(n, dim)) + shift).astype(np.float32)
    want = float(jmmd.rbf_mmd2(jnp.asarray(x), jnp.asarray(y)))
    got = float(tmmd.rbf_mmd2(torch.from_numpy(x), torch.from_numpy(y)))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
