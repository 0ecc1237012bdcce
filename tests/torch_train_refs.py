"""Shared pieces of the port's training parity tests
(``test_torch_train.py``, ``test_torch_mmd.py``): reference weights with
non-zero gates, a numpy-seeded batch, the reference's draws rebuilt from
its keys, a mid-run AdamW state, and the tolerance checks.

Tolerances (float32 on both sides; XLA and torch differ in the order of
their sums): the loss within 1e-5 relative and every gradient leaf within
1e-5 of that leaf's norm; one whole step (gradients, then AdamW from a
mid-run state, so no update is a bare sign) within 1e-5.
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data import pipeline as jdp
from repro.models import dit as jdit
from repro_torch import convert

jflex = importlib.import_module("repro.core.flexify")

LOSS_TOL = 1e-5
GRAD_TOL = 1e-5
STEP_TOL = dict(atol=1e-5, rtol=1e-5)
B = 4
TC = dict(learning_rate=1e-3, warmup_steps=2, total_steps=20,
          weight_decay=0.01, grad_clip=1.0)


def trained_like(cfg, seed, lora_rank=0):
    """Reference weights, flexified to patch 4, with every zero-initialized
    gate made non-zero so no path hides behind a zero."""
    key = jax.random.PRNGKey(seed)
    p = jax.jit(jdit.init_dit, static_argnums=0)(cfg, key)

    def rnd(i, shape, scale):
        return jax.random.normal(jax.random.fold_in(key, i), shape) * scale

    p["deembed"]["w_flex"] = rnd(1, p["deembed"]["w_flex"].shape, 0.1)
    p["final"]["ada"]["w"] = rnd(2, p["final"]["ada"]["w"].shape, 0.05)
    p["blocks"]["ada"]["w"] = rnd(3, p["blocks"]["ada"]["w"].shape, 0.05)
    fp, fc = jflex.flexify(p, cfg, [(1, 4, 4)], lora_rank=lora_rank)
    fp["ps_embed"] = rnd(4, fp["ps_embed"].shape, 0.1)
    if lora_rank:
        fp["blocks"]["lora"] = jax.tree.map(
            lambda a: jax.random.normal(jax.random.fold_in(key, a.size),
                                        a.shape) * 0.05, fp["blocks"]["lora"])
        fp["deembed_new"]["m1"]["w"] = rnd(5, fp["deembed_new"]["m1"]["w"].shape,
                                           0.1)
    return fp, fc


@pytest.fixture(scope="module")
def shared(tiny_dit_cfg):
    """The shared-parameters recipe's model (``tiny_dit_cfg`` flexified)."""
    return trained_like(tiny_dit_cfg, 0)


@pytest.fixture(scope="module")
def lora(tiny_dit_cfg):
    """The LoRA recipe's model (rank 4)."""
    return trained_like(tiny_dit_cfg, 1, lora_rank=4)


@pytest.fixture(scope="module")
def batch(tiny_dit_cfg):
    make = jdp.make_dit_batch_fn(tiny_dit_cfg.dit.latent_shape,
                                 tiny_dit_cfg.dit.num_classes, B)
    return make(0, 0, 1, np.random.default_rng(0))


def jbatch(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def tbatch(b):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in b.items()}


def as_torch(x):
    return torch.from_numpy(np.array(x))


def to_torch(tree):
    return convert.params_from_numpy(jax.tree.map(np.asarray, tree),
                                     device="cpu")


def check_loss_and_grads(loss, grads, jloss, jgrads):
    np.testing.assert_allclose(float(loss), float(jloss), rtol=LOSS_TOL,
                               atol=0)
    flat_t = dict(jax.tree_util.tree_leaves_with_path(convert.tree_to_numpy(grads)))
    flat_j = dict(jax.tree_util.tree_leaves_with_path(
        jax.tree.map(np.asarray, jgrads)))
    assert flat_t.keys() == flat_j.keys()
    for path, gj in flat_j.items():
        err = np.abs(flat_t[path] - gj).max()
        assert err <= GRAD_TOL * np.linalg.norm(gj), (path, err)


def mid_run_state(params, seed=9, step=5):
    """A reference AdamW state after a few steps: m, v non-zero."""
    rng = np.random.default_rng(seed)
    leaves = jax.tree.map(np.asarray, params)
    m = jax.tree.map(lambda a: (rng.normal(size=a.shape) * 1e-3).astype(np.float32),
                     leaves)
    v = jax.tree.map(lambda a: (np.abs(rng.normal(size=a.shape)) * 1e-6)
                     .astype(np.float32), leaves)
    return {"m": m, "v": v, "step": np.int32(step)}


def ref_dit_draws(key, x0, num_steps):
    k_t, k_n = jax.random.split(key)
    t = jax.random.randint(k_t, (x0.shape[0],), 0, num_steps)
    noise = jax.random.normal(k_n, x0.shape, x0.dtype)
    return t, noise


def check_step(got_params, got_opt, want_params, want_opt):
    """Parameters and both moments after one whole step, within STEP_TOL."""
    for got, want in [(got_params, want_params), (got_opt["m"], want_opt["m"]),
                      (got_opt["v"], want_opt["v"])]:
        jax.tree.map(lambda g, w: np.testing.assert_allclose(
            g, np.asarray(w), **STEP_TOL), convert.tree_to_numpy(got), want)
