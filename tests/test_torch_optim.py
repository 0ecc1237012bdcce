"""The port's AdamW, LR schedules, clipping and EMA against the JAX
package, fed the same numpy gradients, plus the port's counterparts of
``tests/test_optim.py``'s optimizer tests.

Tolerance: 1e-6 relative on parameters and moments (both sides compute
the same float32 expressions in the same order; XLA and torch may differ
by an ulp in ``cos``, ``pow`` and the order of the norm's sums). A frozen
leaf (``trainable`` False) is held bit for bit, with its moments.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import TrainConfig as JTrainConfig
from repro.optim import adamw as jadamw
from repro.optim import ema as jema
from repro_torch import convert
from repro_torch.configs.base import TrainConfig
from repro_torch.optim import adamw, ema

TOL = dict(atol=1e-6, rtol=1e-6)
SHAPES = {"a": (4, 8), "b": {"c": (16,), "d": (3, 5)}}
TRAINABLE = {"a": True, "b": {"c": False, "d": True}}


def _tree(rng, shapes, scale=1.0):
    if isinstance(shapes, dict):
        return {k: _tree(rng, v, scale) for k, v in shapes.items()}
    return (rng.normal(size=shapes) * scale).astype(np.float32)


def _jax(tree, dtype):
    return jax.tree.map(lambda a: jnp.asarray(a, dtype), tree)


def _torch(tree, dtype):
    return convert.params_from_numpy(tree, device="cpu", dtype=dtype)


def _np(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


def _close(got, want, tol=TOL):
    got, want = convert.tree_to_numpy(got), _np(want)
    jax.tree.map(lambda g, w: np.testing.assert_allclose(g, w, **tol),
                 got, want)


@pytest.mark.parametrize("schedule", ["cosine", "linear", "constant"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("masked", [False, True], ids=["all", "masked"])
@pytest.mark.parametrize("clip", [0.0, 0.5], ids=["noclip", "clip"])
def test_adamw_update_matches_jax(schedule, dtype, masked, clip):
    """Three steps of each schedule (warm-up of 2, so the steps cross it),
    each fed the same numpy gradients."""
    kw = dict(learning_rate=3e-2, weight_decay=0.1, warmup_steps=2,
              total_steps=5, schedule=schedule, grad_clip=clip)
    jtc, ttc = JTrainConfig(**kw), TrainConfig(**kw)
    jdt, tdt = {"float32": (jnp.float32, torch.float32),
                "bfloat16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    rng = np.random.default_rng(0)
    p0 = _tree(rng, SHAPES)
    jp, tp = _jax(p0, jdt), _torch(p0, tdt)
    jo, to = jadamw.init_opt_state(jp), adamw.init_opt_state(tp)
    mask = TRAINABLE if masked else None
    frozen = tp["b"]["c"]
    for _ in range(3):
        g = _tree(rng, SHAPES)
        jp, jo, jm = jadamw.adamw_update(jp, _jax(g, jdt), jo, jtc, mask)
        tp, to, tm = adamw.adamw_update(tp, _torch(g, tdt), to, ttc, mask)
        _close(tp, jp)
        _close(to["m"], jo["m"])
        _close(to["v"], jo["v"])
        assert int(to["step"]) == int(jo["step"])
        np.testing.assert_allclose(float(tm["lr"]), float(jm["lr"]), **TOL)
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), **TOL)
    if masked:
        assert torch.equal(tp["b"]["c"], frozen)
        assert not to["m"]["b"]["c"].any() and not to["v"]["b"]["c"].any()
    assert tp["a"].dtype == tdt and to["m"]["a"].dtype == torch.float32


@pytest.mark.parametrize("schedule", ["cosine", "linear", "constant"])
def test_lr_at_matches_jax(schedule):
    kw = dict(learning_rate=1.0, warmup_steps=10, total_steps=100,
              schedule=schedule)
    jtc, ttc = JTrainConfig(**kw), TrainConfig(**kw)
    for s in range(0, 110, 7):
        np.testing.assert_allclose(float(adamw.lr_at(ttc, torch.tensor(s))),
                                   float(jadamw.lr_at(jtc, jnp.asarray(s))),
                                   **TOL)


def test_global_norm_and_clip_match_jax():
    rng = np.random.default_rng(1)
    g = _tree(rng, SHAPES, scale=3.0)
    jc, jn = jadamw.clip_by_global_norm(_jax(g, jnp.float32), 2.0)
    tc, tn = adamw.clip_by_global_norm(_torch(g, torch.float32), 2.0)
    np.testing.assert_allclose(float(tn), float(jn), **TOL)
    np.testing.assert_allclose(float(adamw.global_norm(_torch(g, torch.float32))),
                               float(jadamw.global_norm(_jax(g, jnp.float32))),
                               **TOL)
    _close(tc, jc)


@pytest.mark.parametrize("opt_dtype", ["float32", "bfloat16"])
def test_init_opt_state_dtype(opt_dtype):
    p = _torch(_tree(np.random.default_rng(2), SHAPES), torch.float32)
    o = adamw.init_opt_state(p, opt_dtype)
    assert o["m"]["b"]["d"].dtype == getattr(torch, opt_dtype)
    assert o["v"]["a"].shape == (4, 8) and not o["v"]["a"].any()
    assert o["step"].dtype == torch.int32 and int(o["step"]) == 0


def test_ema_matches_jax():
    rng = np.random.default_rng(3)
    p0 = _tree(rng, SHAPES)
    je, te = jema.init_ema(_jax(p0, jnp.bfloat16)), ema.init_ema(_torch(p0, torch.bfloat16))
    for _ in range(3):
        p = _tree(rng, SHAPES)
        je = jema.ema_update(je, _jax(p, jnp.bfloat16), 0.9)
        te = ema.ema_update(te, _torch(p, torch.bfloat16), 0.9)
        _close(te, je)
    like = _torch(p0, torch.bfloat16)
    out = ema.ema_params(te, like)
    assert out["a"].dtype == torch.bfloat16
    _close(out, jema.ema_params(je, _jax(p0, jnp.bfloat16)))


def test_ema_shadow_is_a_copy():
    p = {"w": torch.zeros(3)}
    e = ema.init_ema(p)
    p["w"].add_(1.0)
    assert not e["w"].any()


# ---------------------------------------------------------------------------
# The port's counterparts of tests/test_optim.py


def test_adamw_converges_on_quadratic():
    tc = TrainConfig(learning_rate=0.1, warmup_steps=0, total_steps=200,
                     schedule="constant", grad_clip=0.0, weight_decay=0.0)
    params = {"w": torch.tensor([5.0, -3.0])}
    opt = adamw.init_opt_state(params)
    target = torch.tensor([1.0, 2.0])

    def loss(p):
        return torch.sum((p["w"] - target) ** 2), {}

    for _ in range(200):
        _, g = adamw.value_and_grad(loss, params)
        params, opt, _ = adamw.adamw_update(params, g, opt, tc)
    np.testing.assert_allclose(params["w"].numpy(), target.numpy(), atol=1e-2)


def test_grad_clip():
    g = {"a": torch.tensor([30.0, 40.0])}    # norm 50
    clipped, norm = adamw.clip_by_global_norm(g, 5.0)
    assert float(norm) == pytest.approx(50.0)
    np.testing.assert_allclose(clipped["a"].numpy(), [3.0, 4.0], atol=1e-5)


def test_lr_schedule_shapes():
    tc = TrainConfig(learning_rate=1.0, warmup_steps=10, total_steps=100,
                     schedule="cosine")
    lrs = [float(adamw.lr_at(tc, torch.tensor(s))) for s in range(100)]
    assert lrs[0] < lrs[9]                  # warmup
    assert lrs[20] > lrs[90]                # decay
    assert all(l >= 0 for l in lrs)


@pytest.mark.parametrize("as_tensor", [False, True], ids=["bool", "tensor"])
def test_trainable_mask_freezes(as_tensor):
    tc = TrainConfig(learning_rate=0.1, warmup_steps=0, grad_clip=0.0)
    params = {"a": torch.ones(3), "b": torch.ones(3)}
    grads = {"a": torch.ones(3), "b": torch.ones(3)}
    opt = adamw.init_opt_state(params)
    off = torch.tensor(False) if as_tensor else False
    p2, o2, _ = adamw.adamw_update(params, grads, opt, tc, {"a": True, "b": off})
    assert float((p2["a"] - 1.0).abs().max()) > 0
    np.testing.assert_array_equal(p2["b"].numpy(), np.ones(3))
    assert not o2["m"]["b"].any() and not o2["v"]["b"].any()


def test_ema_tracks_params():
    p = {"w": torch.zeros(4)}
    e = ema.init_ema(p)
    for _ in range(100):
        p = {"w": p["w"] + 0.1}
        e = ema.ema_update(e, p, 0.9)
    assert 0 < float(e["w"][0]) < float(p["w"][0])


def test_value_and_grad_zero_for_unused_leaves():
    params = {"used": torch.tensor([2.0, 3.0]), "unused": torch.ones(2)}
    (loss, aux), g = adamw.value_and_grad(
        lambda p: (torch.sum(p["used"] ** 2), {"x": p["used"].sum()}), params)
    assert float(loss) == 13.0 and not aux["x"].requires_grad
    np.testing.assert_array_equal(g["used"].numpy(), [4.0, 6.0])
    assert torch.equal(g["unused"], torch.zeros(2))
    assert not params["used"].requires_grad
