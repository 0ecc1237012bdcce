"""The train steps as captured runners, on the CPU.

``optim/adamw.TrainStep`` is a ``runtime.graphs`` runner that donates the
parameter tree and the AdamW state (the counterpart of the reference
planner's ``jax.jit(step, donate_argnums=(0, 1))``): AdamW writes p, m, v
and ``step`` into the trees it is handed, and the step returns those same
objects. On CPU tensors the body runs eagerly (the caller asked for the
CPU), and the key is still recorded, so these tests hold:

* three in-place steps equal to the functional update the port ran
  before (kept here as ``functional_adamw_update``, fed the same
  gradients) bit for bit, and to the JAX package's own jitted step at
  1e-5 (``torch_train_refs.check_step``) after each step: the tiny DiT
  at modes 0 and 1 under the LoRA mask, and gemma2's tiny config with
  remat "block" over two microbatches;
* the returned trees being the caller's objects, frozen leaves and their
  moments unchanged bit for bit;
* one key per step object and batch shape, whatever the batch's values
  or the draws, a new tree or state another key, and the mask's Python
  bools in the key by value;
* a parameter tree holding one tensor twice refused, and ``flexify``
  returning a tree that shares no tensor with the pre-trained one;
* the placed path (DTensors over Gloo, run eagerly) keeping the contract
  on a (2 x 1) CPU group, its moments within 1e-5 of the single-device
  step's.

The card's side (captured against ``graphs.disabled()`` bit for bit, one
capture per step object, the first call applying one update) is in
``tests/test_torch_gpu.py``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_train_worker as worker
from torch_threads import one_torch_thread  # noqa: F401

from repro import configs as jcfgs
from repro.configs.base import TrainConfig as JTrainConfig
from repro.launch import steps as jsteps
from repro.models import lm as jlm
from repro_torch import configs as tcfgs
from repro_torch import convert
from repro_torch.configs import base as tbase
from repro_torch.configs.base import TrainConfig
from repro_torch.core import distill as tdistill
from repro_torch.core import flexify, trainable_mask
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import steps as tsteps
from repro_torch.models import common as tcommon
from repro_torch.models import dit as tdit
from repro_torch.optim import adamw as tadamw
from repro_torch.runtime import placement as plc
from torch_train_refs import (B, LOSS_TOL, TC, batch,  # noqa: F401
                              check_step, jbatch, jflex, lora, mid_run_state,
                              ref_dit_draws, shared, tbatch, to_torch)

N_STEPS = 3
LM_B, LM_S = 4, 16


def functional_adamw_update(params, grads, opt_state, tc, trainable=None):
    """The port's AdamW as it was before it wrote in place: new trees,
    the same arithmetic in the same order (single-device leaves)."""
    step = opt_state["step"] + 1
    lr = tadamw.lr_at(tc, step)
    if tc.grad_clip > 0:
        grads, gnorm = tadamw.clip_by_global_norm(grads, tc.grad_clip)
    else:
        gnorm = tadamw.global_norm(grads)
    b1, b2, eps = tc.beta1, tc.beta2, tc.eps
    c1 = 1.0 - torch.pow(b1, step.float())
    c2 = 1.0 - torch.pow(b2, step.float())

    def upd(p, g, m, v, t=True):
        if t is False:
            return p, m, v
        gf = g.float()
        m_new = b1 * m.float() + (1 - b1) * gf
        v_new = b2 * v.float() + (1 - b2) * gf * gf
        mh = m_new / c1
        vh = v_new / c2
        delta = lr * (mh / (torch.sqrt(vh) + eps) + tc.weight_decay * p.float())
        p_new = (p.float() - delta).to(p.dtype)
        if t is not True:
            keep = torch.as_tensor(t, dtype=torch.bool, device=p.device)
            p_new = torch.where(keep, p_new, p)
            m_new = torch.where(keep, m_new, m.float())
            v_new = torch.where(keep, v_new, v.float())
        return p_new, m_new.to(m.dtype), v_new.to(v.dtype)

    rest = (grads, opt_state["m"], opt_state["v"])
    if trainable is not None:
        rest += (trainable,)
    out = tcommon.tree_map(upd, params, *rest)
    pick = lambda i: tcommon.tree_map(lambda _p, o: o[i], params, out)
    return (pick(0), {"m": pick(1), "v": pick(2), "step": step},
            {"lr": lr, "grad_norm": gnorm})


def functional_step(step, params, opt, batch, draws):
    (_loss, metrics), grads = step.grads(params, batch, **draws)
    p, o, om = functional_adamw_update(params, grads, opt, step.tc,
                                       step.trainable)
    return p, o, {**metrics, **om}


def assert_trees_equal(a, b):
    la, lb = tcommon.tree_leaves(a), tcommon.tree_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and torch.equal(x, y)


def clone(tree):
    return tcommon.tree_map(torch.clone, tree)


def port_cfg(jcfg):
    """The JAX package's DiT ModelConfig as the port's (same fields)."""
    kw = {f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg)}
    kw["attn"] = tbase.AttnConfig(**dataclasses.asdict(jcfg.attn))
    kw["dit"] = tbase.DiTConfig(**dataclasses.asdict(jcfg.dit))
    return tbase.ModelConfig(**kw)


def _fill_zero_leaves(tree, rng):
    def one(x):
        x = np.asarray(x)
        if not np.any(x):
            return (0.1 * rng.standard_normal(x.shape)).astype(x.dtype)
        return x
    return jax.tree.map(one, tree)


@pytest.fixture(scope="module")
def lm_case():
    jcfg = dataclasses.replace(jcfgs.get_config("gemma2-9b").reduced(),
                               remat="block")
    tcfg = dataclasses.replace(tcfgs.get_config("gemma2-9b").reduced(),
                               remat="block")
    np_params = _fill_zero_leaves(jax.tree.map(
        np.asarray, jlm.init_params(jcfg, jax.random.PRNGKey(3))),
        np.random.default_rng(5))
    rng = np.random.default_rng(6)
    toks = rng.integers(0, jcfg.vocab_size, (LM_B, LM_S), dtype=np.int32)
    return dict(jcfg=jcfg, tcfg=tcfg, np_params=np_params,
                batch={"tokens": toks, "targets": np.roll(toks, -1, 1)})


def _case(name, lora, batch, lm_case):
    """(the JAX step, the port's step, the JAX parameters, the port's
    parameters, numpy batch, per-step draws as (JAX key, port draws))."""
    tc, jtc = TrainConfig(**TC), JTrainConfig(**TC)
    if name == "lm":
        s = lm_case
        jstep = jax.jit(jsteps.make_train_step(s["jcfg"], jtc, n_microbatches=2))
        tstep = tsteps.make_train_step(s["tcfg"], tc, n_microbatches=2)
        jp = jax.tree.map(jnp.asarray, s["np_params"])
        tp = convert.lm_params_from_numpy(s["np_params"], s["tcfg"], device="cpu")
        return jstep, tstep, jp, tp, s["batch"], [(None, {})] * N_STEPS
    mode = int(name[3])
    jp, cfg = lora
    jstep = jax.jit(jsteps.make_dit_train_step(
        cfg, jtc, mode=mode, trainable=jflex.trainable_mask(jp, "lora")))
    tp = to_torch(jp)
    tstep = tsteps.make_dit_train_step(cfg, tc, mode=mode,
                                       trainable=trainable_mask(tp, "lora"))
    draws = []
    for i in range(N_STEPS):
        key = jax.random.PRNGKey(50 + 10 * mode + i)
        t, noise = ref_dit_draws(key, jnp.asarray(batch["x0"]), 1000)
        draws.append((key, {"t": torch.from_numpy(np.array(t)),
                            "noise": torch.from_numpy(np.array(noise))}))
    return jstep, tstep, jp, tp, batch, draws


@pytest.mark.parametrize("name", ["dit0-lora", "dit1-lora", "lm"])
def test_in_place_steps_equal_functional_and_reference(name, lora, batch, lm_case):
    """Three steps from one mid-run AdamW state: in place (through the
    runner) == the functional update on the same gradients, bit for bit
    (parameters, moments, step, metrics), and == the JAX package's jitted
    step at 1e-5 after each step; the trees come back as the caller's."""
    jstep, tstep, jp, params, nb, draws = _case(name, lora, batch, lm_case)
    state = mid_run_state(jp)
    opt = convert.opt_state_from_numpy(state, device="cpu")
    fp, fo = clone(params), clone(opt)
    jo = jax.tree.map(jnp.asarray, state)
    tb = tbatch(nb)
    for key, d in draws:
        p, o, m = tstep.with_draws(params, opt, tb, **d)
        assert p is params and o is opt
        fp, fo, fm = functional_step(tstep, fp, fo, tb, d)
        assert_trees_equal(params, fp)
        assert_trees_equal(opt, fo)
        assert sorted(m) == sorted(fm)
        assert all(torch.equal(m[k], fm[k]) for k in m)
        jargs = (jp, jo, jbatch(nb)) + (() if key is None else (key,))
        jp, jo, jm = jstep(*jargs)
        check_step(params, opt, jax.tree.map(np.asarray, jp), jo)
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                                   rtol=LOSS_TOL)
    assert int(opt["step"]) == int(jo["step"]) == int(state["step"]) + N_STEPS
    assert len(tstep.keys_seen) == 1          # one graph over the three steps


@pytest.mark.parametrize("mode", [0, 1])
def test_frozen_leaves_and_moments_stay_bit_for_bit(lora, batch, mode):
    """Under the LoRA mask a frozen leaf, its m and its v (non-zero, from a
    mid-run state) are never written; trainable leaves move."""
    jp, cfg = lora
    params = to_torch(jp)
    mask = trainable_mask(params, "lora")
    opt = convert.opt_state_from_numpy(mid_run_state(jp), device="cpu")
    before = clone({"p": params, "m": opt["m"], "v": opt["v"]})
    step = tsteps.make_dit_train_step(cfg, TrainConfig(**TC), mode=mode,
                                      trainable=mask)
    gen = torch.Generator().manual_seed(mode)
    for _ in range(2):
        step(params, opt, tbatch(batch), gen)
    flat = lambda tree: dict(jax.tree_util.tree_leaves_with_path(tree))
    fm = flat(mask)
    now = flat({"p": params, "m": opt["m"], "v": opt["v"]})
    was = flat(before)
    n_frozen = n_moved = 0
    for path, x in now.items():
        on = fm[path[1:]]
        if not on:
            n_frozen += 1
            assert torch.equal(x, was[path]), path
        elif path[0].key == "p":
            n_moved += int(not torch.equal(x, was[path]))
    assert n_frozen > 0 and n_moved > 0


def test_one_key_per_step_object_and_batch_shape(shared, batch):
    """Other batch values and other draws: the same key; another batch
    size: another key; another step object keys apart; a new tree or a
    new state of the same shapes: another key (both are donated); the
    mask's Python bools join the key by value."""
    jp, cfg = shared
    tc = TrainConfig(**TC)
    params = to_torch(jp)
    opt = tadamw.init_opt_state(params)
    step = tsteps.make_dit_train_step(cfg, tc, mode=1)
    gen = torch.Generator().manual_seed(0)
    tb = tbatch(batch)
    other = {"x0": tb["x0"] + 1.0, "cond": (tb["cond"] + 1) % 10}
    for b in (tb, other, tb):
        step(params, opt, b, gen)
    assert len(step.keys_seen) == 1
    half = {k: v[: B // 2] for k, v in tb.items()}
    step(params, opt, half, gen)
    assert len(step.keys_seen) == 2
    assert step.key(params, opt, tb, gen) != step.key(clone(params), opt, tb, gen)
    assert step.key(params, opt, tb, gen) != step.key(params, clone(opt), tb, gen)
    twin = tsteps.make_dit_train_step(cfg, tc, mode=1)
    assert not twin.keys_seen
    mask = trainable_mask(params, "shared")
    on = tsteps.make_dit_train_step(cfg, tc, mode=1, trainable=mask)
    off = tsteps.make_dit_train_step(
        cfg, tc, mode=1, trainable={**mask, "ps_embed": False})
    assert on.key(params, opt, tb, gen) != off.key(params, opt, tb, gen)
    assert on.key(params, opt, tb, gen) == on.key(params, opt, other, gen)
    assert step.donate == (0, 1) and not step.eager_only and step.captures == 0


def test_a_leaf_held_twice_is_refused_and_flexify_owns_its_leaves(tiny_dit_cfg):
    """An in-place update would write a tensor the tree holds twice twice:
    refused. ``flexify`` (LoRA recipe: the new embeds' bias comes from the
    pre-trained one) returns a tree sharing no tensor with its input or
    within itself, so training it leaves the pre-trained tree as it was."""
    cfg = port_cfg(tiny_dit_cfg)
    base = tdit.init_dit(cfg, torch.Generator().manual_seed(0))
    fparams, fcfg = flexify(base, cfg, [(1, 4, 4)], lora_rank=2)
    ids = [id(x) for x in tcommon.tree_leaves(fparams)]
    assert len(set(ids)) == len(ids)
    assert not set(ids) & {id(x) for x in tcommon.tree_leaves(base)}
    step = tdistill.make_distill_step(fcfg, TrainConfig(**TC))
    twice = {**fparams, "embed_new": {"m1": {**fparams["embed_new"]["m1"],
                                             "b": fparams["embed"]["b"]}}}
    gen = torch.Generator().manual_seed(0)
    x0 = torch.randn((2,) + fcfg.dit.latent_shape, generator=gen)
    tb = {"x0": x0, "cond": torch.tensor([1, 2])}
    with pytest.raises(ValueError, match="twice"):
        step(twice, tadamw.init_opt_state(twice), tb, gen)
    was = clone(base)
    step(fparams, tadamw.init_opt_state(fparams), tb, gen)
    assert_trees_equal(base, was)


def test_placed_step_keeps_the_contract_on_a_cpu_group(shared, batch):
    """Two DiT steps on placed parameters over a (2 x 1) Gloo group (one
    through ``with_draws``, one drawing from a seeded generator): the
    trees come back as the caller's objects with every rank's chunks
    written where they lie, no graph is captured (Gloo collectives run
    eagerly), and the moments equal the single-device step's within 1e-5
    of each leaf's norm."""
    jp, cfg = shared
    t, noise = ref_dit_draws(jax.random.PRNGKey(77), jnp.asarray(batch["x0"]), 1000)
    draws = {"t": np.asarray(t), "noise": np.asarray(noise)}
    case = dict(name="dit-placed", cfg=port_cfg(cfg), mode=1, tc=TC,
                profile="fsdp2d",
                params=jax.tree.map(np.asarray, jp),
                batch={k: np.asarray(v) for k, v in batch.items()},
                draws=[draws])
    res = tmesh.run_ranks(worker.inplace_group, 2, backend="gloo", device="cpu",
                          threads=1, timeout_s=300,
                          args=({"case": case, "seed": 5},))
    assert all(r["same_objects"] and r["in_place"] for r in res)
    r0 = res[0]
    assert r0["placed"] and r0["captures"] == 0 and r0["step"] == 2
    assert r0["moved"] > 0
    # the single-device steps from the same state, draws and generator
    step = tsteps.make_dit_train_step(cfg, TrainConfig(**TC), mode=1)
    params = to_torch(jp)
    opt = tadamw.init_opt_state(params)
    tb = tbatch(batch)
    _, _, m1 = step.with_draws(params, opt, tb, **{k: torch.from_numpy(np.array(v))
                                                    for k, v in draws.items()})
    _, _, m2 = step(params, opt, tb, torch.Generator().manual_seed(5))
    for got, want in zip(r0["metrics"], (m1, m2)):
        np.testing.assert_allclose(got["loss"], float(want["loss"]), rtol=1e-5)
    flat = lambda tree: dict(jax.tree_util.tree_leaves_with_path(tree))
    want = flat(convert.tree_to_numpy({"m": opt["m"], "v": opt["v"]}))
    got = flat(r0["moments"])
    assert got.keys() == want.keys()
    for k, w in want.items():
        assert np.abs(got[k] - w).max() <= 1e-5 * max(np.linalg.norm(w), 1e-30), k
    assert not plc.is_placed(tcommon.tree_leaves(params)[0])


@pytest.mark.parametrize("capacity_factor", [0.5, 4.0])
def test_moe_row_gathers_backward_matches_reference(capacity_factor):
    """``moe_apply_sorted``'s row gathers take their backward as gathers
    through the inverse map (no atomics, no sort): the gradients of x and
    of every expert weight equal ``jax.grad`` of the JAX package's layer
    at 1e-5, with assignments dropped past capacity (0.5) and with none
    dropped (4.0), and two backward runs agree bit for bit."""
    from repro.configs.base import MoEConfig as JMoEConfig
    from repro.models import moe as jmoe
    from repro_torch.models import moe as tmoe
    E, k, d, f = 8, 2, 12, 16
    kw = dict(num_experts=E, num_experts_per_tok=k, expert_d_ff=f,
              capacity_factor=capacity_factor)
    rng = np.random.default_rng(0)
    params = {"router": rng.normal(size=(d, E)),
              "w_in": 0.3 * rng.normal(size=(E, d, f)),
              "w_gate": 0.3 * rng.normal(size=(E, d, f)),
              "w_out": 0.3 * rng.normal(size=(E, f, d))}
    params = {n: v.astype(np.float32) for n, v in params.items()}
    x = rng.normal(size=(3, 40, d)).astype(np.float32)
    w = rng.normal(size=x.shape).astype(np.float32)

    def jloss(p, xx):
        y, _ = jmoe.moe_apply_sorted(p, xx, JMoEConfig(**kw))
        return jnp.sum(y * w)
    jgp, jgx = jax.grad(jloss, argnums=(0, 1))(
        {n: jnp.asarray(v) for n, v in params.items()}, jnp.asarray(x))

    runs = []
    for _ in range(2):
        tp = {n: torch.from_numpy(v).requires_grad_(True)
              for n, v in params.items()}
        tx = torch.from_numpy(x).requires_grad_(True)
        y, aux = tmoe.moe_apply_sorted(tp, tx, tbase.MoEConfig(**kw))
        (y * torch.from_numpy(w)).sum().backward()
        runs.append((tx.grad, {n: t.grad for n, t in tp.items()}))
    if capacity_factor < 1:
        assert float(aux["dropped_fraction"]) > 0
    (gx, gp), (gx2, gp2) = runs
    np.testing.assert_allclose(gx.numpy(), np.asarray(jgx), atol=1e-5, rtol=1e-5)
    for n in params:
        np.testing.assert_allclose(gp[n].numpy(), np.asarray(jgp[n]),
                                   atol=1e-5, rtol=1e-5, err_msg=n)
        assert torch.equal(gp[n], gp2[n])
    assert torch.equal(gx, gx2)
