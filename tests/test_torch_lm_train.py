"""The port's language-model training against the JAX package, on the
CPU: ``forward_train`` for all ten configs (with packed ``segment_ids``,
and ``lm_loss`` with a ``loss_mask``), ``lm_loss`` and its gradients for
one config per family, remat against no remat, whole ``make_train_step``
steps (and two microbatches), the trainer's CLI and its refusals, and the
fault-tolerant training example.

Every config is the arch's ``reduced()`` one (2 layers, d=64, float32).
Parameters are the reference's ``lm.init_params`` draws, every all-zero
leaf filled with small numpy draws so no path multiplies by 0, carried
into the port by ``convert.lm_params_from_numpy``. Inputs are numpy from
a seed. Tolerances: logits 1e-4 (two layers and the unembedding compound
float32 sums in other orders), MoE aux losses 1e-5; the loss 1e-5
relative and every gradient leaf within 1e-5 of its norm; one whole step
1e-5 (``torch_train_refs``); remat against none bit for bit (port
against port).

The vision model's two gates are held otherwise: each gate's gradient
is one sum of B x S x d = 5,120 products of either sign, which cancel
(for ``gate_attn`` the sum is 0.004 of the products' 1.76 in magnitude),
so a float32 sum in another order lands ~1e-5 of the result away. Each
is held against the same products summed in float64 (taken from the
port's forward and backward): the port within 1e-5 of it, the
reference within 1e-6 of the products' magnitude.
"""
import dataclasses
import runpy
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_threads import one_torch_thread  # noqa: F401

from repro import configs as jcfgs
from repro.configs.base import TrainConfig as JTrainConfig
from repro.launch import steps as jsteps
from repro.models import lm as jlm
from repro_torch import configs as tcfgs
from repro_torch import convert
from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.configs.base import TrainConfig
from repro_torch.launch import steps as tsteps
from repro_torch.launch import train as ttrain
from repro_torch.models import attention as tattn
from repro_torch.models import blocks as tblocks
from repro_torch.models import common as tcommon
from repro_torch.models import lm as tlm
from repro_torch.models import mlp as tmlp
from repro_torch.optim import adamw as tadamw
from torch_train_refs import (GRAD_TOL, LOSS_TOL, TC, check_step,
                              mid_run_state)

LOGIT_TOL = dict(atol=1e-4, rtol=1e-4)
AUX_TOL = dict(atol=1e-5, rtol=1e-5)
B, S = 2, 40                      # S past the reduced window (32)
ARCHS = ["deepseek-7b", "qwen2.5-14b", "gemma2-9b", "gemma3-4b", "hymba-1.5b",
         "mamba2-130m", "deepseek-moe-16b", "grok-1-314b",
         "llama-3.2-vision-90b", "whisper-small"]
# one config per family: dense, hybrid, SSM, MoE, vision, audio
GRAD_ARCHS = ["gemma2-9b", "hymba-1.5b", "mamba2-130m", "deepseek-moe-16b",
              "llama-3.2-vision-90b", "whisper-small"]
ROOT = Path(__file__).resolve().parents[1]


def fill_zero_leaves(tree, rng):
    """Every all-zero leaf gets small draws, so no path multiplies by 0."""
    def one(x):
        x = np.asarray(x)
        if not np.any(x):
            return (0.1 * rng.standard_normal(x.shape)).astype(x.dtype)
        return x
    return jax.tree.map(one, tree)


def np_batch(cfg, b=B, s=S, seed=0):
    """tokens, targets (and the vision / audio states) for one family."""
    rng = np.random.default_rng(seed)
    out = {k: rng.integers(0, cfg.vocab_size, (b, s), dtype=np.int32)
           for k in ("tokens", "targets")}
    if cfg.family == "vlm":
        out["vision"] = rng.standard_normal((b, cfg.vision_tokens, cfg.d_model)
                                            ).astype(np.float32)
    if cfg.family == "audio":
        out["frames"] = rng.standard_normal((b, cfg.audio_frames, cfg.d_model)
                                            ).astype(np.float32)
    return out


def tbatch(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


def jbatch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


class Setup:
    """One arch's reduced configs, parameters in both packages and its
    batch, with the reference's results computed once, on first use."""

    def __init__(self, arch):
        self.arch = arch
        self.jcfg = jcfgs.get_config(arch).reduced()
        self.tcfg = tcfgs.get_config(arch).reduced()
        rng = np.random.default_rng(len(arch))
        self.np_params = fill_zero_leaves(jax.tree.map(
            np.asarray, jlm.init_params(self.jcfg, jax.random.PRNGKey(3))), rng)
        self.jp = jax.tree.map(jnp.asarray, self.np_params)
        self.tp = convert.lm_params_from_numpy(self.np_params, self.tcfg,
                                               device="cpu")
        self.batch = np_batch(self.jcfg)
        self._ref = None

    def ref(self):
        """The reference's (logits, aux) and, for GRAD_ARCHS, its
        ((loss, metrics), grads), from one jitted function."""
        if self._ref is None:
            cfg = self.jcfg

            def fwd(p, b):
                return jlm.forward_train(p, b["tokens"], cfg, extra=b)

            def both(p, b):
                return fwd(p, b), jax.value_and_grad(
                    lambda q: jlm.lm_loss(q, b, cfg), has_aux=True)(p)

            grads = self.arch in GRAD_ARCHS
            self._ref = jax.jit(both if grads else fwd)(self.jp,
                                                        jbatch(self.batch))
        return self._ref


@pytest.fixture(scope="module")
def setups():
    return {}


def get(setups, arch):
    if arch not in setups:
        setups[arch] = Setup(arch)
    return setups[arch]


def close(got, want, tol):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), **tol)


def gate_sums(s, monkeypatch):
    """The vision gates' gradients as the products the port sums (the
    gated branch's output gradient times the branch, times tanh'(gate)),
    summed in float64: {path: (sum, sum of magnitudes)}."""
    rec = {}

    def gated(p, name, x, y):
        out = tblocks._gate(p[name], x.dtype) * y
        out.register_hook(lambda g: rec.__setitem__(name, (g, y.detach())))
        return out

    def recording(p, x, kv, cfg, kv_valid=None):
        h = tcommon.apply_norm(p["ln1"], x, cfg.norm_type)
        x = x + gated(p, "gate_attn", x, tattn.cross_attention(
            p["xattn"], h, kv, cfg.attn, kv_valid=kv_valid))
        h2 = tcommon.apply_norm(p["ln2"], x, cfg.norm_type)
        return x + gated(p, "gate_mlp", x, tmlp.mlp_apply(
            p["mlp"], h2, cfg.mlp_activation))

    monkeypatch.setattr(tlm, "cross_block_apply", recording)
    port_grads(s, s.batch)
    out = {}
    for name, (g, y) in rec.items():
        d = 1.0 - torch.tanh(s.tp["groups"]["cross"][name].double()) ** 2
        terms = (g * y).double() * d
        path = (jax.tree_util.DictKey("groups"), jax.tree_util.DictKey("cross"),
                jax.tree_util.DictKey(name))
        out[path] = (float(terms.sum()), float(terms.abs().sum()))
    return out


def check_grads(tg, jg, exact=None):
    """Every leaf within GRAD_TOL of its norm of the reference's, but the
    leaves in ``exact`` ({path: (float64 sum, sum of magnitudes)}): the
    port within GRAD_TOL of that sum, the reference within 1e-6 of the
    magnitudes."""
    flat_t = dict(jax.tree_util.tree_leaves_with_path(convert.tree_to_numpy(tg)))
    flat_j = dict(jax.tree_util.tree_leaves_with_path(jax.tree.map(np.asarray, jg)))
    assert flat_t.keys() == flat_j.keys()
    for path, gj in flat_j.items():
        if exact and path in exact:
            want, mag = exact[path]
            assert abs(float(flat_t[path].sum()) - want) <= GRAD_TOL * abs(want)
            assert abs(float(gj.sum()) - want) <= 1e-6 * mag
            continue
        err = np.abs(flat_t[path] - gj).max()
        assert err <= GRAD_TOL * np.linalg.norm(gj), (path, err)


def port_grads(s, batch, tcfg=None):
    return tadamw.value_and_grad(
        lambda p, b: tlm.lm_loss(p, b, tcfg or s.tcfg), s.tp, tbatch(batch))


# ---------------------------------------------------------------------------
# The training forward


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_train_matches_jax(setups, arch):
    s = get(setups, arch)
    ref = s.ref()
    j_logits, j_aux = ref[0] if arch in GRAD_ARCHS else ref
    tb = tbatch(s.batch)
    with torch.no_grad():
        logits, aux = tlm.forward_train(s.tp, tb["tokens"], s.tcfg, extra=tb)
    assert logits.dtype == torch.float32 and logits.shape == (B, S, s.tcfg.vocab_size)
    close(logits, j_logits, LOGIT_TOL)
    assert sorted(aux) == sorted(j_aux)
    for k in j_aux:
        close(aux[k], j_aux[k], AUX_TOL)
    if s.tcfg.moe is not None:
        assert float(aux["load_balance"]) > 0 and float(aux["router_z"]) > 0


def test_forward_train_with_segment_ids_matches_jax(setups):
    """gemma2-9b with two packed documents a row (split at 17 and 26):
    logits at 1e-4, and the segments change them."""
    s = get(setups, "gemma2-9b")
    seg = np.zeros((B, S), np.int32)
    seg[0, 17:], seg[1, 26:] = 1, 1
    tok = s.batch["tokens"]
    want, _ = jax.jit(lambda p, t, sid: jlm.forward_train(p, t, s.jcfg,
                                                          segment_ids=sid))(
        s.jp, jnp.asarray(tok), jnp.asarray(seg))
    with torch.no_grad():
        got, _ = tlm.forward_train(s.tp, torch.from_numpy(tok), s.tcfg,
                                   segment_ids=torch.from_numpy(seg))
        plain, _ = tlm.forward_train(s.tp, torch.from_numpy(tok), s.tcfg)
    close(got, want, LOGIT_TOL)
    assert torch.equal(got[0, :17], plain[0, :17])
    assert (got[0, 17:] - plain[0, 17:]).abs().max() > 1e-2


def test_lm_loss_with_loss_mask_matches_jax(setups):
    s = get(setups, "gemma2-9b")
    batch = dict(s.batch)
    batch["loss_mask"] = (np.random.default_rng(5).random((B, S)) < 0.6
                          ).astype(np.float32)
    want, wm = jax.jit(lambda p, b: jlm.lm_loss(p, b, s.jcfg))(s.jp, jbatch(batch))
    with torch.no_grad():
        got, m = tlm.lm_loss(s.tp, tbatch(batch), s.tcfg)
    np.testing.assert_allclose(float(got), float(want), rtol=LOSS_TOL, atol=0)
    np.testing.assert_allclose(float(m["loss"]), float(wm["loss"]), rtol=LOSS_TOL)
    # the mask changes the mean
    with torch.no_grad():
        unmasked, _ = tlm.lm_loss(s.tp, tbatch(s.batch), s.tcfg)
    assert abs(float(unmasked) - float(got)) > 1e-4


# ---------------------------------------------------------------------------
# The loss and its gradients


@pytest.mark.parametrize("arch", GRAD_ARCHS)
def test_lm_loss_and_grads_match_jax(setups, arch, monkeypatch):
    s = get(setups, arch)
    (jl, jm), jg = s.ref()[1]
    (tl, tm), tg = port_grads(s, s.batch)
    np.testing.assert_allclose(float(tl), float(jl), rtol=LOSS_TOL, atol=0)
    assert sorted(tm) == sorted(jm)
    for k in jm:
        close(tm[k], jm[k], AUX_TOL)
    check_grads(tg, jg, gate_sums(s, monkeypatch)
                if s.tcfg.family == "vlm" else None)
    assert all(torch.isfinite(g).all() and g.dtype == torch.float32
               for g in tcommon.tree_leaves(tg))


@pytest.mark.parametrize("arch", ["gemma2-9b", "deepseek-moe-16b",
                                  "llama-3.2-vision-90b"])
def test_remat_block_equals_none_bitwise(setups, arch, monkeypatch):
    """``remat="block"`` recomputes each layer (each vision group) in the
    backward: twice the calls, and the loss, metrics and every gradient
    equal bit for bit to ``"none"``."""
    s = get(setups, arch)
    fn_name = "_vlm_train_group" if s.tcfg.family == "vlm" else "_train_block"
    fn = getattr(tlm, fn_name)
    calls = []
    monkeypatch.setattr(tlm, fn_name, lambda *a: calls.append(1) or fn(*a))
    out = {}
    for remat in ("none", "block"):
        calls.clear()
        out[remat] = port_grads(s, s.batch, dataclasses.replace(s.tcfg,
                                                                remat=remat))
        out[remat + "_calls"] = len(calls)
    n = out["none_calls"]
    assert n == (s.tcfg.num_layers // 2 if fn_name == "_vlm_train_group"
                 else s.tcfg.num_layers)
    assert out["block_calls"] == 2 * n
    (l0, m0), g0 = out["none"]
    (l1, m1), g1 = out["block"]
    assert torch.equal(l0, l1)
    assert all(torch.equal(m0[k], m1[k]) for k in m0)
    assert all(torch.equal(a, b) for a, b in zip(tcommon.tree_leaves(g0),
                                                 tcommon.tree_leaves(g1)))


# ---------------------------------------------------------------------------
# Whole steps


@pytest.mark.parametrize("arch,n_micro", [("gemma2-9b", 1), ("deepseek-moe-16b", 1),
                                          ("gemma2-9b", 2)])
def test_train_step_matches_jax(setups, arch, n_micro):
    """The reference's own make_train_step against the port's, one whole
    step from a mid-run AdamW state; with two microbatches, each one row
    of the batch."""
    s = get(setups, arch)
    state = mid_run_state(s.np_params)
    jstep = jax.jit(jsteps.make_train_step(s.jcfg, JTrainConfig(**TC),
                                           n_microbatches=n_micro))
    jp2, jo2, jm = jstep(s.jp, jax.tree.map(jnp.asarray, state),
                         jbatch(s.batch))
    step = tsteps.make_train_step(s.tcfg, TrainConfig(**TC),
                                  n_microbatches=n_micro)
    tstate = convert.opt_state_from_numpy(state, device="cpu")
    # the step writes its trees in place: step a copy of the shared setup's
    tp = tcommon.tree_map(torch.clone, s.tp)
    tp2, to2, tm = step(tp, tstate, tbatch(s.batch))
    assert tp2 is tp and to2 is tstate
    check_step(tp2, to2, jax.tree.map(np.asarray, jp2), jo2)
    assert int(to2["step"]) == int(jo2["step"]) == 6
    assert sorted(tm) == sorted(jm)
    for k in jm:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5,
                                   atol=1e-7)


# ---------------------------------------------------------------------------
# Entry points and refusals


def test_train_cli_trains_an_lm_and_checkpoints(tmp_path):
    out = ttrain.main(["--arch", "deepseek-7b", "--smoke", "--steps", "3",
                       "--batch", "4", "--seq", "32", "--device", "cpu",
                       "--ckpt-dir", str(tmp_path)])
    assert out["cfg"].family == "dense"
    ck = Checkpointer(out["ckpt_root"], async_save=False)
    assert ck.all_steps() == [3]
    tree, _ = ck.restore(device="cpu")
    assert int(tree["opt"]["step"]) == 3
    jax.tree.map(lambda a, b: np.testing.assert_array_equal(a, b),
                 convert.tree_to_numpy(tree["params"]),
                 convert.tree_to_numpy(out["params"]))
    assert [s for s, _ in out["losses"]] == [0, 2]
    assert all(np.isfinite(l) for _, l in out["losses"])


@pytest.mark.parametrize("arch", ["llama-3.2-vision-90b", "whisper-small"])
def test_train_cli_refuses_vision_and_audio(arch):
    with pytest.raises(ValueError, match="make_train_step"):
        ttrain.main(["--arch", arch, "--smoke", "--device", "cpu"])


def test_sequence_parallel_raises_naming_the_distributed_slice(setups):
    """Once a raise naming the distributed slice, now the behaviour: with
    no mesh, ``sequence_parallel`` (remat "block" too) is the plain
    forward bit for bit (its constraint is the identity, as the
    reference's), and equals the JAX package's ``forward_train`` with
    ``sequence_parallel=True``: the logits at 1e-5 of their norm, each
    row within LOGIT_TOL, the loss at 1e-5. Under a mesh it is held in
    ``test_torch_sharded_train.py``."""
    s = get(setups, "gemma2-9b")
    toks = torch.from_numpy(s.batch["tokens"])
    plain, _ = tlm.forward_train(s.tp, toks, s.tcfg)
    for remat in ("none", "block"):
        cfg = dataclasses.replace(s.tcfg, sequence_parallel=True, remat=remat)
        got, _ = tlm.forward_train(s.tp, toks, cfg)
        assert torch.equal(got, plain)
    jcfg = dataclasses.replace(s.jcfg, sequence_parallel=True)
    want, _ = jax.jit(lambda p, t: jlm.forward_train(p, t, jcfg))(
        s.jp, jnp.asarray(s.batch["tokens"]))
    close(got, want, LOGIT_TOL)
    want = np.asarray(want)
    assert np.linalg.norm(got.numpy() - want) <= 1e-5 * np.linalg.norm(want)
    (tl, _), _ = port_grads(s, s.batch, cfg)
    (jl, _), _ = s.ref()[1]
    np.testing.assert_allclose(float(tl), float(jl), rtol=LOSS_TOL, atol=0)


def test_fault_tolerant_training_example_runs(tmp_path, capsys):
    mod = runpy.run_path(str(ROOT / "examples" / "torch_fault_tolerant_training.py"))
    out = mod["main"](["--device", "cpu", "--ckpt-dir", str(tmp_path)])
    kinds = [e.kind for e in out["events"]]
    assert kinds.count("failure") == 1 and "rescale" in kinds and "restart" in kinds
    assert all(np.isfinite(l) for l in out["losses"])
    assert out["checkpoints"] and out["checkpoints"][-1] <= 40
    assert "injecting failure of workers [2, 6]" in capsys.readouterr().out
