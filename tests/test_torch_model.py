"""The port's configs, PI-resize, tokenization, DiT forward and flexify
against the JAX package, on the same numpy-seeded inputs and weights.

Tolerance: float32, 1e-5 absolute and relative per module (both sides
compute in float32; only the order of the sums differs). Integer and
host-numpy results (configs, resize matrices, masks) must be equal.
"""
import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_threads import one_torch_thread  # noqa: F401

from repro import configs as jcfgs
from repro.core import patch as jpatch
from repro.core import resize as jresize
from repro.models import common as jcommon
from repro.models import dit as jdit
from repro_torch import configs as tcfgs
from repro_torch import convert
from repro_torch.core import patch as tpatch
from repro_torch.core import resize as tresize
from repro_torch.models import common as tcommon
from repro_torch.models import dit as tdit

# repro.core and repro_torch.core re-export the function flexify under
# the module's name
jflex = importlib.import_module("repro.core.flexify")
tflex = importlib.import_module("repro_torch.core.flexify")

TOL = dict(atol=1e-5, rtol=1e-5)


def to_torch(tree):
    return convert.params_from_numpy(jax.tree.map(np.asarray, tree), device="cpu")


def trained_like(cfg, seed: int = 0):
    """Random reference weights with the zero-initialized gates made
    non-zero (de-embed, final and block adaLN, per-mode embed/LN, LoRA
    ``b``, cross-attention out), so no path hides behind a zero."""
    key = jax.random.PRNGKey(seed)
    p = jdit.init_dit(cfg, key)

    def rnd(i, shape, scale):
        return jax.random.normal(jax.random.fold_in(key, i), shape) * scale

    p["deembed"]["w_flex"] = rnd(1, p["deembed"]["w_flex"].shape, 0.1)
    p["final"]["ada"]["w"] = rnd(2, p["final"]["ada"]["w"].shape, 0.05)
    p["blocks"]["ada"]["w"] = rnd(3, p["blocks"]["ada"]["w"].shape, 0.05)
    if "xattn" in p["blocks"]:
        p["blocks"]["xattn"]["wo"] = rnd(4, p["blocks"]["xattn"]["wo"].shape, 0.05)
    return p


def _gates(p, seed: int = 5):
    key = jax.random.PRNGKey(seed)
    out = dict(p)
    if "ps_embed" in p:
        out["ps_embed"] = jax.random.normal(key, p["ps_embed"].shape) * 0.1
        out["ps_ln"] = {k: jax.random.normal(jax.random.fold_in(key, i), v.shape) * 0.1
                        for i, (k, v) in enumerate(p["ps_ln"].items())}
    if "lora" in p["blocks"]:
        blocks = dict(p["blocks"])
        blocks["lora"] = jax.tree.map(
            lambda a: jax.random.normal(jax.random.fold_in(key, a.size), a.shape) * 0.05,
            p["blocks"]["lora"])
        out["blocks"] = blocks
    return out


@pytest.fixture(scope="module")
def models(tiny_dit_cfg):
    """Reference (params, cfg) per model kind."""
    out = {}
    fp, fc = jflex.flexify(trained_like(tiny_dit_cfg), tiny_dit_cfg,
                           [(1, 4, 4), (1, 8, 8)])
    out["flex2"] = (_gates(fp), fc)
    xl = jcfgs.get_config("dit-xl-2").reduced()
    out["xl"] = (_gates(trained_like(xl, 1)), xl)
    tcfg = dataclasses.replace(tiny_dit_cfg, dit=dataclasses.replace(
        tiny_dit_cfg.dit, conditioning="text", text_len=8, text_dim=32))
    tp, tc = jflex.flexify(trained_like(tcfg, 2), tcfg, [(1, 4, 4)])
    out["text"] = (_gates(tp), tc)
    lp, lc = jflex.flexify(trained_like(tiny_dit_cfg, 3), tiny_dit_cfg,
                           [(1, 4, 4)], lora_rank=4)
    out["lora"] = (_gates(lp), lc)
    return out


# ---------------------------------------------------------------------------
# Configs, resize, tokenization


def test_configs_equal_field_for_field():
    for name in tcfgs.DIT_ARCHS:
        want = jcfgs.get_config(name)
        got = tcfgs.get_config(name)
        assert dataclasses.asdict(got) == dataclasses.asdict(want), name
        assert dataclasses.asdict(got.reduced()) == \
            dataclasses.asdict(want.reduced()), name


RESIZE_PAIRS = [((1, 2, 2), (1, 2, 2)), ((1, 2, 2), (1, 4, 4)),
                ((1, 4, 4), (1, 4, 4)), ((1, 2, 2), (1, 8, 8)),
                ((1, 4, 4), (1, 8, 8)), ((1, 8, 8), (1, 8, 8)),
                ((1, 2, 2), (2, 4, 4)), ((2, 2, 2), (2, 4, 4)),
                ((1, 4, 4), (2, 4, 4)), ((2, 4, 4), (2, 4, 4))]


def test_resize_pairs_cover_every_config():
    """Every (patch, underlying) pair the configs use is in RESIZE_PAIRS."""
    for name in tcfgs.DIT_ARCHS:
        dit = tcfgs.get_config(name).dit
        for p in (dit.patch_size,) + dit.flex_patch_sizes:
            assert (p, dit.underlying_patch_size) in RESIZE_PAIRS


@pytest.mark.parametrize("pair", RESIZE_PAIRS, ids=str)
def test_resize_matches_reference(pair):
    a, pp = pair
    np.testing.assert_array_equal(tresize.b_up(a, pp), jresize.b_up(a, pp))
    np.testing.assert_allclose(tresize.q_embed(a, pp), jresize.q_embed(a, pp),
                               atol=1e-12)
    np.testing.assert_allclose(tresize.q_deembed(a, pp),
                               jresize.q_deembed(a, pp), atol=1e-12)


@pytest.mark.parametrize("p", [(1, 2, 2), (1, 4, 4), (2, 2, 2)], ids=str)
def test_patchify_pos_embed_and_flex_embed(p):
    rng = np.random.default_rng(0)
    ls = (2, 8, 8, 4)
    x = rng.standard_normal((3,) + ls).astype(np.float32)
    tok = tpatch.patchify(torch.from_numpy(x), p)
    np.testing.assert_array_equal(tok.numpy(),
                                  np.asarray(jpatch.patchify(jnp.asarray(x), p)))
    np.testing.assert_array_equal(tpatch.unpatchify(tok, ls, p).numpy(), x)
    coords = tpatch.patch_centers(ls, p)
    np.testing.assert_array_equal(coords, jpatch.patch_centers(ls, p))
    np.testing.assert_array_equal(tpatch.sincos_pos_embed(48, coords),
                                  jpatch.sincos_pos_embed(48, coords))
    pp, d = (2, 4, 4), 16
    w = rng.standard_normal((32, 4, d)).astype(np.float32)
    b = rng.standard_normal((d,)).astype(np.float32)
    got = tpatch.embed_tokens_flex(torch.from_numpy(w), torch.from_numpy(b),
                                   torch.from_numpy(x), p, pp)
    want = jpatch.embed_tokens_flex(jnp.asarray(w), jnp.asarray(b),
                                    jnp.asarray(x), p, pp)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    wd = rng.standard_normal((d, 8, 32)).astype(np.float32)
    bd = rng.standard_normal((8, 32)).astype(np.float32)
    tk = rng.standard_normal((3, tpatch.num_tokens(ls, p), d)).astype(np.float32)
    got = tpatch.deembed_tokens_flex(torch.from_numpy(wd), torch.from_numpy(bd),
                                     torch.from_numpy(tk), ls, p, pp, 8)
    want = jpatch.deembed_tokens_flex(jnp.asarray(wd), jnp.asarray(bd),
                                      jnp.asarray(tk), ls, p, pp, 8)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_timestep_embedding_and_layer_norm():
    t = np.array([0, 1, 17, 999], np.float32)
    # XLA's and torch's float32 exp differ by up to one ulp (2**-24 relative)
    # in some frequencies; cos/sin of t·f turn that into up to t·2**-24
    # absolute, so the bound grows with the largest timestep
    atol = 1e-5 + float(t.max()) * 2.0 ** -23
    for dim in (256, 7):
        np.testing.assert_allclose(
            tcommon.timestep_embedding(torch.from_numpy(t), dim).numpy(),
            np.asarray(jcommon.timestep_embedding(jnp.asarray(t), dim)),
            atol=atol, rtol=1e-5)
    x = np.random.default_rng(1).standard_normal((3, 5, 32)).astype(np.float32)
    s, b = x[0, 0] * 0.1 + 1.0, x[0, 1] * 0.1
    np.testing.assert_allclose(
        tcommon.layer_norm(torch.from_numpy(x), torch.from_numpy(s),
                           torch.from_numpy(b)).numpy(),
        np.asarray(jcommon.layer_norm(jnp.asarray(x), jnp.asarray(s),
                                      jnp.asarray(b))), **TOL)


def test_convert_keeps_names_shapes_and_bf16_values():
    xl = jcfgs.get_config("dit-xl-2").reduced(param_dtype="bfloat16")
    jp = jdit.init_dit(xl, jax.random.PRNGKey(0))
    tp = to_torch(jp)
    flat_j = jax.tree_util.tree_flatten_with_path(jp)[0]
    for path, leaf in flat_j:
        node = tp
        for k in path:
            node = node[k.key]
        assert node.dtype == torch.bfloat16 and tuple(node.shape) == leaf.shape
        np.testing.assert_array_equal(node.float().numpy(),
                                      np.asarray(leaf, np.float32))


# ---------------------------------------------------------------------------
# DiT forward


def _inputs(cfg, B: int = 2, seed: int = 0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B,) + cfg.dit.latent_shape).astype(np.float32)
    t = np.array([3, 71][:B], np.int32)
    if cfg.dit.conditioning == "text":
        cond = rng.standard_normal((B, cfg.dit.text_len,
                                    cfg.dit.text_dim)).astype(np.float32)
        mask = np.ones((B, cfg.dit.text_len), bool)
        mask[0, 5:] = False
    else:
        cond, mask = np.array([1, 7][:B], np.int32), None
    return x, t, cond, mask


FWD_CASES = [("flex2", 0, "dense"), ("flex2", 1, "dense"), ("flex2", 2, "dense"),
             ("xl", 0, "dense"), ("xl", 1, "dense"), ("xl", 0, "pallas"),
             ("xl", 1, "pallas"), ("text", 0, "dense"), ("text", 1, "dense"),
             ("lora", 0, "dense"), ("lora", 1, "dense")]


@pytest.mark.parametrize("case", FWD_CASES, ids=lambda c: f"{c[0]}-m{c[1]}-{c[2]}")
def test_dit_forward_matches_reference(models, case):
    kind, mode, backend = case
    jp, cfg = models[kind]
    x, t, cond, mask = _inputs(cfg)
    want = jdit.dit_forward(jp, jnp.asarray(x), jnp.asarray(t),
                            jnp.asarray(cond), cfg, mode=mode,
                            text_mask=None if mask is None else jnp.asarray(mask),
                            attn_backend=backend)
    tcfg = tcfgs.base.ModelConfig(**{f.name: getattr(cfg, f.name)
                                     for f in dataclasses.fields(cfg)})
    got = tdit.dit_forward(to_torch(jp), torch.from_numpy(x), torch.from_numpy(t),
                           torch.from_numpy(cond), tcfg, mode=mode,
                           text_mask=None if mask is None else torch.from_numpy(mask),
                           attn_backend=backend)
    assert float(np.abs(np.asarray(want)).max()) > 1e-2     # not all zeros
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("refresh", [True, False])
@pytest.mark.parametrize("mode", [0, 1])
def test_dit_forward_block_cache_matches_reference(models, refresh, mode):
    jp, cfg = models["flex2"]
    x, t, cond, _ = _inputs(cfg)
    n = jdit.tokens_for_mode(cfg, mode)
    delta = np.random.default_rng(2).standard_normal(
        (2, n, cfg.d_model)).astype(np.float32) * 0.1
    jc = jdit.BlockCache(delta=jnp.asarray(delta), refresh=jnp.asarray(refresh),
                         split=1)
    w_out, w_delta = jdit.dit_forward(jp, jnp.asarray(x), jnp.asarray(t),
                                      jnp.asarray(cond), cfg, mode=mode,
                                      block_cache=jc)
    tc = tdit.BlockCache(delta=torch.from_numpy(delta), refresh=refresh, split=1)
    g_out, g_delta = tdit.dit_forward(to_torch(jp), torch.from_numpy(x),
                                      torch.from_numpy(t), torch.from_numpy(cond),
                                      cfg, mode=mode, block_cache=tc)
    np.testing.assert_allclose(g_out.numpy(), np.asarray(w_out), **TOL)
    np.testing.assert_allclose(g_delta.numpy(), np.asarray(w_delta), **TOL)
    if refresh:   # a refresh step is the uncached forward
        plain = tdit.dit_forward(to_torch(jp), torch.from_numpy(x),
                                 torch.from_numpy(t), torch.from_numpy(cond),
                                 cfg, mode=mode)
        torch.testing.assert_close(g_out, plain, atol=0, rtol=0)


# ---------------------------------------------------------------------------
# Flexify and LoRA merge


@pytest.mark.parametrize("lora_rank", [0, 4])
def test_flexify_matches_reference(tiny_dit_cfg, lora_rank):
    jp = trained_like(tiny_dit_cfg, 4)
    want, wcfg = jflex.flexify(jp, tiny_dit_cfg, [(1, 4, 4), (1, 8, 8)],
                               lora_rank=lora_rank)
    got, gcfg = tflex.flexify(to_torch(jp), tiny_dit_cfg, [(1, 4, 4), (1, 8, 8)],
                              lora_rank=lora_rank)
    assert gcfg == wcfg
    flat_w = jax.tree_util.tree_flatten_with_path(want)[0]
    n = 0
    for path, leaf in flat_w:
        keys = [k.key for k in path]
        if "lora" in keys and keys[-1] == "a":
            continue          # random init: torch's draws, not threefry's
        node = got
        for k in keys:
            node = node[k]
        np.testing.assert_allclose(node.numpy(), np.asarray(leaf), **TOL)
        n += 1
    assert n == len(flat_w) - (6 if lora_rank else 0)
    mask = tflex.trainable_mask(got, "lora")
    assert mask["ps_embed"] is True and mask["embed"]["w_flex"] is False


def test_merge_lora_matches_reference(models):
    jp, cfg = models["lora"]
    want = jflex.merge_lora(jp, cfg, 1)
    got = tflex.merge_lora(to_torch(jp), cfg, 1)
    assert "lora" not in got["blocks"]
    for grp, name in [("attn", "wq"), ("attn", "wo"), ("mlp", "w_in"),
                      ("mlp", "w_out")]:
        np.testing.assert_allclose(got["blocks"][grp][name].numpy(),
                                   np.asarray(want["blocks"][grp][name]), **TOL)


@pytest.mark.parametrize("helper", ["leaf_to_torch", "params_from_numpy",
                                    "init_ssm_state"])
def test_helpers_default_to_cuda(helper):
    """The weight bridge and the SSM state land on CUDA unless the caller
    passes device="cpu"; without CUDA the default raises."""
    from repro_torch.models import ssm as tssm
    cfg = tcfgs.get_config("mamba2-130m").ssm
    calls = {
        "leaf_to_torch": lambda **kw: convert.leaf_to_torch(np.ones(3, np.float32), **kw),
        "params_from_numpy": lambda **kw: convert.params_from_numpy(
            {"a": {"b": np.ones(2, np.float32)}}, **kw)["a"]["b"],
        "init_ssm_state": lambda **kw: tssm.init_ssm_state(1, 64, cfg, torch.float32,
                                                           **kw)["h"],
    }
    assert calls[helper](device="cpu").device.type == "cpu"
    if torch.cuda.is_available():
        assert calls[helper]().device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            calls[helper]()
