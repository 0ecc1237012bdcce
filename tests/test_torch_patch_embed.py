"""The port's flexible tokenizer kernels against the JAX package's Pallas
kernels, on the CPU.

On the CPU the port's wrappers run their plain versions
(``kernels/patch_embed/ref.py``); the JAX kernels run in interpret mode,
as the JAX package's own tests run them. Inputs are made with numpy from a
seed and handed to both. Tolerance: f32 1e-5 (both sides sum in float32,
in different orders); bf16 5e-2, the JAX package's own level for these
kernels (outputs may differ by one bf16 rounding). The Hopper kernels run
only on a CUDA card: ``test_torch_gpu.py`` holds them there.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jcfgs
from repro.core import patch as jpatch
from repro.kernels.patch_embed import ops as jops
from repro.kernels.patch_embed.patch_embed import (patch_deembed_pallas,
                                                   patch_embed_pallas)
from repro.models import dit as jdit
from repro_torch import convert
from repro_torch.core import patch as tpatch
from repro_torch.kernels.patch_embed import ops
from repro_torch.kernels.patch_embed.ref import (patch_deembed_ref,
                                                 patch_embed_ref)

# the JAX package's PE_CASES (tests/test_kernels.py)
PE_CASES = [(512, 64, 256, "float32"), (256, 48, 128, "float32"),
            (1024, 128, 512, "bfloat16"), (256, 16, 64, "float32")]
TOL = {"float32": 1e-5, "bfloat16": 5e-2}


def _jax(a, dtype):
    return jnp.asarray(a, jnp.bfloat16 if dtype == "bfloat16" else jnp.float32)


def _torch(a, dtype):
    return torch.from_numpy(a).to(getattr(torch, dtype))


@pytest.mark.parametrize("case", PE_CASES, ids=[f"p{i}" for i in range(len(PE_CASES))])
@pytest.mark.parametrize("which", ["embed", "deembed"])
def test_plain_patch_kernels_match_jax_kernels(case, which):
    N, K, d, dtype = case
    rng = np.random.default_rng(N + d)
    x, w, b = (rng.standard_normal(s).astype(np.float32)
               for s in ((N, K), (K, d), (d,)))
    if which == "embed":
        want = patch_embed_pallas(_jax(x, dtype), _jax(w, dtype), _jax(b, dtype),
                                  block_n=min(256, N), block_d=min(256, d))
        got = patch_embed_ref(_torch(x, dtype), _torch(w, dtype), _torch(b, dtype))
    else:
        want = patch_deembed_pallas(_jax(x, dtype), _jax(w, dtype),
                                    _jax(b, dtype), block_n=min(256, N))
        got = patch_deembed_ref(_torch(x, dtype), _torch(w, dtype),
                                _torch(b, dtype))
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               atol=TOL[dtype], rtol=TOL[dtype])


@pytest.fixture(scope="module")
def xl_tokenizer():
    """Reduced DiT-XL/2 tokenizer weights (non-zero de-embedding) in both
    packages, and a B=2 latent."""
    cfg = jcfgs.get_config("dit-xl-2").reduced()
    p = jdit.init_dit(cfg, jax.random.PRNGKey(0))
    rng = np.random.default_rng(1)
    tree = {"embed": jax.tree.map(np.asarray, p["embed"]),
            "deembed": {"w_flex": rng.standard_normal(
                p["deembed"]["w_flex"].shape).astype(np.float32) * 0.1,
                "b_flex": rng.standard_normal(
                    p["deembed"]["b_flex"].shape).astype(np.float32) * 0.1}}
    tree["embed"]["b"] = rng.standard_normal(tree["embed"]["b"].shape
                                             ).astype(np.float32) * 0.1
    x = rng.standard_normal((2,) + tuple(cfg.dit.latent_shape)).astype(np.float32)
    return cfg, tree, x


@pytest.mark.parametrize("mode", [0, 1])
def test_flex_tokenizer_ops_match_jax_ops(xl_tokenizer, mode):
    """ops.embed_tokens_flex / deembed_tokens_flex against the JAX ops at
    a reduced DiT-XL/2 (d=64, 16x16x4 latent), each patch size."""
    cfg, tree, x = xl_tokenizer
    dit = cfg.dit
    p = (dit.patch_size,) + dit.flex_patch_sizes
    p = p[mode]
    pp = dit.underlying_patch_size
    c_out = tree["deembed"]["w_flex"].shape[1]
    jtree = jax.tree.map(jnp.asarray, tree)
    ttree = convert.params_from_numpy(tree)
    want = jops.embed_tokens_flex(jtree["embed"]["w_flex"], jtree["embed"]["b"],
                                  jnp.asarray(x), p, pp)
    got = ops.embed_tokens_flex(ttree["embed"]["w_flex"], ttree["embed"]["b"],
                                torch.from_numpy(x), p, pp)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)
    tok = np.array(want)
    want_de = jops.deembed_tokens_flex(jtree["deembed"]["w_flex"],
                                       jtree["deembed"]["b_flex"], jnp.asarray(tok),
                                       dit.latent_shape, p, pp, c_out)
    got_de = ops.deembed_tokens_flex(ttree["deembed"]["w_flex"],
                                     ttree["deembed"]["b_flex"], torch.from_numpy(tok),
                                     dit.latent_shape, p, pp, c_out)
    assert got_de.shape == (2,) + tuple(dit.latent_shape[:3]) + (c_out,)
    np.testing.assert_allclose(got_de.numpy(), np.asarray(want_de),
                               atol=1e-5, rtol=1e-5)
    # and the JAX package's core path (what dit_forward calls)
    np.testing.assert_allclose(
        got_de.numpy(), np.asarray(jpatch.deembed_tokens_flex(
            jtree["deembed"]["w_flex"], jtree["deembed"]["b_flex"], jnp.asarray(tok),
            dit.latent_shape, p, pp, c_out)), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("p", [(1, 2, 2), (1, 4, 4)])
def test_flex_tokenizer_ops_match_core_path(p):
    """The port's version of test_flexi_embed_kernel_matches_core_path:
    the ops entry equals the port's core/patch.py path."""
    rng = np.random.default_rng(0)
    x, w_flex, b = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
                    for s in ((2, 1, 16, 16, 4), (16, 4, 64), (64,)))
    w_de, b_de = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
                  for s in ((64, 8, 16), (8, 16)))
    tok = ops.embed_tokens_flex(w_flex, b, x, p, (1, 4, 4))
    torch.testing.assert_close(tok, tpatch.embed_tokens_flex(w_flex, b, x, p, (1, 4, 4)),
                               atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(
        ops.deembed_tokens_flex(w_de, b_de, tok, (1, 16, 16, 4), p, (1, 4, 4), 8),
        tpatch.deembed_tokens_flex(w_de, b_de, tok, (1, 16, 16, 4), p, (1, 4, 4), 8),
        atol=1e-5, rtol=1e-5)


def test_tokenizer_wrappers_count_only_kernel_launches_and_reject_devices():
    """CPU tensors take the plain version and add nothing to the counts;
    a device that is neither cuda nor cpu raises."""
    x = torch.zeros(1, 1, 8, 8, 4)
    w, b = torch.zeros(16, 4, 32), torch.zeros(32)
    w_de, b_de = torch.zeros(32, 8, 16), torch.zeros(8, 16)
    before = (ops.embed_tokens_flex.launches, ops.deembed_tokens_flex.launches)
    tok = ops.embed_tokens_flex(w, b, x, (1, 2, 2), (1, 4, 4))
    ops.deembed_tokens_flex(w_de, b_de, tok, (1, 8, 8, 4), (1, 2, 2), (1, 4, 4), 8)
    assert (ops.embed_tokens_flex.launches, ops.deembed_tokens_flex.launches) == before
    with pytest.raises(ValueError, match="cuda or cpu"):
        ops.embed_tokens_flex(w.to("meta"), b.to("meta"), x.to("meta"),
                              (1, 2, 2), (1, 4, 4))
    with pytest.raises(ValueError, match="cuda or cpu"):
        ops.deembed_tokens_flex(w_de.to("meta"), b_de.to("meta"), tok.to("meta"),
                                (1, 8, 8, 4), (1, 2, 2), (1, 4, 4), 8)
