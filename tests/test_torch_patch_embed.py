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
from repro_torch.kernels.patch_embed import patch_embed as tpe
from repro_torch.kernels.patch_embed.ref import (patch_deembed_ref,
                                                 patch_deembed_split_k,
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
    ttree = convert.params_from_numpy(tree, device="cpu")
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


# de-embed (N, K, M): the DiT-XL/2 path at B=8 (mode 0, mode 1), a ragged
# N, K not in whole 64-chunks, and the JAX package's PE_CASES
PLAN_SHAPES = [(2048, 1152, 32), (512, 1152, 128), (2000, 1152, 32),
               (256, 1000, 64), (100, 72, 16), (100, 40, 16)] + [c[:3] for c in PE_CASES]
# blocks the mma.sync de-embed launches at the path shapes (16-row x 64-column tiles)
MMA_BLOCKS = {(2048, 1152, 32): 128, (512, 1152, 128): 64}


@pytest.mark.parametrize("shape", PLAN_SHAPES,
                         ids=[f"n{n}k{k}m{m}" for n, k, m in PLAN_SHAPES])
def test_deembed_tile_plan(shape):
    """K slices cover K with none empty, the cluster is portable, one CTA's
    shared memory fits, and the path shapes launch at least as many CTAs
    as the mma.sync de-embed kernel."""
    N, K, M = shape
    plan = tpe.deembed_plan(N, K, M)
    assert plan is not None
    assert 1 <= plan.cluster <= 8 and plan.k_slice % 64 == 0
    assert (plan.cluster - 1) * plan.k_slice < K <= plan.cluster * plan.k_slice
    assert plan.smem_bytes() <= 227 * 1024
    assert plan.row_tile == 64
    assert plan.col_tile == (64 if M % 64 == 0 else 32)
    if shape in MMA_BLOCKS:
        assert plan.ctas(N, M) >= MMA_BLOCKS[shape]
    if K == 1152:
        assert (plan.cluster, plan.k_slice) == (6, 192)
    assert tpe.select_deembed_variant(torch.bfloat16, N, K, M, True) == (
        "cluster" if K % 8 == 0 and M % 8 == 0 and K >= 64 else "mma")
    assert tpe.select_deembed_variant(torch.bfloat16, N, K, M, False) == "mma"
    assert tpe.select_deembed_variant(torch.float32, N, K, M, True) == "f32"


def test_deembed_plan_refuses_what_shared_memory_cannot_hold():
    assert tpe.deembed_plan(64, 64 * 8 * 14, 64) is None
    assert tpe.select_deembed_variant(torch.bfloat16, 64, 64 * 8 * 14, 64,
                                      True) == "mma"


@pytest.mark.parametrize("case", PE_CASES, ids=[f"s{i}" for i in range(len(PE_CASES))])
def test_split_k_order_matches_jax_deembed(case):
    """The cluster kernel's order of sums (per-slice float32 partials in
    rank order, the bias, one rounding) against the JAX Pallas de-embed in
    interpret mode, at the plan the kernel would take."""
    N, K, M, dtype = case
    rng = np.random.default_rng(N + K + M)
    x, w, b = (rng.standard_normal(s).astype(np.float32)
               for s in ((N, K), (K, M), (M,)))
    plan = tpe.deembed_plan(N, K, M)
    want = patch_deembed_pallas(_jax(x, dtype), _jax(w, dtype), _jax(b, dtype),
                                block_n=min(256, N))
    got = patch_deembed_split_k(_torch(x, dtype), _torch(w, dtype),
                                _torch(b, dtype), plan.cluster, plan.k_slice)
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               atol=TOL[dtype], rtol=TOL[dtype])


# embed (N, K, M) -> (row tiles, column tiles): the DiT-XL/2 path at B=8
# (mode 0, mode 1) and the JAX package's bf16 case
EMBED_PLANS = {(2048, 16, 1152): (32, 18), (512, 64, 1152): (8, 18),
               (1024, 128, 512): (16, 8)}
# and shapes whose CTAs walk several row tiles, a ragged N, M = 72
EMBED_SHAPES = list(EMBED_PLANS) + [(16384, 16, 1152), (8192, 64, 1152),
                                    (4096, 256, 1152), (2000, 16, 1152),
                                    (256, 48, 128), (256, 16, 72), (100, 24, 40)]


@pytest.mark.parametrize("shape", EMBED_SHAPES,
                         ids=[f"n{n}k{k}m{m}" for n, k, m in EMBED_SHAPES])
def test_embed_tile_plan(shape):
    """64 x 64 tiles that cover the output, no more than one tile past it
    either way, and the path shapes' tile counts (576 and 144)."""
    N, K, M = shape
    plan = tpe.embed_plan(N, K, M)
    assert plan is not None
    assert (plan.row_tile, plan.col_tile) == (64, tpe.EMBED_COL_TILE) == (64, 64)
    assert plan.row_tiles * 64 >= N > (plan.row_tiles - 1) * 64
    assert plan.col_tiles * 64 >= M > (plan.col_tiles - 1) * 64
    assert plan.tiles == plan.row_tiles * plan.col_tiles
    if shape in EMBED_PLANS:
        assert (plan.row_tiles, plan.col_tiles) == EMBED_PLANS[shape]
    assert {(2048, 16, 1152): 576, (512, 64, 1152): 144}.get(shape, plan.tiles) \
        == plan.tiles
    assert tpe.select_embed_variant(torch.bfloat16, N, K, M, True) == "wgmma"


def test_embed_plan_shared_memory_by_hand():
    """EMBED_MAX_K is the largest K whose 2-stage ring fits 227 KB, as
    ``ek::geo`` counts it: W in whole 64-row boxes of 128 B rows, two X
    stages of 64 rows, two 64 x 64 staging tiles, 64 bf16 biases, three
    barriers, 1 KB alignment slack. K = 544 (34 steps of 16, W 576 rows)
    fits; K = 552 (35 steps) does not."""
    def two_stage_bytes(K):
        kp = -(-K // 16) * 16
        return -(-kp // 64) * 64 * 128 + 2 * 64 * kp * 2 + 2 * 64 * 128 + 128 + 24 + 1024
    assert two_stage_bytes(544) == 73728 + 139264 + 16384 + 1176 <= tpe.SMEM_LIMIT
    assert two_stage_bytes(552) > tpe.SMEM_LIMIT
    assert tpe.EMBED_MAX_K == 544
    assert tpe.embed_plan(100, 544, 64) is not None
    assert tpe.embed_plan(100, 552, 64) is None


@pytest.mark.parametrize("case", [
    (torch.float32, 2048, 16, 1152, True, "f32"),
    (torch.bfloat16, 2048, 16, 1152, False, "mma"),     # misaligned base
    (torch.bfloat16, 2048, 20, 1152, True, "mma"),      # K not a multiple of 8
    (torch.bfloat16, 2048, 16, 1150, True, "mma"),      # M not a multiple of 8
    (torch.bfloat16, 64, 1024, 64, True, "mma"),        # plan exceeds shared memory
    (torch.bfloat16, 512, 64, 1152, True, "wgmma"),
], ids=["f32", "misaligned", "k20", "m1150", "k1024", "path"])
def test_select_embed_variant(case):
    dtype, N, K, M, aligned, want = case
    assert tpe.select_embed_variant(dtype, N, K, M, aligned) == want
    if K == 1024:
        assert tpe.embed_plan(N, K, M) is None


def test_embed_launches_by_variant_stay_zero_on_cpu_and_reset():
    """CPU tensors run the plain version and count no variant;
    reset_launches() sets every count back to 0."""
    ops.reset_launches()
    x = torch.zeros(1, 1, 8, 8, 4, dtype=torch.bfloat16)
    w, b = torch.zeros(16, 4, 32), torch.zeros(32)
    ops.embed_tokens_flex(w, b, x, (1, 2, 2), (1, 4, 4))
    assert ops.embed_tokens_flex.launches_by_variant == {"wgmma": 0, "mma": 0,
                                                         "f32": 0}
    ops.embed_tokens_flex.launches_by_variant["wgmma"] = 3
    ops.embed_tokens_flex.launches = 3
    ops.reset_launches()
    assert ops.embed_tokens_flex.launches == 0
    assert set(ops.embed_tokens_flex.launches_by_variant.values()) == {0}
    assert tuple(ops.embed_tokens_flex.launches_by_variant) == tpe.EMBED_VARIANTS
