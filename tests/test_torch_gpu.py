"""The port's CUDA kernels against their plain PyTorch versions, on a CUDA
card. Every test here is marked ``gpu`` and skips without a card.

This file imports neither JAX nor the JAX package, so it also runs on a
machine that has only PyTorch (run it without the repository's conftest,
which imports JAX):

    PYTHONPATH=src python -m pytest -q --noconftest -m gpu tests/test_torch_gpu.py

Tolerance: the JAX package's kernel-test levels (tests/test_kernels.py).
Flash attention: f32 2e-5, bf16 2e-2; the kernel and the plain version sum
in float32 in different orders, and the bf16 kernel rounds probabilities
to bf16. Patch embed: f32 2e-4, bf16 5e-2 (sums of up to 1152 products in
another order; bf16 outputs differ by at most one rounding). SSD: f32
1e-3 and bf16 y 2e-2 (one rounding of y): the kernel sums the cumulative
log decay L of a 128-step chunk in another order than torch.cumsum, and
|L| reaches ~150 here, where a float32 ulp is 1.5e-5; exp(L_q - L_k)
turns a few ulps into ~1e-4 relative (seen: 2.7e-4 on 14 of 10^6
elements of y). The JAX package holds its own SSD kernel at 2e-3. The
bf16 SSD's wgmma kernel is held at the same levels: its split-bf16
pieces keep Sc at float32 level and y far under its own bf16 rounding.
"""
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.core import patch as patch_mod
from repro_torch.kernels.attention import ops
from repro_torch.kernels.attention.flash_attention import (flash_attention_cuda,
                                                          variant_of)
from repro_torch.kernels.attention.ref import flash_attention_ref
from repro_torch.kernels.patch_embed import ops as pe_ops
from repro_torch.kernels.patch_embed.patch_embed import (SMEM_LIMIT,
                                                         deembed_variant_of,
                                                         embed_launch_plan,
                                                         embed_plan,
                                                         embed_variant_of,
                                                         patch_deembed_cuda,
                                                         patch_embed_cuda)
from repro_torch.kernels.patch_embed.ref import (patch_deembed_ref,
                                                 patch_embed_ref)
from repro_torch.kernels.ssd import ops as ssd_ops
from repro_torch.kernels.ssd.ref import ssd_chunk_ref, ssd_chunked
from repro_torch.kernels.ssd.ssd_chunk import ssd_chunk_cuda, ssd_variant_of

# the JAX package's ATTN_CASES (tests/test_kernels.py), a ragged hd-72
# case, and the DiT-XL/2 main-path shapes (B = 2 x 4 rows under CFG)
CASES = [
    # B, S, H, K, hd, causal, softcap, window, dtype
    (2, 128, 4, 2, 64, True, 0.0, 0, "float32"),
    (1, 256, 4, 4, 64, True, 50.0, 0, "float32"),
    (2, 256, 8, 2, 32, True, 0.0, 128, "float32"),
    (1, 128, 2, 1, 128, False, 0.0, 0, "float32"),
    (1, 256, 4, 2, 64, True, 0.0, 0, "bfloat16"),
    (2, 384, 6, 2, 64, True, 30.0, 256, "float32"),
    (2, 100, 4, 4, 72, False, 0.0, 0, "float32"),
    (2, 100, 4, 2, 70, True, 0.0, 0, "bfloat16"),
    (8, 256, 16, 16, 72, False, 0.0, 0, "bfloat16"),
    (8, 64, 16, 16, 72, False, 0.0, 0, "bfloat16"),
]
TOL = {"float32": 2e-5, "bfloat16": 2e-2}


def _packed_segments(B: int, S: int) -> torch.Tensor:
    seg = torch.full((B, S), -1, dtype=torch.int32)
    seg[0, :70], seg[0, 70:150] = 0, 1
    seg[1, :30], seg[1, 30:190] = 0, 1
    return seg


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("case", CASES, ids=[f"g{i}" for i in range(len(CASES))])
def test_kernel_matches_plain_on_card(cuda, case):
    B, S, H, K, hd, causal, cap, win, dtype = case
    rng = np.random.default_rng(S + hd)
    q, k, v = (torch.from_numpy(rng.standard_normal((B, S, h, hd), np.float32))
               .to(cuda, getattr(torch, dtype)) for h in (H, K, K))
    before = ops.flash_attention.launches
    got = ops.flash_attention(q, k, v, causal=causal, softcap=cap, window=win)
    torch.cuda.synchronize()
    assert ops.flash_attention.launches == before + 1
    want = flash_attention_ref(q, k, v, causal=causal, softcap=cap, window=win)
    torch.testing.assert_close(got.float(), want.float(), atol=TOL[dtype],
                               rtol=TOL[dtype])


# bf16 cases of the TMA/wgmma kernel: ragged S, GQA, causal with window,
# softcap, hd 64 and 128, the main-path shapes, and one long causal row
# past 8192 tokens (where the JAX package sends every sequence here)
WGMMA_CASES = [
    # B, S, H, K, hd, causal, softcap, window
    (2, 100, 4, 4, 72, False, 0.0, 0),
    (2, 200, 4, 4, 72, True, 0.0, 0),
    (2, 300, 4, 4, 72, False, 0.0, 0),
    (2, 256, 8, 2, 64, True, 0.0, 0),
    (2, 384, 4, 2, 64, True, 0.0, 128),
    (1, 256, 4, 4, 64, True, 50.0, 0),
    (2, 256, 4, 4, 128, False, 0.0, 0),
    (8, 256, 16, 16, 72, False, 0.0, 0),
    (8, 64, 16, 16, 72, False, 0.0, 0),
    (1, 9000, 2, 2, 64, True, 0.0, 0),
]


def _check_wgmma(q, k, v, kw):
    """ops.flash_attention takes the TMA/wgmma kernel and counts it; it
    agrees with the plain version and with the forced mma.sync kernel."""
    assert variant_of(q, k, v) == "wgmma"
    before = dict(ops.flash_attention.launches_by_variant)
    got = ops.flash_attention(q, k, v, **kw)
    prev = flash_attention_cuda(q, k, v, **ops.kernel_kwargs(q, k, **kw), variant="mma")
    torch.cuda.synchronize()
    assert ops.flash_attention.launches_by_variant["wgmma"] == before["wgmma"] + 1
    assert ops.flash_attention.launches_by_variant["mma"] == before["mma"]
    want = flash_attention_ref(q, k, v, **kw)
    tol = TOL["bfloat16"]
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)
    torch.testing.assert_close(got.float(), prev.float(), atol=tol, rtol=tol)
    return got


@pytest.mark.gpu
@pytest.mark.parametrize("case", WGMMA_CASES,
                         ids=[f"w{i}" for i in range(len(WGMMA_CASES))])
def test_wgmma_kernel_matches_plain_and_mma_on_card(cuda, case):
    B, S, H, K, hd, causal, cap, win = case
    rng = np.random.default_rng(S + hd + H)
    q, k, v = (torch.from_numpy(rng.standard_normal((B, S, h, hd), np.float32))
               .to(cuda, torch.bfloat16) for h in (H, K, K))
    _check_wgmma(q, k, v, dict(causal=causal, softcap=cap, window=win))


@pytest.mark.gpu
@pytest.mark.parametrize("blocks", [(64, 64), (48, 80), (128, 128)])
def test_wgmma_kernel_packed_block_map_on_card(cuda, blocks):
    """Packed causal rows with padding and the caller's map at 64, 48 x 80
    (straddling the kernel's tiles) and 128: padding rows return 0."""
    bq, bk = blocks
    rng = np.random.default_rng(5)
    B, S, H, hd = 2, 200, 4, 72
    q, k, v = (torch.from_numpy(rng.standard_normal((B, S, H, hd), np.float32))
               .to(cuda, torch.bfloat16) for _ in range(3))
    seg = _packed_segments(B, S).to(cuda)
    bmap = torch.from_numpy((rng.random((B, -(-S // bq), -(-S // bk))) < 0.7)
                            .astype(np.int32)).to(cuda)
    for block_map in (None, bmap):
        got = _check_wgmma(q, k, v, dict(causal=True, segment_ids=seg,
                                         block_map=block_map, block_q=bq,
                                         block_k=bk))
        assert torch.all(got[1, 190:] == 0)


@pytest.mark.gpu
def test_flash_counts_launches_by_variant_on_card(cuda):
    """hd 72 bf16 takes the TMA/wgmma kernel, hd 70 the mma.sync kernel,
    float32 the CUDA-core kernel; each launch is counted under its own."""
    ops.reset_launches()
    for hd, dtype in ((72, torch.bfloat16), (70, torch.bfloat16),
                      (72, torch.float32)):
        q = torch.randn((1, 64, 2, hd), device=cuda).to(dtype)
        ops.flash_attention(q, q, q, causal=False)
    torch.cuda.synchronize()
    assert ops.flash_attention.launches == 3
    assert ops.flash_attention.launches_by_variant == {"f32": 1, "mma": 1,
                                                       "wgmma": 1}


@pytest.mark.gpu
def test_kernels_refuse_autograd_on_card(cuda):
    """No kernel has a backward: each wrapper raises, and launches
    nothing, where autograd would record through it (a DiT forward on the
    flash backend with weights that require grad among them), and runs
    the same call under ``torch.no_grad()``."""
    from repro_torch.models import dit as dit_mod
    q = torch.randn((1, 64, 2, 72), device=cuda).bfloat16().requires_grad_()
    x = torch.randn((2, 1, 16, 16, 4), device=cuda).requires_grad_()
    w_flex = torch.randn((16, 4, 64), device=cuda)
    b = torch.randn((64,), device=cuda)
    ssd_in = [t.requires_grad_() for t in
              _ssd_inputs(cuda, 1, 128, 4, 64, 128, "float32", 128)]
    cfg = _serving_cfg("float32")
    params = dit_mod.init_dit(cfg, torch.Generator(device=cuda).manual_seed(0))
    params["blocks"]["attn"]["wq"].requires_grad_()
    xt = torch.randn((2,) + cfg.dit.latent_shape, device=cuda)
    t = torch.tensor([3.0, 50.0], device=cuda)
    y = torch.tensor([1, 2], device=cuda)
    calls = [
        ("flash_attention", lambda: ops.flash_attention(q, q, q, causal=False)),
        ("embed_tokens_flex", lambda: pe_ops.embed_tokens_flex(
            w_flex, b, x, (1, 2, 2), (1, 4, 4))),
        ("ssd", lambda: ssd_ops.ssd(*ssd_in, 128)),
        ("flash_attention", lambda: dit_mod.dit_forward(
            params, xt, t, y, cfg, attn_backend="pallas")),
    ]
    for name, call in calls:
        ops.reset_launches()
        pe_ops.reset_launches()
        ssd_ops.reset_launches()
        with pytest.raises(RuntimeError,
                           match=f"{name}: the CUDA kernel has no backward"):
            call()
        assert (ops.flash_attention.launches, pe_ops.embed_tokens_flex.launches,
                ssd_ops.ssd.launches) == (0, 0, 0)
        with torch.no_grad():
            call()
    torch.cuda.synchronize()
    assert ops.flash_attention.launches == cfg.num_layers


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("blocks", [(64, 64), (48, 80), (128, 128)])
def test_kernel_segments_block_map_on_card(cuda, blocks, dtype):
    """Packed rows with padding; the caller's map at several granularities,
    one that straddles the kernel's 64-wide tiles."""
    bq, bk = blocks
    rng = np.random.default_rng(3)
    B, S, H, hd = 2, 200, 4, 72
    q, k, v = (torch.from_numpy(rng.standard_normal((B, S, H, hd), np.float32))
               .to(cuda, getattr(torch, dtype)) for _ in range(3))
    seg = _packed_segments(B, S).to(cuda)
    nq, nk = -(-S // bq), -(-S // bk)
    bmap = torch.from_numpy((rng.random((B, nq, nk)) < 0.7).astype(np.int32))
    for block_map in (None, bmap.to(cuda)):
        kw = dict(causal=True, segment_ids=seg, block_map=block_map,
                  block_q=bq, block_k=bk)
        got = ops.flash_attention(q, k, v, **kw)
        torch.cuda.synchronize()
        want = flash_attention_ref(q, k, v, **kw)
        torch.testing.assert_close(got.float(), want.float(), atol=TOL[dtype],
                                   rtol=TOL[dtype])
        assert torch.all(got[1, 190:] == 0)


# the JAX package's PE_CASES, a ragged case (no 16-byte rows), and the
# DiT-XL/2 tokenizer shapes at B=8: (N, K, M) of embed and de-embed
PE_CASES = [
    (512, 64, 256, "float32"), (256, 48, 128, "float32"),
    (1024, 128, 512, "bfloat16"), (256, 16, 64, "float32"),
    (100, 20, 50, "bfloat16"), (100, 20, 50, "float32"),
    (2048, 16, 1152, "bfloat16"), (512, 64, 1152, "bfloat16"),
    (2048, 1152, 32, "bfloat16"), (512, 1152, 128, "bfloat16"),
]
PE_TOL = {"float32": 2e-4, "bfloat16": 5e-2}


@pytest.mark.gpu
@pytest.mark.parametrize("case", PE_CASES, ids=[f"p{i}" for i in range(len(PE_CASES))])
def test_patch_kernels_match_plain_on_card(cuda, case):
    N, K, M, dtype = case
    gen = torch.Generator(device=cuda).manual_seed(N + K + M)
    x, w, b = (torch.randn(shape, generator=gen, device=cuda).to(getattr(torch, dtype))
               for shape in ((N, K), (K, M), (M,)))
    for kernel, plain in ((patch_embed_cuda, patch_embed_ref),
                          (patch_deembed_cuda, patch_deembed_ref)):
        got = kernel(x, w, b)
        torch.cuda.synchronize()
        torch.testing.assert_close(got.float(), plain(x, w, b).float(),
                                   atol=PE_TOL[dtype], rtol=PE_TOL[dtype])


# the cluster de-embed: the DiT-XL/2 path at B=8, the JAX package's bf16
# case, a ragged N, and K not in whole 64-chunks
CLUSTER_CASES = [(2048, 1152, 32), (512, 1152, 128), (1024, 128, 512),
                 (2000, 1152, 32), (256, 1000, 64), (100, 72, 16)]


@pytest.mark.gpu
@pytest.mark.parametrize("case", CLUSTER_CASES,
                         ids=[f"c{i}" for i in range(len(CLUSTER_CASES))])
def test_cluster_deembed_matches_plain_and_mma_on_card(cuda, case):
    N, K, M = case
    gen = torch.Generator(device=cuda).manual_seed(N + K + M)
    x, w, b = (torch.randn(shape, generator=gen, device=cuda).to(torch.bfloat16)
               for shape in ((N, K), (K, M), (M,)))
    assert deembed_variant_of(x, w) == "cluster"
    got = patch_deembed_cuda(x, w, b)
    prev = patch_deembed_cuda(x, w, b, variant="mma")
    again = patch_deembed_cuda(x, w, b)
    torch.cuda.synchronize()
    tol = PE_TOL["bfloat16"]
    torch.testing.assert_close(got.float(), patch_deembed_ref(x, w, b).float(),
                               atol=tol, rtol=tol)
    torch.testing.assert_close(got.float(), prev.float(), atol=tol, rtol=tol)
    assert torch.equal(got, again)   # fixed reduction order: run to run equal


# the TMA/wgmma embed: the DiT-XL/2 path at B=8 (mode 0, mode 1), a ragged
# N, K = 48 (the JAX package's case) and 128, M = 72 (not whole 64s), the
# JAX package's bf16 case, K an odd number of 8s with M < 64, and shapes
# whose CTAs walk several row tiles (the ring and the staging tiles wrap),
# and the largest K the kernel takes (EMBED_MAX_K, on a 2-stage ring)
WGMMA_EMBED_CASES = [(2048, 16, 1152), (512, 64, 1152), (2000, 16, 1152),
                     (256, 48, 128), (512, 128, 1152), (256, 16, 72),
                     (1024, 128, 512), (100, 24, 40), (16384, 16, 1152),
                     (8192, 64, 1152), (4096, 256, 1152), (256, 544, 128)]


@pytest.mark.gpu
@pytest.mark.parametrize("case", WGMMA_EMBED_CASES,
                         ids=[f"e{i}" for i in range(len(WGMMA_EMBED_CASES))])
def test_wgmma_embed_matches_plain_and_mma_on_card(cuda, case):
    N, K, M = case
    gen = torch.Generator(device=cuda).manual_seed(N + K + M)
    x, w, b = (torch.randn(shape, generator=gen, device=cuda).to(torch.bfloat16)
               for shape in ((N, K), (K, M), (M,)))
    assert embed_variant_of(x, w, b) == "wgmma"
    got = patch_embed_cuda(x, w, b)
    prev = patch_embed_cuda(x, w, b, variant="mma")
    again = patch_embed_cuda(x, w, b)
    torch.cuda.synchronize()
    tol = PE_TOL["bfloat16"]
    torch.testing.assert_close(got.float(), patch_embed_ref(x, w, b).float(),
                               atol=tol, rtol=tol)
    torch.testing.assert_close(got.float(), prev.float(), atol=tol, rtol=tol)
    assert torch.equal(got, again)
    ctas, stages, smem = embed_launch_plan(N, K, M)
    tiles = embed_plan(N, K, M)
    assert ctas % tiles.col_tiles == 0 and ctas <= tiles.tiles
    assert smem <= SMEM_LIMIT and stages == (4 if K <= 320 else 2)   # 4 fit to K 320
    if N >= 4096:   # each CTA walks several row tiles
        assert ctas < tiles.tiles


@pytest.mark.gpu
def test_flexi_tokenizer_counts_launches_on_card(cuda):
    gen = torch.Generator(device=cuda).manual_seed(0)
    x = torch.randn((2, 1, 16, 16, 4), generator=gen, device=cuda)
    w_flex = torch.randn((16, 4, 64), generator=gen, device=cuda)
    b = torch.randn((64,), generator=gen, device=cuda)
    w_de = torch.randn((64, 8, 16), generator=gen, device=cuda)
    b_de = torch.randn((8, 16), generator=gen, device=cuda)
    e0, d0 = pe_ops.embed_tokens_flex.launches, pe_ops.deembed_tokens_flex.launches
    for p in [(1, 2, 2), (1, 4, 4)]:
        tok = pe_ops.embed_tokens_flex(w_flex, b, x, p, (1, 4, 4))
        out = pe_ops.deembed_tokens_flex(w_de, b_de, tok, (1, 16, 16, 4), p,
                                         (1, 4, 4), 8)
        assert out.shape == (2, 1, 16, 16, 8)
    torch.cuda.synchronize()
    assert pe_ops.embed_tokens_flex.launches == e0 + 2
    assert pe_ops.deembed_tokens_flex.launches == d0 + 2


@pytest.mark.gpu
def test_flexi_tokenizer_bf16_embeds_run_on_wgmma_on_card(cuda):
    """Both patch sizes of a bf16 tokenizer go to the TMA/wgmma embed."""
    gen = torch.Generator(device=cuda).manual_seed(1)
    x = torch.randn((2, 1, 16, 16, 4), generator=gen, device=cuda).to(torch.bfloat16)
    w_flex = torch.randn((16, 4, 64), generator=gen, device=cuda).to(torch.bfloat16)
    b = torch.randn((64,), generator=gen, device=cuda).to(torch.bfloat16)
    pe_ops.reset_launches()
    for p in [(1, 2, 2), (1, 4, 4)]:
        tok = pe_ops.embed_tokens_flex(w_flex, b, x, p, (1, 4, 4))
        torch.cuda.synchronize()
        want = patch_mod.embed_tokens_flex(w_flex, b, x, p, (1, 4, 4))
        torch.testing.assert_close(tok.float(), want.float(), atol=2e-2, rtol=2e-2)
    assert pe_ops.embed_tokens_flex.launches == 2
    assert pe_ops.embed_tokens_flex.launches_by_variant == {"wgmma": 2, "mma": 0,
                                                            "f32": 0}


# the JAX package's SSD_CASES (B, S, H, P, N, chunk) and one mamba2-130m
# layer at B=4, S=2048
SSD_CASES = [(2, 64, 4, 16, 8, 16), (1, 96, 2, 32, 16, 32),
             (2, 48, 3, 8, 8, 16), (1, 128, 4, 16, 32, 64),
             (4, 2048, 24, 64, 128, 128)]
SSD_TOL = {"float32": 1e-3, "bfloat16": 2e-2}


def _ssd_inputs(device, B, S, H, P, N, dtype, seed, dt_scale=1.0):
    gen = torch.Generator(device=device).manual_seed(seed)

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=device)
    x = rnd(B, S, H, P).to(getattr(torch, dtype))
    dt = torch.nn.functional.softplus(rnd(B, S, H)) * dt_scale
    A = -torch.exp(rnd(H) * 0.5)
    return x, dt, A, rnd(B, S, N), rnd(B, S, N)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", SSD_CASES, ids=[f"s{i}" for i in range(len(SSD_CASES))])
def test_ssd_kernel_matches_plain_on_card(cuda, case, dtype):
    B, S, H, P, N, chunk = case
    x, dt, A, Bm, Cm = _ssd_inputs(cuda, B, S, H, P, N, dtype, S + N)
    got = ssd_chunk_cuda(x, dt, A, Bm, Cm, chunk)
    torch.cuda.synchronize()
    want = ssd_chunk_ref(x, dt, A, Bm, Cm, chunk)
    tol = SSD_TOL[dtype]
    torch.testing.assert_close(got[0].float(), want[0].float(), atol=tol, rtol=tol)
    for g, w in zip(got[1:], want[1:]):
        torch.testing.assert_close(g, w, atol=SSD_TOL["float32"],
                                   rtol=SSD_TOL["float32"])


@pytest.mark.gpu
@pytest.mark.parametrize("S", [2000, 100])
def test_ssd_ops_padded_with_state_on_card(cuda, S):
    """S not a multiple of the chunk, a carried state: ops.ssd (kernel +
    plain inter-chunk part) against ssd_chunked on the card."""
    B, H, P, N, chunk = 2, 4, 64, 128, 128
    x, dt, A, Bm, Cm = _ssd_inputs(cuda, B, S, H, P, N, "float32", S)
    h0 = torch.randn((B, H, P, N), device=cuda) * 0.1
    before = ssd_ops.ssd.launches
    y, h = ssd_ops.ssd(x, dt, A, Bm, Cm, chunk, h0)
    torch.cuda.synchronize()
    assert ssd_ops.ssd.launches == before + 1
    y_ref, h_ref = ssd_chunked(x, dt, A, Bm, Cm, chunk, h0)
    tol = SSD_TOL["float32"]
    torch.testing.assert_close(y, y_ref, atol=tol, rtol=tol)
    torch.testing.assert_close(h, h_ref, atol=tol, rtol=tol)


# the bf16 wgmma kernel (B, S, H, P, N, chunk, dt scale): the path shape,
# Q = 64, P = 32, N = 64, H = 25 (the last head group ragged), B nc = 1,
# and dt 1.6x as large (|L| reaches ~440 within a chunk; on the card)
WGMMA_SSD_CASES = [(4, 2048, 24, 64, 128, 128, 1.0), (2, 512, 8, 64, 128, 64, 1.0),
                   (2, 512, 8, 32, 128, 128, 1.0), (2, 256, 4, 64, 64, 128, 1.0),
                   (2, 512, 25, 64, 128, 128, 1.0), (1, 128, 4, 64, 128, 128, 1.0),
                   (2, 1024, 8, 64, 128, 128, 1.6)]


@pytest.mark.gpu
@pytest.mark.parametrize("case", WGMMA_SSD_CASES,
                         ids=[f"w{i}" for i in range(len(WGMMA_SSD_CASES))])
def test_ssd_wgmma_matches_plain_and_simt_on_card(cuda, case):
    """The wgmma kernel against its plain version and the forced simt
    kernel, and equal bit for bit when repeated."""
    B, S, H, P, N, chunk, dt_scale = case
    x, dt, A, Bm, Cm = _ssd_inputs(cuda, B, S, H, P, N, "bfloat16", S + H + P,
                                   dt_scale)
    assert ssd_variant_of(x, Bm, Cm, chunk) == "wgmma"
    got = ssd_chunk_cuda(x, dt, A, Bm, Cm, chunk)
    again = ssd_chunk_cuda(x, dt, A, Bm, Cm, chunk, variant="wgmma")
    simt = ssd_chunk_cuda(x, dt, A, Bm, Cm, chunk, variant="simt")
    torch.cuda.synchronize()
    want = ssd_chunk_ref(x, dt, A, Bm, Cm, chunk)
    if dt_scale > 1:
        assert want[2].abs().max().item() > 140
    for other in (want, simt):
        torch.testing.assert_close(got[0].float(), other[0].float(),
                                   atol=SSD_TOL["bfloat16"], rtol=SSD_TOL["bfloat16"])
        for g, w in zip(got[1:], other[1:]):
            torch.testing.assert_close(g, w, atol=SSD_TOL["float32"],
                                       rtol=SSD_TOL["float32"])
    for g, a in zip(got, again):
        assert torch.equal(g, a)


@pytest.mark.gpu
def test_ssd_wgmma_refuses_what_it_does_not_take_on_card(cuda):
    x, dt, A, Bm, Cm = _ssd_inputs(cuda, 1, 128, 2, 16, 128, "bfloat16", 0)
    with pytest.raises(ValueError, match="wgmma kernel does not take"):
        ssd_chunk_cuda(x, dt, A, Bm, Cm, 128, variant="wgmma")
    x, dt, A, Bm, Cm = _ssd_inputs(cuda, 1, 128, 2, 64, 128, "float32", 0)
    with pytest.raises(ValueError, match="wgmma kernel does not take"):
        ssd_chunk_cuda(x, dt, A, Bm, Cm, 128, variant="wgmma")


@pytest.mark.gpu
def test_ssd_ops_bf16_padded_with_state_runs_on_wgmma_on_card(cuda):
    """ops.ssd at S = 2000 (padded to whole chunks) with a carried state,
    bf16 x: counted under the wgmma kernel, held against ssd_chunked. y is
    the sum of two bf16-rounded parts (intra- and inter-chunk) that can
    cancel, so it is held on its own scale: max|err| <= 2e-2 max|y|."""
    B, S, H, P, N, chunk = 2, 2000, 4, 64, 128, 128
    x, dt, A, Bm, Cm = _ssd_inputs(cuda, B, S, H, P, N, "bfloat16", S)
    h0 = torch.randn((B, H, P, N), device=cuda) * 0.1
    ssd_ops.reset_launches()
    y, h = ssd_ops.ssd(x, dt, A, Bm, Cm, chunk, h0)
    torch.cuda.synchronize()
    assert ssd_ops.ssd.launches == 1
    assert ssd_ops.ssd.launches_by_variant == {"wgmma": 1, "simt": 0}
    y_ref, h_ref = ssd_chunked(x, dt, A, Bm, Cm, chunk, h0)
    err = (y.float() - y_ref.float()).abs().max().item()
    assert err <= SSD_TOL["bfloat16"] * y_ref.float().abs().max().item()
    torch.testing.assert_close(h, h_ref, atol=SSD_TOL["float32"], rtol=SSD_TOL["float32"])


# ---------------------------------------------------------------------------
# The serving path on the card: packed rows with segment ids through the
# flash kernel. dit-xl-2's geometry at d=64 (4 heads x 16) with a 32 x 32
# latent, so rows hold 256 tokens: one mode-0 segment or four mode-1
# segments of 64, smaller than the kernel's 128-row tile.

def _serving_cfg(dtype: str):
    import dataclasses

    from repro_torch.configs import get_config
    cfg = get_config("dit-xl-2").reduced()
    return dataclasses.replace(
        cfg, param_dtype=dtype, compute_dtype=dtype,
        dit=dataclasses.replace(cfg.dit, latent_shape=(1, 32, 32, 4)))


def _serving_params(dtype: str, device):
    from repro_torch.models import dit as dit_mod
    gen = torch.Generator(device=device).manual_seed(0)
    params = dit_mod.init_dit(_serving_cfg(dtype), gen)
    for node, key in [(params["deembed"], "w_flex"),
                      (params["final"]["ada"], "w"),
                      (params["blocks"]["ada"], "w")]:
        node[key] = (torch.randn(node[key].shape, generator=gen, device=device)
                     * 0.05).to(node[key].dtype)
    return params


def _serving_pipe(dtype: str, device):
    from repro_torch.diffusion.schedule import linear_schedule
    from repro_torch.pipeline import FlexiPipeline
    return FlexiPipeline(_serving_params(dtype, device), _serving_cfg(dtype),
                         linear_schedule(100), device=device)


def _serving_params_f32(device):
    """The float32 serving weights, built on a rank (spawned ranks import
    this module by name)."""
    return _serving_params("float32", device)


def _plans(solver="ddim", **kw):
    from repro_torch.core.scheduler import FlexiSchedule
    from repro_torch.pipeline import SamplingPlan
    return {0.6: SamplingPlan(T=6, budget=FlexiSchedule.weak_first(6, 3),
                              solver=solver, attn_backend="pallas", **kw),
            1.0: SamplingPlan(T=6, budget=1.0, solver=solver,
                              attn_backend="pallas", **kw)}


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_packed_forward_on_card_matches_plain(cuda, dtype):
    """One mixed-mode packed forward (padding tails, four 64-token segments
    in a row) on the card against the same forward on the CPU, where the
    kernel's plain version runs. Padded rows stay 0 through attention."""
    from repro_torch.core import packing
    from repro_torch.models.common import tree_map
    pipe = _serving_pipe(dtype, cuda)
    cfg = pipe.cfg
    cpu_params = tree_map(lambda a: a.cpu(), pipe.params)
    groups = ((0, 3), (1, 5))
    gen = torch.Generator().manual_seed(1)
    xs = [torch.randn((n,) + cfg.dit.latent_shape, generator=gen)
          for _m, n in groups]
    ts = [torch.randint(0, 100, (n,), generator=gen) for _m, n in groups]
    cs = [torch.randint(0, 10, (n,), generator=gen) for _m, n in groups]
    ops.reset_launches()
    got = packing.packed_mixed_forward(pipe.params, cfg, groups,
                                       [x.to(cuda) for x in xs],
                                       [t.to(cuda) for t in ts],
                                       [c.to(cuda) for c in cs],
                                       attn_backend="pallas")
    torch.cuda.synchronize()
    assert ops.flash_attention.launches == cfg.num_layers
    want = packing.packed_mixed_forward(cpu_params, cfg, groups, xs, ts, cs,
                                        attn_backend="pallas")
    tol = 1e-4 if dtype == "float32" else 5e-2
    for g, w in zip(got, want):
        torch.testing.assert_close(g.float().cpu(), w.float(), atol=tol,
                                   rtol=tol)


@pytest.mark.gpu
@pytest.mark.parametrize("solver", ["ddim", "ddpm"])
def test_engine_on_card_matches_pipeline(cuda, solver):
    """float32 serving on the card: every x0 against the per-request
    pipeline at 1e-4, one flash launch per block pass, all on the f32
    kernel; a replay builds nothing; interval=1 caching equals uncached
    serving bit for bit."""
    import dataclasses

    from repro_torch.serving import CacheSpec, ServingEngine
    from repro_torch.pipeline import FlexiPipeline
    pipe = _serving_pipe("float32", cuda)
    plans = _plans(solver)
    results = {}
    for name, cache in [("plain", None),
                        ("cached", CacheSpec(policy="interval", interval=1,
                                             split=1))]:
        # a fresh runner cache each: both plan from the same warm set
        eng = ServingEngine(FlexiPipeline(pipe.params, pipe.cfg, pipe.sched,
                                          device=cuda), plans, cache=cache)
        ops.reset_launches()
        for i in range(5):
            eng.submit(cond=i, budget=(0.6, 1.0)[i % 2])
        out = eng.run()
        torch.cuda.synchronize()
        assert ops.flash_attention.launches == eng.block_passes
        assert ops.flash_attention.launches_by_variant["f32"] == eng.block_passes
        results[name] = {r.request.id: r for r in out}
        if cache is not None:
            assert eng.store.n_active == 0
    for rid, r in results["plain"].items():
        assert torch.equal(r.x0, results["cached"][rid].x0)
        plan = dataclasses.replace(plans[r.budget_served])
        ref = pipe.sample(plan, 1, torch.Generator(cuda).manual_seed(
            eng.request_seed(rid)), cond=torch.tensor([r.request.cond],
                                                      device=cuda)).x0[0]
        torch.testing.assert_close(r.x0, ref, atol=1e-4, rtol=1e-4)


@pytest.mark.gpu
def test_bf16_engine_on_card_runs_wgmma(cuda):
    """bf16 serving: every flash launch on the TMA/wgmma kernel, the count
    equal to the block passes, finite x0, and a replay that builds
    nothing."""
    from repro_torch.serving import ServingEngine
    pipe = _serving_pipe("bfloat16", cuda)
    eng = ServingEngine(pipe, _plans(), steps_per_dispatch=4)
    for wave in range(2):
        if wave == 1:
            built = eng.cache_stats()["compiled"]
            ops.reset_launches()
            passes = eng.block_passes
        for i in range(6):
            eng.submit(cond=i, budget=(0.6, 1.0)[i % 2])
        out = eng.run()
        assert all(torch.isfinite(r.x0).all() for r in out)
    assert eng.cache_stats()["compiled"] == built
    assert ops.flash_attention.launches == eng.block_passes - passes
    assert ops.flash_attention.launches_by_variant["wgmma"] \
        == ops.flash_attention.launches


@pytest.mark.gpu
def test_serve_cli_on_card(cuda):
    from repro_torch.launch import serve
    m = serve.main(["--arch", "dit-xl-2", "--smoke", "--requests", "4",
                    "--T", "4"])
    assert m["served"] == 8.0


# ---------------------------------------------------------------------------
# The sampling extensions and the telemetry layer on the card


@pytest.mark.gpu
@pytest.mark.parametrize("S", [4096, 1024])
def test_flash_hd128_long_rows_match_plain_on_card(cuda, S):
    """The text-to-image transformer's self-attention (16 heads x 128, no
    segment ids, every CTA walking all kv tiles) at batch 1, held on the
    output's own scale (a typical |o| over these rows is as small as the
    bf16 TOL): ||o - ref|| / ||ref|| within chip_smoke.py's limit, and the
    kernel handed a map that hides one 64-wide kv tile of every row reads
    over it."""
    limit = 1e-2
    gen = torch.Generator(device=cuda).manual_seed(S)
    q, k, v = (torch.randn((1, S, 16, 128), generator=gen, device=cuda)
               .to(torch.bfloat16) for _ in range(3))
    assert variant_of(q, k, v) == "wgmma"
    want = flash_attention_ref(q, k, v, causal=False).float()

    def rel(o):
        return ((o.float() - want).norm() / want.norm()).item()

    assert rel(ops.flash_attention(q, k, v, causal=False)) <= limit
    bmap = torch.ones((1, S // 128, S // 64), dtype=torch.int32, device=cuda)
    bmap[:, :, 0] = 0
    assert rel(ops.flash_attention(q, k, v, causal=False, block_map=bmap,
                                   block_q=128, block_k=64)) > limit


@pytest.mark.gpu
def test_flash_video_length_matches_plain_on_card(cuda):
    """The text-to-video DiT's mode-0 self-attention (33,792 tokens, 24
    heads x 128, no segment ids) at batch 1, held head by head on two
    heads (a [S, S] float32 score tile is 4.6 GB) on the output's own
    scale at chip_smoke.py's limit; the kernel handed a map that hides the
    second half of every row's kv tiles reads over it on both."""
    limit, S, H = 1e-2, 33792, 24
    gen = torch.Generator(device=cuda).manual_seed(S)
    q, k, v = (torch.randn((1, S, H, 128), generator=gen, device=cuda)
               .to(torch.bfloat16) for _ in range(3))
    assert variant_of(q, k, v) == "wgmma"
    got = ops.flash_attention(q, k, v, causal=False)
    nq, nk = S // 128, S // 64
    bmap = torch.ones((1, nq, nk), dtype=torch.int32, device=cuda)
    bmap[:, :, nk // 2:] = 0
    planted = ops.flash_attention(q, k, v, causal=False, block_map=bmap,
                                  block_q=128, block_k=64)
    for h in (0, H - 1):
        hs = slice(h, h + 1)
        want = flash_attention_ref(q[:, :, hs].contiguous(),
                                   k[:, :, hs].contiguous(),
                                   v[:, :, hs].contiguous(),
                                   causal=False).float()

        def rel(o):
            return ((o[:, :, hs].float() - want).norm() / want.norm()).item()

        assert rel(got) <= limit, h
        assert rel(planted) > limit, h
        del want


@pytest.mark.gpu
@pytest.mark.parametrize("solver", ["flow_euler", "flow_heun"])
def test_flow_pipeline_on_card_matches_cpu(cuda, solver):
    """The reduced text-to-image config (float32, text + LoRA) through
    ``FlexiPipeline.sample`` with a flow solver at budget 0.6: the card
    (the flash kernel's f32 variant) against the CPU (its plain version)
    at 1e-4, 2 x 6 launches a step per NFE."""
    from repro_torch.configs import get_config
    from repro_torch.diffusion.schedule import linear_schedule
    from repro_torch.models import dit as dit_mod
    from repro_torch.models.common import tree_map
    from repro_torch.pipeline import FlexiPipeline, SamplingPlan
    cfg = get_config("t2i-transformer").reduced()
    gen = torch.Generator().manual_seed(0)
    params = dit_mod.init_dit(cfg, gen)
    for node, key in [(params["deembed"], "w_flex"),
                      (params["deembed_new"]["m1"], "w"),
                      (params["final"]["ada"], "w"),
                      (params["blocks"]["ada"], "w")]:
        node[key] = torch.randn(node[key].shape, generator=gen) * 0.05
    plan = SamplingPlan(T=6, budget=0.6, solver=solver, guidance_scale=0.0,
                        attn_backend="pallas")
    x_T = torch.randn((2,) + cfg.dit.latent_shape, generator=gen)
    text = torch.randn((2, cfg.dit.text_len, cfg.dit.text_dim), generator=gen)
    out = {}
    for dev in (cuda, torch.device("cpu")):
        pipe = FlexiPipeline(tree_map(lambda a: a.to(dev), params), cfg,
                             linear_schedule(1000), device=dev)
        ops.reset_launches()
        out[dev.type] = pipe.sample(plan, 2, None, cond=text.to(dev),
                                    x_T=x_T.to(dev)).x0.cpu()
        if dev.type == "cuda":
            nfe = 6 * (2 if solver == "flow_heun" else 1)
            assert ops.flash_attention.launches == cfg.num_layers * nfe
            assert ops.flash_attention.launches_by_variant["f32"] \
                == cfg.num_layers * nfe
    torch.testing.assert_close(out["cuda"], out["cpu"], atol=1e-4, rtol=1e-4)


@pytest.mark.gpu
def test_adaptive_on_card_matches_cpu(cuda):
    """Adaptive DDIM (float32) on the card against the CPU: the same
    gaps at 1e-4 relative, the same switch step, x0 at 1e-4."""
    from repro_torch.models.common import tree_map
    from repro_torch.pipeline import AdaptiveBudget, FlexiPipeline, SamplingPlan
    pipe = _serving_pipe("float32", cuda)
    plan = SamplingPlan(T=6, budget=AdaptiveBudget(threshold=1e9,
                                                   probe_every=1),
                        attn_backend="pallas")
    x_T = torch.randn((2,) + pipe.cfg.dit.latent_shape,
                      generator=torch.Generator().manual_seed(3))
    cpu = FlexiPipeline(tree_map(lambda a: a.cpu(), pipe.params), pipe.cfg,
                        pipe.sched, device="cpu")
    got = pipe.sample(plan, 2, None, cond=[1, 2], x_T=x_T.to(cuda))
    want = cpu.sample(plan, 2, None, cond=[1, 2], x_T=x_T)
    assert got.trace["switch_step"] == want.trace["switch_step"] == 6
    np.testing.assert_allclose(got.trace["gaps"], want.trace["gaps"], rtol=1e-4)
    torch.testing.assert_close(got.x0.cpu(), want.x0, atol=1e-4, rtol=1e-4)


@pytest.mark.gpu
def test_tapped_engine_on_card_equals_untapped(cuda):
    """bf16 serving on the card with ``Telemetry(taps=True, profile=True)``:
    x0 equal bit for bit to the untapped engine's, taps read only at
    aggregation, attribution conserved, walls measured by CUDA events."""
    from repro_torch.pipeline import FlexiPipeline
    from repro_torch.serving import ServingEngine
    from repro_torch.telemetry import Telemetry
    pipe = _serving_pipe("bfloat16", cuda)
    x0s = {}
    for tel in (None, Telemetry(taps=True, profile=True)):
        eng = ServingEngine(FlexiPipeline(pipe.params, pipe.cfg, pipe.sched,
                                          device=cuda), _plans(),
                            steps_per_dispatch=4, telemetry=tel)
        for i in range(6):
            eng.submit(cond=i, budget=(0.6, 1.0)[i % 2])
        x0s[tel is None] = {r.request.id: r.x0 for r in eng.run()}
    assert all(torch.equal(x0s[True][i], x0s[False][i]) for i in x0s[True])
    agg = tel.taps.aggregate()
    assert agg["nonfinite_request_steps"] == 0 and agg["eps_norm"]["mean"] > 0
    assert not any(tel.attribution.conservation().values())
    assert sum(w.n for w in tel.profile.walls.values()) \
        == eng.metrics.total_steps
    assert all(w.min_s > 0 for w in tel.profile.walls.values())


@pytest.mark.gpu
def test_spans_only_engine_on_card_times_dispatches_without_a_wait(
        cuda, tmp_path):
    """bf16 serving on the card with spans only (``Telemetry()``): x0 and
    ``waits`` equal the telemetry-off engine's; one positive
    ``dispatch.device`` span a dispatch, each inside the serving window
    and their sum within it; under ``torch.profiler`` the recorder's
    Unix-time export of a span lands within 0.1 ms of a
    ``record_function`` probe around the same block."""
    import json
    import time

    from torch.profiler import ProfilerActivity, profile, record_function

    from repro_torch.pipeline import FlexiPipeline
    from repro_torch.serving import ServingEngine
    from repro_torch.telemetry import Telemetry
    pipe = _serving_pipe("bfloat16", cuda)
    runs = {}
    for tel in (None, Telemetry()):
        eng = ServingEngine(FlexiPipeline(pipe.params, pipe.cfg, pipe.sched,
                                          device=cuda), _plans(),
                            steps_per_dispatch=4, telemetry=tel,
                            clock=time.perf_counter)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(6):
            eng.submit(cond=i, budget=(0.6, 1.0)[i % 2])
        out = eng.run()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        runs[tel is None] = ({r.request.id: r.x0 for r in out}, eng.waits)
    (plain, w0), (spans, w1) = runs[True], runs[False]
    assert all(torch.equal(plain[i], spans[i]) for i in plain)
    assert w1 == w0
    rec = tel.recorder
    rec.read_pending()
    dev = rec.by_name("dispatch.device")
    assert len(dev) == eng.metrics.total_steps
    assert all(e.dur > 0 and t0 <= e.ts and e.ts + e.dur <= t1 for e in dev)
    assert sum(e.dur for e in dev) <= t1 - t0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function("warm"):
            pass
        for i in range(3):
            with rec.span("probe"), record_function("probe"):
                eng.submit(cond=i, budget=1.0)
                eng.run()
    path = tmp_path / "prof.json"
    prof.export_chrome_trace(str(path))
    trace = json.loads(path.read_text())
    base_us = trace["baseTimeNanoseconds"] / 1e3
    theirs = sorted((e for e in trace["traceEvents"]
                     if e.get("name") == "probe"
                     and e.get("cat") == "user_annotation"),
                    key=lambda e: e["ts"])
    ours = [e for e in rec.to_chrome_trace(unix=True)["traceEvents"]
            if e["name"] == "probe"]
    assert len(ours) == len(theirs) == 3
    for a, b in zip(ours, theirs):
        assert abs(a["ts"] - base_us - b["ts"]) < 100.0


# ---------------------------------------------------------------------------
# Training on the card


@pytest.mark.gpu
def test_full_width_train_step_on_card(cuda):
    """One DiT-XL/2 train step at full width (28 layers, d=1152, bf16
    parameters, float32 moments, B=8, mode 0): finite loss and parameters,
    the step counted, and the peak memory stated."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import TrainConfig
    from repro_torch.data import pipeline as dp
    from repro_torch.launch import steps as st
    from repro_torch.models import dit as dit_mod
    from repro_torch.optim import adamw
    from repro_torch.models.common import tree_leaves
    cfg = get_config("dit-xl-2")
    gen = torch.Generator(device=cuda).manual_seed(0)
    params = dit_mod.init_dit(cfg, gen)
    b = dp.make_dit_batch_fn(cfg.dit.latent_shape, 1000, 8)(
        0, 0, 1, np.random.default_rng(0))
    batch = {k: torch.from_numpy(b[k]).to(cuda) for k in ("x0", "cond")}
    step = st.make_dit_train_step(cfg, TrainConfig(learning_rate=1e-4,
                                                   warmup_steps=0))
    torch.cuda.reset_peak_memory_stats()
    p, o, m = step(params, adamw.init_opt_state(params), batch, gen)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    print(f"DiT-XL/2 train step, B=8: loss {float(m['loss']):.4f}, peak "
          f"memory {peak / 1e9:.2f} GB on {torch.cuda.get_device_name(0)}")
    assert np.isfinite(float(m["loss"])) and int(o["step"]) == 1
    assert all(torch.isfinite(x).all() for x in tree_leaves(p))
    assert p["blocks"]["attn"]["wq"].dtype == torch.bfloat16
    assert o["m"]["blocks"]["attn"]["wq"].dtype == torch.float32
    assert peak < torch.cuda.get_device_properties(0).total_memory


@pytest.mark.gpu
def test_checkpoint_then_serve_on_card(cuda, tmp_path):
    """The trainer's CLI (reduced config, float32, LoRA recipe) on the
    card, its checkpoint restored and served through
    ``FlexiPipeline.sample`` on the flash kernel: x0 equal bit for bit to
    the in-memory parameters', one f32-kernel launch per block a forward."""
    from repro_torch.checkpoint.checkpointer import Checkpointer
    from repro_torch.diffusion.schedule import linear_schedule
    from repro_torch.launch import train
    from repro_torch.pipeline import FlexiPipeline, SamplingPlan
    out = train.main(["--arch", "dit-xl-2", "--smoke", "--steps", "3",
                      "--flexi", "--recipe", "lora", "--ckpt-dir",
                      str(tmp_path)])
    tree, _ = Checkpointer(out["ckpt_root"]).restore()
    assert int(tree["opt"]["step"]) == 3
    cfg = out["cfg"]
    plan = SamplingPlan(T=4, budget=0.6, attn_backend="pallas")
    x0 = []
    for params in (tree["params"], out["params"]):
        pipe = FlexiPipeline(params, cfg, linear_schedule(1000), device=cuda)
        ops.reset_launches()
        x0.append(pipe.sample(plan, 2, torch.Generator(cuda).manual_seed(1),
                              cond=torch.tensor([1, 2], device=cuda)).x0)
        assert ops.flash_attention.launches_by_variant["f32"] \
            == ops.flash_attention.launches == cfg.num_layers * plan.T
    assert torch.isfinite(x0[0]).all() and torch.equal(x0[0], x0[1])


# ---------------------------------------------------------------------------
# The fleet and the resilience seams on the card


class _Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


@pytest.mark.gpu
def test_fleet_on_card_matches_pipeline(cuda):
    """float32, two packed replicas on the one card behind the affinity
    router, one killed after its first dispatch: nothing lost, every x0
    within 1e-4 of the per-request pipeline (seeded by the fleet id), one
    flash launch per block pass summed over the replicas."""
    from repro_torch.fleet import Fleet
    pipe = _serving_pipe("float32", cuda)
    plans = _plans()
    fleet = Fleet(pipe, plans, 2, router="affinity", clock=_Clock(),
                  seconds_per_token=1e-4)
    ops.reset_launches()
    rids = [fleet.submit(cond=i, budget=(0.6, 1.0)[i % 2]) for i in range(6)]
    fleet.tick()
    assert fleet.kill_replica(0) > 0
    fleet.run()
    torch.cuda.synchronize()
    assert sorted(fleet.results) == rids
    passes = sum(r.engine.block_passes for r in fleet.replicas.values())
    assert ops.flash_attention.launches == passes
    assert ops.flash_attention.launches_by_variant["f32"] == passes
    for rid, r in fleet.results.items():
        gen = torch.Generator(cuda).manual_seed(fleet.request_seed(rid))
        ref = pipe.sample(plans[r.budget_served], 1, gen,
                          cond=torch.tensor([r.cond], device=cuda)).x0[0]
        torch.testing.assert_close(r.x0, ref, atol=1e-4, rtol=1e-4)


@pytest.mark.gpu
def test_fleet_over_rank_groups_on_card(cuda):
    """float32, two groups of 2 rank processes on the one card over Gloo
    (``fleet/groups.RankGroupPipeline``, Ulysses at 2 of 4 heads) behind
    the fixed-slot fleet: each request lands on the replica a
    single-process fixed-slot fleet on the card picks, every x0 within
    1e-4 of that fleet's, each rank's flash launches on the f32 variant;
    closing the fleet stops every rank."""
    import dataclasses

    from repro_torch.distributed import ParallelSpec
    from repro_torch.fleet import Fleet
    from repro_torch.fleet.groups import RankGroupPipeline
    from repro_torch.kernels import build
    build.build_all()                  # before any rank starts
    pipe = _serving_pipe("float32", cuda)
    groups = [RankGroupPipeline(pipe.cfg, pipe.sched, _serving_params_f32, 2,
                                device=cuda, backend="gloo", timeout_s=300.0)
              for _ in range(2)]
    fleets = []
    try:
        for pipes, plans in ((None, _plans()),
                             (groups, _plans(parallel=ParallelSpec()))):
            fleet = Fleet(pipe if pipes is None else pipes[0], plans, 2,
                          pipes=pipes, engine_kind="fixed", seq_parallel=2,
                          batch_size=2, router="cheapest", clock=_Clock(),
                          seconds_per_token=1e-4)
            rids = [fleet.submit(cond=i, budget=(0.6, 1.0)[i % 2])
                    for i in range(6)]
            fleet.run()
            assert sorted(fleet.results) == rids
            fleets.append(fleet)
        ref, ours = fleets
        for rid, r in ref.results.items():
            assert ours.results[rid].replica == r.replica
            torch.testing.assert_close(ours.results[rid].x0, r.x0,
                                       atol=1e-4, rtol=1e-4)
        launches = [g.group.call(_rank_flash_launches) for g in groups]
        assert all(n > 0 and v["f32"] == n for ranks in launches
                   for n, v in ranks), launches
        ours.close()
        assert not any(g.alive() for g in groups)
    finally:
        for g in groups:
            g.close()


def _rank_flash_launches(rank, device, state):
    return (ops.flash_attention.launches,
            dict(ops.flash_attention.launches_by_variant))


@pytest.mark.gpu
def test_resilience_seams_on_card(cuda):
    """bf16 on the card: an engine with quarantine on and an armed facade
    whose plan is empty serves the stock engine's x0 bit for bit; a
    poisoned request self-heals to the clean powerful-path sample bit for
    bit (alone in its pack, the same GEMM shapes)."""
    from repro_torch.pipeline import FlexiPipeline
    from repro_torch.resilience import FaultInjector, FaultPlan
    from repro_torch.serving import ServingEngine
    pipe = _serving_pipe("bfloat16", cuda)

    def engine(**kw):
        return ServingEngine(FlexiPipeline(pipe.params, pipe.cfg, pipe.sched,
                                           device=cuda), _plans(),
                             steps_per_dispatch=4, **kw)

    x0s = []
    for kw in ({}, {"faults": FaultInjector(FaultPlan()).for_replica(0),
                    "quarantine": True}):
        eng = engine(**kw)
        for i in range(6):
            eng.submit(cond=i, budget=(0.6, 1.0)[i % 2])
        x0s.append({r.request.id: r.x0 for r in eng.run()})
    assert all(torch.equal(x0s[0][i], x0s[1][i]) for i in x0s[0])
    inj = FaultInjector(FaultPlan())
    inj.add_poison(0, 0)
    eng = engine(faults=inj.for_replica(0))
    eng.submit(cond=3, budget=0.6, seed=5)
    (healed,) = eng.run()
    clean = engine()
    clean.submit(cond=3, budget=1.0, seed=5)
    (ref,) = clean.run()
    assert eng.metrics.total_quarantined == 1
    assert healed.budget_served == 1.0 and torch.equal(healed.x0, ref.x0)


# ---------------------------------------------------------------------------
# Head width 256 (the language models' gemma2 / gemma3 width)

HD256_CASES = [
    # B, S, H, K, causal, softcap, window
    (1, 200, 4, 2, True, 50.0, 64),
    (2, 300, 4, 4, False, 0.0, 0),
    (1, 64, 2, 1, True, 0.0, 0),
    (2, 1000, 16, 8, True, 50.0, 256),
]


@pytest.mark.gpu
@pytest.mark.parametrize("variant", ["wgmma", "mma", "f32"])
@pytest.mark.parametrize("case", HD256_CASES, ids=[f"h{i}" for i in range(len(HD256_CASES))])
def test_hd256_kernel_matches_plain_on_card(cuda, case, variant):
    """Each variant at hd 256 against the plain version; bf16 inputs
    select ``wgmma`` and float32 ones ``f32``."""
    B, S, H, K, causal, cap, win = case
    dtype = torch.float32 if variant == "f32" else torch.bfloat16
    rng = np.random.default_rng(S + H)
    q, k, v = (torch.from_numpy(rng.standard_normal((B, S, h, 256), np.float32))
               .to(cuda, dtype) for h in (H, K, K))
    kw = dict(causal=causal, softcap=cap, window=win)
    assert variant_of(q, k, v) == ("f32" if variant == "f32" else "wgmma")
    got = flash_attention_cuda(q, k, v, **ops.kernel_kwargs(q, k, **kw), variant=variant)
    torch.cuda.synchronize()
    want = flash_attention_ref(q, k, v, **kw)
    tol = TOL["float32" if variant == "f32" else "bfloat16"]
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


@pytest.mark.gpu
def test_tiny_bf16_lm_prefill_pallas_matches_dense(cuda):
    """gemma2's reduced config in bf16 at hd 256 (2 layers, window 32,
    softcap 50, S=96): the ``pallas`` prefill (2 flash launches, both
    ``wgmma``) against the dense backend, logits within 2e-2 of their
    scale; then a decode step from each cache agrees too."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.launch import steps as st
    from repro_torch.models import lm
    from repro_torch.runtime.padding import pad_kv_cache

    base = get_config("gemma2-9b").reduced()
    cfg = base.reduced(attn=dataclasses.replace(base.attn, head_dim=256),
                       param_dtype="bfloat16", compute_dtype="bfloat16")
    params = lm.init_params(cfg, torch.Generator(device=cuda).manual_seed(0))
    toks = torch.randint(0, cfg.vocab_size, (2, 96), device=cuda,
                         generator=torch.Generator(device=cuda).manual_seed(1))
    out = {}
    for backend in ("pallas", "dense"):
        ops.reset_launches()
        logits, cache = st.make_prefill_step(cfg, backend=backend)(
            params, {"tokens": toks})
        torch.cuda.synchronize()
        launches = dict(ops.flash_attention.launches_by_variant)
        assert launches["wgmma"] == (2 if backend == "pallas" else 0)
        cache = pad_kv_cache(cache, 96, 1)
        step, _ = st.make_decode_step(cfg)(params, cache, logits.argmax(-1)[:, None],
                                           torch.full((2,), 96, device=cuda))
        out[backend] = (logits, step)
    for got, want in zip(out["pallas"], out["dense"]):
        assert torch.isfinite(got).all()
        rel = ((got - want).norm() / want.norm()).item()
        assert rel <= 2e-2, rel


@pytest.mark.gpu
def test_captured_lm_steps_equal_eager_on_card(cuda):
    """gemma2's reduced config in bf16 at hd 256 on ``pallas``, two batches
    served as ``launch/serve.serve_lm`` serves them (a prefill into the
    batch size's slot, then 4 decode steps on it) through the captured
    runners (the first batch captures, the second replays), against the
    same runners under ``graphs.disabled()``: logits, tokens and every
    cache leaf bit for bit, the slot's tensors written in place
    (``data_ptr`` unchanged), flash launches equal to eager's, and no
    capture in the second batch."""
    import contextlib
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.launch import steps as st
    from repro_torch.models import lm
    from repro_torch.runtime import graphs

    base = get_config("gemma2-9b").reduced()
    cfg = base.reduced(attn=dataclasses.replace(base.attn, head_dim=256),
                       param_dtype="bfloat16", compute_dtype="bfloat16")
    params = lm.init_params(cfg, torch.Generator(device=cuda).manual_seed(0))
    prefill = st.make_prefill_step(cfg, backend="pallas")
    decode = st.make_decode_step(cfg)
    S, n_dec = 96, 4
    g = torch.Generator(device=cuda).manual_seed(1)
    batches = [torch.randint(0, cfg.vocab_size, (2, S), device=cuda, generator=g)
               for _ in range(2)]
    out = {}
    for side in ("captured", "eager"):
        ctx = graphs.disabled() if side == "eager" else contextlib.nullcontext()
        slot = lm.serve_slot(cfg, 2, S + n_dec, cuda)
        ptrs = {k: t.data_ptr() for k, t in slot.items()}
        runs = []
        with ctx, torch.inference_mode():
            for toks in batches:
                ops.reset_launches()
                before = prefill.captures + decode.captures
                logits = serve.lm_prefill(prefill, params, {"tokens": toks}, slot)
                tok = logits.argmax(-1).to(torch.int32)[:, None]
                gen, dec = serve.lm_decode(decode, params, slot, tok, S, n_dec)
                torch.cuda.synchronize()
                runs.append(dict(
                    logits=logits, gen=gen, dec=dec,
                    cache={k: t.clone() for k, t in slot.items()},
                    launches=dict(ops.flash_attention.launches_by_variant),
                    captured=prefill.captures + decode.captures - before))
        out[side] = runs
        assert {k: t.data_ptr() for k, t in slot.items()} == ptrs
    for cap, eag in zip(out["captured"], out["eager"]):
        for key in ("logits", "gen", "dec"):
            assert torch.equal(cap[key], eag[key]), key
        assert all(torch.equal(cap["cache"][k], eag["cache"][k])
                   for k in eag["cache"])
        assert cap["launches"] == eag["launches"]
        assert cap["launches"]["wgmma"] == cfg.num_layers
        assert eag["captured"] == 0
    assert [r["captured"] for r in out["captured"]] == [2, 0]
    assert decode.graphs()[0].in_bytes == 2 * 4 + 2 * 4    # token and position
    assert prefill.graphs()[0].replays == 1 and decode.graphs()[0].replays \
        == 2 * n_dec - 1


@pytest.mark.gpu
def test_out_dtype_matmul_matches_f32_upcast(cuda):
    """``matmul_f32`` on CUDA bf16 (cuBLAS, ``out_dtype=float32``) against
    the float32 product of the upcast operands (TF32 off): both sum exact
    bf16 products in float32, in orders that differ; with a bias; and its
    gradient is the bf16 product's."""
    from repro_torch.models.common import matmul_f32

    assert not torch.backends.cuda.matmul.allow_tf32
    g = torch.Generator(device=cuda).manual_seed(0)
    x = torch.randn(64, 3584, device=cuda, generator=g).bfloat16().requires_grad_()
    w = torch.randn(3584, 512, device=cuda, generator=g).bfloat16().requires_grad_()
    b = torch.randn(512, device=cuda, generator=g)
    y = matmul_f32(x, w, b)
    assert y.dtype == torch.float32
    want = x.float() @ w.float() + b
    torch.testing.assert_close(y, want, atol=1e-3, rtol=1e-4)
    y.sum().backward()
    torch.testing.assert_close(x.grad.float(), (torch.ones(64, 512, device=cuda).bfloat16()
                                                @ w.detach().t()).float())
    yt = matmul_f32(x.detach(), w.detach().t().contiguous().t())
    torch.testing.assert_close(yt, x.detach().float() @ w.detach().float(),
                               atol=1e-3, rtol=1e-4)
    # the telemetry's FlopCounterMode counts it (it cannot count addmm's
    # out_dtype overload)
    from torch.utils.flop_counter import FlopCounterMode
    with FlopCounterMode(display=False) as fc:
        matmul_f32(x.detach(), w.detach(), b)
    assert fc.get_total_flops() == 2 * 64 * 3584 * 512


# ---------------------------------------------------------------------------
# The MoE, vision and audio models' shapes

FAMILY_ATTN_CASES = [
    # B, S, H, K, hd, causal: deepseek-moe-16b, grok-1 and llama-3.2-vision
    # prefill, whisper's encoder (non-causal, a ragged last kv tile)
    (2, 4096, 16, 16, 128, True),
    (2, 2048, 48, 8, 128, True),
    (2, 2048, 64, 8, 128, True),
    (4, 1500, 12, 12, 64, False),
]


@pytest.mark.gpu
@pytest.mark.parametrize("case", FAMILY_ATTN_CASES,
                         ids=[f"f{i}" for i in range(len(FAMILY_ATTN_CASES))])
def test_flash_at_family_shapes_matches_plain_on_card(cuda, case):
    """The wgmma kernel at the shapes the MoE, vision and audio models give
    it, against the plain version one kv head at a time, on the output's
    scale (||o - ref|| / ||ref|| <= 1e-2, as chip_smoke.py holds it)."""
    B, S, H, K, hd, causal = case
    g = torch.Generator(device=cuda).manual_seed(S + H)
    q, k, v = (torch.randn((B, S, h, hd), generator=g, device=cuda).bfloat16()
               for h in (H, K, K))
    assert variant_of(q, k, v) == "wgmma"
    got = flash_attention_cuda(q, k, v, **ops.kernel_kwargs(q, k, causal=causal))
    G = H // K
    want = torch.empty_like(q)
    for kh in range(K):
        hs = slice(kh * G, (kh + 1) * G)
        want[:, :, hs] = flash_attention_ref(q[:, :, hs].contiguous(),
                                             k[:, :, kh:kh + 1].contiguous(),
                                             v[:, :, kh:kh + 1].contiguous(),
                                             causal=causal)
    rel = ((got.float() - want.float()).norm() / want.float().norm()).item()
    assert rel <= 1e-2, rel


@pytest.mark.gpu
def test_moe_sorted_matches_dense_oracle_on_card(cuda):
    """One deepseek-moe-16b MoE layer's routed experts at full width in
    bf16, [2, 512, 2048], capacity factor E / k (nothing drops): the
    sorted dispatch against the dense oracle within 2e-2 of its norm; the
    router's columns rolled by one read over that. (The shared experts
    are left out: at the reference's init they outweigh the routed ones
    ~8^3 times and would hide a wrong routing.)"""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models.common import init_tree
    from repro_torch.models.moe import (moe_apply_dense, moe_apply_sorted,
                                        moe_schema)

    cfg = get_config("deepseek-moe-16b")
    m = dataclasses.replace(cfg.moe, capacity_factor=64 / 6)
    g = torch.Generator(device=cuda).manual_seed(0)
    m = dataclasses.replace(m, num_shared_experts=0)
    p = init_tree(moe_schema(cfg.d_model, m, cfg.d_ff, cfg.mlp_activation), g,
                  torch.bfloat16)
    x = torch.randn((2, 512, cfg.d_model), generator=g, device=cuda).bfloat16()
    y, aux = moe_apply_sorted(p, x, m, cfg.mlp_activation)
    ref, _ = moe_apply_dense(p, x, m, cfg.mlp_activation)
    assert float(aux["dropped_fraction"]) == 0.0
    rel = ((y.float() - ref.float()).norm() / ref.float().norm()).item()
    assert rel <= 2e-2, rel
    y_f, _ = moe_apply_sorted(dict(p, router=p["router"].roll(1, dims=1)), x, m,
                              cfg.mlp_activation)
    assert ((y_f.float() - ref.float()).norm() / ref.float().norm()).item() > 2e-2


# ---------------------------------------------------------------------------
# Language-model training on the card


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["gemma2-9b", "hymba-1.5b", "mamba2-130m",
                                  "deepseek-moe-16b", "llama-3.2-vision-90b",
                                  "whisper-small"])
def test_lm_train_card_matches_cpu(cuda, arch):
    """One reduced float32 config per family (every all-zero leaf filled):
    lm_loss and every gradient leaf on the card against the CPU from the
    same weights and batch (TF32 off), the loss within 1e-5 relative and
    each leaf within 1e-5 of its norm."""
    from repro_torch.configs import get_config
    from repro_torch.data import pipeline as dp
    from repro_torch.models import lm
    from repro_torch.models.common import tree_leaves, tree_map
    from repro_torch.optim import adamw
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config(arch).reduced()
    g = torch.Generator().manual_seed(0)
    params = tree_map(lambda t: t if t.any() else torch.randn(
        t.shape, generator=g) * 0.1, lm.init_params(cfg, g))
    b = dp.make_lm_batch_fn(cfg.vocab_size, 40, 2)(0, 0, 1, np.random.default_rng(0))
    batch = {k: torch.from_numpy(b[k]) for k in ("tokens", "targets")}
    if cfg.family == "vlm":
        batch["vision"] = torch.randn((2, cfg.vision_tokens, cfg.d_model), generator=g)
    if cfg.family == "audio":
        batch["frames"] = torch.randn((2, cfg.audio_frames, cfg.d_model), generator=g)
    out = {}
    for dev in ("cpu", cuda):
        to = lambda t: t.to(dev)
        (loss, _), grads = adamw.value_and_grad(
            lambda p, bb: lm.lm_loss(p, bb, cfg), tree_map(to, params),
            tree_map(to, batch))
        out[str(dev)] = (loss.cpu(), [t.cpu() for t in tree_leaves(grads)])
    (lc, gc), (lg, gg) = out["cpu"], out[str(cuda)]
    assert abs(float(lg - lc)) <= 1e-5 * abs(float(lc))
    for a, want in zip(gg, gc):
        assert (a - want).abs().max() <= 1e-5 * want.norm(), arch


# ---------------------------------------------------------------------------
# Runners captured once as CUDA graphs (runtime.graphs)


@pytest.mark.gpu
@pytest.mark.parametrize("solver,cached", [("ddim", False), ("ddpm", False),
                                           ("ddim", True)])
def test_captured_engine_equals_eager_on_card(cuda, solver, cached):
    """A frozen engine whose runners are captured at warm-up, against the
    same engine under ``graphs.disabled()``: x0 bit for bit across a
    budget switch, flash launches (counted through replays) equal to the
    eager run's and to the block passes, and no capture after warm-up."""
    import contextlib

    from repro_torch.pipeline import FlexiPipeline
    from repro_torch.runtime import graphs
    from repro_torch.serving import CacheSpec, ServingEngine
    pipe = _serving_pipe("float32", cuda)
    spec = CacheSpec(policy="interval", interval=2, split=1) if cached else None
    out = {}
    for side in ("captured", "eager"):
        ctx = graphs.disabled() if side == "eager" else contextlib.nullcontext()
        with ctx:
            gp = FlexiPipeline(pipe.params, pipe.cfg, pipe.sched, device=cuda)
            eng = ServingEngine(gp, _plans(solver), steps_per_dispatch=4,
                                allow_cold=False, cache=spec)
            n_warm = eng.precapture_warm_set(max_per_mode=1)
            warm = gp.cache_stats()
            ops.reset_launches()
            passes = eng.block_passes
            x0 = {}
            for budgets in ((0.6, 1.0), (1.0, 0.6)):     # a budget switch
                for i in range(6):
                    eng.submit(cond=i, budget=budgets[i % 2])
                x0.update({r.request.id: r.x0 for r in eng.run()})
            torch.cuda.synchronize()
            out[side] = dict(x0=x0, warm=warm, end=gp.cache_stats(),
                             layouts=len({k.layout for k in gp._runners}),
                             launches=ops.flash_attention.launches,
                             f32=ops.flash_attention.launches_by_variant["f32"],
                             passes=eng.block_passes - passes, n_warm=n_warm)
    cap, eag = out["captured"], out["eager"]
    assert sorted(cap["x0"]) == sorted(eag["x0"])
    assert all(torch.equal(cap["x0"][i], eag["x0"][i]) for i in cap["x0"])
    assert cap["launches"] == eag["launches"] == cap["f32"] == cap["passes"]
    # one captured micro-step a layout (every depth k), a graph a branch
    assert cap["warm"]["captured"] == cap["layouts"] * (2 if cached else 1)
    assert cap["end"]["captured"] == cap["warm"]["captured"]
    assert cap["end"]["compiled"] == cap["warm"]["compiled"]
    assert cap["end"]["replays"] > cap["warm"]["replays"]
    assert eag["end"]["captured"] == 0


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["ddim", "ddpm", "cached", "adaptive"])
def test_captured_sample_equals_eager_on_card(cuda, kind):
    """``FlexiPipeline.sample`` twice on a captured pipeline (the first
    call captures, the second replays) against a pipeline under
    ``graphs.disabled()``: x0 bit for bit, launches equal, and one
    runner."""
    from repro_torch.pipeline import AdaptiveBudget, FlexiPipeline, SamplingPlan
    from repro_torch.runtime import graphs
    from repro_torch.serving import CacheSpec
    pipe = _serving_pipe("float32", cuda)
    plan = {"ddim": SamplingPlan(T=6, budget=0.6, attn_backend="pallas"),
            "ddpm": SamplingPlan(T=6, budget=0.6, solver="ddpm",
                                 attn_backend="pallas"),
            "cached": SamplingPlan(T=6, cache=CacheSpec(
                policy="interval", interval=2, split=1), attn_backend="pallas"),
            "adaptive": SamplingPlan(T=6, budget=AdaptiveBudget(),
                                     attn_backend="pallas")}[kind]
    cond = torch.tensor([1, 2], device=cuda)
    xs, launches = [], []
    for side in ("captured", "captured", "eager"):
        gp = (FlexiPipeline(pipe.params, pipe.cfg, pipe.sched, device=cuda)
              if not xs or side == "eager" else gp)
        ops.reset_launches()
        if side == "eager":
            with graphs.disabled():
                x = gp.sample(plan, 2, torch.Generator(cuda).manual_seed(4),
                              cond=cond).x0
        else:
            x = gp.sample(plan, 2, torch.Generator(cuda).manual_seed(4),
                          cond=cond).x0
            stats = gp.cache_stats()
        torch.cuda.synchronize()
        xs.append(x)
        launches.append(ops.flash_attention.launches)
    assert torch.equal(xs[0], xs[2]) and torch.equal(xs[1], xs[2])
    assert launches[0] == launches[1] == launches[2] > 0
    assert stats["captured"] >= 1 and stats["replays"] >= 1


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["dit", "lm", "moe"])
def test_captured_train_steps_equal_eager_on_card(cuda, kind):
    """A tiny train step (DiT at the weak mode, drawing from a CUDA
    generator; gemma2's reduced config with remat "block" over two
    microbatches; deepseek-moe's reduced config, whose row gathers'
    backward must add in a fixed order) three times through its captured runner against the
    same step object under ``graphs.disabled()`` from a copy of the same
    parameters, moments and generator state: the loss and every parameter
    and moment leaf bit for bit after each step; one capture, taken by
    the first call, which applies exactly one update (``step`` 1, the
    parameters equal to the eager first step's); the trees written in
    place (``data_ptr`` unchanged) and returned as the caller's."""
    import contextlib
    import dataclasses

    from repro_torch.configs import AttnConfig, DiTConfig, ModelConfig, get_config
    from repro_torch.configs.base import TrainConfig
    from repro_torch.core import flexify
    from repro_torch.launch import steps as st
    from repro_torch.models import dit as dit_mod
    from repro_torch.models import lm
    from repro_torch.models.common import tree_leaves, tree_map
    from repro_torch.optim import adamw
    from repro_torch.runtime import graphs
    tc = TrainConfig(learning_rate=1e-3, warmup_steps=2, total_steps=20)
    gen = torch.Generator(device=cuda).manual_seed(0)
    if kind == "dit":
        cfg = ModelConfig(
            name="tiny-dit", family="dit", num_layers=2, d_model=64, d_ff=256,
            vocab_size=0, attn=AttnConfig(4, 4, 16, use_rope=False),
            dit=DiTConfig(latent_shape=(1, 16, 16, 4), patch_size=(1, 2, 2),
                          flex_patch_sizes=(), underlying_patch_size=(1, 2, 2),
                          conditioning="class", num_classes=10),
            mlp_activation="gelu", norm_type="layernorm", param_dtype="float32",
            compute_dtype="float32", remat="none", max_seq_len=256)
        params, cfg = flexify(dit_mod.init_dit(cfg, gen), cfg, [(1, 4, 4)],
                              generator=gen)
        step = st.make_dit_train_step(cfg, tc, mode=1)
        batch = {"x0": torch.randn((4, 1, 16, 16, 4), device=cuda, generator=gen),
                 "cond": torch.randint(0, 10, (4,), device=cuda, generator=gen)}
    else:
        arch = "gemma2-9b" if kind == "lm" else "deepseek-moe-16b"
        cfg = dataclasses.replace(get_config(arch).reduced(), remat="block")
        params = lm.init_params(cfg, gen)
        step = st.make_train_step(cfg, tc, n_microbatches=2 if kind == "lm" else 1)
        toks = torch.randint(0, cfg.vocab_size, (4, 40), device=cuda, generator=gen)
        batch = {"tokens": toks, "targets": toks.roll(-1, 1)}
    opt = adamw.init_opt_state(params)
    start = tree_map(torch.clone, {"p": params, "o": opt})
    out = {}
    for side in ("captured", "eager"):
        p, o = ((params, opt) if side == "captured"
                else (tree_map(torch.clone, start["p"]),
                      tree_map(torch.clone, start["o"])))
        ptrs = [t.data_ptr() for t in tree_leaves({"p": p, "o": o})]
        g = torch.Generator(device=cuda).manual_seed(1)
        ctx = graphs.disabled() if side == "eager" else contextlib.nullcontext()
        runs = []
        with ctx:
            for i in range(3):
                p2, o2, m = step(p, o, batch, g)
                assert p2 is p and o2 is o
                torch.cuda.synchronize()
                runs.append(dict(m=m, state=tree_map(torch.clone, {"p": p, "o": o}),
                                 captures=step.captures))
        assert [t.data_ptr() for t in tree_leaves({"p": p, "o": o})] == ptrs
        out[side] = runs
    for cap, eag in zip(out["captured"], out["eager"]):
        assert torch.equal(cap["m"]["loss"], eag["m"]["loss"])
        for a, b in zip(tree_leaves(cap["state"]), tree_leaves(eag["state"])):
            assert torch.equal(a, b)
    assert [r["captures"] for r in out["captured"]] == [1, 1, 1]
    assert int(out["captured"][0]["state"]["o"]["step"]) == 1
    assert int(opt["step"]) == 3 and step.graphs()[0].replays == 2
    assert any(not torch.equal(a, b) for a, b in zip(
        tree_leaves(out["captured"][0]["state"]["p"]), tree_leaves(start["p"])))


@pytest.mark.gpu
def test_train_step_holds_one_tree_on_card(cuda):
    """A step handed new trees (a restore, a fresh copy) drops the graph
    of the old ones before it captures: one graph a step object, the old
    trees freed once the caller lets them go, and the new trees' steps
    equal to the same steps under ``graphs.disabled()`` bit for bit."""
    import gc
    import weakref

    from repro_torch.configs import get_config
    from repro_torch.configs.base import TrainConfig
    from repro_torch.launch import steps as st
    from repro_torch.models import lm
    from repro_torch.models.common import tree_leaves, tree_map
    from repro_torch.optim import adamw
    from repro_torch.runtime import graphs
    gen = torch.Generator(device=cuda).manual_seed(0)
    cfg = get_config("gemma2-9b").reduced()
    tc = TrainConfig(learning_rate=1e-3, warmup_steps=2, total_steps=20)
    step = st.make_train_step(cfg, tc)
    toks = torch.randint(0, cfg.vocab_size, (2, 32), device=cuda, generator=gen)
    batch = {"tokens": toks, "targets": toks.roll(-1, 1)}
    old = lm.init_params(cfg, gen)
    old_opt = adamw.init_opt_state(old)
    new = tree_map(torch.clone, old)
    new_opt = tree_map(torch.clone, old_opt)
    ref = tree_map(torch.clone, {"p": new, "o": new_opt})
    for _ in range(2):
        step(old, old_opt, batch)
    assert step.captures == 1
    gone = weakref.ref(tree_leaves(old)[0])
    del old, old_opt
    gc.collect()
    assert gone() is not None            # held by the step's graph
    for _ in range(2):
        p, o, m = step(new, new_opt, batch)
        assert p is new and o is new_opt
    gc.collect()
    assert gone() is None and step.captures == 1
    assert step.graphs()[0].replays == 1
    with graphs.disabled():
        for _ in range(2):
            _, _, me = step(ref["p"], ref["o"], batch)
    assert torch.equal(m["loss"], me["loss"])
    for a, b in zip(tree_leaves({"p": new, "o": new_opt}), tree_leaves(ref)):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# The fused adaLN kernels (kernels/adaln) against their plain version on
# the card. Where a warp holds a row of 128 < d (d <= 1536 in bf16, 1024 in
# float32) the kernel sums LN's rows in PyTorch's reduce order, so every
# output equals the plain version's bit for bit: at DiT-XL/2's width on
# two served layouts of 8,192 tokens (32
# rows of one 256-token segment; mixed rows of 256- and 64-token segments
# with a 128-token padding tail, the table's last row). At other widths
# only the order of LN's sums differs: x' bit for bit, and h equal to the
# plain chain with LN rounded to its bf16 value or a neighbour
# (``torch_adaln_checks.norm_matches``), or at 1e-5 in float32.

ADALN_LAYOUTS = {"full": ((256, 32),), "mixed": ((256, 8), (64, 94))}


def _adaln_case(cuda, layout, d=1152, k=6, dtype=torch.bfloat16, seed=0):
    from repro_torch.core import packing
    if isinstance(layout, str):
        plan = packing._pack_plan(ADALN_LAYOUTS[layout], 256)
        idx, rows = torch.from_numpy(plan.token_idx), plan.n_seg + 1
    else:                       # [n] tokens in runs of the given lengths
        idx = torch.repeat_interleave(torch.arange(len(layout)),
                                      torch.tensor(layout))
        rows = len(layout)
    g = torch.Generator(device=cuda).manual_seed(seed)
    shape = tuple(idx.shape) + (d,)
    x = (torch.randn(shape, generator=g, device=cuda) * 3 + 0.5).to(dtype)
    y = torch.randn(shape, generator=g, device=cuda).to(dtype)
    table = (torch.randn((rows, k * d), generator=g, device=cuda)
             * 0.3).to(dtype)
    return x, y, table, idx.to(cuda)


def _adaln_agrees(x, y, table, idx, cols, got):
    """Whether the kernel's (x', h) at columns (gate, shift, scale) agree
    with the plain version: x' bit for bit; h bit for bit where the kernel
    sums LN in PyTorch's order (a warp a row, 128 < d), else by
    ``norm_matches`` (bf16) or at 1e-5 (float32)."""
    from torch_adaln_checks import norm_matches

    from repro_torch.kernels.adaln.adaln import launch_plan
    from repro_torch.kernels.adaln.ref import (adaln_norm_ref,
                                               adaln_residual_norm_ref)
    gate, shift, scale = cols
    want_x = x
    if gate is not None:
        want_x = adaln_residual_norm_ref(x, y, table, idx, gate)[0]
        if not torch.equal(got[0], want_x):
            return False
    if shift is None:
        return True
    want_h = adaln_norm_ref(want_x, table, idx, shift, scale)
    d = x.shape[-1]
    if d > 128 and launch_plan(1, d, x.element_size(), 1).row_threads == 32:
        return torch.equal(got[1], want_h)
    if x.dtype == torch.bfloat16:
        return bool(norm_matches(got[1], want_x, table, idx, shift, scale).all())
    return torch.allclose(got[1], want_h, atol=1e-5, rtol=1e-5)


ADALN_OPS = {"norm": (None, 0, 1), "residual_norm": (2, 3, 4),
             "residual": (5, None, None)}


def _order_note() -> str:
    """What a bit-for-bit failure may mean: another torch's reduce order."""
    from repro_torch.kernels.adaln.adaln import REDUCE_ORDER_TORCH
    return (f"LN's sums follow torch {REDUCE_ORDER_TORCH}'s CUDA reduce "
            f"order; this card runs torch {torch.__version__}")


def _adaln_call(x, y, table, idx, cols):
    from repro_torch.kernels.adaln.adaln import adaln_cuda
    gate, shift, scale = cols
    return adaln_cuda(x, table, idx, y=None if gate is None else y,
                      gate_col=gate, shift_col=shift, scale_col=scale)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("layout", list(ADALN_LAYOUTS))
def test_adaln_kernels_match_plain_on_card(cuda, layout, dtype):
    """Each operation through its wrapper (counted) at d 1152: the block's
    [S + 1, 6d] table and the final layer's [S + 1, 2d]."""
    from repro_torch.kernels.adaln import ops as adaln_ops
    x, y, table, idx = _adaln_case(cuda, layout, dtype=getattr(torch, dtype))
    adaln_ops.reset_launches()
    got = {"norm": (None, adaln_ops.adaln_norm(x, table, idx, 0, 1)),
           "residual_norm": adaln_ops.adaln_residual_norm(x, y, table, idx,
                                                          2, 3, 4),
           "residual": adaln_ops.adaln_residual_norm(x, y, table, idx, 5)}
    final = table[:, :2 * x.shape[-1]].contiguous()
    got_final = adaln_ops.adaln_norm(x, final, idx, 0, 1)
    torch.cuda.synchronize()
    assert (adaln_ops.adaln_norm.launches,
            adaln_ops.adaln_residual_norm.launches) == (2, 2)
    assert got["residual"][1] is None
    for name, cols in ADALN_OPS.items():
        assert _adaln_agrees(x, y, table, idx, cols, got[name]), (
            name, _order_note())
    assert _adaln_agrees(x, y, final, idx, (None, 0, 1), (None, got_final)), (
        _order_note())


@pytest.mark.gpu
@pytest.mark.parametrize("layout", list(ADALN_LAYOUTS))
def test_adaln_planted_faults_fail_on_card(cuda, layout):
    """The same checks must fail a kernel handed the next segment's table
    row, or the scale column in place of the gate."""
    x, y, table, idx = _adaln_case(cuda, layout, seed=1)
    nxt = (idx + 1) % table.shape[0]
    for name, cols in ADALN_OPS.items():
        got = _adaln_call(x, y, table, nxt, cols)
        assert not _adaln_agrees(x, y, table, idx, cols, got), name
    for cols in ((4, None, None), (4, 3, 4)):
        got = _adaln_call(x, y, table, idx, cols)
        assert not _adaln_agrees(x, y, table, idx, (2,) + cols[1:], got)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("d", [8, 64, 136, 520, 1536, 2048, 4096, 8192])
def test_adaln_kernels_at_other_widths_on_card(cuda, d, dtype):
    """Widths that take one warp a row (1 to 12 chunks a lane) and those
    that take up to 8 warps (their row sums across warps in shared
    memory), on runs of tokens of uneven lengths."""
    runs = (1, 63, 5, 130, 64, 37)
    x, y, table, idx = _adaln_case(cuda, runs, d=d, dtype=getattr(torch, dtype),
                                   seed=d)
    for name, cols in ADALN_OPS.items():
        got = _adaln_call(x, y, table, idx, cols)
        assert _adaln_agrees(x, y, table, idx, cols, got), (
            name, d, dtype, _order_note())


@pytest.mark.gpu
def test_adaln_refusals_on_card(cuda):
    """A width the kernel does not take and an input that autograd would
    record through are refused before a launch."""
    from repro_torch.kernels.adaln import ops as adaln_ops
    x, y, table, idx = _adaln_case(cuda, (40, 24), d=64)
    with pytest.raises(ValueError, match="multiple of 8"):
        adaln_ops.adaln_norm(x[..., :60].contiguous(), table[:, :120].contiguous(),
                             idx, 0, 1)
    adaln_ops.reset_launches()
    xg = x.float().requires_grad_()
    with pytest.raises(RuntimeError, match="adaln_norm: the CUDA kernel has no"):
        adaln_ops.adaln_norm(xg, table.float(), idx, 0, 1)
    with pytest.raises(RuntimeError, match="adaln_residual_norm: the CUDA"):
        adaln_ops.adaln_residual_norm(xg, y.float(), table.float(), idx, 2)
    assert adaln_ops.adaln_norm.launches == adaln_ops.adaln_residual_norm.launches == 0


class _IndexSources(TorchDispatchMode):
    """Record the shape of every tensor ``aten.index.Tensor`` gathers from."""

    def __init__(self):
        super().__init__()
        self.shapes = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func is torch.ops.aten.index.Tensor:
            self.shapes.append(tuple(args[0].shape))
        return func(*args, **(kwargs or {}))


@pytest.mark.gpu
def test_packed_forward_launches_the_adaln_kernels_on_card(cuda):
    """One bf16 packed forward (mixed modes, a padding tail): 3L + 1 adaLN
    launches (a norm, a residual + norm and a residual a block, the final
    norm), and no adaLN table gathered to token level."""
    from repro_torch.core import packing
    from repro_torch.kernels.adaln import ops as adaln_ops
    pipe = _serving_pipe("bfloat16", cuda)
    cfg = pipe.cfg
    groups = ((0, 3), (1, 5))
    gen = torch.Generator(device=cuda).manual_seed(2)
    xs = [torch.randn((n,) + cfg.dit.latent_shape, generator=gen, device=cuda)
          for _m, n in groups]
    ts = [torch.randint(0, 100, (n,), generator=gen, device=cuda)
          for _m, n in groups]
    cs = [torch.randint(0, 10, (n,), generator=gen, device=cuda)
          for _m, n in groups]
    gathers = _IndexSources()
    adaln_ops.reset_launches()
    with torch.inference_mode(), gathers:
        out = packing.packed_mixed_forward(pipe.params, cfg, groups, xs, ts,
                                           cs, attn_backend="pallas")
    torch.cuda.synchronize()
    L, d, rows = cfg.num_layers, cfg.d_model, 3 + 5 + 1
    assert adaln_ops.adaln_norm.launches == L + 1
    assert adaln_ops.adaln_residual_norm.launches == 2 * L
    assert gathers.shapes          # the token streams are still gathered
    assert not [s for s in gathers.shapes if s in ((rows, 6 * d), (rows, 2 * d))]
    assert all(torch.isfinite(o).all() for o in out)


@pytest.mark.gpu
@pytest.mark.parametrize("cached", [False, True])
def test_captured_bf16_engine_equals_eager_on_card(cuda, cached):
    """A bf16 engine whose packed micro-steps are captured (the adaLN
    kernels inside the graphs) against the same engine under
    ``graphs.disabled()``: x0 bit for bit, adaLN launches counted through
    the replays equal to the eager run's, and 3L + 1 a forward uncached."""
    import contextlib

    from repro_torch.kernels.adaln import ops as adaln_ops
    from repro_torch.pipeline import FlexiPipeline
    from repro_torch.runtime import graphs
    from repro_torch.serving import CacheSpec, ServingEngine
    pipe = _serving_pipe("bfloat16", cuda)
    spec = CacheSpec(policy="interval", interval=2, split=1) if cached else None
    out = {}
    for side in ("captured", "eager"):
        ctx = graphs.disabled() if side == "eager" else contextlib.nullcontext()
        with ctx:
            gp = FlexiPipeline(pipe.params, pipe.cfg, pipe.sched, device=cuda)
            eng = ServingEngine(gp, _plans(), steps_per_dispatch=4,
                                allow_cold=False, cache=spec)
            eng.precapture_warm_set(max_per_mode=1)
            adaln_ops.reset_launches()
            f0 = eng.packed_forwards
            for i in range(6):
                eng.submit(cond=i, budget=(0.6, 1.0)[i % 2])
            x0 = {r.request.id: r.x0 for r in eng.run()}
            torch.cuda.synchronize()
            out[side] = dict(x0=x0, forwards=eng.packed_forwards - f0,
                             launches=(adaln_ops.adaln_norm.launches,
                                       adaln_ops.adaln_residual_norm.launches),
                             captured=gp.cache_stats()["captured"])
    cap, eag = out["captured"], out["eager"]
    assert sorted(cap["x0"]) == sorted(eag["x0"])
    assert all(torch.equal(cap["x0"][i], eag["x0"][i]) for i in cap["x0"])
    assert cap["captured"] > 0 and eag["captured"] == 0
    assert cap["launches"] == eag["launches"]
    if not cached:
        L = pipe.cfg.num_layers
        assert cap["launches"] == ((L + 1) * cap["forwards"],
                                   2 * L * cap["forwards"])
