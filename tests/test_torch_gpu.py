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
elements of y). The JAX package holds its own SSD kernel at 2e-3.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.attention import ops
from repro_torch.kernels.attention.flash_attention import (flash_attention_cuda,
                                                          variant_of)
from repro_torch.kernels.attention.ref import flash_attention_ref
from repro_torch.kernels.patch_embed import ops as pe_ops
from repro_torch.kernels.patch_embed.patch_embed import (deembed_variant_of,
                                                         patch_deembed_cuda,
                                                         patch_embed_cuda)
from repro_torch.kernels.patch_embed.ref import (patch_deembed_ref,
                                                 patch_embed_ref)
from repro_torch.kernels.ssd import ops as ssd_ops
from repro_torch.kernels.ssd.ref import ssd_chunk_ref, ssd_chunked
from repro_torch.kernels.ssd.ssd_chunk import ssd_chunk_cuda

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


# the JAX package's SSD_CASES (B, S, H, P, N, chunk) and one mamba2-130m
# layer at B=4, S=2048
SSD_CASES = [(2, 64, 4, 16, 8, 16), (1, 96, 2, 32, 16, 32),
             (2, 48, 3, 8, 8, 16), (1, 128, 4, 16, 32, 64),
             (4, 2048, 24, 64, 128, 128)]
SSD_TOL = {"float32": 1e-3, "bfloat16": 2e-2}


def _ssd_inputs(device, B, S, H, P, N, dtype, seed):
    gen = torch.Generator(device=device).manual_seed(seed)

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=device)
    x = rnd(B, S, H, P).to(getattr(torch, dtype))
    dt = torch.nn.functional.softplus(rnd(B, S, H))
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
