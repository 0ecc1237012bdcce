"""The port's flash attention against the JAX package's Pallas kernel.

On the CPU the port's wrapper runs its plain version (``ref.py``); the
JAX kernel runs in interpret mode, as the JAX package's own tests run it.
Inputs are made with numpy from a seed and handed to both. Tolerance: f32
1e-5 (both sides sum in float32, in different orders); bf16 2e-2, the
JAX package's own kernel-test level. The kernel itself runs only on a
CUDA card: ``test_torch_gpu.py`` holds it against the plain version there.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_threads import one_torch_thread  # noqa: F401

from repro.kernels.attention import flash_attention as jax_fa
from repro.kernels.attention import mask as jax_mask
from repro_torch.kernels.attention import flash_attention as tfa
from repro_torch.kernels.attention import mask as mask_mod
from repro_torch.kernels.attention import ops

# the JAX package's ATTN_CASES (tests/test_kernels.py), plus the DiT-XL/2
# head width 72 with a ragged length
ATTN_CASES = [
    # B, S, H, K, hd, causal, softcap, window, dtype
    (2, 128, 4, 2, 64, True, 0.0, 0, "float32"),
    (1, 256, 4, 4, 64, True, 50.0, 0, "float32"),
    (2, 256, 8, 2, 32, True, 0.0, 128, "float32"),
    (1, 128, 2, 1, 128, False, 0.0, 0, "float32"),
    (1, 256, 4, 2, 64, True, 0.0, 0, "bfloat16"),
    (2, 384, 6, 2, 64, True, 30.0, 256, "float32"),
    (2, 100, 4, 4, 72, False, 0.0, 0, "float32"),
]


def _qkv(rng, B, S, H, K, hd):
    return [rng.standard_normal((B, S, h, hd)).astype(np.float32)
            for h in (H, K, K)]


def _jax(a, dtype):
    return jnp.asarray(a, jnp.bfloat16 if dtype == "bfloat16" else jnp.float32)


def _torch(a, dtype):
    return torch.from_numpy(a).to(getattr(torch, dtype))


def _packed_segments(B: int, S: int) -> np.ndarray:
    """Row-sorted segments with trailing padding (-1), as packing lays out."""
    seg = np.full((B, S), -1, np.int32)
    seg[0, :70], seg[0, 70:150] = 0, 1
    seg[1, :30], seg[1, 30:190] = 0, 1
    return seg


@pytest.mark.parametrize("case", ATTN_CASES,
                         ids=[f"a{i}" for i in range(len(ATTN_CASES))])
def test_plain_flash_matches_jax_kernel(case):
    B, S, H, K, hd, causal, cap, win, dtype = case
    q, k, v = _qkv(np.random.default_rng(B * S + H), B, S, H, K, hd)
    want = jax_fa.flash_attention(_jax(q, dtype), _jax(k, dtype), _jax(v, dtype),
                                  causal=causal, softcap=cap, window=win)
    got = ops.flash_attention(_torch(q, dtype), _torch(k, dtype),
                              _torch(v, dtype), causal=causal, softcap=cap,
                              window=win)
    tol = 1e-5 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=tol, rtol=tol)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("with_map", [False, True])
def test_plain_flash_segments_padding_block_map(causal, with_map):
    """Packed rows with padding, and a caller's block map that hides tiles;
    padding rows return exactly 0 on both sides."""
    rng = np.random.default_rng(7)
    B, S, H, hd = 2, 200, 4, 72
    q, k, v = _qkv(rng, B, S, H, H, hd)
    seg = _packed_segments(B, S)
    bmap = (rng.random((B, 4, 4)) < 0.7).astype(np.int32) if with_map else None
    kw = dict(causal=causal, block_q=64, block_k=64)
    want = np.asarray(jax_fa.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        segment_ids=jnp.asarray(seg),
        block_map=None if bmap is None else jnp.asarray(bmap), **kw))
    got = ops.flash_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        segment_ids=torch.from_numpy(seg),
        block_map=None if bmap is None else torch.from_numpy(bmap), **kw).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    assert np.all(got[1, 190:] == 0.0) and np.all(want[1, 190:] == 0.0)


def test_block_map_and_masks_match_jax():
    seg = _packed_segments(2, 200)
    for bq, bk, causal, window in [(64, 64, False, 0), (48, 80, True, 0),
                                   (64, 32, False, 50)]:
        q_seg, _ = mask_mod.pad_to_block_multiple(torch.from_numpy(seg), 2, 200, bq)
        k_seg, _ = mask_mod.pad_to_block_multiple(torch.from_numpy(seg), 2, 200, bk)
        got = mask_mod.attention_block_map(q_seg, k_seg, block_q=bq, block_k=bk,
                                           causal=causal, window=window)
        jq, _ = jax_mask.pad_to_block_multiple(jnp.asarray(seg), 2, 200, bq)
        jk, _ = jax_mask.pad_to_block_multiple(jnp.asarray(seg), 2, 200, bk)
        want = jax_mask.attention_block_map(jq, jk, block_q=bq, block_k=bk,
                                            causal=causal, window=window)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        # the numpy path (host ledger) agrees with the torch path
        np.testing.assert_array_equal(
            mask_mod.attention_block_map(q_seg.numpy(), k_seg.numpy(),
                                         block_q=bq, block_k=bk, causal=causal,
                                         window=window), got.numpy())
    pos = np.arange(50)
    for causal, window in [(True, 0), (False, 7), (True, 7)]:
        np.testing.assert_array_equal(
            mask_mod.position_allowed(torch.from_numpy(pos), torch.from_numpy(pos),
                                      causal=causal, window=window).numpy(),
            np.asarray(jax_mask.position_allowed(pos, pos, causal=causal,
                                                 window=window)))


def test_wrapper_counts_only_kernel_launches():
    """CPU tensors take the plain version and add nothing to the count."""
    q = torch.zeros(1, 8, 2, 16)
    before = ops.flash_attention.launches
    ops.flash_attention(q, q, q)
    assert ops.flash_attention.launches == before


# the DiT-XL/2 main-path shapes (B = 2 x 4 rows under CFG, 256 tokens at
# patch 2, 64 at patch 4) and bf16 shapes a tensor map cannot describe
PATH_CASES = [(8, 256, 16, 16, 72, False, 0.0, 0, "bfloat16"),
              (8, 64, 16, 16, 72, False, 0.0, 0, "bfloat16")]


@pytest.mark.parametrize("case", ATTN_CASES + PATH_CASES,
                         ids=[f"v{i}" for i in range(len(ATTN_CASES) + 2)])
def test_flash_variant_selection(case):
    """float32 keeps the CUDA-core kernel; bf16 rows of whole 16-byte
    chunks at 16-byte aligned bases take the TMA/wgmma kernel; other bf16
    shapes the mma.sync kernel. Decided from the inputs alone."""
    hd, dtype = case[4], getattr(torch, case[8])
    want = "f32" if dtype == torch.float32 else "wgmma"
    assert tfa.select_variant(dtype, hd, aligned=True) == want
    q = torch.zeros(case[:3] + (hd,), dtype=dtype)
    assert tfa.variant_of(q, q, q) == want
    if dtype == torch.bfloat16:
        assert tfa.select_variant(dtype, hd, aligned=False) == "mma"
        assert tfa.select_variant(dtype, hd - 2, aligned=True) == "mma"
        assert tfa.select_variant(dtype, 136, aligned=True) == "wgmma"
        assert tfa.select_variant(dtype, 256, aligned=True) == "wgmma"
