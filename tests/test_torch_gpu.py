"""The port's CUDA kernels against their plain PyTorch versions, on a CUDA
card. Every test here is marked ``gpu`` and skips without a card.

This file imports neither JAX nor the JAX package, so it also runs on a
machine that has only PyTorch (run it without the repository's conftest,
which imports JAX):

    PYTHONPATH=src python -m pytest -q --noconftest -m gpu tests/test_torch_gpu.py

Tolerance: f32 2e-5, bf16 2e-2, the JAX package's kernel-test levels
(tests/test_kernels.py); the kernel and the plain version sum in float32
in different orders, and the bf16 kernel rounds probabilities to bf16.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.attention import ops
from repro_torch.kernels.attention.ref import flash_attention_ref

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
