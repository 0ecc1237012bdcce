"""A check of the fused adaLN kernels' normalised output that the tests
share (``tests/test_torch_adaln.py`` holds it on the CPU,
``tests/test_torch_gpu.py`` applies it to the kernel on a card).

Where the kernel sums LayerNorm's rows in another order than PyTorch's
reduce kernel (rows that take more than one warp, or d <= 128), its LN
may round one bf16 ulp the other way; the rest of the chain is the same
arithmetic, so ``h`` must equal the plain chain with LN taken as its
bf16 value or either neighbour of it.
"""
import torch

from repro_torch.kernels.adaln.ref import segment_rows
from repro_torch.models.dit import _ln as layer_norm


def norm_matches(h: torch.Tensor, x: torch.Tensor, table: torch.Tensor,
                 token_idx: torch.Tensor, shift_col: int,
                 scale_col: int) -> torch.Tensor:
    """Where a bf16 ``h`` equals ``adaln_norm_ref`` of ``x`` with LN(x)
    taken as its bf16 value or as either bf16 neighbour of it. A bool
    tensor like h."""
    d = x.shape[-1]
    ln = layer_norm(x)
    bits = ln.view(torch.int16)
    s1 = 1.0 + segment_rows(table, token_idx, scale_col, d)
    sh = segment_rows(table, token_idx, shift_col, d)
    ok = torch.zeros(h.shape, dtype=torch.bool, device=h.device)
    for cand in (ln, (bits - 1).view(ln.dtype), (bits + 1).view(ln.dtype)):
        ok |= cand * s1 + sh == h
    return ok
