"""Plain PyTorch version of the fused adaLN kernels: the packed DiT block's
chain of PyTorch ops, written out.

``table`` is a block's (or the final layer's) adaLN projection per
segment, [S + 1, k * d], cut into k column chunks of d (the DiT's order:
shift, scale, gate for attention, then for the MLP); ``token_idx`` [...]
holds each token's segment row (the last row serves padding). Each op
rounds its float32 result once to x's dtype, as PyTorch's element-wise
kernels do; LayerNorm is the model's own (``models/dit._ln``: no affine,
eps 1e-6, float32, rounded once).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.models.dit import _ln as layer_norm


def segment_rows(table: torch.Tensor, token_idx: torch.Tensor, col: int,
                 d: int) -> torch.Tensor:
    """Column chunk ``col`` of each token's segment row: [..., d]."""
    return table[:, col * d:(col + 1) * d][token_idx]


def adaln_norm_ref(x: torch.Tensor, table: torch.Tensor,
                   token_idx: torch.Tensor, shift_col: int,
                   scale_col: int) -> torch.Tensor:
    """LN(x) * (1 + scale[seg]) + shift[seg]."""
    d = x.shape[-1]
    return (layer_norm(x) * (1.0 + segment_rows(table, token_idx, scale_col, d))
            + segment_rows(table, token_idx, shift_col, d))


def adaln_residual_norm_ref(x: torch.Tensor, y: torch.Tensor,
                            table: torch.Tensor, token_idx: torch.Tensor,
                            gate_col: int, shift_col: Optional[int] = None,
                            scale_col: Optional[int] = None
                            ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """x' = x + gate[seg] * y, and LN(x') * (1 + scale[seg]) + shift[seg]
    where the norm's columns are given (else None)."""
    x = x + segment_rows(table, token_idx, gate_col, x.shape[-1]) * y
    if shift_col is None:
        return x, None
    return x, adaln_norm_ref(x, table, token_idx, shift_col, scale_col)

