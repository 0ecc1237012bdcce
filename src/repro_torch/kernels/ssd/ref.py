"""Plain PyTorch versions around the SSD kernel: the kernel's own function
(``ssd_chunk_ref``, the contract of ``ssd_chunk.ssd_chunk_cuda``), the
chunked algorithm, and the naive O(S·N·P) sequential recurrence (ground
truth)."""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.models.ssm import ssd_chunked  # noqa: F401
from repro_torch.models.ssm import ssd_intra_chunk


def ssd_chunk_ref(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                  Bm: torch.Tensor, Cm: torch.Tensor, chunk: int
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x: [B,S,H,P]; dt: [B,S,H]; A: [H]; Bm/Cm: [B,S,N], S a multiple of
    ``chunk``. Returns (y_intra [B,S,H,P] in x's dtype, Sc [B,nc,H,P,N],
    Ltot [B,nc,H]), float32 inside."""
    B, S, H, P = x.shape
    N = Bm.shape[-1]
    if S % chunk:
        raise ValueError(f"S={S} is not a multiple of the chunk {chunk}")
    nc = S // chunk
    y, Sc, L = ssd_intra_chunk(
        x.reshape(B, nc, chunk, H, P), dt.float().reshape(B, nc, chunk, H),
        A.float(), Bm.float().reshape(B, nc, chunk, N),
        Cm.float().reshape(B, nc, chunk, N))
    return y.reshape(B, S, H, P).to(x.dtype), Sc, L[:, :, -1]


def ssd_recurrence_ref(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                       Bm: torch.Tensor, Cm: torch.Tensor,
                       h0: Optional[torch.Tensor] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Naive step-by-step recurrence — the mathematical definition."""
    B, S, H, P = x.shape
    N = Bm.shape[-1]
    h = h0 if h0 is not None else x.new_zeros((B, H, P, N), dtype=torch.float32)
    ys = []
    for t in range(S):
        a = torch.exp(dt[:, t] * A[None, :])                      # [B,H]
        h = h * a[:, :, None, None] \
            + (dt[:, t, :, None] * x[:, t].float())[..., None] \
            * Bm[:, t, None, None, :].float()
        ys.append(torch.einsum("bhpn,bn->bhp", h, Cm[:, t].float()))
    return torch.stack(ys, dim=1).to(x.dtype), h
