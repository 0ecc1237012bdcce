"""Plain PyTorch versions around the SSD kernel: the kernel's own function
(``ssd_chunk_ref``, the contract of ``ssd_chunk.ssd_chunk_cuda``), the
chunked algorithm, and the naive O(S·N·P) sequential recurrence (ground
truth). Beside them, the split-bf16 arithmetic of the ``"wgmma"`` kernel
(``split_bf16``, ``ssd_chunk_split_ref``), for the tests."""
from __future__ import annotations

from typing import List, Optional, Tuple

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


def split_bf16(v: torch.Tensor, pieces: int) -> List[torch.Tensor]:
    """float32 ``v`` as ``pieces`` bf16 tensors whose float32 sum is ``v``
    to 8 significant bits a piece: v1 = bf16(v), v2 = bf16(v - v1), ...
    Each difference is exact in float32, so three pieces carry float32's
    24 bits and two carry 16 (relative error at most ~2^-17)."""
    out, r = [], v.float()
    for _ in range(pieces):
        piece = r.to(torch.bfloat16)
        out.append(piece)
        r = r - piece.float()
    return out


def ssd_chunk_split_ref(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                        Bm: torch.Tensor, Cm: torch.Tensor, chunk: int
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``ssd_chunk_ref``'s contract, computed as the ``"wgmma"`` kernel
    does: y = M x with M = CB exp(L_q - L_k) dt_k in two bf16 pieces,
    Sc^T = (B^T w) x with w_k = exp(L_tot - L_k) dt_k in three, each piece
    times bf16 x summed in float32 (CB itself in float32). For tests: it
    shows on the CPU what the split costs in accuracy."""
    B, S, H, P = x.shape
    N = Bm.shape[-1]
    if S % chunk:
        raise ValueError(f"S={S} is not a multiple of the chunk {chunk}")
    nc = S // chunk
    xf = x.to(torch.bfloat16).float().reshape(B, nc, chunk, H, P)
    dtc = dt.float().reshape(B, nc, chunk, H)
    Bc = Bm.float().reshape(B, nc, chunk, N)
    Cc = Cm.float().reshape(B, nc, chunk, N)
    L = torch.cumsum(dtc * A.float()[None, None, None, :], dim=2)   # [B,nc,Q,H]
    Ltot = L[:, :, -1]
    CB = torch.einsum("bcqn,bckn->bcqk", Cc, Bc)
    causal = torch.ones((chunk, chunk), dtype=torch.bool, device=x.device).tril()
    diff = L[:, :, :, None, :] - L[:, :, None, :, :]                # [B,nc,Q,K,H]
    decay = torch.exp(torch.where(causal[None, None, :, :, None], diff,
                                  float("-inf")))
    M = CB[..., None] * decay * dtc[:, :, None, :, :]
    y = sum(torch.einsum("bcqkh,bckhp->bcqhp", m.float(), xf)
            for m in split_bf16(M, 2))
    w = torch.exp(Ltot[:, :, None, :] - L) * dtc                    # [B,nc,Q,H]
    Bw = Bc[:, :, :, None, :] * w[..., None]                        # [B,nc,Q,H,N]
    Sc = sum(torch.einsum("bckhn,bckhp->bchpn", a.float(), xf)
             for a in split_bf16(Bw, 3))
    return y.reshape(B, S, H, P).to(x.dtype), Sc, Ltot


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
