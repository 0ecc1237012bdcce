"""SSD with the intra-chunk part on the kernel: a drop-in for
``repro_torch.models.ssm.ssd_chunked``.

On a CUDA tensor the intra-chunk part launches the Hopper kernel
(``ssd_chunk.py``) and counts the launch in ``ssd.launches``; on a CPU
tensor it runs the plain version (``ref.ssd_chunk_ref``) and counts
nothing. Any other device raises. The inter-chunk recurrence and the
carried-state term stay plain PyTorch, as they stay outside the kernel in
the JAX package.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels.ssd.ref import ssd_chunk_ref
from repro_torch.kernels.ssd.ssd_chunk import ssd_chunk_cuda
from repro_torch.models.ssm import pad_to_chunks, ssd_inter_chunk


def ssd(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, Bm: torch.Tensor,
        Cm: torch.Tensor, chunk: int, h0: Optional[torch.Tensor] = None
        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Same contract as ``models.ssm.ssd_chunked`` (pads internally)."""
    B, S, H, P = x.shape
    N = Bm.shape[-1]
    x, dt, Bm, Cm = pad_to_chunks(chunk, x, dt, Bm, Cm)
    nc = x.shape[1] // chunk
    if x.device.type == "cpu":
        y_intra, Sc, Ltot = ssd_chunk_ref(x, dt, A, Bm, Cm, chunk)
    elif x.device.type == "cuda":
        y_intra, Sc, Ltot = ssd_chunk_cuda(
            x.contiguous(), *(t.float().contiguous() for t in (dt, A, Bm, Cm)),
            chunk)
        ssd.launches += 1
    else:
        raise ValueError(f"ssd runs on cuda or cpu tensors, got {x.device}")
    L = torch.cumsum((dt.float() * A.float()[None, None, :])
                     .reshape(B, nc, chunk, H), dim=2)
    y_inter, h_final = ssd_inter_chunk(Sc, Ltot, L,
                                       Cm.float().reshape(B, nc, chunk, N), h0)
    y = y_intra + y_inter.reshape(B, nc * chunk, H, P).to(y_intra.dtype)
    return y[:, :S], h_final


ssd.launches = 0
