"""SSD with the intra-chunk part on the kernel: a drop-in for
``repro_torch.models.ssm.ssd_chunked``.

On a CUDA tensor the intra-chunk part launches the Hopper kernel
(``ssd_chunk.py``) and counts the launch in ``ssd.launches`` and under
the variant the inputs select in ``ssd.launches_by_variant``; on a CPU
tensor it runs the plain version (``ref.ssd_chunk_ref``) and counts
nothing. Any other device raises, and so does a CUDA launch that
autograd would record through (the kernel has no backward). The
inter-chunk recurrence and the carried-state term stay plain PyTorch, as
they stay outside the kernel in the JAX package.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import refuse_autograd
from repro_torch.kernels.ssd.ref import ssd_chunk_ref
from repro_torch.kernels.ssd.ssd_chunk import (SSD_VARIANTS, ssd_chunk_cuda,
                                               ssd_variant_of)
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
        refuse_autograd("ssd", x, dt, A, Bm, Cm)
        args = (x.contiguous(),
                *(t.float().contiguous() for t in (dt, A, Bm, Cm)))
        y_intra, Sc, Ltot = ssd_chunk_cuda(*args, chunk)
        ssd.launches += 1
        ssd.launches_by_variant[ssd_variant_of(args[0], args[3], args[4], chunk)] += 1
    else:
        raise ValueError(f"ssd runs on cuda or cpu tensors, got {x.device}")
    L = torch.cumsum((dt.float() * A.float()[None, None, :])
                     .reshape(B, nc, chunk, H), dim=2)
    y_inter, h_final = ssd_inter_chunk(Sc, Ltot, L,
                                       Cm.float().reshape(B, nc, chunk, N), h0)
    y = y_intra + y_inter.reshape(B, nc * chunk, H, P).to(y_intra.dtype)
    return y[:, :S], h_final


def reset_launches() -> None:
    """Set the launch count and the counts by variant to 0."""
    ssd.launches = 0
    ssd.launches_by_variant = dict.fromkeys(SSD_VARIANTS, 0)


reset_launches()
