"""Public wrappers of the fused adaLN kernels: the packed DiT block's
LayerNorm + modulation, and its gated residual (with the next norm).

On a CUDA tensor each launches the Hopper kernel (``adaln.py``) and
counts the launch in its own ``launches`` (``adaln_norm.launches``,
``adaln_residual_norm.launches``); a launch inside a captured runner
counts at each replay of the capture (``runtime.graphs.count``). On a CPU
tensor each runs the plain version (``ref.py``) and counts nothing. Any
other device raises. There is no fallback from one to the other. The
kernel has no backward: on a CUDA tensor that autograd would record
through, the wrappers raise (``kernels.refuse_autograd``).

``table`` [S + 1, k * d] is the per-segment adaLN projection and
``token_idx`` each token's row of it (the last row serves padding): the
kernel reads the rows where they lie, so nothing is gathered to token
level.
"""
from __future__ import annotations

import threading
from typing import Callable, Optional, Tuple

import torch

from repro_torch.kernels import refuse_autograd
from repro_torch.kernels.adaln.adaln import adaln_cuda
from repro_torch.kernels.adaln.ref import (adaln_norm_ref,
                                           adaln_residual_norm_ref)
from repro_torch.runtime import graphs


def _on_cuda(name: str, x: torch.Tensor, *tensors: torch.Tensor) -> bool:
    """True for CUDA tensors (checked for autograd), False for CPU ones;
    raises on any other device."""
    if x.device.type == "cpu":
        return False
    if x.device.type != "cuda":
        raise ValueError(f"{name} runs on cuda or cpu tensors, got {x.device}")
    refuse_autograd(name, x, *tensors)
    return True


def adaln_norm(x: torch.Tensor, table: torch.Tensor, token_idx: torch.Tensor,
               shift_col: int, scale_col: int) -> torch.Tensor:
    """LN(x) * (1 + scale[seg]) + shift[seg] for x [..., d], with shift and
    scale the column chunks ``shift_col`` and ``scale_col`` of each token's
    table row ``token_idx[...]``. A new tensor like x."""
    if not _on_cuda("adaln_norm", x, table):
        return adaln_norm_ref(x, table, token_idx, shift_col, scale_col)
    _, h = adaln_cuda(x.contiguous(), table.contiguous(),
                      token_idx.contiguous(), shift_col=shift_col,
                      scale_col=scale_col)
    graphs.count(_count, adaln_norm)
    return h


def adaln_residual_norm(x: torch.Tensor, y: torch.Tensor, table: torch.Tensor,
                        token_idx: torch.Tensor, gate_col: int,
                        shift_col: Optional[int] = None,
                        scale_col: Optional[int] = None
                        ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """x' = x + gate[seg] * y and, where the norm's columns are given,
    LN(x') * (1 + scale[seg]) + shift[seg] (else None). New tensors."""
    if not _on_cuda("adaln_residual_norm", x, y, table):
        return adaln_residual_norm_ref(x, y, table, token_idx, gate_col,
                                       shift_col, scale_col)
    out = adaln_cuda(x.contiguous(), table.contiguous(), token_idx.contiguous(),
                     y=y.contiguous(), gate_col=gate_col, shift_col=shift_col,
                     scale_col=scale_col)
    graphs.count(_count, adaln_residual_norm)
    return out


_count_lock = threading.Lock()


def _count(wrapper: Callable, n: int) -> None:
    with _count_lock:       # a warm-up thread may launch beside serving
        wrapper.launches += n


def reset_launches() -> None:
    """Set both wrappers' launch counts to 0."""
    adaln_norm.launches = 0
    adaln_residual_norm.launches = 0


reset_launches()
