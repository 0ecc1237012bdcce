"""Public wrapper of the flash-attention kernel.

On a CUDA tensor it launches the Hopper kernel (``flash_attention.py``)
and counts the launch in ``flash_attention.launches`` and, under the
variant the inputs select (``"wgmma"``, ``"mma"`` or ``"f32"``), in
``flash_attention.launches_by_variant``; a launch inside a captured
runner counts at each replay of the capture (``runtime.graphs.count``).
On a CPU tensor it runs the plain PyTorch version (``ref.py``) and counts
nothing. Any other
device raises. There is no fallback from one to the other. The kernel has
no backward: on a CUDA tensor that autograd would record through, the
wrapper raises (``kernels.refuse_autograd``).
"""
from __future__ import annotations

import threading
from typing import Optional

import torch

from repro_torch.kernels import refuse_autograd
from repro_torch.kernels.attention import mask as mask_mod
from repro_torch.kernels.attention.flash_attention import (VARIANTS,
                                                          flash_attention_cuda,
                                                          variant_of)
from repro_torch.kernels.attention.ref import flash_attention_ref
from repro_torch.runtime import graphs


def segment_block_map(segment_ids: torch.Tensor, S: int, Sk: int, *,
                      causal: bool = False, window: int = 0,
                      block_q: int = 128, block_k: int = 128) -> torch.Tensor:
    """The tile map the kernel takes for self-attention over [B, S]
    segment ids (a superset of the mask: it only skips work). A packed
    forward derives it once and hands it to every block."""
    B = segment_ids.shape[0]
    bq, bk = min(block_q, S), min(block_k, Sk)
    q_seg, _ = mask_mod.pad_to_block_multiple(segment_ids, B, S, bq)
    k_seg, _ = mask_mod.pad_to_block_multiple(segment_ids, B, Sk, bk)
    return mask_mod.attention_block_map(q_seg, k_seg, block_q=bq,
                                        block_k=bk, causal=causal,
                                        window=window)


def kernel_kwargs(q: torch.Tensor, k: torch.Tensor, *, causal: bool = True,
                  softcap: float = 0.0, window: int = 0,
                  segment_ids: Optional[torch.Tensor] = None,
                  block_map: Optional[torch.Tensor] = None,
                  block_q: int = 128, block_k: int = 128) -> dict:
    """The keyword arguments :func:`flash_attention` hands its kernel (and
    its plain version): the caller's, checked, with the block map derived
    from the segment ids' per-block ranges when the caller gives ids and no
    map (a superset of the mask: it only skips work)."""
    B, S = q.shape[:2]
    Sk = k.shape[1]
    if segment_ids is not None:
        if tuple(segment_ids.shape) != (B, S):
            raise ValueError(f"segment_ids {tuple(segment_ids.shape)} != {(B, S)}")
        if S != Sk:
            raise ValueError("segment packing is self-attention only")
        if block_map is None:
            block_map = segment_block_map(segment_ids, S, Sk, causal=causal,
                                          window=window, block_q=block_q,
                                          block_k=block_k)
    return dict(causal=causal, softcap=softcap, window=window,
                segment_ids=segment_ids, block_map=block_map,
                block_q=block_q, block_k=block_k)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, softcap: float = 0.0,
                    window: int = 0,
                    segment_ids: Optional[torch.Tensor] = None,
                    block_map: Optional[torch.Tensor] = None,
                    block_q: int = 128, block_k: int = 128) -> torch.Tensor:
    """q: [B,S,H,hd]; k,v: [B,Sk,K,hd] (GQA) → [B,S,H,hd].

    ``segment_ids``: optional [B, S] int32 shared by queries and keys
    (self-attention packing); ids < 0 mark padding. ``block_map``:
    optional [B, ceil(S/bq), ceil(Sk/bk)] int32 tile map with
    ``bq = min(block_q, S)``, ``bk = min(block_k, Sk)``; a 0 entry hides
    that tile. With segment ids and no map, the map is derived from the
    ids (:func:`kernel_kwargs`).
    """
    kw = kernel_kwargs(q, k, causal=causal, softcap=softcap, window=window,
                       segment_ids=segment_ids, block_map=block_map,
                       block_q=block_q, block_k=block_k)
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, **kw)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda or cpu tensors, "
                         f"got {q.device}")
    refuse_autograd("flash_attention", q, k, v)
    out = flash_attention_cuda(q, k, v, **kw)
    graphs.count(_count, variant_of(q, k, v))
    return out


_count_lock = threading.Lock()


def _count(variant: str, n: int) -> None:
    with _count_lock:       # a warm-up thread may launch beside serving
        flash_attention.launches += n
        flash_attention.launches_by_variant[variant] += n


def reset_launches() -> None:
    """Set every launch count of :func:`flash_attention` to 0."""
    flash_attention.launches = 0
    flash_attention.launches_by_variant = dict.fromkeys(VARIANTS, 0)


reset_launches()
