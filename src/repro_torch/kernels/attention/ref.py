"""Plain PyTorch version of the flash-attention kernel: the same function,
computed densely in float32.

It applies exactly the kernel's masks: causal / window positions, packing
segment ids (−1 = padding), ragged key tails, and the caller's block map
at its ``block_q``/``block_k`` granularity (a 0 entry hides every key of
that tile from every query of it). A row with no visible key returns 0,
not the uniform average a dense softmax gives a fully masked row.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.kernels.attention import mask as mask_mod

NEG_INF = -1e30


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True, softcap: float = 0.0,
                        window: int = 0,
                        segment_ids: Optional[torch.Tensor] = None,
                        block_map: Optional[torch.Tensor] = None,
                        block_q: int = 128, block_k: int = 128) -> torch.Tensor:
    """q: [B,S,H,hd]; k,v: [B,Sk,K,hd] (GQA) → [B,S,H,hd] in q's dtype."""
    B, S, H, hd = q.shape
    Sk, K = k.shape[1], k.shape[2]
    G = H // K
    dev = q.device
    kf = k.float().repeat_interleave(G, dim=2)
    vf = v.float().repeat_interleave(G, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), kf) * (1.0 / math.sqrt(hd))
    if softcap > 0.0:
        s = torch.tanh(s / softcap) * softcap
    qp = torch.arange(S, device=dev)
    kp = torch.arange(Sk, device=dev)
    allowed = mask_mod.position_allowed(qp, kp, causal=causal,
                                        window=window)[None]     # [1,S,Sk]
    if segment_ids is not None:
        allowed = allowed & mask_mod.segment_allowed(segment_ids, segment_ids)
    if block_map is not None:
        bq, bk = min(block_q, S), min(block_k, Sk)
        tiles = block_map.to(dev)[:, qp // bq][:, :, kp // bk] != 0
        allowed = allowed & tiles
    allowed = allowed[:, None]                                  # [B|1,1,S,Sk]
    s = torch.where(allowed, s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(allowed, torch.exp(s - m), 0.0)
    denom = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    o = torch.einsum("bhqk,bkhd->bqhd", p / denom, vf)
    return o.to(q.dtype)
