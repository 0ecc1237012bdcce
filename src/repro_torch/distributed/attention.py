"""Sequence-parallel attention collectives — the port of
``repro.distributed.attention`` over ``torch.distributed``.

Every rank of the sequence group holds its own token shard of
``q, k, v: [B, N/sp, H, hd]`` and gets back the attention output for that
shard:

* :func:`ulysses_attention` — DeepSpeed-Ulysses: an all-to-all turns the
  sequence sharding into a head sharding (every rank sees the whole
  sequence for H/sp heads), the inner attention runs (the segment-aware
  flash kernel under ``auto``/``pallas``), and an all-to-all turns it
  back. Needs H % sp == 0.
* :func:`ring_attention` — K/V chunks rotate around the group while a
  streaming softmax (max, numerator, denominator in float32) accumulates
  the output. Any head count.

Padding tokens (the engine pads N to a multiple of sp) carry segment id
-1 and never contribute as keys; padded query rows are sliced off by the
caller. Each collective is one that both NCCL and Gloo take: the ring's
rotation is an ``all_to_all_single`` whose only non-empty split goes to
rank ``j - 1``.

``comm_bytes`` counts, per process, the bytes each collective call sends
to other ranks, by kind: ``qkvo`` (Ulysses q, k, v in and o back), ``kv``
(ring hops), ``segment_ids``, ``tokens`` (the gather before the
de-embedding) and ``x0`` (the samples gathered over the data axis).
"""
from __future__ import annotations

import collections
import math
from typing import Optional

import torch
import torch.distributed as dist

from repro_torch.configs.base import AttnConfig
from repro_torch.kernels.attention import mask as mask_mod
from repro_torch.kernels.attention import ops as attn_ops
from repro_torch.models import attention as attn_mod

comm_bytes: collections.Counter = collections.Counter()


def reset_comm_bytes() -> None:
    comm_bytes.clear()


def _nbytes(x: torch.Tensor) -> int:
    return x.numel() * x.element_size()


def all_to_all(x: torch.Tensor, group, kind: str) -> torch.Tensor:
    """Chunk j of ``x`` ([sp, ...]) goes to rank j; chunk j of the result
    came from rank j."""
    x = x.contiguous()
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=group)
    comm_bytes[kind] += _nbytes(x) // x.shape[0] * (x.shape[0] - 1)
    return out


def all_gather(x: torch.Tensor, group, kind: str, dim: int) -> torch.Tensor:
    """Every rank's ``x`` concatenated along ``dim`` in rank order."""
    sp = dist.get_world_size(group)
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(sp)]
    dist.all_gather(parts, x, group=group)
    comm_bytes[kind] += _nbytes(x) * (sp - 1)
    return torch.cat(parts, dim=dim)


def rotate(x: torch.Tensor, group, kind: str) -> torch.Tensor:
    """Rank j sends ``x`` to rank j - 1 and receives rank j + 1's (the
    reference's ``ppermute`` with perm (j, j - 1))."""
    sp, j = dist.get_world_size(group), dist.get_rank(group)
    x = x.contiguous()
    send, recv = [0] * sp, [0] * sp
    send[(j - 1) % sp] = recv[(j + 1) % sp] = x.shape[0]
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, output_split_sizes=recv,
                           input_split_sizes=send, group=group)
    comm_bytes[kind] += _nbytes(x)
    return out


def split_seq_chunks(o: torch.Tensor, sp: int) -> torch.Tensor:
    """[B, N, h, hd] → [sp, B, N/sp, h, hd]: sequence chunk j leads."""
    B, N, h, hd = o.shape
    return o.reshape(B, sp, N // sp, h, hd).transpose(0, 1)


def join_seq_chunks(x: torch.Tensor) -> torch.Tensor:
    """[sp, B, n, h, hd] (chunk j from rank j) → [B, sp n, h, hd]."""
    sp, B, n, h, hd = x.shape
    return x.transpose(0, 1).reshape(B, sp * n, h, hd)


def _inner_cfg(heads: int, head_dim: int) -> AttnConfig:
    return AttnConfig(num_heads=heads, num_kv_heads=heads,
                      head_dim=head_dim, use_rope=False)


def _dense_attend(q, k, v, seg, attn_backend: str = "auto") -> torch.Tensor:
    """The inner attention on one rank's heads over the full sequence.
    ``auto``/``pallas`` run the segment-aware flash kernel: padding
    (segment -1) kv tiles are skipped, not computed and masked."""
    B, S, h, hd = q.shape
    resolved = attn_mod.resolve_backend(attn_backend, n_tokens=S,
                                        segmented=seg is not None)
    if resolved == "pallas":
        return attn_ops.flash_attention(q, k, v, causal=False,
                                        segment_ids=seg)
    cfg = _inner_cfg(h, hd)
    pos = torch.arange(S, dtype=torch.int32, device=q.device).expand(B, S)
    if resolved == "xla-blocked":
        return attn_mod.blocked_gqa_attend(q, k, v, positions=pos,
                                           causal=False, window=0, cfg=cfg,
                                           segment_ids=seg)
    bias = attn_mod.make_attention_bias(pos, pos, causal=False, window=0,
                                        q_segment=seg, k_segment=seg)
    return attn_mod.gqa_attend(q, k, v, bias, cfg)


def ulysses_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      group, segment_ids: Optional[torch.Tensor] = None,
                      attn_backend: str = "auto") -> torch.Tensor:
    """All-to-all attention: sequence-sharded in, sequence-sharded out."""
    B, n, H, hd = q.shape
    sp = dist.get_world_size(group)
    if H % sp != 0:
        raise ValueError(f"ulysses needs heads ({H}) % axis size ({sp}) == 0")
    if segment_ids is None:
        segment_ids = torch.zeros((B, n), dtype=torch.int32, device=q.device)
    h = H // sp

    def heads_out(x):
        # [B, n, H, hd] → head chunk j to rank j → [B, N, H/sp, hd]
        chunks = x.reshape(B, n, sp, h, hd).permute(2, 0, 1, 3, 4)
        return join_seq_chunks(all_to_all(chunks, group, "qkvo"))

    qf, kf, vf = heads_out(q), heads_out(k), heads_out(v)
    segf = all_gather(segment_ids, group, "segment_ids", dim=1)
    o = _dense_attend(qf, kf, vf, segf, attn_backend=attn_backend)
    # sequence chunk j back to rank j; the reply's chunks are head groups
    back = all_to_all(split_seq_chunks(o, sp), group, "qkvo")
    return back.permute(1, 2, 0, 3, 4).reshape(B, n, H, hd)


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                   group, segment_ids: Optional[torch.Tensor] = None,
                   attn_backend: str = "auto") -> torch.Tensor:
    """Ring attention: local queries, K/V chunks rotating with a
    streaming-softmax accumulator. ``attn_backend`` is accepted for
    interface parity with :func:`ulysses_attention` and unused: the
    rotating accumulator is the flash-style inner loop."""
    del attn_backend
    B, n, H, hd = q.shape
    sp = dist.get_world_size(group)
    if segment_ids is None:
        segment_ids = torch.zeros((B, n), dtype=torch.int32, device=q.device)
    seg_q = segment_ids
    scale = 1.0 / math.sqrt(hd)
    qf = q.float()

    def accumulate(acc, k_c, v_c, seg_c):
        m, num, den = acc
        s = torch.einsum("bqhd,bkhd->bqhk", qf, k_c.float()) * scale
        mask = mask_mod.segment_allowed(seg_q, seg_c)[:, :, None, :]
        s = torch.where(mask, s, -math.inf)
        m_new = torch.maximum(m, s.amax(dim=-1))
        m_safe = torch.where(torch.isfinite(m_new), m_new, 0.0)
        p = torch.where(mask, torch.exp(s - m_safe[..., None]), 0.0)
        corr = torch.where(torch.isfinite(m), torch.exp(m - m_safe), 0.0)
        num = (num * corr[..., None]
               + torch.einsum("bqhk,bkhd->bqhd", p, v_c.float()))
        den = den * corr + p.sum(dim=-1)
        return m_new, num, den

    # the local chunk first, then (sp - 1) rotate-and-accumulate hops: no
    # dead final rotation, so the traffic is the analytic ledger's
    acc = (torch.full((B, n, H), -math.inf, device=q.device),
           torch.zeros((B, n, H, hd), device=q.device),
           torch.zeros((B, n, H), device=q.device))
    acc = accumulate(acc, k, v, seg_q)
    k_c, v_c, seg_c = k, v, seg_q
    for _ in range(sp - 1):
        k_c = rotate(k_c, group, "kv")
        v_c = rotate(v_c, group, "kv")
        seg_c = rotate(seg_c, group, "segment_ids")
        acc = accumulate(acc, k_c, v_c, seg_c)
    _, num, den = acc
    return (num / den.clamp_min(1e-30)[..., None]).to(q.dtype)


ATTN_FNS = {"ulysses": ulysses_attention, "ring": ring_attention}
