"""Grouped-query attention of the port: backend selection, the language
models' layers (RoPE, sliding windows, soft-capping, QKV bias, QK-norm,
prefill and KV-cache decode, the int8 cache, cross-attention to vision or
encoder states) and the blocked long-sequence path, with the reference's
names and rules (``repro.models.attention``), so a plan means the same in
both packages.

``"pallas"`` names the segment-aware flash kernel: in the port that is
the Hopper kernel of ``kernels.attention`` (its plain version on CPU
tensors). ``"dense"`` and ``"xla-blocked"`` are the plain paths below:
products of 16-bit operands with float32 results
(:func:`repro_torch.models.common.matmul_f32`'s batched sibling), scores
and softmax in float32, probabilities rounded to v's dtype before P.V, as
the reference.

Windows are Python ints here: layers run as a Python loop, so the
reference's static-window route is the only one (no traced window).
Decode writes the new key and value into the cache tensors it is given,
in place (the reference rebuilds the whole cache each step); the returned
cache holds those same tensors.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import AttnConfig
from repro_torch.device import resolve_device
from repro_torch.kernels.attention import mask as mask_mod
from repro_torch.kernels.attention import ops as attn_ops
from repro_torch.models.common import (ParamSpec, _MatmulF32, apply_rope,
                                       rms_norm)

Params = Dict[str, Any]

ATTN_BACKENDS = ("auto", "pallas", "xla-blocked", "dense")

# Sequence length above which "auto" leaves the dense path.
BLOCKED_ATTN_THRESHOLD = 8192

NEG_BIAS = -1e30


def resolve_backend(backend: str, *, n_tokens: int, segmented: bool,
                    window_traced: bool = False) -> str:
    """Resolve an ``attn_backend`` name to a concrete implementation.

    ``auto`` picks the flash kernel whenever segment ids are in play or
    the sequence is long, the dense path otherwise; a per-call window
    schedule stays on the blocked path. ``xla`` is the legacy alias for
    the pre-backend auto (never the kernel)."""
    if backend in ("auto", "xla"):
        long = n_tokens > BLOCKED_ATTN_THRESHOLD
        if window_traced or backend == "xla":
            return "xla-blocked" if long else "dense"
        return "pallas" if (segmented or long) else "dense"
    if backend not in ATTN_BACKENDS:
        raise ValueError(f"unknown attn_backend {backend!r}; known: "
                         f"{ATTN_BACKENDS}")
    if backend == "pallas" and window_traced:
        raise ValueError("the flash kernel takes a static window; window "
                         "schedules need the blocked backend")
    return backend


def attention_schema(d_model: int, cfg: AttnConfig) -> Params:
    H, K, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    s: Params = {
        "wq": ParamSpec((d_model, H, hd), ("embed", "heads", None)),
        "wk": ParamSpec((d_model, K, hd), ("embed", "kv_heads", None)),
        "wv": ParamSpec((d_model, K, hd), ("embed", "kv_heads", None)),
        "wo": ParamSpec((H, hd, d_model), ("heads", None, "embed")),
    }
    if cfg.qkv_bias:
        s["bq"] = ParamSpec((H, hd), ("heads", None), init="zeros")
        s["bk"] = ParamSpec((K, hd), ("kv_heads", None), init="zeros")
        s["bv"] = ParamSpec((K, hd), ("kv_heads", None), init="zeros")
    if cfg.qk_norm:
        s["q_norm"] = {"scale": ParamSpec((hd,), (None,), init="zeros")}
        s["k_norm"] = {"scale": ParamSpec((hd,), (None,), init="zeros")}
    return s


def cross_attention_schema(d_model: int, cfg: AttnConfig, kv_dim: int = 0) -> Params:
    kv_dim = kv_dim or d_model
    H, K, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    return {
        "wq": ParamSpec((d_model, H, hd), ("embed", "heads", None)),
        "wk": ParamSpec((kv_dim, K, hd), ("embed", "kv_heads", None)),
        "wv": ParamSpec((kv_dim, K, hd), ("embed", "kv_heads", None)),
        "wo": ParamSpec((H, hd, d_model), ("heads", None, "embed")),
    }


# ---------------------------------------------------------------------------
# Masking


def make_attention_bias(q_pos: torch.Tensor, k_pos: torch.Tensor, *,
                        causal: bool, window: int = 0,
                        q_segment: Optional[torch.Tensor] = None,
                        k_segment: Optional[torch.Tensor] = None,
                        k_valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Additive float32 bias [..., Sq, Sk] (0 allowed, -1e30 masked) from
    the flash kernel's own mask algebra (``kernels.attention.mask``):
    tokens attend within their segment, ids < 0 neither attend nor are
    attended to; ``window`` 0 is full attention."""
    allowed = mask_mod.position_allowed(q_pos, k_pos, causal=causal,
                                        window=window)
    if q_segment is not None and k_segment is not None:
        allowed = allowed & mask_mod.segment_allowed(q_segment, k_segment)
    if k_valid is not None:
        allowed = allowed & k_valid[..., None, :]
    return torch.where(allowed, 0.0, NEG_BIAS).float()


# ---------------------------------------------------------------------------
# Core attention math (GQA, no repeated-KV materialization)


def bmm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched ``a @ b`` with a float32 result: on CUDA 16-bit operands
    through ``torch.bmm(out_dtype=float32)`` (``_MatmulF32``'s backward),
    else on upcast operands."""
    if a.device.type == "cuda" and a.dtype != torch.float32:
        return _MatmulF32.apply(a, b.to(a.dtype))
    return torch.bmm(a.float(), b.float())


def _scores(s: torch.Tensor, bias: torch.Tensor, hd: int,
            cfg: AttnConfig) -> torch.Tensor:
    """Scores scaled by 1/sqrt(hd), soft-capped and biased: in place,
    unless autograd records them (tanh's backward keeps its output)."""
    if torch.is_grad_enabled() and s.requires_grad:
        s = s / math.sqrt(hd)
        if cfg.logit_softcap > 0.0:
            s = torch.tanh(s / cfg.logit_softcap) * cfg.logit_softcap
        return s + bias
    s.div_(math.sqrt(hd))
    if cfg.logit_softcap > 0.0:
        s.div_(cfg.logit_softcap).tanh_().mul_(cfg.logit_softcap)
    return s.add_(bias)


def gqa_attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               bias: torch.Tensor, cfg: AttnConfig) -> torch.Tensor:
    """q: [B,Sq,H,hd]; k,v: [B,Sk,K,hd]; bias: [B,Sq,Sk] additive (f32).

    Query head h reads kv head h // (H / K). Per batch row: one batched
    product over the K kv heads ([G Sq, hd] x [hd, Sk], k read in its own
    layout), scores scaled, soft-capped and biased in place (one float32
    score tensor of a row alive at a time), softmax, P rounded to v's
    dtype, P.V with a float32 result, cast to q's dtype."""
    B, Sq, H, hd = q.shape
    Sk, K = k.shape[1], k.shape[2]
    G = H // K
    out = []
    for b in range(B):
        qb = q[b].reshape(Sq, K, G, hd).permute(1, 2, 0, 3).reshape(K, G * Sq, hd)
        s = bmm_f32(qb, k[b].permute(1, 2, 0)).view(K, G, Sq, Sk)
        p = torch.softmax(_scores(s, bias[b], hd, cfg), dim=-1).to(v.dtype)
        del s
        o = bmm_f32(p.view(K, G * Sq, Sk), v[b].permute(1, 0, 2))
        out.append(o.view(K, G, Sq, hd).permute(2, 0, 1, 3).reshape(Sq, H, hd)
                   .to(q.dtype))
    return torch.stack(out)


def blocked_gqa_attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                       positions: torch.Tensor, causal: bool, window: int,
                       cfg: AttnConfig, q_block: int = 1024,
                       segment_ids: Optional[torch.Tensor] = None
                       ) -> torch.Tensor:
    """Attention for long sequences, a query block at a time, each block
    attending with an arithmetic mask, so no [B, H, S, S] score tensor is
    ever built (the reference's ``lax.scan`` over q blocks).

    Causal with a window shorter than S: each block visits only keys in
    [start, start + q_block + window), clipped into the sequence.
    ``segment_ids``: optional [B, S] shared by queries and keys; padded
    query rows carry position -1 and see no key."""
    B, S, H, hd = q.shape
    nq = -(-S // q_block)
    pad = nq * q_block - S
    if pad:
        q = torch.cat([q, q.new_zeros((B, pad, H, hd))], dim=1)
        positions = torch.cat([positions, positions.new_full((B, pad), -1)], dim=1)
    seg_q = segment_ids
    if segment_ids is not None and pad:
        seg_q = torch.cat([segment_ids, segment_ids.new_full((B, pad), -1)], dim=1)
    window = int(window)
    sliced = window > 0 and causal and window < S
    k_span = min(q_block + window, S) if sliced else S
    out = []
    for i in range(nq):
        q_i = q[:, i * q_block:(i + 1) * q_block]
        dq = positions[:, i * q_block:(i + 1) * q_block, None]
        start = min(max(i * q_block - window, 0), S - k_span) if sliced else 0
        k_s, v_s = k[:, start:start + k_span], v[:, start:start + k_span]
        dk = torch.arange(start, start + k_span, device=q.device)[None, None, :]
        if sliced:
            allowed = (dq >= dk) & (dq - dk < window) & (dq >= 0)
        else:
            allowed = (dq >= dk) if causal else torch.ones_like(dq >= dk)
            if window > 0:
                allowed = allowed & (dq - dk < window) & (dq - dk > -window)
            allowed = allowed & (dq >= 0)
        if segment_ids is not None:
            allowed = allowed & mask_mod.segment_allowed(
                seg_q[:, i * q_block:(i + 1) * q_block],
                segment_ids[:, start:start + k_span])
        out.append(gqa_attend(q_i, k_s, v_s,
                              torch.where(allowed, 0.0, NEG_BIAS).float(), cfg))
    return torch.cat(out, dim=1)[:, :S]


def _proj(inp: torch.Tensor, w: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """[..., d] x [d, heads, hd] → [..., heads, hd] in ``dtype``."""
    d, heads, hd = w.shape
    return torch.matmul(inp, w.to(dtype).reshape(d, heads * hd)).reshape(
        *inp.shape[:-1], heads, hd)


def project_qkv(params: Params, x: torch.Tensor, kv_x: torch.Tensor,
                cfg: AttnConfig
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    q = _proj(x, params["wq"], x.dtype)
    k = _proj(kv_x, params["wk"], x.dtype)
    v = _proj(kv_x, params["wv"], x.dtype)
    if "bq" in params:
        q = q + params["bq"].to(x.dtype)
        k = k + params["bk"].to(x.dtype)
        v = v + params["bv"].to(x.dtype)
    if "q_norm" in params:
        q = rms_norm(q, params["q_norm"]["scale"])
        k = rms_norm(k, params["k_norm"]["scale"])
    return q, k, v


def _out_proj(params: Params, out: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    H, hd, d = params["wo"].shape
    return torch.matmul(out.reshape(*out.shape[:-2], H * hd),
                        params["wo"].to(dtype).reshape(H * hd, d))


def _positions(B: int, S: int, device: Any) -> torch.Tensor:
    return torch.arange(S, dtype=torch.int32, device=device).expand(B, S)


def _attend(q, k, v, cfg: AttnConfig, positions, *, causal: bool, window: int,
            segment_ids: Optional[torch.Tensor], backend: str) -> torch.Tensor:
    """Self-attention core over rotated q, k, v on the resolved backend."""
    resolved = resolve_backend(backend, n_tokens=q.shape[1],
                               segmented=segment_ids is not None)
    if resolved == "pallas":
        return attn_ops.flash_attention(q, k, v, causal=causal,
                                        window=int(window),
                                        softcap=cfg.logit_softcap,
                                        segment_ids=segment_ids)
    if resolved == "xla-blocked":
        return blocked_gqa_attend(q, k, v, positions=positions, causal=causal,
                                  window=window, cfg=cfg,
                                  segment_ids=segment_ids)
    bias = make_attention_bias(positions, positions, causal=causal,
                               window=window, q_segment=segment_ids,
                               k_segment=segment_ids)
    return gqa_attend(q, k, v, bias, cfg)


def attention(params: Params, x: torch.Tensor, cfg: AttnConfig, *,
              positions: Optional[torch.Tensor] = None,
              causal: bool = True, window: int = 0,
              segment_ids: Optional[torch.Tensor] = None,
              backend: str = "auto") -> torch.Tensor:
    """Self-attention over x: [B,S,d] → [B,S,d]."""
    B, S, _ = x.shape
    if positions is None:
        positions = _positions(B, S, x.device)
    q, k, v = project_qkv(params, x, x, cfg)
    if cfg.use_rope:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    out = _attend(q, k, v, cfg, positions, causal=causal, window=window,
                  segment_ids=segment_ids, backend=backend)
    return _out_proj(params, out, x.dtype)


def cross_attention(params: Params, x: torch.Tensor, kv: torch.Tensor,
                    cfg: AttnConfig,
                    kv_valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x: [B,Sq,d] attends to kv: [B,Sk,d_kv] (non-causal, no RoPE, dense
    as in the reference); ``kv_valid``: optional [B,Sk] bool, False keys
    get no weight."""
    q = _proj(x, params["wq"], x.dtype)
    k = _proj(kv, params["wk"], x.dtype)
    v = _proj(kv, params["wv"], x.dtype)
    B, Sq = x.shape[:2]
    Sk = kv.shape[1]
    zeros_q = torch.zeros((B, Sq), dtype=torch.int32, device=x.device)
    zeros_k = torch.zeros((B, Sk), dtype=torch.int32, device=x.device)
    bias = make_attention_bias(zeros_q, zeros_k, causal=False, window=0,
                               k_valid=kv_valid)
    return _out_proj(params, gqa_attend(q, k, v, bias, cfg), x.dtype)


# ---------------------------------------------------------------------------
# KV-cache decode


def init_kv_cache(batch: int, max_len: int, cfg: AttnConfig,
                  dtype: torch.dtype, device: Any = None) -> Params:
    """Zero K/V cache [batch, max_len, K, hd] on ``device`` (default: CUDA)."""
    device = resolve_device(device)
    K, hd = cfg.num_kv_heads, cfg.head_dim
    return {"k": torch.zeros((batch, max_len, K, hd), dtype=dtype, device=device),
            "v": torch.zeros((batch, max_len, K, hd), dtype=dtype, device=device)}


def kv_cache_spec(batch: int, max_len: int, cfg: AttnConfig,
                  dtype: torch.dtype) -> Params:
    """The cache's shapes and dtypes, as tensors on the ``meta`` device
    (torch's abstract arrays: no storage)."""
    K, hd = cfg.num_kv_heads, cfg.head_dim
    return {"k": torch.empty((batch, max_len, K, hd), dtype=dtype, device="meta"),
            "v": torch.empty((batch, max_len, K, hd), dtype=dtype, device="meta")}


def _quantize_kv(t: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """[.., hd] → (int8, per-(...)-absmax scale as bf16)."""
    tf = t.float()
    scale = tf.abs().amax(dim=-1).clamp_min(1e-6) / 127.0
    q = torch.round(tf / scale[..., None]).clamp(-127, 127).to(torch.int8)
    return q, scale.to(torch.bfloat16)


def decode_attention(params: Params, cache: Params, x: torch.Tensor,
                     pos: torch.Tensor, cfg: AttnConfig, *,
                     window: int = 0) -> Tuple[torch.Tensor, Params]:
    """One decode step. x: [B,1,d]; pos: [B] current position (int).

    Writes the new K/V at ``pos`` into the cache tensors (in place), then
    attends over the whole cache with the mask ``k_pos <= pos`` (and the
    window). A cache with ``k_scale``/``v_scale`` is int8 (per position
    and head absmax): the new entry is quantized on write and the cache
    dequantized to x's dtype on read."""
    B, one, _ = x.shape
    assert one == 1
    q, k_new, v_new = project_qkv(params, x, x, cfg)
    if cfg.use_rope:
        q = apply_rope(q, pos[:, None], cfg.rope_theta)
        k_new = apply_rope(k_new, pos[:, None], cfg.rope_theta)
    S = cache["k"].shape[1]
    rows = torch.arange(B, device=x.device)
    pos = pos.to(device=x.device, dtype=torch.long)
    if "k_scale" in cache:
        kq, ks = _quantize_kv(k_new[:, 0])
        vq, vs = _quantize_kv(v_new[:, 0])
        cache["k"][rows, pos] = kq
        cache["v"][rows, pos] = vq
        cache["k_scale"][rows, pos] = ks
        cache["v_scale"][rows, pos] = vs
        k = cache["k"].to(x.dtype) * cache["k_scale"][..., None].to(x.dtype)
        v = cache["v"].to(x.dtype) * cache["v_scale"][..., None].to(x.dtype)
    else:
        cache["k"][rows, pos] = k_new[:, 0].to(cache["k"].dtype)
        cache["v"][rows, pos] = v_new[:, 0].to(cache["v"].dtype)
        k, v = cache["k"], cache["v"]
    k_pos = torch.arange(S, device=x.device).expand(B, S)
    bias = make_attention_bias(pos[:, None], k_pos, causal=True, window=window)
    out = gqa_attend(q, k, v, bias, cfg)
    return _out_proj(params, out, x.dtype), dict(cache)


def prefill_attention(params: Params, x: torch.Tensor, cfg: AttnConfig, *,
                      window: int = 0, backend: str = "xla"
                      ) -> Tuple[torch.Tensor, Params]:
    """Prefill: causal self-attention that also returns the populated
    cache ({"k", "v"}: the rotated keys and the values, [B,S,K,hd])."""
    B, S, _ = x.shape
    positions = _positions(B, S, x.device)
    q, k, v = project_qkv(params, x, x, cfg)
    if cfg.use_rope:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    out = _attend(q, k, v, cfg, positions, causal=True, window=window,
                  segment_ids=None, backend=backend)
    return _out_proj(params, out, x.dtype), {"k": k, "v": v}
