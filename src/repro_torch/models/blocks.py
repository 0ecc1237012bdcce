"""Decoder blocks of the language models — the port of
``repro.models.blocks``: one ``block_schema`` / ``block_apply`` pair for
the dense, MoE, SSM (mamba2) and hybrid (hymba: attention and Mamba2
heads in parallel) layers, and the gated cross-attention block of the
vision model.

The SSM branches run ``models.ssm.ssm_apply`` without ``use_kernel``, as
the reference's ``block_apply`` does; the MoE feed-forward is
``models.moe.moe_apply_sorted``, whose aux losses ``block_apply`` returns.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.attention import (attention_schema, cross_attention,
                                          cross_attention_schema,
                                          decode_attention, prefill_attention)
from repro_torch.models.common import ParamSpec, apply_norm, norm_schema
from repro_torch.models.mlp import mlp_apply, mlp_schema
from repro_torch.models.moe import moe_apply_sorted, moe_schema

Params = Dict[str, Any]


def block_schema(cfg: ModelConfig) -> Params:
    d = cfg.d_model
    s: Params = {}
    if cfg.family == "ssm":          # pure mamba2: norm → ssm → residual
        s["ln1"] = norm_schema(d, cfg.norm_type)
        s["ssm"] = ssm_mod.ssm_schema(d, cfg.ssm)
        return s
    s["ln1"] = norm_schema(d, cfg.norm_type)
    s["attn"] = attention_schema(d, cfg.attn)
    if cfg.family == "hybrid":       # hymba: parallel attn + ssm heads
        s["ssm"] = ssm_mod.ssm_schema(d, cfg.ssm)
        s["ln_attn_out"] = norm_schema(d, cfg.norm_type)
        s["ln_ssm_out"] = norm_schema(d, cfg.norm_type)
    if cfg.use_post_norm:
        s["post_ln1"] = norm_schema(d, cfg.norm_type)
    s["ln2"] = norm_schema(d, cfg.norm_type)
    if cfg.family == "moe" or cfg.moe is not None:
        s["moe"] = moe_schema(d, cfg.moe, cfg.d_ff, cfg.mlp_activation)
    else:
        s["mlp"] = mlp_schema(d, cfg.d_ff, cfg.mlp_activation)
    if cfg.use_post_norm:
        s["post_ln2"] = norm_schema(d, cfg.norm_type)
    return s


def cross_block_schema(cfg: ModelConfig, kv_dim: int = 0) -> Params:
    """Gated cross-attention block (llama-3.2-vision style); both gates
    start at zero, so tanh(0) = 0 closes the block until trained."""
    d = cfg.d_model
    return {
        "ln1": norm_schema(d, cfg.norm_type),
        "xattn": cross_attention_schema(d, cfg.attn, kv_dim),
        "gate_attn": ParamSpec((1,), (None,), init="zeros"),
        "ln2": norm_schema(d, cfg.norm_type),
        "mlp": mlp_schema(d, cfg.d_ff, cfg.mlp_activation),
        "gate_mlp": ParamSpec((1,), (None,), init="zeros"),
    }


def _gate(g: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """tanh of a gate in float32, cast to the residual's dtype."""
    return torch.tanh(g.float()).to(dtype)


def cross_block_apply(p: Params, x: torch.Tensor, kv: torch.Tensor,
                      cfg: ModelConfig,
                      kv_valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Gated cross-attention block (vision / encoder conditioning)."""
    h = apply_norm(p["ln1"], x, cfg.norm_type)
    y = cross_attention(p["xattn"], h, kv, cfg.attn, kv_valid=kv_valid)
    x = x + _gate(p["gate_attn"], x.dtype) * y
    h2 = apply_norm(p["ln2"], x, cfg.norm_type)
    y2 = mlp_apply(p["mlp"], h2, cfg.mlp_activation)
    return x + _gate(p["gate_mlp"], x.dtype) * y2


def _ffn(p: Params, h: torch.Tensor, cfg: ModelConfig
         ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    if "moe" in p:
        return moe_apply_sorted(p["moe"], h, cfg.moe, cfg.mlp_activation)
    return mlp_apply(p["mlp"], h, cfg.mlp_activation), {}


def block_apply(p: Params, x: torch.Tensor, cfg: ModelConfig, *,  # repro: traced
                window: int = 0, mode: str = "train",
                cache: Optional[Params] = None,
                pos: Optional[torch.Tensor] = None,
                segment_ids: Optional[torch.Tensor] = None,
                backend: str = "xla"
                ) -> Tuple[torch.Tensor, Optional[Params], Dict[str, torch.Tensor]]:
    """Apply one decoder block.

    mode: 'train' | 'prefill' | 'decode' | 'encode' (non-causal).
    cache (decode): {'k','v'[, 'k_scale','v_scale']} and/or {'h','conv'}
    per family; decode writes the K/V entry into it in place.
    Returns (x, new_cache, aux_losses)."""
    aux: Dict[str, torch.Tensor] = {}
    new_cache: Params = {}

    if cfg.family == "ssm":
        h = apply_norm(p["ln1"], x, cfg.norm_type)
        state = cache if (cache and "h" in cache) else None
        y, st = ssm_mod.ssm_apply(p["ssm"], h, cfg.ssm, cfg.d_model, state)
        if mode in ("prefill", "decode"):
            new_cache.update(st)
        return x + y, (new_cache or None), aux

    # --- attention (and hybrid ssm branch) --------------------------------
    h = apply_norm(p["ln1"], x, cfg.norm_type)
    causal = mode != "encode"
    if mode == "decode":
        kv_in = {k: cache[k] for k in ("k", "v", "k_scale", "v_scale")
                 if k in cache}
        attn_out, kvc = decode_attention(p["attn"], kv_in, h, pos, cfg.attn,
                                         window=window)
        new_cache.update(kvc)
    elif mode == "prefill":
        attn_out, kvc = prefill_attention(p["attn"], h, cfg.attn,
                                          window=window, backend=backend)
        new_cache.update(kvc)
    else:
        attn_out = attn_mod.attention(p["attn"], h, cfg.attn, causal=causal,
                                      window=window, segment_ids=segment_ids,
                                      backend=backend)

    if cfg.family == "hybrid":
        state = ({k: cache[k] for k in ("h", "conv")}
                 if (cache and "h" in cache) else None)
        ssm_out, st = ssm_mod.ssm_apply(p["ssm"], h, cfg.ssm, cfg.d_model, state)
        if mode in ("prefill", "decode"):
            new_cache.update(st)
        attn_out = 0.5 * (apply_norm(p["ln_attn_out"], attn_out, cfg.norm_type)
                          + apply_norm(p["ln_ssm_out"], ssm_out, cfg.norm_type))

    if cfg.use_post_norm:
        attn_out = apply_norm(p["post_ln1"], attn_out, cfg.norm_type)
    x = x + attn_out

    h2 = apply_norm(p["ln2"], x, cfg.norm_type)
    ffn_out, moe_aux = _ffn(p, h2, cfg)
    aux.update(moe_aux)
    if cfg.use_post_norm:
        ffn_out = apply_norm(p["post_ln2"], ffn_out, cfg.norm_type)
    x = x + ffn_out
    return x, (new_cache or None), aux
