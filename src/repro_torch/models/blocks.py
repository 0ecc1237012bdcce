"""Decoder blocks of the language models — the port of
``repro.models.blocks`` for the dense, hybrid (hymba: attention and
Mamba2 heads in parallel) and SSM (mamba2) families.

The SSM branches run ``models.ssm.ssm_apply`` without ``use_kernel``, as
the reference's ``block_apply`` does. The MoE feed-forward and the
cross-attention blocks (vision / audio) come with the next language-model
slice and raise here.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.attention import (attention_schema, decode_attention,
                                          prefill_attention)
from repro_torch.models.common import apply_norm, norm_schema
from repro_torch.models.mlp import mlp_apply, mlp_schema

Params = Dict[str, Any]

NEXT_LM_SLICE = "the next language-model slice of the port"


def block_schema(cfg: ModelConfig) -> Params:
    if cfg.family == "moe" or cfg.moe is not None:
        raise NotImplementedError(f"MoE blocks come with {NEXT_LM_SLICE}")
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
    s["mlp"] = mlp_schema(d, cfg.d_ff, cfg.mlp_activation)
    if cfg.use_post_norm:
        s["post_ln2"] = norm_schema(d, cfg.norm_type)
    return s


def cross_block_schema(cfg: ModelConfig, kv_dim: int = 0) -> Params:
    raise NotImplementedError(f"cross-attention blocks (vision / audio) come "
                              f"with {NEXT_LM_SLICE}")


def cross_block_apply(*args: Any, **kw: Any) -> torch.Tensor:
    raise NotImplementedError(f"cross-attention blocks (vision / audio) come "
                              f"with {NEXT_LM_SLICE}")


def _ffn(p: Params, h: torch.Tensor, cfg: ModelConfig
         ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    if "moe" in p:
        raise NotImplementedError(f"the MoE feed-forward comes with "
                                  f"{NEXT_LM_SLICE}")
    return mlp_apply(p["mlp"], h, cfg.mlp_activation), {}


def block_apply(p: Params, x: torch.Tensor, cfg: ModelConfig, *,
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
