"""Language-model wrapper of the port — ``repro.models.lm`` for the dense,
hybrid and SSM families: schema, init, prefill and KV-cache decode.

Parameters are the reference's tree: per-layer leaves stacked ``[L, ...]``
under ``blocks``, matrices ``[in, out]``. Layers run as a Python loop over
those leaves, so each layer's window is a static int (the reference's
unrolled route); the cache is stacked ``[L, ...]`` the same way. Decode
writes each layer's new K/V entry and SSM state into the cache it is
given, in place, and returns that cache.

The vision and audio models, MoE, and training (``forward_train``,
``lm_loss``) come with the next language-model slice and raise here.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.blocks import NEXT_LM_SLICE, block_apply, block_schema
from repro_torch.models.common import (ParamSpec, apply_norm, dtype_of,
                                       init_tree, matmul_f32, norm_schema,
                                       softcap, stack_schema)

Params = Dict[str, Any]

LM_FAMILIES = ("dense", "hybrid", "ssm")


def _check_family(cfg: ModelConfig) -> None:
    if cfg.family not in LM_FAMILIES or cfg.moe is not None:
        raise NotImplementedError(f"the {cfg.family!r} family ({cfg.name}) "
                                  f"comes with {NEXT_LM_SLICE}")


# ---------------------------------------------------------------------------
# Schema


def lm_schema(cfg: ModelConfig) -> Params:
    _check_family(cfg)
    d, V, L = cfg.d_model, cfg.vocab_size, cfg.num_layers
    s: Params = {
        "embed": ParamSpec((V, d), ("vocab", "embed"), init="embed"),
        "final_norm": norm_schema(d, cfg.norm_type),
        "blocks": stack_schema(block_schema(cfg), L),
    }
    if not cfg.tie_embeddings:
        s["lm_head"] = ParamSpec((d, V), ("embed", "vocab"))
    return s


def init_params(cfg: ModelConfig, generator: torch.Generator) -> Params:
    """Random parameters on ``generator.device`` in ``cfg.param_dtype``."""
    return init_tree(lm_schema(cfg), generator, dtype_of(cfg.param_dtype))


def layer_windows(cfg: ModelConfig) -> np.ndarray:
    if cfg.attn is None:
        return np.zeros((cfg.num_layers,), np.int32)
    return np.asarray([cfg.attn.window_for_layer(i)
                       for i in range(cfg.num_layers)], np.int32)


# ---------------------------------------------------------------------------
# Embedding / unembedding


def embed_tokens(params: Params, tokens: torch.Tensor,
                 cfg: ModelConfig) -> torch.Tensor:
    x = params["embed"][tokens.long()].to(dtype_of(cfg.compute_dtype))
    if cfg.scale_embeddings:
        # sqrt(d) in float32, then rounded to x's dtype, as the reference
        scale = torch.tensor(math.sqrt(float(cfg.d_model)), dtype=torch.float32)
        x = x * scale.to(x.dtype).to(x.device)
    return x


def unembed(params: Params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Final norm, then logits with a float32 result (one rounding of the
    products' sums), soft-capped."""
    x = apply_norm(params["final_norm"], x, cfg.norm_type)
    head = params["lm_head"] if "lm_head" in params else params["embed"].t()
    return softcap(matmul_f32(x, head), cfg.final_logit_softcap)


# ---------------------------------------------------------------------------
# Serving: prefill + decode


def _layer(tree: Params, i: int) -> Params:
    return {k: (_layer(v, i) if isinstance(v, dict) else v[i])
            for k, v in tree.items()}


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               device: Any = None) -> Params:
    """Stacked per-layer cache of zeros on ``device`` (default CUDA): an
    empty cache to decode into, the int8 one with its bf16 scales."""
    _check_family(cfg)
    device = resolve_device(device)
    dt = dtype_of(cfg.compute_dtype)
    L = cfg.num_layers

    def zeros(shape, dtype):
        return torch.zeros(shape, dtype=dtype, device=device)

    int8 = cfg.kv_cache_dtype == "int8"
    kv_dt = torch.int8 if int8 else dt
    c: Params = {}
    if cfg.attn is not None:
        K, hd = cfg.attn.num_kv_heads, cfg.attn.head_dim
        c["k"] = zeros((L, batch, max_len, K, hd), kv_dt)
        c["v"] = zeros((L, batch, max_len, K, hd), kv_dt)
        if int8:
            c["k_scale"] = zeros((L, batch, max_len, K), torch.bfloat16)
            c["v_scale"] = zeros((L, batch, max_len, K), torch.bfloat16)
    if cfg.ssm is not None:
        d_in, H, P = ssm_mod.ssm_dims(cfg.d_model, cfg.ssm)
        N = cfg.ssm.state_dim
        W = cfg.ssm.conv_width
        c["h"] = zeros((L, batch, H, P, N), torch.float32)
        c["conv"] = zeros((L, batch, W - 1, d_in + 2 * N), dt)
    return c


def prefill(params: Params, tokens: torch.Tensor, cfg: ModelConfig, *,
            extra: Optional[Dict[str, torch.Tensor]] = None,
            backend: str = "xla") -> Tuple[torch.Tensor, Params]:
    """Process the prompt, return (last-position logits [B,V] float32,
    cache). Each layer's cache is written into one stacked tensor per
    leaf, allocated at the first layer."""
    _check_family(cfg)
    x = embed_tokens(params, tokens, cfg)
    windows = layer_windows(cfg)
    cache: Params = {}
    for i in range(cfg.num_layers):
        x, c, _ = block_apply(_layer(params["blocks"], i), x, cfg,
                              window=int(windows[i]), mode="prefill",
                              backend=backend)
        for k, t in c.items():
            if k not in cache:
                cache[k] = t.new_empty((cfg.num_layers,) + tuple(t.shape))
            cache[k][i].copy_(t)
    logits = unembed(params, x[:, -1:], cfg)[:, 0]
    return logits, cache


def decode_step(params: Params, cache: Params, token: torch.Tensor,
                pos: torch.Tensor, cfg: ModelConfig
                ) -> Tuple[torch.Tensor, Params]:
    """One decode step. token: [B,1] int; pos: [B] int. Returns (logits
    [B,V] float32, the cache, updated in place)."""
    _check_family(cfg)
    x = embed_tokens(params, token, cfg)
    windows = layer_windows(cfg)
    for i in range(cfg.num_layers):
        c = _layer(cache, i)
        x, c_new, _ = block_apply(_layer(params["blocks"], i), x, cfg,
                                  window=int(windows[i]), mode="decode",
                                  cache=c, pos=pos)
        for k, t in c_new.items():
            if t is not c[k]:            # the SSM state comes back anew
                cache[k][i].copy_(t)
    return unembed(params, x, cfg)[:, 0], cache


def forward_train(*args: Any, **kw: Any):
    raise NotImplementedError(f"forward_train (language-model training) "
                              f"comes with {NEXT_LM_SLICE}")


def lm_loss(*args: Any, **kw: Any):
    raise NotImplementedError(f"lm_loss (language-model training) comes "
                              f"with {NEXT_LM_SLICE}")
