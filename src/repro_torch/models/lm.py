"""Language-model wrapper of the port — ``repro.models.lm`` for every
family (dense, MoE, hybrid, SSM, vision, audio): schema, init, the
training forward and loss, prefill and KV-cache decode.

Parameters are the reference's tree: per-layer leaves stacked ``[L, ...]``
under ``blocks`` (the vision model's self layers ``[G, k-1, ...]`` and its
cross layers ``[G, ...]`` under ``groups``; whisper's ``enc_blocks`` and
``dec_blocks``), matrices ``[in, out]``. Layers run as a Python loop over
those leaves, so each layer's window is a static int (the reference's
unrolled route); the cache is stacked the same way. Decode writes each
layer's new K/V entry and SSM state into the cache it is given, in place,
and returns that cache. On the card, prefill and decode run inside the
CUDA graphs of ``launch/steps``' runners (their defs carry the
``# repro: traced`` mark of the capture-safety rule): they read no
device value on the host and copy nothing from it.

Which attention runs the flash kernel on ``backend="pallas"`` follows the
reference: every self-attention layer of the dense, MoE and hybrid
models, the vision model's self layers (its cross layers are dense), and
whisper's encoder (non-causal; its decoder's attention is dense). Decode
is dense over the cache everywhere.

Training (``forward_train``, ``lm_loss``) runs the reference's train
mode: the same layer loop with ``mode="train"`` (dense attention on the
reference's ``"xla"`` backend; no Pallas kernel has a backward rule), the
MoE aux losses summed over layers, and ``cfg.remat == "block"`` as
activation checkpointing of each layer (each vision group).
``cfg.sequence_parallel`` puts the reference's constraint on each layer's
output, ``(("pod", "data"), "model", None)``: under a mesh with a 'model'
axis each rank keeps its sequence chunk of the residual between layers
(what remat saves) and gathers it at the next layer's entry; without a
mesh both are the identity. The losses are global under a mesh: the
cross-entropy's masked sums and the MoE router's means reduce over the
data axes (``runtime/sharding.data_sum`` / ``data_mean``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch
import torch.utils.checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.attention import (_out_proj, _proj, attention,
                                          attention_schema, cross_attention,
                                          cross_attention_schema,
                                          decode_attention, gqa_attend,
                                          prefill_attention)
from repro_torch.models.blocks import (_gate, block_apply, block_schema,
                                       cross_block_apply, cross_block_schema)
from repro_torch.models.common import (ParamSpec, apply_norm, dtype_of,
                                       init_tree, matmul_f32, norm_schema,
                                       softcap, stack_schema)
from repro_torch.models.mlp import mlp_apply, mlp_schema
from repro_torch.runtime.sharding import (constrain, data_mean, data_sum,
                                          gather_layout)

Params = Dict[str, Any]

VLM_GROUP = 5     # llama-3.2-vision: 1 cross-attn layer per 5 layers

# the layout of each layer's output under cfg.sequence_parallel:
# batch over the data axes, sequence over 'model'
SP_SPEC = (("pod", "data"), "model", None)


# ---------------------------------------------------------------------------
# Schema


def _audio_dec_block_schema(cfg: ModelConfig) -> Params:
    d = cfg.d_model
    return {
        "ln1": norm_schema(d, cfg.norm_type),
        "attn": attention_schema(d, cfg.attn),
        "lnx": norm_schema(d, cfg.norm_type),
        "xattn": cross_attention_schema(d, cfg.attn),
        "ln2": norm_schema(d, cfg.norm_type),
        "mlp": mlp_schema(d, cfg.d_ff, cfg.mlp_activation),
    }


def _vlm_group(cfg: ModelConfig) -> Tuple[int, int]:
    """(layers a group, groups): k-1 self layers then one cross layer."""
    k = cfg.cross_attn_every or VLM_GROUP
    assert cfg.num_layers % k == 0, (cfg.num_layers, k)
    return k, cfg.num_layers // k


def lm_schema(cfg: ModelConfig) -> Params:
    d, V, L = cfg.d_model, cfg.vocab_size, cfg.num_layers
    s: Params = {
        "embed": ParamSpec((V, d), ("vocab", "embed"), init="embed"),
        "final_norm": norm_schema(d, cfg.norm_type),
    }
    if not cfg.tie_embeddings:
        s["lm_head"] = ParamSpec((d, V), ("embed", "vocab"))
    if cfg.family == "vlm":
        k, G = _vlm_group(cfg)
        s["groups"] = {
            "self": stack_schema(stack_schema(block_schema(cfg), k - 1, None), G),
            "cross": stack_schema(cross_block_schema(cfg), G),
        }
        s["vision_proj"] = ParamSpec((d, d), ("embed", "mlp"))
    elif cfg.family == "audio":
        s["enc_blocks"] = stack_schema(block_schema(cfg), cfg.encoder_layers)
        s["enc_norm"] = norm_schema(d, cfg.norm_type)
        s["dec_blocks"] = stack_schema(_audio_dec_block_schema(cfg), L)
        s["pos_embed"] = ParamSpec((cfg.max_seq_len, d), (None, "embed"),
                                   init="embed")
    else:
        s["blocks"] = stack_schema(block_schema(cfg), L)
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


def embed_tokens(params: Params, tokens: torch.Tensor,  # repro: traced
                 cfg: ModelConfig) -> torch.Tensor:
    x = params["embed"][tokens.long()].to(dtype_of(cfg.compute_dtype))
    if cfg.scale_embeddings:
        # sqrt(d) in float32, then rounded to x's dtype, as the reference;
        # filled on the device (a host copy would fail a capture)
        scale = torch.full((), math.sqrt(float(cfg.d_model)),
                           dtype=torch.float32, device=x.device)
        x = x * scale.to(x.dtype)
    return x


def unembed(params: Params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:  # repro: traced
    """Final norm, then logits with a float32 result (one rounding of the
    products' sums), soft-capped."""
    x = apply_norm(params["final_norm"], x, cfg.norm_type)
    head = params["lm_head"] if "lm_head" in params else params["embed"].t()
    return softcap(matmul_f32(x, head), cfg.final_logit_softcap)


# ---------------------------------------------------------------------------
# Aux losses of the MoE layers, summed over layers


def _aux_zero(cfg: ModelConfig, device: Any = None
              ) -> Dict[str, torch.Tensor]:
    """The sums' zeros, on ``device`` (the activations')."""
    if cfg.moe is None:
        return {}
    return {k: torch.zeros((), dtype=torch.float32, device=device)
            for k in ("load_balance", "router_z", "dropped_fraction")}


def _aux_add(acc: Dict[str, torch.Tensor], aux: Dict[str, torch.Tensor]
             ) -> Dict[str, torch.Tensor]:
    return {k: acc[k] + aux.get(k, 0.0) for k in acc}


# ---------------------------------------------------------------------------
# Train forward


def _layer(tree: Params, i: int) -> Params:
    return {k: (_layer(v, i) if isinstance(v, dict) else v[i])
            for k, v in tree.items()}


def _remat(cfg: ModelConfig, fn: Callable, *args: Any) -> Any:
    """``fn(*args)``; under ``cfg.remat == "block"`` (and autograd on) as
    activation checkpointing: its activations are recomputed in the
    backward from these same arguments, so everything ``fn`` depends on
    (the layer's parameters, its window) is an argument, never a name of
    the caller's loop. Other values run plainly: the reference acts on
    ``"block"`` alone. The layers draw nothing, so the RNG state is not
    saved for the recompute (reading the CUDA generator's state fails a
    CUDA-graph capture of the train step)."""
    if cfg.remat == "block" and torch.is_grad_enabled():
        return torch.utils.checkpoint.checkpoint(fn, *args, use_reentrant=False,
                                                 preserve_rng_state=False)
    return fn(*args)


def _train_block(p: Params, x: torch.Tensor, window: int,
                 segment_ids: Optional[torch.Tensor], cfg: ModelConfig,
                 backend: str) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One decoder layer in train mode: (x, its aux losses)."""
    x, _, aux = block_apply(p, x, cfg, window=window, mode="train",
                            segment_ids=segment_ids, backend=backend)
    return x, aux


def _sp_train_block(p: Params, x: torch.Tensor, window: int,
                    segment_ids: Optional[torch.Tensor], cfg: ModelConfig,
                    backend: str) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """:func:`_train_block` on the sequence-parallel layout: the chunk
    gathered at entry, the output's chunk kept (both collectives run
    again when remat recomputes the layer)."""
    x, aux = _train_block(p, gather_layout(x, SP_SPEC), window, segment_ids,
                          cfg, backend)
    return constrain(x, SP_SPEC), aux


def _vlm_train_group(p_self: Params, p_cross: Params, x: torch.Tensor,
                     vis: torch.Tensor, cfg: ModelConfig,
                     backend: str) -> torch.Tensor:
    """One vision group in train mode: k-1 self layers (window 0), then
    the gated cross layer over the projected vision states."""
    k, _ = _vlm_group(cfg)
    for j in range(k - 1):
        x, _, _ = block_apply(_layer(p_self, j), x, cfg, window=0,
                              mode="train", backend=backend)
    return cross_block_apply(p_cross, x, vis, cfg)


def forward_train(params: Params, tokens: torch.Tensor, cfg: ModelConfig, *,
                  extra: Optional[Dict[str, torch.Tensor]] = None,
                  segment_ids: Optional[torch.Tensor] = None,
                  backend: str = "xla"
                  ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """tokens: [B,S] int → (logits [B,S,V] float32, aux losses: the MoE
    layers' ``load_balance``, ``router_z`` and ``dropped_fraction`` summed
    over layers, empty for the other families). ``extra``: ``vision``
    (vlm) or ``frames`` (audio), as in :func:`prefill`; ``segment_ids``
    [B,S] keeps packed documents apart (dense, MoE and hybrid layers, as
    the reference)."""
    x = embed_tokens(params, tokens, cfg)
    aux = _aux_zero(cfg, x.device)
    if cfg.family == "vlm":
        vis = extra["vision"].to(x.dtype)
        vis = torch.matmul(vis, params["vision_proj"].to(x.dtype))
        _, G = _vlm_group(cfg)
        for g in range(G):
            x = _remat(cfg, _vlm_train_group, _layer(params["groups"]["self"], g),
                       _layer(params["groups"]["cross"], g), x, vis, cfg,
                       backend)
    elif cfg.family == "audio":
        enc = _audio_encode(params, extra["frames"], cfg, backend)
        S = x.shape[1]
        x = x + params["pos_embed"][:S].to(x.dtype)[None]
        x, _ = _audio_decoder(params["dec_blocks"], x, enc, cfg, mode="train")
    else:
        block = _train_block
        if cfg.sequence_parallel:
            block = _sp_train_block
            x = constrain(x, SP_SPEC)
        windows = layer_windows(cfg)
        for i in range(cfg.num_layers):
            x, a = _remat(cfg, block, _layer(params["blocks"], i), x,
                          int(windows[i]), segment_ids, cfg, backend)
            aux = _aux_add(aux, a)
        if cfg.sequence_parallel:
            x = gather_layout(x, SP_SPEC)
    return unembed(params, x, cfg), aux


# ---------------------------------------------------------------------------
# Loss


def lm_loss(params: Params, batch: Dict[str, torch.Tensor], cfg: ModelConfig,
            backend: str = "xla"
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Next-token cross-entropy of ``batch["targets"]`` (masked mean over
    ``loss_mask`` when given), plus every aux loss: (total, metrics with
    ``loss`` the cross-entropy alone). The reference's sum includes
    ``dropped_fraction``, which carries no gradient. Under a mesh the
    masked mean's numerator and denominator are each summed over the data
    axes (a mean of per-rank means would be another number)."""
    logits, aux = forward_train(params, batch["tokens"], cfg, extra=batch,
                                backend=backend,
                                segment_ids=batch.get("segment_ids"))
    logp = torch.log_softmax(logits, dim=-1)
    del logits        # the backward needs logp only: one [B, S, V] float32 less
    nll = -logp.gather(-1, batch["targets"][..., None].long())[..., 0]
    mask = batch.get("loss_mask")
    if mask is not None:
        loss = (data_sum(torch.sum(nll * mask))
                / torch.clamp(data_sum(torch.sum(mask)), min=1.0))
    else:
        loss = data_mean(torch.mean(nll))
    total = loss + sum(aux.values()) if aux else loss
    return total, {"loss": loss, **aux}


# ---------------------------------------------------------------------------
# Serving: prefill + decode


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               device: Any = None) -> Params:
    """Stacked per-layer cache of zeros on ``device`` (default CUDA): an
    empty cache to decode into, the int8 one with its bf16 scales. The
    vision model's self-attention cache is ``[G, k-1, ...]`` with the
    vision keys and values ``xk`` / ``xv`` ``[G, B, vision_tokens, K,
    hd]``; whisper's holds the encoder states ``enc`` ``[B, frames, d]``."""
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
        if cfg.family == "vlm":
            k, G = _vlm_group(cfg)
            lead: Tuple[int, ...] = (G, k - 1)
        else:
            lead = (L,)
        c["k"] = zeros(lead + (batch, max_len, K, hd), kv_dt)
        c["v"] = zeros(lead + (batch, max_len, K, hd), kv_dt)
        if int8:
            c["k_scale"] = zeros(lead + (batch, max_len, K), torch.bfloat16)
            c["v_scale"] = zeros(lead + (batch, max_len, K), torch.bfloat16)
        if cfg.family == "vlm":
            c["xk"] = zeros((G, batch, cfg.vision_tokens, K, hd), dt)
            c["xv"] = zeros((G, batch, cfg.vision_tokens, K, hd), dt)
        elif cfg.family == "audio":
            c["enc"] = zeros((batch, cfg.audio_frames, cfg.d_model), dt)
    if cfg.ssm is not None:
        d_in, H, P = ssm_mod.ssm_dims(cfg.d_model, cfg.ssm)
        N = cfg.ssm.state_dim
        W = cfg.ssm.conv_width
        c["h"] = zeros((L, batch, H, P, N), torch.float32)
        c["conv"] = zeros((L, batch, W - 1, d_in + 2 * N), dt)
    return c


def serve_slot(cfg: ModelConfig, batch: int, max_len: int,
               device: Any = None) -> Params:
    """The cache a served batch decodes in: :func:`init_cache`'s leaves
    for ``batch`` rows of ``max_len`` positions, made once per batch size
    and written by each prefill (``runtime.padding.write_kv_slot``), so a
    captured decode step replays on the same tensors batch after batch.
    Its K/V are in the compute dtype, as a prefill writes them (a served
    cache holds no int8 scales: the reference pads its prefill's)."""
    return init_cache(dataclasses.replace(cfg, kv_cache_dtype="compute"),
                      batch, max_len, device)


def _store(cache: Params, index: Tuple[int, ...], n: Tuple[int, ...],
           c: Params) -> None:
    """Write one layer's cache entries at ``index`` of the stacked leaves
    (each allocated ``n + shape`` at its first write)."""
    for k, t in c.items():
        if k not in cache:
            cache[k] = t.new_empty(n + tuple(t.shape))
        cache[k][index].copy_(t)


def prefill(params: Params, tokens: torch.Tensor, cfg: ModelConfig, *,  # repro: traced
            extra: Optional[Dict[str, torch.Tensor]] = None,
            backend: str = "xla",
            aux_out: Optional[Dict[str, torch.Tensor]] = None
            ) -> Tuple[torch.Tensor, Params]:
    """Process the prompt, return (last-position logits [B,V] float32,
    cache). ``extra``: ``vision`` [B, vision_tokens, d] (vlm) or
    ``frames`` [B, audio_frames, d] (audio). Each layer's cache is written
    into one stacked tensor per leaf. ``aux_out``, when given, receives
    the MoE layers' aux losses summed over layers (``_aux_add``; the
    reference's prefill drops them)."""
    x = embed_tokens(params, tokens, cfg)
    cache: Params = {}
    if cfg.family == "audio":
        enc = _audio_encode(params, extra["frames"], cfg, backend)
        S = x.shape[1]
        x = x + params["pos_embed"][:S].to(x.dtype)[None]
        x, cache = _audio_decoder(params["dec_blocks"], x, enc, cfg,
                                  mode="prefill")
        cache["enc"] = enc
    elif cfg.family == "vlm":
        vis = extra["vision"].to(x.dtype)
        vis = torch.matmul(vis, params["vision_proj"].to(x.dtype))
        x, cache = _vlm_prefill(params["groups"], x, vis, cfg, backend)
    else:
        windows = layer_windows(cfg)
        aux = _aux_zero(cfg, x.device)
        for i in range(cfg.num_layers):
            x, c, a = block_apply(_layer(params["blocks"], i), x, cfg,
                                  window=int(windows[i]), mode="prefill",
                                  backend=backend)
            _store(cache, (i,), (cfg.num_layers,), c)
            aux = _aux_add(aux, a)
        if aux_out is not None:
            aux_out.update(aux)
    logits = unembed(params, x[:, -1:], cfg)[:, 0]
    return logits, cache


def _vlm_prefill(groups: Params, x: torch.Tensor, vis: torch.Tensor,  # repro: traced
                 cfg: ModelConfig, backend: str) -> Tuple[torch.Tensor, Params]:
    """Each group: its k-1 self layers (window 0, on ``backend``), then the
    gated cross layer over the projected vision states, whose keys and
    values are cached as ``xk`` / ``xv``."""
    k, G = _vlm_group(cfg)
    cache: Params = {}
    for g in range(G):
        p_self = _layer(groups["self"], g)
        for j in range(k - 1):
            x, c, _ = block_apply(_layer(p_self, j), x, cfg, window=0,
                                  mode="prefill", backend=backend)
            _store(cache, (g, j), (G, k - 1), c)
        p_cross = _layer(groups["cross"], g)
        xa = p_cross["xattn"]
        _store(cache, (g,), (G,), {"xk": _proj(vis, xa["wk"], x.dtype),
                                   "xv": _proj(vis, xa["wv"], x.dtype)})
        x = cross_block_apply(p_cross, x, vis, cfg)
    return x, cache


def _audio_encode(params: Params, frames: torch.Tensor, cfg: ModelConfig,  # repro: traced
                  backend: str = "xla") -> torch.Tensor:
    """Whisper encoder over frame embeddings [B,F,d] (the conv front end
    is a stub, as in the reference: frames arrive embedded); non-causal
    self-attention on ``backend``."""
    h = frames.to(dtype_of(cfg.compute_dtype))
    for i in range(cfg.encoder_layers):
        h, _, _ = block_apply(_layer(params["enc_blocks"], i), h, cfg,
                              window=0, mode="encode", backend=backend)
    return apply_norm(params["enc_norm"], h, cfg.norm_type)


def _audio_decoder(dec_p: Params, x: torch.Tensor, enc: torch.Tensor,  # repro: traced
                   cfg: ModelConfig, mode: str, cache: Optional[Params] = None,
                   pos: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, Params]:
    """Whisper's decoder layers (the reference's ``_audio_decoder_scan``):
    causal self-attention (dense, as the reference's takes no backend),
    cross-attention to the encoder states, MLP. ``prefill`` returns the
    stacked K/V cache; ``decode`` writes into ``cache`` in place;
    ``train`` runs ``attention`` on its default backend (dense at
    whisper's lengths) and returns no cache."""
    L = cfg.num_layers
    out: Params = {} if cache is None else cache
    for i in range(L):
        p = _layer(dec_p, i)
        a_in = apply_norm(p["ln1"], x, cfg.norm_type)
        if mode == "decode":
            c = {"k": cache["k"][i], "v": cache["v"][i]}
            a, _ = decode_attention(p["attn"], c, a_in, pos, cfg.attn)
        elif mode == "prefill":
            a, c = prefill_attention(p["attn"], a_in, cfg.attn)
            _store(out, (i,), (L,), c)
        else:
            a = attention(p["attn"], a_in, cfg.attn, causal=True)
        x = x + a
        xa_in = apply_norm(p["lnx"], x, cfg.norm_type)
        x = x + cross_attention(p["xattn"], xa_in, enc, cfg.attn)
        m_in = apply_norm(p["ln2"], x, cfg.norm_type)
        x = x + mlp_apply(p["mlp"], m_in, cfg.mlp_activation)
    return x, out


def decode_step(params: Params, cache: Params, token: torch.Tensor,  # repro: traced
                pos: torch.Tensor, cfg: ModelConfig
                ) -> Tuple[torch.Tensor, Params]:
    """One decode step. token: [B,1] int; pos: [B] int. Returns (logits
    [B,V] float32, the cache, updated in place)."""
    x = embed_tokens(params, token, cfg)
    if cfg.family == "audio":
        pe = params["pos_embed"][pos.to(device=x.device, dtype=torch.long)]
        x = x + pe[:, None].to(x.dtype)
        x, _ = _audio_decoder(params["dec_blocks"], x, cache["enc"], cfg,
                              mode="decode", cache=cache, pos=pos)
        return unembed(params, x, cfg)[:, 0], cache
    if cfg.family == "vlm":
        x = _vlm_decode(params["groups"], x, cache, pos, cfg)
        return unembed(params, x, cfg)[:, 0], cache
    windows = layer_windows(cfg)
    for i in range(cfg.num_layers):
        c = _layer(cache, i)
        x, c_new, _ = block_apply(_layer(params["blocks"], i), x, cfg,
                                  window=int(windows[i]), mode="decode",
                                  cache=c, pos=pos)
        if cfg.ssm is not None:          # the SSM state comes back anew
            cache["h"][i].copy_(c_new["h"])
            cache["conv"][i].copy_(c_new["conv"])
    return unembed(params, x, cfg)[:, 0], cache


def _vlm_decode(groups: Params, x: torch.Tensor, cache: Params,  # repro: traced
                pos: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Each group: its self layers decode against their cache (K/V only,
    as the reference's), then the gated cross layer attends to the cached
    vision keys and values (dense, no mask)."""
    k, G = _vlm_group(cfg)
    for g in range(G):
        p_self = _layer(groups["self"], g)
        for j in range(k - 1):
            c = {"k": cache["k"][g, j], "v": cache["v"][g, j]}
            x, _, _ = block_apply(_layer(p_self, j), x, cfg, window=0,
                                  mode="decode", cache=c, pos=pos)
        p = _layer(groups["cross"], g)
        xk, xv = cache["xk"][g], cache["xv"][g]
        a_in = apply_norm(p["ln1"], x, cfg.norm_type)
        q = _proj(a_in, p["xattn"]["wq"], x.dtype)
        bias = torch.zeros((x.shape[0], 1, xk.shape[1]), dtype=torch.float32,
                           device=x.device)
        o = _out_proj(p["xattn"], gqa_attend(q, xk, xv, bias, cfg.attn), x.dtype)
        x = x + _gate(p["gate_attn"], x.dtype) * o
        m_in = apply_norm(p["ln2"], x, cfg.norm_type)
        x = x + _gate(p["gate_mlp"], x.dtype) * mlp_apply(p["mlp"], m_in,
                                                          cfg.mlp_activation)
    return x

