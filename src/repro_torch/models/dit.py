"""Diffusion Transformer (DiT) with FlexiDiT patch-size modes — the port of
``repro.models.dit``.

Class conditioning (adaLN-Zero, DiT-XL/2 style) and text conditioning
(cross-attention) over image or video latents. A *mode* indexes
``patch_sizes(cfg) = [p_powerful, *flex sizes]``; mode 0 is the pre-trained
patch size. Parameters are the reference's tree: nested dicts of tensors,
per-layer leaves stacked ``[L, ...]``, matrices ``[in, out]``.

Self-attention goes through ``kernels.attention.ops.flash_attention`` when
the backend resolves to ``"pallas"`` (the Hopper kernel on CUDA tensors),
through ``models.attention.blocked_gqa_attend`` on ``"xla-blocked"``, else
through the dense path below. Linear layers round once: float32 results
(``models.common.matmul_f32``), cast to the activations' dtype.
Sequence-parallel execution (``parallel=``, a
``distributed.engine.SeqParallel``): every rank keeps its own token shard
through the blocks, self-attention runs Ulysses or the ring over the
mesh's sequence axis, and the tokens are gathered before the de-embedding.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import AttnConfig, ModelConfig
from repro_torch.core import patch as patch_mod
from repro_torch.kernels.attention import mask as mask_mod
from repro_torch.kernels.attention import ops as attn_ops
from repro_torch.models import attention as attn_mod
from repro_torch.models.common import (ParamSpec, dtype_of, init_tree,
                                       layer_norm, matmul_f32, stack_schema,
                                       timestep_embedding, tree_map)
from repro_torch.runtime import graphs

Params = Dict[str, Any]
Patch = Tuple[int, int, int]

T_EMB_DIM = 256


@dataclasses.dataclass
class BlockCache:
    """Cross-step activation cache handed to :func:`dit_forward`: ``delta``
    is the deep-block residual recorded at the last refresh ([B, N, d]),
    ``refresh`` a bool (or 0-d bool tensor), and ``split`` the number of
    shallow blocks that always recompute. The deep blocks [split, L) run
    only on refresh steps; skip steps replay ``delta``."""
    delta: torch.Tensor
    refresh: Any
    split: int


def patch_sizes(cfg: ModelConfig) -> Tuple[Patch, ...]:
    return (cfg.dit.patch_size,) + tuple(cfg.dit.flex_patch_sizes)


def tokens_for_mode(cfg: ModelConfig, mode: int) -> int:
    return patch_mod.num_tokens(cfg.dit.latent_shape, patch_sizes(cfg)[mode])


def c_out_dim(cfg: ModelConfig) -> int:
    c_in = cfg.dit.latent_shape[-1]
    return 2 * c_in if cfg.dit.learn_sigma else c_in


# ---------------------------------------------------------------------------
# Schema


def _lora_pair(d_in: int, d_out: int, n_new: int, r: int) -> Params:
    return {"a": ParamSpec((n_new, d_in, r), (None, "embed", None), scale=0.02),
            "b": ParamSpec((n_new, r, d_out), (None, None, "embed"), init="zeros")}


def dit_block_schema(cfg: ModelConfig) -> Params:
    d = cfg.d_model
    dc = cfg.dit.text_dim or d
    n_new = len(cfg.dit.flex_patch_sizes)
    r = cfg.dit.lora_rank
    s: Params = {
        "ada": {"w": ParamSpec((d, 6 * d), ("embed", "mlp"), init="zeros"),
                "b": ParamSpec((6 * d,), ("mlp",), init="zeros")},
        "attn": {"wq": ParamSpec((d, d), ("embed", "heads")),
                 "wk": ParamSpec((d, d), ("embed", "heads")),
                 "wv": ParamSpec((d, d), ("embed", "heads")),
                 "wo": ParamSpec((d, d), ("heads", "embed"))},
        "mlp": {"w_in": ParamSpec((d, cfg.d_ff), ("embed", "mlp")),
                "b_in": ParamSpec((cfg.d_ff,), ("mlp",), init="zeros"),
                "w_out": ParamSpec((cfg.d_ff, d), ("mlp", "embed")),
                "b_out": ParamSpec((d,), ("embed",), init="zeros")},
    }
    if cfg.dit.conditioning == "text":
        s["xattn"] = {"wq": ParamSpec((d, d), ("embed", "heads")),
                      "wk": ParamSpec((dc, d), ("embed", "heads")),
                      "wv": ParamSpec((dc, d), ("embed", "heads")),
                      "wo": ParamSpec((d, d), ("heads", "embed"), init="zeros")}
    if r > 0 and n_new > 0:
        s["lora"] = {
            "attn": {k: _lora_pair(d, d, n_new, r) for k in ("wq", "wk", "wv", "wo")},
            "mlp": {"w_in": _lora_pair(d, cfg.d_ff, n_new, r),
                    "w_out": _lora_pair(cfg.d_ff, d, n_new, r)},
        }
    return s


def dit_schema(cfg: ModelConfig) -> Params:
    d = cfg.d_model
    dit = cfg.dit
    pp = dit.underlying_patch_size
    c_in = dit.latent_shape[-1]
    n_modes = 1 + len(dit.flex_patch_sizes)
    npp = math.prod(pp)
    s: Params = {
        "embed": {"w_flex": ParamSpec((npp, c_in, d), (None, None, "embed")),
                  "b": ParamSpec((d,), ("embed",), init="zeros")},
        "deembed": {"w_flex": ParamSpec((d, c_out_dim(cfg), npp),
                                        ("embed", None, None), init="zeros"),
                    "b_flex": ParamSpec((c_out_dim(cfg), npp),
                                        (None, None), init="zeros")},
        "t_embed": {"w1": ParamSpec((T_EMB_DIM, d), (None, "embed")),
                    "b1": ParamSpec((d,), ("embed",), init="zeros"),
                    "w2": ParamSpec((d, d), ("embed", "mlp")),
                    "b2": ParamSpec((d,), ("embed",), init="zeros")},
        "final": {"ada": {"w": ParamSpec((d, 2 * d), ("embed", "mlp"), init="zeros"),
                          "b": ParamSpec((2 * d,), ("mlp",), init="zeros")}},
        "blocks": stack_schema(dit_block_schema(cfg), cfg.num_layers),
    }
    if n_modes > 1:
        s["ps_embed"] = ParamSpec((n_modes - 1, d), (None, "embed"), init="zeros")
        s["ps_ln"] = {"scale": ParamSpec((n_modes - 1, d), (None, "embed"), init="zeros"),
                      "bias": ParamSpec((n_modes - 1, d), (None, "embed"), init="zeros")}
    if dit.lora_rank > 0 and n_modes > 1:
        # LoRA recipe (§3.2): brand-new (de-)embedding layers per new patch size
        s["embed_new"] = {}
        s["deembed_new"] = {}
        for m, p in enumerate(dit.flex_patch_sizes, start=1):
            npix = math.prod(p)
            s["embed_new"][f"m{m}"] = {
                "w": ParamSpec((npix, c_in, d), (None, None, "embed")),
                "b": ParamSpec((d,), ("embed",), init="zeros")}
            s["deembed_new"][f"m{m}"] = {
                "w": ParamSpec((d, c_out_dim(cfg), npix), ("embed", None, None),
                               init="zeros"),
                "b": ParamSpec((c_out_dim(cfg), npix), (None, None), init="zeros")}
    if dit.conditioning == "class":
        s["class_embed"] = ParamSpec((dit.num_classes + 1, d), (None, "embed"),
                                     init="embed")
    elif dit.conditioning == "text":
        dc = dit.text_dim or d
        s["text_proj"] = ParamSpec((dc, dc), (None, "embed"))
    return s


def init_dit(cfg: ModelConfig, generator: torch.Generator) -> Params:
    """Random parameters on ``generator.device`` in ``cfg.param_dtype``."""
    return init_tree(dit_schema(cfg), generator, dtype_of(cfg.param_dtype))


# ---------------------------------------------------------------------------
# Forward


def _linear(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor] = None,
            lora: Optional[Params] = None, mode: int = 0,
            lora_scale: float = 2.0) -> torch.Tensor:
    """x @ w (+ LoRA at mode > 0) (+ b) with float32 results and sums,
    rounded once to x.dtype, as the reference (``preferred_element_type``
    float32). The LoRA's inner product ``x @ a`` stays in x.dtype, as
    there."""
    if lora is None or mode == 0:
        return matmul_f32(x, w, b).to(x.dtype)
    y = matmul_f32(x, w)
    a = lora["a"][mode - 1].to(x.dtype)
    bb = lora["b"][mode - 1].to(x.dtype)
    r = a.shape[-1]
    y = y + matmul_f32(torch.matmul(x, a), bb) * (lora_scale / r)
    if b is not None:
        y = y + b.float()
    return y.to(x.dtype)


def _modulate(x: torch.Tensor, shift: torch.Tensor, scale: torch.Tensor
              ) -> torch.Tensor:
    return x * (1.0 + scale[:, None]) + shift[:, None]


def _dense_attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  bias: Optional[torch.Tensor], out_dtype: torch.dtype
                  ) -> torch.Tensor:
    """Dense softmax attention, scores and sums in float32."""
    hd = q.shape[-1]
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) / math.sqrt(hd)
    if bias is not None:
        scores = scores + bias
    probs = torch.softmax(scores, dim=-1)
    o = torch.einsum("bhqk,bkhd->bqhd", probs.to(v.dtype).float(), v.float())
    return o.to(out_dtype)


def _mha(p: Params, x: torch.Tensor, num_heads: int, *,
         lora: Optional[Params] = None, mode: int = 0,
         segment_ids: Optional[torch.Tensor] = None,
         parallel: Optional[Any] = None,
         attn_backend: str = "auto",
         block_map: Optional[torch.Tensor] = None) -> torch.Tensor:
    B, N, d = x.shape
    hd = d // num_heads
    la = lora or {}
    q = _linear(x, p["wq"], lora=la.get("wq"), mode=mode).reshape(B, N, num_heads, hd)
    k = _linear(x, p["wk"], lora=la.get("wk"), mode=mode).reshape(B, N, num_heads, hd)
    v = _linear(x, p["wv"], lora=la.get("wv"), mode=mode).reshape(B, N, num_heads, hd)
    if parallel is not None and parallel.sp > 1:
        # x is this rank's token shard: Ulysses all-to-all or the ring over
        # the mesh's sequence axis (padding tokens carry segment id -1)
        o = parallel.attend(q, k, v, segment_ids=segment_ids)
        return _linear(o.reshape(B, N, d), p["wo"], lora=la.get("wo"),
                       mode=mode)
    resolved = attn_mod.resolve_backend(attn_backend, n_tokens=N,
                                        segmented=segment_ids is not None)
    if resolved == "pallas":
        # the segment-aware flash kernel (Hopper kernel on CUDA tensors)
        o = attn_ops.flash_attention(q, k, v, causal=False,
                                     segment_ids=segment_ids,
                                     block_map=block_map)
    elif resolved == "xla-blocked":
        # long (possibly packed) sequences: query blocks with an arithmetic
        # mask; segment ids thread through, so no [B,H,N,N] score tensor
        acfg = AttnConfig(num_heads=num_heads, num_kv_heads=num_heads,
                          head_dim=hd, use_rope=False)
        # positions None: every token is real, at 0..N-1
        o = attn_mod.blocked_gqa_attend(q, k, v, positions=None, causal=False,
                                        window=0, cfg=acfg,
                                        segment_ids=segment_ids)
    else:
        bias = None
        if segment_ids is not None:
            allowed = mask_mod.segment_allowed(segment_ids, segment_ids)
            bias = torch.where(allowed, 0.0, -1e30)[:, None]
        o = _dense_attend(q, k, v, bias, x.dtype)
    return _linear(o.reshape(B, N, d), p["wo"], lora=la.get("wo"), mode=mode)


def _cross_mha(p: Params, x: torch.Tensor, kv: torch.Tensor, num_heads: int,
               kv_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    B, N, d = x.shape
    hd = d // num_heads
    q = _linear(x, p["wq"]).reshape(B, N, num_heads, hd)
    k = _linear(kv, p["wk"]).reshape(B, kv.shape[1], num_heads, hd)
    v = _linear(kv, p["wv"]).reshape(B, kv.shape[1], num_heads, hd)
    bias = None
    if kv_mask is not None:
        bias = torch.where(kv_mask[:, None, None].bool(), 0.0, -1e30)
    o = _dense_attend(q, k, v, bias, x.dtype)
    return _linear(o.reshape(B, N, d), p["wo"])


def _ln(x: torch.Tensor) -> torch.Tensor:
    """LayerNorm without learned affine (DiT blocks use adaLN modulation)."""
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = (xf - mu).square().mean(dim=-1, keepdim=True)
    return ((xf - mu) * torch.rsqrt(var + 1e-6)).to(x.dtype)


def _silu_f32(c: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return F.silu(c.float()).to(dtype)


def dit_block_apply(p: Params, x: torch.Tensor, c: torch.Tensor,
                    cfg: ModelConfig, *, mode: int = 0,
                    text: Optional[torch.Tensor] = None,
                    text_mask: Optional[torch.Tensor] = None,
                    segment_ids: Optional[torch.Tensor] = None,
                    parallel: Optional[Any] = None,
                    attn_backend: str = "auto") -> torch.Tensor:
    H = cfg.attn.num_heads
    ada = _linear(_silu_f32(c, x.dtype), p["ada"]["w"], p["ada"]["b"])
    sh1, sc1, g1, sh2, sc2, g2 = torch.chunk(ada, 6, dim=-1)
    lora = p.get("lora", {})
    h = _modulate(_ln(x), sh1, sc1)
    x = x + g1[:, None] * _mha(p["attn"], h, H, lora=lora.get("attn"),
                               mode=mode, segment_ids=segment_ids,
                               parallel=parallel, attn_backend=attn_backend)
    if "xattn" in p and text is not None:
        x = x + _cross_mha(p["xattn"], _ln(x), text, H, kv_mask=text_mask)
    h2 = _modulate(_ln(x), sh2, sc2)
    mlp_lora = lora.get("mlp", {})
    h2 = _linear(h2, p["mlp"]["w_in"], p["mlp"]["b_in"],
                 lora=mlp_lora.get("w_in"), mode=mode)
    h2 = F.gelu(h2.float(), approximate="tanh").to(x.dtype)
    h2 = _linear(h2, p["mlp"]["w_out"], p["mlp"]["b_out"],
                 lora=mlp_lora.get("w_out"), mode=mode)
    return x + g2[:, None] * h2


@functools.lru_cache(maxsize=64)
def _pos_embed(latent_shape: Tuple[int, int, int, int], p: Patch, d: int,
               dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    coords = patch_mod.patch_centers(latent_shape, p)
    emb = torch.from_numpy(patch_mod.sincos_pos_embed(d, coords))
    # a normal tensor even when first built under inference mode (a
    # sampler's): a later training step must be able to use it
    with torch.inference_mode(False):
        return emb.to(device=device, dtype=dtype)


def condition_vector(params: Params, t: torch.Tensor, cond: Any,
                     cfg: ModelConfig, dtype: torch.dtype) -> torch.Tensor:
    """c = t_emb (+ class emb). t: [B] float; cond: labels [B] or None."""
    te = timestep_embedding(t, T_EMB_DIM).to(dtype)
    te = _linear(te, params["t_embed"]["w1"], params["t_embed"]["b1"])
    te = _silu_f32(te, dtype)
    te = _linear(te, params["t_embed"]["w2"], params["t_embed"]["b2"])
    if cfg.dit.conditioning == "class" and cond is not None:
        te = te + params["class_embed"][cond.long()].to(dtype)
    return te


def embed_mode_tokens(params: Params, x_t: torch.Tensor, cfg: ModelConfig,
                      mode: int,
                      latent_shape: Optional[Tuple[int, int, int, int]] = None
                      ) -> torch.Tensor:
    """Tokenize [B,F,H,W,C] latents at ``mode``'s patch size: patch
    embedding + positional embedding + per-mode embedding and LN."""
    dit = cfg.dit
    ls = latent_shape or dit.latent_shape
    p = patch_sizes(cfg)[mode]
    dtype = dtype_of(cfg.compute_dtype)
    x_t = x_t.to(dtype)
    if mode > 0 and "embed_new" in params:
        pn = params["embed_new"][f"m{mode}"]
        patches = patch_mod.patchify(x_t, p)
        tok = torch.einsum("bnqc,qcd->bnd", patches.float(),
                           pn["w"].to(dtype).float()).to(dtype)
        tok = tok + pn["b"].to(dtype)
    else:
        tok = patch_mod.embed_tokens_flex(params["embed"]["w_flex"],
                                          params["embed"]["b"], x_t, p,
                                          dit.underlying_patch_size)
    pos = _pos_embed(ls, p, cfg.d_model, dtype, tok.device)
    graphs.hold(pos)
    tok = tok + pos[None]
    if mode > 0:
        tok = tok + params["ps_embed"][mode - 1].to(dtype)[None, None]
        tok = layer_norm(tok, 1.0 + params["ps_ln"]["scale"][mode - 1],
                         params["ps_ln"]["bias"][mode - 1])
    return tok


def deembed_mode_tokens(params: Params, tok: torch.Tensor, cfg: ModelConfig,
                        mode: int,
                        latent_shape: Optional[Tuple[int, int, int, int]] = None
                        ) -> torch.Tensor:
    """Project [B, N_mode, d] tokens back to [B,F,H,W,c_out] latents (the
    inverse of :func:`embed_mode_tokens`, without the final adaLN)."""
    dit = cfg.dit
    ls = latent_shape or dit.latent_shape
    p = patch_sizes(cfg)[mode]
    dtype = tok.dtype
    if mode > 0 and "deembed_new" in params:
        pn = params["deembed_new"][f"m{mode}"]
        patches = torch.einsum("bnd,dcq->bnqc", tok.float(),
                               pn["w"].to(dtype).float())
        patches = (patches + pn["b"].T.float()[None, None]).to(dtype)
        return patch_mod.unpatchify(patches, ls, p)
    return patch_mod.deembed_tokens_flex(params["deembed"]["w_flex"],
                                         params["deembed"]["b_flex"], tok,
                                         ls, p, dit.underlying_patch_size,
                                         c_out_dim(cfg))


def _layer(blocks: Params, i: int) -> Params:
    return tree_map(lambda a: a[i], blocks)


def split_blocks(blocks: Params, split: int) -> Tuple[Params, Params]:
    """Slice a stacked block tree into (shallow [0, split), deep
    [split, L)) for the cached forward path (views, no copies)."""
    return (tree_map(lambda a: a[:split], blocks),
            tree_map(lambda a: a[split:], blocks))


def dit_forward(params: Params, x_t: torch.Tensor, t: torch.Tensor, cond: Any,  # repro: traced
                cfg: ModelConfig, *, mode: int = 0,
                text_mask: Optional[torch.Tensor] = None,
                latent_shape: Optional[Tuple[int, int, int, int]] = None,
                parallel: Optional[Any] = None,
                block_cache: Optional[BlockCache] = None,
                attn_backend: str = "auto") -> Any:
    """Denoiser NFE.  x_t: [B,F,H,W,C]; t: [B]; cond: labels [B] (class) or
    text embeddings [B,T,dc] (text). Returns [B,F,H,W,c_out].

    With ``block_cache`` the return value is ``(out, new_delta)``: on a
    refresh step the deep blocks run (the output IS their result) and
    the fresh residual ``h_deep - h_shallow`` is returned; on a skip step
    only the shallow blocks run and the cached delta is replayed.

    With ``parallel`` (sp > 1) every rank embeds all tokens, pads them to a
    multiple of sp (segment id -1), keeps its own shard through the blocks
    and gathers the shards before the de-embedding; the token count, and
    so the sharding, changes at phase boundaries and is re-padded per
    call."""
    dit = cfg.dit
    ls = latent_shape or dit.latent_shape
    dtype = dtype_of(cfg.compute_dtype)
    tok = embed_mode_tokens(params, x_t, cfg, mode, ls)

    n_real = tok.shape[1]
    seg_ids = None
    sharded = parallel is not None and parallel.sp > 1
    if sharded:
        if block_cache is not None:
            raise ValueError("the activation cache does not compose with "
                             "sequence-parallel execution yet (ROADMAP)")
        tok, seg_ids = parallel.pad_and_shard(tok)

    text = None
    if dit.conditioning == "text":
        text = _linear(cond.to(dtype), params["text_proj"])
        c = condition_vector(params, t, None, cfg, dtype)
    else:
        c = condition_vector(params, t, cond, cfg, dtype)

    def run(h: torch.Tensor, lo: int, hi: int) -> torch.Tensor:
        for i in range(lo, hi):
            h = dit_block_apply(_layer(params["blocks"], i), h, c, cfg,
                                mode=mode, text=text, text_mask=text_mask,
                                segment_ids=seg_ids, parallel=parallel,
                                attn_backend=attn_backend)
        return h

    L = cfg.num_layers
    new_delta = None
    if block_cache is None:
        tok = run(tok, 0, L)
    else:
        tok = run(tok, 0, block_cache.split)
        if bool(block_cache.refresh):
            h_deep = run(tok, block_cache.split, L)
            tok, new_delta = h_deep, h_deep - tok
        else:
            tok, new_delta = tok + block_cache.delta, block_cache.delta
    if sharded:
        tok = parallel.unshard(tok, n_real)

    ada = _linear(_silu_f32(c, dtype), params["final"]["ada"]["w"],
                  params["final"]["ada"]["b"])
    sh, sc = torch.chunk(ada, 2, dim=-1)
    tok = _modulate(_ln(tok), sh, sc)
    out = deembed_mode_tokens(params, tok, cfg, mode, ls)
    return out if block_cache is None else (out, new_delta)


def eps_prediction(out: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """The ε-prediction (first c_in channels when learning Σ)."""
    c_in = cfg.dit.latent_shape[-1]
    return out[..., :c_in] if cfg.dit.learn_sigma else out
