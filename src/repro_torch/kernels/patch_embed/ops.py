"""Flexible tokenize / de-tokenize through the patch embed kernels.

Drop-in versions of ``repro_torch.core.patch.embed_tokens_flex`` /
``deembed_tokens_flex``, with the contract of the JAX package's
``repro.kernels.patch_embed.ops``: the PI-resize projection is folded into
the weight before the kernel runs, so the kernel is patch-size-agnostic.

On a CUDA tensor each launches its Hopper kernel (``patch_embed.py``) and
counts the launch in ``.launches`` and under the variant the inputs select
in ``.launches_by_variant``; on a CPU tensor it runs the plain version
(``ref.py``) and counts nothing. Any other device raises, and so does a
CUDA launch that autograd would record through (the kernels have no
backward).
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.core import patch as patch_mod
from repro_torch.core import resize
from repro_torch.kernels import refuse_autograd
from repro_torch.kernels.patch_embed.patch_embed import (DEEMBED_VARIANTS,
                                                         EMBED_VARIANTS,
                                                         deembed_variant_of,
                                                         embed_variant_of,
                                                         patch_deembed_cuda,
                                                         patch_embed_cuda)
from repro_torch.kernels.patch_embed.ref import (patch_deembed_ref,
                                                 patch_embed_ref)

Patch = Tuple[int, int, int]


def _device_kind(t: torch.Tensor, name: str) -> str:
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name} runs on cuda or cpu tensors, got {t.device}")
    return t.device.type


def embed_tokens_flex(w_flex: torch.Tensor, b: torch.Tensor, x: torch.Tensor,
                      p: Patch, p_prime: Patch) -> torch.Tensor:
    """Tokenize latent x [B,F,H,W,C] at patch size p with flexible weights
    w_flex [prod(p'), C, d] and bias b [d] → tokens [B,N,d]."""
    W = resize.project_embed(w_flex, p, p_prime)            # [pp, c, d]
    K = W.shape[0] * W.shape[1]
    d = W.shape[2]
    patches = patch_mod.patchify(x, p)                      # [B,N,pp,c]
    B, N = patches.shape[:2]
    args = (patches.reshape(B * N, K), W.reshape(K, d).to(x.dtype),
            b.to(x.dtype))
    if _device_kind(x, "embed_tokens_flex") == "cpu":
        return patch_embed_ref(*args).reshape(B, N, d)
    refuse_autograd("embed_tokens_flex", *args)
    args = tuple(t.contiguous() for t in args)
    tok = patch_embed_cuda(*args)
    embed_tokens_flex.launches += 1
    embed_tokens_flex.launches_by_variant[embed_variant_of(*args)] += 1
    return tok.reshape(B, N, d)


def deembed_tokens_flex(w_flex: torch.Tensor, b_flex: torch.Tensor,
                        tok: torch.Tensor,
                        latent_shape: Tuple[int, int, int, int], p: Patch,
                        p_prime: Patch, c_out: int) -> torch.Tensor:
    """De-tokenize [B,N,d] → latent [B,F,H,W,c_out] at patch size p.
    w_flex: [d, c_out, prod(p')]; b_flex: [c_out, prod(p')]."""
    W = resize.project_deembed(w_flex, p, p_prime)          # [d, c, pp]
    Bb = resize.project_deembed_bias(b_flex, p, p_prime)    # [c, pp]
    d = W.shape[0]
    K = W.shape[1] * W.shape[2]
    B, N = tok.shape[:2]
    args = (tok.reshape(B * N, d), W.reshape(d, K).to(tok.dtype),
            Bb.reshape(K).to(tok.dtype))
    if _device_kind(tok, "deembed_tokens_flex") == "cpu":
        out = patch_deembed_ref(*args)
    else:
        refuse_autograd("deembed_tokens_flex", *args)
        args = tuple(t.contiguous() for t in args)
        out = patch_deembed_cuda(*args)
        deembed_tokens_flex.launches += 1
        deembed_tokens_flex.launches_by_variant[deembed_variant_of(*args[:2])] += 1
    # kernel output layout is [.., c*pp]; unpatchify expects [.., pp, c]
    pp = W.shape[2]
    patches = out.reshape(B, N, c_out, pp).transpose(2, 3)
    return patch_mod.unpatchify(patches, latent_shape, p)


def reset_launches() -> None:
    """Set every launch count of the two wrappers to 0."""
    embed_tokens_flex.launches = 0
    deembed_tokens_flex.launches = 0
    embed_tokens_flex.launches_by_variant = dict.fromkeys(EMBED_VARIANTS, 0)
    deembed_tokens_flex.launches_by_variant = dict.fromkeys(DEEMBED_VARIANTS, 0)


reset_launches()
