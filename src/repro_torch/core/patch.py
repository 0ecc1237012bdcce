"""Flexible (de-)tokenization: patchify / unpatchify for images and videos,
plus the flexible patch embed / de-embed built on ``core.resize``.

Latents are laid out ``[B, F, H, W, C]`` (F=1 for images), as in the JAX
package. A patch size is ``(p_f, p_h, p_w)``; tokenization at patch size p
gives ``N = (F/p_f)·(H/p_h)·(W/p_w)`` tokens.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from repro_torch.core import resize

Patch = Tuple[int, int, int]


def num_tokens(latent_shape: Tuple[int, int, int, int], p: Patch) -> int:
    F, H, W, _ = latent_shape
    assert F % p[0] == 0 and H % p[1] == 0 and W % p[2] == 0, (latent_shape, p)
    return (F // p[0]) * (H // p[1]) * (W // p[2])


def patchify(x: torch.Tensor, p: Patch) -> torch.Tensor:
    """[B,F,H,W,C] → [B,N,prod(p),C]"""
    B, F, H, W, C = x.shape
    pf, ph, pw = p
    x = x.reshape(B, F // pf, pf, H // ph, ph, W // pw, pw, C)
    x = x.permute(0, 1, 3, 5, 2, 4, 6, 7)
    return x.reshape(B, (F // pf) * (H // ph) * (W // pw), pf * ph * pw, C)


def unpatchify(tok: torch.Tensor, latent_shape: Tuple[int, int, int, int],
               p: Patch) -> torch.Tensor:
    """[B,N,prod(p),C] → [B,F,H,W,C]"""
    F, H, W, _ = latent_shape
    pf, ph, pw = p
    B, N, PP, C = tok.shape
    x = tok.reshape(B, F // pf, H // ph, W // pw, pf, ph, pw, C)
    x = x.permute(0, 1, 4, 2, 5, 3, 6, 7)
    return x.reshape(B, F, H, W, C)


def patch_centers(latent_shape: Tuple[int, int, int, int], p: Patch
                  ) -> np.ndarray:
    """Centers of every patch in the original latent frame → [N, 3] float
    (all patch sizes share one coordinate system, paper App. C.2)."""
    F, H, W, _ = latent_shape
    pf, ph, pw = p
    f = (np.arange(F // pf) + 0.5) * pf
    h = (np.arange(H // ph) + 0.5) * ph
    w = (np.arange(W // pw) + 0.5) * pw
    grid = np.stack(np.meshgrid(f, h, w, indexing="ij"), axis=-1)
    return grid.reshape(-1, 3)


def sincos_pos_embed(d: int, coords: np.ndarray) -> np.ndarray:
    """Fixed sin-cos embedding at fractional coords [N,3] → [N, d] float32.

    Each axis is ordered [sin, cos] (the timestep embedding is [cos, sin]);
    d is split across the 3 axes, f taking the remainder."""
    n_axes = coords.shape[1]
    d_axis = d // n_axes
    outs = []
    for ax in range(n_axes):
        dd = d - d_axis * (n_axes - 1) if ax == 0 else d_axis
        half = dd // 2
        freqs = 1.0 / (10_000.0 ** (np.arange(half) / max(1, half)))
        args = coords[:, ax:ax + 1] * freqs[None]
        emb = np.concatenate([np.sin(args), np.cos(args)], axis=1)
        if emb.shape[1] < dd:
            emb = np.pad(emb, ((0, 0), (0, dd - emb.shape[1])))
        outs.append(emb)
    return np.concatenate(outs, axis=1).astype(np.float32)


def embed_tokens_flex(w_flex: torch.Tensor, b: torch.Tensor, x: torch.Tensor,
                      p: Patch, p_prime: Patch) -> torch.Tensor:
    """Tokenize latent x [B,F,H,W,C] at patch size p with flexible weights
    w_flex [prod(p'), C, d] and bias b [d] → tokens [B,N,d]."""
    W = resize.project_embed(w_flex, p, p_prime)       # [prod(p), C, d]
    patches = patchify(x, p)                           # [B,N,prod(p),C]
    tok = torch.einsum("bnpc,pcd->bnd", patches.float(),
                       W.to(x.dtype).float()).to(x.dtype)
    return tok + b.to(x.dtype)


def deembed_tokens_flex(w_flex: torch.Tensor, b_flex: torch.Tensor,
                        tok: torch.Tensor,
                        latent_shape: Tuple[int, int, int, int], p: Patch,
                        p_prime: Patch, c_out: int) -> torch.Tensor:
    """De-tokenize [B,N,d] → latent [B,F,H,W,c_out] at patch size p.
    w_flex: [d, c_out, prod(p')]; b_flex: [c_out, prod(p')]."""
    W = resize.project_deembed(w_flex, p, p_prime)     # [d, c_out, prod(p)]
    Bb = resize.project_deembed_bias(b_flex, p, p_prime)
    patches = torch.einsum("bnd,dcq->bnqc", tok.float(), W.to(tok.dtype).float())
    patches = (patches + Bb.T.float()[None, None]).to(tok.dtype)
    return unpatchify(patches, latent_shape, p)
