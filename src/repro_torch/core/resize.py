"""PI-resize (pseudo-inverse linear interpolation) weight projections —
FlexiDiT §3.1, with the conventions of ``repro.core.resize``:

* ``b_up(a, p')``: the upsampling matrix ``B ∈ R^{Πp'ᵢ × Πaᵢ}`` taking a
  flattened patch at resolution ``a`` to resolution ``p'`` (p' ≥ a).
* ``q_embed(a) = pinv(B)`` instantiates the embedding ``W(a) = Q·w_flex``;
  ``q_deembed(a) = pinv(B)ᵀ`` instantiates the de-embedding.

``b_up`` is built directly in numpy: per axis, half-pixel linear
interpolation (source coordinate ``(o + 0.5)·a/p' − 0.5`` clamped to
``[0, a − 1]``), combined over the (f, h, w) axes by a Kronecker product.
For upsampling (p' ≥ a) this is the matrix the reference gets from
``jax.image.resize(..., method="linear")``.
"""
from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch

from repro_torch.runtime import graphs


def _interp_1d(a: int, p: int) -> np.ndarray:
    """[p, a] half-pixel linear interpolation from a samples to p."""
    m = np.zeros((p, a), np.float64)
    for o in range(p):
        src = min(max((o + 0.5) * a / p - 0.5, 0.0), a - 1.0)
        i0 = int(np.floor(src))
        i1 = min(i0 + 1, a - 1)
        w1 = src - i0
        m[o, i0] += 1.0 - w1
        m[o, i1] += w1
    return m


@functools.lru_cache(maxsize=64)
def b_up(a: Tuple[int, ...], p_prime: Tuple[int, ...]) -> np.ndarray:
    """(Tri)linear upsampling matrix B: R^{prod(a)} → R^{prod(p')} ([out, in])."""
    a = tuple(int(x) for x in a)
    p_prime = tuple(int(x) for x in p_prime)
    assert len(a) == len(p_prime)
    assert all(q >= b for q, b in zip(p_prime, a)), (a, p_prime)
    mat = np.ones((1, 1), np.float64)
    for ai, pi in zip(a, p_prime):
        mat = np.kron(mat, _interp_1d(ai, pi))
    return mat


@functools.lru_cache(maxsize=64)
def q_embed(a: Tuple[int, ...], p_prime: Tuple[int, ...]) -> np.ndarray:
    """Q_embed(a) = pinv(B_up(a→p')) ∈ R^{prod(a) × prod(p')}"""
    return np.linalg.pinv(b_up(a, p_prime))


@functools.lru_cache(maxsize=64)
def q_deembed(a: Tuple[int, ...], p_prime: Tuple[int, ...]) -> np.ndarray:
    """Q_de(a) = pinv(B_upᵀ) = Q_embed(a)ᵀ ∈ R^{prod(p') × prod(a)}"""
    return q_embed(a, p_prime).T


def _const(mat: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(mat, dtype=like.dtype, device=like.device)


@functools.lru_cache(maxsize=256)
def _projection(kind: str, a: Tuple[int, ...], p_prime: Tuple[int, ...],
                dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """Q_embed / Q_deembed as a ``dtype`` tensor on ``device``, copied
    there once: the forward's projections read it without a host copy
    (a captured runner may hold no host copy)."""
    mat = q_embed(a, p_prime) if kind == "embed" else q_deembed(a, p_prime)
    # a normal tensor even when first built under inference mode (a
    # sampler's): a later training step must be able to use it
    with torch.inference_mode(False):
        return torch.as_tensor(mat, dtype=dtype, device=device)


def _q(kind: str, a, p_prime, like: torch.Tensor) -> torch.Tensor:
    q = _projection(kind, tuple(int(x) for x in a),
                    tuple(int(x) for x in p_prime), like.dtype, like.device)
    graphs.hold(q)
    return q


# Embedding weights are stored as w_flex [prod(p'), c_in, d]; de-embedding
# weights as w_de_flex [d, c_out, prod(p')] and b_de_flex [c_out, prod(p')].


def project_embed(w_flex: torch.Tensor, a, p_prime) -> torch.Tensor:
    """[prod(p'), c, d] → [prod(a), c, d]"""
    return torch.einsum("qp,pcd->qcd", _q("embed", a, p_prime, w_flex), w_flex)


def project_deembed(w_flex: torch.Tensor, a, p_prime) -> torch.Tensor:
    """[d, c, prod(p')] → [d, c, prod(a)]"""
    return torch.einsum("dcp,pq->dcq", w_flex, _q("deembed", a, p_prime, w_flex))


def project_deembed_bias(b_flex: torch.Tensor, a, p_prime) -> torch.Tensor:
    """[c, prod(p')] → [c, prod(a)]"""
    return torch.einsum("cp,pq->cq", b_flex, _q("deembed", a, p_prime, b_flex))


def lift_embed(w_pre: torch.Tensor, p_pre, p_prime) -> torch.Tensor:
    """Init: w_flex = B_up(p_pre→p') · w_pre.  [prod(p_pre),c,d] → [prod(p'),c,d]"""
    return torch.einsum("qp,pcd->qcd", _const(b_up(p_pre, p_prime), w_pre), w_pre)


def lift_deembed(w_pre: torch.Tensor, p_pre, p_prime) -> torch.Tensor:
    """Init: w_de_flex = w_de_pre · B_upᵀ.  [d,c,prod(p_pre)] → [d,c,prod(p')]"""
    return torch.einsum("dcp,qp->dcq", w_pre, _const(b_up(p_pre, p_prime), w_pre))


def lift_deembed_bias(b_pre: torch.Tensor, p_pre, p_prime) -> torch.Tensor:
    return torch.einsum("cp,qp->cq", b_pre, _const(b_up(p_pre, p_prime), b_pre))
