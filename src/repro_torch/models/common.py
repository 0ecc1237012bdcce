"""Common model pieces of the port: the parameter schema, init on a
``torch.Generator``, LayerNorm, RMSNorm and the sinusoidal timestep
embedding.

Parameters are nested dicts of tensors with the reference's names, stacked
``[L, ...]`` block leaves and ``[in, out]`` matrices, so weights cross from
the JAX package by a dtype cast alone (``repro_torch.convert``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional, Tuple

import torch

# ---------------------------------------------------------------------------
# Parameter schema


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]          # logical axis name per dim
    init: str = "normal"                     # normal | zeros | ones | embed
    scale: float = 0.02

    def __post_init__(self):
        assert len(self.shape) == len(self.axes), (self.shape, self.axes)


def tree_map(fn, tree: Any, *rest: Any) -> Any:
    """Apply ``fn`` to every leaf of a nested dict (schema or parameters),
    or to the matching leaves of trees of one structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def tree_leaves(tree: Any) -> list:
    """Leaves in the reference's order (``jax.tree.leaves``: sorted keys)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    return [tree]


def stack_schema(schema: Any, n: int, axis_name: Optional[str] = "layers") -> Any:
    """Prepend a stacking dimension (stacked per-layer parameters)."""
    return tree_map(lambda s: ParamSpec((n,) + s.shape, (axis_name,) + s.axes,
                                        s.init, s.scale), schema)


def _truncated_normal(shape, generator: torch.Generator) -> torch.Tensor:
    """Standard normal truncated to [-2, 2], by inverting the CDF."""
    lo = 0.5 * (1.0 + math.erf(-2.0 / math.sqrt(2.0)))
    hi = 0.5 * (1.0 + math.erf(2.0 / math.sqrt(2.0)))
    u = torch.empty(shape, dtype=torch.float32, device=generator.device)
    u.uniform_(lo, hi, generator=generator)
    return torch.erfinv(2.0 * u - 1.0) * math.sqrt(2.0)


def init_tree(schema: Any, generator: torch.Generator,
              dtype: torch.dtype) -> Any:
    """Materialize a parameter tree from a schema on ``generator.device``.

    The init rules are the reference's (zeros / ones / N(0, scale) embed /
    fan-in truncated normal); the draws are torch's, not threefry's."""
    dev = generator.device

    def one(spec: ParamSpec) -> torch.Tensor:
        if spec.init == "zeros":
            return torch.zeros(spec.shape, dtype=dtype, device=dev)
        if spec.init == "ones":
            return torch.ones(spec.shape, dtype=dtype, device=dev)
        if spec.init == "embed":
            x = torch.randn(spec.shape, generator=generator, device=dev)
            return (x * spec.scale).to(dtype)
        fan_in = spec.shape[0] if len(spec.shape) > 1 else max(1, spec.shape[0])
        if len(spec.shape) >= 2:
            fan_in = math.prod(spec.shape[:-1])
        std = spec.scale if spec.scale != 0.02 else 1.0 / math.sqrt(max(1, fan_in))
        return (_truncated_normal(spec.shape, generator) * std).to(dtype)

    return tree_map(one, schema)


# ---------------------------------------------------------------------------
# Norms and embeddings


def layer_norm(x: torch.Tensor, scale: torch.Tensor,
               bias: Optional[torch.Tensor] = None,
               eps: float = 1e-6) -> torch.Tensor:
    dtype = x.dtype
    x = x.float()
    mu = x.mean(dim=-1, keepdim=True)
    var = (x - mu).square().mean(dim=-1, keepdim=True)
    y = (x - mu) * torch.rsqrt(var + eps) * scale.float()
    if bias is not None:
        y = y + bias.float()
    return y.to(dtype)


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6,
             zero_centered: bool = True) -> torch.Tensor:
    """RMSNorm in float32. Gemma-style ``(1 + scale)`` when ``zero_centered``."""
    dtype = x.dtype
    x = x.float()
    y = x * torch.rsqrt(x.square().mean(dim=-1, keepdim=True) + eps)
    w = 1.0 + scale.float() if zero_centered else scale.float()
    return (y * w).to(dtype)


def dtype_of(name: str) -> torch.dtype:
    return {"float32": torch.float32, "bfloat16": torch.bfloat16,
            "float16": torch.float16}[name]


def timestep_embedding(t: torch.Tensor, dim: int,
                       max_period: float = 10_000.0) -> torch.Tensor:
    """Sinusoidal embedding of timesteps [B] → [B, dim], ordered [cos, sin]."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_period)
                      * torch.arange(half, dtype=torch.float32, device=t.device)
                      / half)
    args = t.float()[:, None] * freqs[None]
    emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    if dim % 2:
        emb = torch.nn.functional.pad(emb, (0, 1))
    return emb
