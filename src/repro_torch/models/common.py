"""Common model pieces of the port: the parameter schema, init on a
``torch.Generator``, LayerNorm, RMSNorm, RoPE, soft-capping, the MLP
activations, the sinusoidal timestep embedding, and :func:`matmul_f32`,
the one product with a float32 result that every layer rounding once
uses.

Parameters are nested dicts of tensors with the reference's names, stacked
``[L, ...]`` block leaves and ``[in, out]`` matrices, so weights cross from
the JAX package by a dtype cast alone (``repro_torch.convert``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

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
    """Standard normal truncated to [-2, 2], by inverting the CDF:
    ``erfinv(2u - 1) * sqrt(2)`` for u uniform in [cdf(-2), cdf(2)], each
    operation in place on the one float32 buffer, so a leaf costs one
    float32 copy (deepseek-moe-16b's expert leaves are 20.7 GB each)."""
    lo = 0.5 * (1.0 + math.erf(-2.0 / math.sqrt(2.0)))
    hi = 0.5 * (1.0 + math.erf(2.0 / math.sqrt(2.0)))
    u = torch.empty(shape, dtype=torch.float32, device=generator.device)
    u.uniform_(lo, hi, generator=generator)
    return u.mul_(2.0).sub_(1.0).erfinv_().mul_(math.sqrt(2.0))


def init_tree(schema: Any, generator: torch.Generator,
              dtype: torch.dtype) -> Any:
    """Materialize a parameter tree from a schema on ``generator.device``.

    The init rules are the reference's (zeros / ones / N(0, scale) embed /
    fan-in truncated normal); the draws are torch's, not threefry's. Each
    draw is scaled in place, so a leaf holds one float32 copy at a time
    (then its ``dtype`` cast)."""
    dev = generator.device

    def one(spec: ParamSpec) -> torch.Tensor:
        if spec.init == "zeros":
            return torch.zeros(spec.shape, dtype=dtype, device=dev)
        if spec.init == "ones":
            return torch.ones(spec.shape, dtype=dtype, device=dev)
        if spec.init == "embed":
            x = torch.randn(spec.shape, generator=generator, device=dev)
            return x.mul_(spec.scale).to(dtype)
        fan_in = spec.shape[0] if len(spec.shape) > 1 else max(1, spec.shape[0])
        if len(spec.shape) >= 2:
            fan_in = math.prod(spec.shape[:-1])
        std = spec.scale if spec.scale != 0.02 else 1.0 / math.sqrt(max(1, fan_in))
        return _truncated_normal(spec.shape, generator).mul_(std).to(dtype)

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


def norm_schema(d: int, norm_type: str) -> Any:
    if norm_type == "rmsnorm":
        return {"scale": ParamSpec((d,), ("embed",), init="zeros")}
    return {"scale": ParamSpec((d,), ("embed",), init="ones"),
            "bias": ParamSpec((d,), ("embed",), init="zeros")}


def apply_norm(params: Dict[str, torch.Tensor], x: torch.Tensor,
               norm_type: str) -> torch.Tensor:
    if norm_type == "rmsnorm":
        return rms_norm(x, params["scale"])
    return layer_norm(x, params["scale"], params.get("bias"))


# ---------------------------------------------------------------------------
# RoPE


def rope_frequencies(head_dim: int, theta: float,
                     device: Any = None) -> torch.Tensor:
    half = head_dim // 2
    return 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32,
                                         device=device) / half))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: [..., S, H, head_dim]; positions: [..., S] int. In float32,
    cast back to x's dtype (rotate-half layout)."""
    freqs = rope_frequencies(x.shape[-1], theta, x.device)        # [hd/2]
    angles = positions[..., None].float() * freqs                # [..., S, hd/2]
    angles = angles[..., None, :]                                # [..., S, 1, hd/2]
    sin, cos = torch.sin(angles), torch.cos(angles)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Activations, products


def softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    """Gemma-2 style logit soft-capping; no-op when cap == 0."""
    if cap <= 0.0:
        return x
    return torch.tanh(x / cap) * cap


def gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")


def mlp_act(gate: torch.Tensor, up: Optional[torch.Tensor],
            kind: str) -> torch.Tensor:
    if kind == "swiglu":
        assert up is not None
        return F.silu(gate) * up
    if kind == "geglu":
        assert up is not None
        return gelu(gate) * up
    return gelu(gate)


def count_params(tree: Any) -> int:
    return sum(math.prod(x.shape) for x in tree_leaves(tree))


class _MatmulF32(torch.autograd.Function):
    """cuBLAS's ``out_dtype=float32`` product of 16-bit operands, which has
    no derivative in torch: the backward takes the incoming float32
    gradient back to the operands' dtype and multiplies there, as a
    16-bit product followed by ``.float()`` would."""

    @staticmethod
    def forward(ctx, x2, w):
        ctx.save_for_backward(x2, w)
        return torch.mm(x2, w, out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, g):
        x2, w = ctx.saved_tensors
        g16 = g.to(x2.dtype)
        gx = g16 @ w.t() if ctx.needs_input_grad[0] else None
        gw = x2.t() @ g16 if ctx.needs_input_grad[1] else None
        return gx, gw


def matmul_f32(x: torch.Tensor, w: torch.Tensor,
               bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``x @ w`` (+ ``bias``) with a float32 result from operands in x's
    dtype: the reference's ``preferred_element_type=float32``. Products
    are summed in float32 and rounded once, by the caller's cast.

    x: [..., d]; w: [d, e] (a transposed view is fine); bias: [e], added
    in float32. On a CUDA tensor of 16 bits, ``torch.mm`` with
    ``out_dtype=float32`` (cuBLAS, float32 accumulation and output; not
    ``addmm``'s overload, which ``FlopCounterMode`` cannot count); the
    CPU backend has no such overload, so there the operands are upcast
    (every bf16 product is exact in float32). float32 operands take the
    plain product (TF32 stays off: ``torch.backends.cuda.matmul``)."""
    w = w.to(x.dtype)
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    if x.dtype == torch.float32 or x.device.type != "cuda":
        y = torch.matmul(x2.float(), w.float())
    else:
        y = _MatmulF32.apply(x2, w)
    if bias is not None:
        y = y + bias.float()
    return y.reshape(*lead, w.shape[-1])


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
