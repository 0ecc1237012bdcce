"""Dense feed-forward blocks (SwiGLU / GeGLU / GELU) — the port of
``repro.models.mlp``.

As in the reference, the products return x's dtype (no float32 result):
on the card a bf16 ``torch.matmul`` accumulates in float32 and rounds
once, as the MXU does.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.models.common import ParamSpec, mlp_act

Params = Dict[str, Any]


def mlp_schema(d_model: int, d_ff: int, activation: str = "swiglu",
               bias: bool = False) -> Params:
    gated = activation in ("swiglu", "geglu")
    s: Params = {
        "w_in": ParamSpec((d_model, d_ff), ("embed", "mlp")),
        "w_out": ParamSpec((d_ff, d_model), ("mlp", "embed")),
    }
    if gated:
        s["w_gate"] = ParamSpec((d_model, d_ff), ("embed", "mlp"))
    if bias:
        s["b_in"] = ParamSpec((d_ff,), ("mlp",), init="zeros")
        s["b_out"] = ParamSpec((d_model,), ("embed",), init="zeros")
    return s


def mlp_apply(params: Params, x: torch.Tensor,
              activation: str = "swiglu") -> torch.Tensor:
    dt = x.dtype
    up = torch.matmul(x, params["w_in"].to(dt))
    if "b_in" in params:
        up = up + params["b_in"].to(dt)
    if activation in ("swiglu", "geglu"):
        gate = torch.matmul(x, params["w_gate"].to(dt))
        h = mlp_act(gate, up, activation)
    else:
        h = mlp_act(up, None, activation)
    out = torch.matmul(h.to(dt), params["w_out"].to(dt))
    if "b_out" in params:
        out = out + params["b_out"].to(dt)
    return out.to(dt)
