"""Mixture-of-Experts layer — the port of ``repro.models.moe``.

* :func:`moe_apply_sorted` — the serving path (``blocks._ffn``). Each batch
  row sorts its own (token, expert) assignments by expert, places them
  into a fixed ``[E, capacity]`` buffer per row (assignments past an
  expert's capacity are dropped; the residual keeps those tokens), runs
  the experts as batched products, and gathers the results back weighted
  by the router's gates. Dispatch is gather-only: the one scatter is of
  int token indices.
* :func:`moe_apply_dense` — every expert on every token, gated combine:
  the oracle the sorted path is held against.

Shared experts (deepseek-moe) are a dense MLP applied to every token. The
expert products stay ``torch.bmm`` in x's dtype, as the reference's
einsums sit outside any Pallas kernel. The reference's sharding
constraints on the expert buffers remain layout hints here: a sharded
step computes each expert on its own rows (``runtime/placement``).

The aux losses are means over all tokens of the global batch. Under a
mesh each rank routes its own rows, so the router's means are reduced
over the data axes (``runtime/sharding.data_mean``) before they are
combined: ``load_balance = E · Σ me·ce`` is a product of two global means,
and a mean of per-rank products would be another number.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch.configs.base import MoEConfig
from repro_torch.models.common import ParamSpec, matmul_f32, mlp_act
from repro_torch.models.mlp import mlp_apply, mlp_schema
from repro_torch.runtime.sharding import data_mean

Params = Dict[str, Any]


def moe_schema(d_model: int, cfg: MoEConfig, d_ff_dense: int,
               activation: str = "swiglu") -> Params:
    e_ff = cfg.expert_d_ff or d_ff_dense
    E = cfg.num_experts
    gated = activation in ("swiglu", "geglu")
    s: Params = {
        "router": ParamSpec((d_model, E), ("embed", None), scale=0.02),
        "w_in": ParamSpec((E, d_model, e_ff), ("expert", "embed", "mlp")),
        "w_out": ParamSpec((E, e_ff, d_model), ("expert", "mlp", "embed")),
    }
    if gated:
        s["w_gate"] = ParamSpec((E, d_model, e_ff), ("expert", "embed", "mlp"))
    if cfg.num_shared_experts:
        s["shared"] = mlp_schema(d_model, cfg.num_shared_experts * e_ff, activation)
    return s


def top_k_lower_index_first(probs: torch.Tensor, k: int
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k largest entries of each row and their indices, equal entries
    in ascending index order (``jax.lax.top_k``'s rule; ``torch.topk``
    promises no order among ties): a stable descending sort."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _router(params: Params, x2d: torch.Tensor, cfg: MoEConfig
            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                       Dict[str, torch.Tensor]]:
    """x2d: [T,d] → (gates [T,k] float32, idx [T,k] int64, probs [T,E],
    aux losses: the Switch load balance and the router z-loss, each
    scaled by its weight)."""
    logits = matmul_f32(x2d, params["router"])                    # [T,E] f32
    probs = torch.softmax(logits, dim=-1)
    gates, idx = top_k_lower_index_first(probs, cfg.num_experts_per_tok)
    gates = gates / gates.sum(-1, keepdim=True).clamp_min(1e-9)
    E = cfg.num_experts
    me = probs.mean(0)                                            # [E]
    ce = torch.zeros(E, dtype=torch.float32, device=x2d.device).index_add_(
        0, idx[:, 0], torch.ones_like(idx[:, 0], dtype=torch.float32)) / idx.shape[0]
    lb = _load_balance(me, ce, E)
    z = data_mean(torch.logsumexp(logits, dim=-1).square().mean())
    aux = {"load_balance": lb * cfg.load_balance_loss,
           "router_z": z * cfg.router_z_loss}
    return gates.float(), idx, probs, aux


def _load_balance(me: torch.Tensor, ce: torch.Tensor, E: int) -> torch.Tensor:
    """``E · Σ me·ce`` of the global means (each reduced over the data
    axes first)."""
    return E * torch.sum(data_mean(me) * data_mean(ce))


def _bmm(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """[E, n, i] x [E, i, o] in a's dtype (on the card a bf16 product sums
    in float32 and rounds once)."""
    return torch.bmm(a, w.to(a.dtype))


def _expert_ffn(params: Params, xb: torch.Tensor, activation: str) -> torch.Tensor:
    """xb: [E, C, d] → [E, C, d], each expert's MLP on its rows."""
    up = _bmm(xb, params["w_in"])
    if "w_gate" in params:
        h = mlp_act(_bmm(xb, params["w_gate"]), up, activation)
    else:
        h = mlp_act(up, None, activation)
    return _bmm(h.to(xb.dtype), params["w_out"]).to(xb.dtype)


def _expert_ffn_batched(params: Params, xb: torch.Tensor, activation: str
                        ) -> torch.Tensor:
    """xb: [B, E, C, d] → [B, E, C, d]: one product per expert over the
    rows of every batch row."""
    B, E, C, d = xb.shape
    y = _expert_ffn(params, xb.transpose(0, 1).reshape(E, B * C, d), activation)
    return y.reshape(E, B, C, d).transpose(0, 1)


def capacity(num_tokens: int, cfg: MoEConfig) -> int:
    """Slots per (row, expert): tokens x k x capacity_factor / E, rounded
    up to a multiple of 8, at least 8."""
    c = int(num_tokens * cfg.num_experts_per_tok * cfg.capacity_factor
            / cfg.num_experts)
    return max(8, -(-c // 8) * 8)


def moe_apply_sorted(params: Params, x: torch.Tensor, cfg: MoEConfig,  # repro: traced
                     activation: str = "swiglu"
                     ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Per-row sort-based dispatch. x: [B,S,d] → (y [B,S,d], aux with
    ``dropped_fraction``, the share of (token, expert) assignments over
    capacity). Capacity is per (row, expert): ``capacity(S)``."""
    B, S, d = x.shape
    k = cfg.num_experts_per_tok
    E = cfg.num_experts
    T = S * k
    dev = x.device
    gates, idx, _, aux = _router(params, x.reshape(B * S, d), cfg)
    gates = gates.reshape(B, T)
    e_flat = idx.reshape(B, T)
    tok_flat = torch.arange(S, device=dev).repeat_interleave(k).expand(B, T)

    C = capacity(S, cfg)
    order = torch.argsort(e_flat, dim=-1, stable=True)
    e_sorted = e_flat.gather(1, order)
    tok_sorted = tok_flat.gather(1, order)
    counts = torch.zeros(B, E, dtype=torch.long, device=dev).scatter_add_(
        1, e_flat, torch.ones_like(e_flat))
    starts = counts.cumsum(-1) - counts                           # [B,E]
    pos = torch.arange(T, device=dev)[None] - starts.gather(1, e_sorted)
    keep = pos < C
    buf_idx = torch.where(keep, e_sorted * C + pos, E * C)        # [B,T]

    # the slot → token table; every dropped assignment lands in the
    # overflow column E*C, which is sliced away
    idx_buf = torch.full((B, E * C + 1), S, dtype=torch.long, device=dev)
    idx_buf = idx_buf.scatter_(1, buf_idx, tok_sorted)[:, :E * C]
    valid = (idx_buf < S)[..., None].to(x.dtype)
    rows = torch.arange(B, device=dev)[:, None] * S
    # one flat gather of whole token rows: an index of B*E*C ints
    x_buf = x.reshape(B * S, d).index_select(
        0, (idx_buf.clamp(max=S - 1) + rows).reshape(-1)).reshape(B, E * C, d)
    x_buf = x_buf * valid
    y_buf = _expert_ffn_batched(params, x_buf.reshape(B, E, C, d), activation)
    y_buf = y_buf.reshape(B * E * C, d)

    # back to token-major through the inverse permutation (gathers only)
    inv = torch.empty_like(order).scatter_(
        1, order, torch.arange(T, device=dev).expand(B, T))
    buf_pos = buf_idx.gather(1, inv)                              # [B,T]
    keep_tok = keep.gather(1, inv)
    brow = torch.arange(B, device=dev)[:, None] * (E * C)
    y_slots = y_buf.index_select(
        0, (buf_pos.clamp(max=E * C - 1) + brow).reshape(-1)).reshape(B, T, d)
    w_tok = (gates * keep_tok.float())[..., None].to(x.dtype)
    out = (y_slots * w_tok).reshape(B, S, k, d).sum(dim=2)
    if "shared" in params:
        out = out + mlp_apply(params["shared"], x, activation)
    aux["dropped_fraction"] = data_mean(1.0 - keep.float().mean())
    return out, aux


def moe_apply_dense(params: Params, x: torch.Tensor, cfg: MoEConfig,
                    activation: str = "swiglu"
                    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Oracle: every expert on every token, combined by the gates (no
    capacity, nothing dropped). For tests and the card check only."""
    B, S, d = x.shape
    T = B * S
    x2d = x.reshape(T, d)
    gates, idx, _, aux = _router(params, x2d, cfg)
    E = cfg.num_experts
    combine = torch.zeros(T, E, dtype=torch.float32, device=x.device)
    for j in range(cfg.num_experts_per_tok):
        combine = combine + torch.nn.functional.one_hot(idx[:, j], E) * gates[:, j:j + 1]
    y_all = _expert_ffn(params, x2d.expand(E, T, d), activation)  # [E,T,d]
    out = torch.einsum("te,etd->td", combine.to(x.dtype), y_all)
    if "shared" in params:
        out = out + mlp_apply(params["shared"], x2d, activation)
    aux["dropped_fraction"] = torch.zeros((), device=x.device)
    return out.reshape(B, S, d), aux
