"""Mamba2 (SSD — state-space duality) layer of the port.

The chunked SSD algorithm (Dao & Gu, 2024) in plain PyTorch for prefill,
and the O(1)-per-token recurrence for decode, as ``repro.models.ssm``.
With ``use_kernel=True`` the intra-chunk part runs on the Hopper kernel of
``repro_torch.kernels.ssd`` (on a CUDA tensor).

Layer layout (n_groups = 1):
  in_proj:  d → [z (d_in), x (d_in), B (N), C (N), dt (H)]
  conv1d:   depthwise causal conv width W over the (x, B, C) channels
  SSD:      h_t = a_t h_{t-1} + dt_t · x_t ⊗ B_t ;  y_t = C_t · h_t + D x_t
            with a_t = exp(-exp(A_log) · dt_t), dt_t = softplus(raw + bias)
  gate:     y = RMSNorm(y) * silu(z), then out_proj: d_in → d
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import SSMConfig
from repro_torch.device import resolve_device
from repro_torch.models.common import ParamSpec, rms_norm

Params = Dict[str, Any]


def ssm_dims(d_model: int, cfg: SSMConfig) -> Tuple[int, int, int]:
    d_in = cfg.expand * d_model
    nheads = cfg.num_heads or max(1, d_in // cfg.head_dim)
    return d_in, nheads, cfg.head_dim


def ssm_schema(d_model: int, cfg: SSMConfig) -> Params:
    d_in, H, P = ssm_dims(d_model, cfg)
    N = cfg.state_dim
    conv_ch = d_in + 2 * N
    return {
        "in_proj": ParamSpec((d_model, 2 * d_in + 2 * N + H), ("embed", "mlp")),
        "conv_w": ParamSpec((cfg.conv_width, conv_ch), (None, "mlp"), scale=0.5),
        "conv_b": ParamSpec((conv_ch,), ("mlp",), init="zeros"),
        "A_log": ParamSpec((H,), (None,), init="zeros"),
        "D": ParamSpec((H,), (None,), init="ones"),
        "dt_bias": ParamSpec((H,), (None,), init="zeros"),
        "norm": {"scale": ParamSpec((d_in,), ("mlp",), init="zeros")},
        "out_proj": ParamSpec((d_in, d_model), ("mlp", "embed")),
    }


def _split_proj(params: Params, u: torch.Tensor, d_in: int, N: int, H: int):
    zxbcdt = torch.matmul(u, params["in_proj"].to(u.dtype))
    z = zxbcdt[..., :d_in]
    xBC = zxbcdt[..., d_in:d_in + d_in + 2 * N]
    dt_raw = zxbcdt[..., d_in + d_in + 2 * N:]
    return z, xBC, dt_raw


def _causal_conv(params: Params, xBC: torch.Tensor,
                 conv_state: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv. xBC: [B,S,Cch]. Returns (out, new_conv_state).

    ``conv_state``: [B, W-1, Cch] holds the last W-1 inputs for decode.
    """
    W = params["conv_w"].shape[0]
    B, S, Cch = xBC.shape
    if conv_state is None:
        conv_state = xBC.new_zeros((B, W - 1, Cch))
    padded = torch.cat([conv_state.to(xBC.dtype), xBC], dim=1)    # [B,S+W-1,C]
    out = torch.zeros((B, S, Cch), dtype=torch.float32, device=xBC.device)
    for i in range(W):
        out = out + padded[:, i:i + S].float() * params["conv_w"][i].float()
    out = out + params["conv_b"].float()
    out = F.silu(out).to(xBC.dtype)
    return out, padded[:, S:]


def pad_to_chunks(chunk: int, *ts: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """Zero-pad each [B, S, ...] tensor along S to a multiple of ``chunk``.

    Zero padding is exact: dt=0 → decay exp(0)=1 and contribution 0, so
    the final state and the unpadded outputs are unchanged."""
    pad = -ts[0].shape[1] % chunk
    if not pad:
        return ts
    return tuple(torch.cat([t, t.new_zeros((t.shape[0], pad) + t.shape[2:])],
                           dim=1) for t in ts)


def ssd_intra_chunk(xc: torch.Tensor, dtc: torch.Tensor, A: torch.Tensor,
                    Bc: torch.Tensor, Cc: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The quadratic part of each chunk, in float32.

    xc: [B,nc,Q,H,P]; dtc: [B,nc,Q,H]; A: [H]; Bc, Cc: [B,nc,Q,N].
    Returns (y_intra [B,nc,Q,H,P], Sc [B,nc,H,P,N], L [B,nc,Q,H]) with L
    the inclusive cumulative log decay; Ltot is ``L[:, :, -1]``.
    """
    Q = xc.shape[2]
    xf = xc.float()
    # log decay per step: log a_t = A * dt_t  (A < 0)
    L = torch.cumsum(dtc * A[None, None, None, :], dim=2)          # [B,nc,Q,H]
    Ltot = L[:, :, -1, :]
    # M[q,k] = C_q·B_k * exp(L_q - L_k) * dt_k  for k <= q; the mask is
    # applied before the exponential (L_q - L_k > 0 for k > q can overflow)
    CB = torch.einsum("bcqn,bckn->bcqk", Cc, Bc)                  # [B,nc,Q,Q]
    diff = L[:, :, :, None, :] - L[:, :, None, :, :]              # [B,nc,Q,Q,H]
    causal = torch.ones((Q, Q), dtype=torch.bool, device=xc.device).tril()
    decay = torch.exp(torch.where(causal[None, None, :, :, None], diff,
                                  float("-inf")))
    M = CB[..., None] * decay * dtc[:, :, None, :, :]             # [B,nc,Q,K,H]
    y_intra = torch.einsum("bcqkh,bckhp->bcqhp", M, xf)
    # chunk summaries S_c = sum_k exp(Ltot - L_k) dt_k x_k ⊗ B_k
    w = torch.exp(Ltot[:, :, None, :] - L) * dtc                  # [B,nc,Q,H]
    Sc = torch.einsum("bcqh,bcqhp,bcqn->bchpn", w, xf, Bc)
    return y_intra, Sc, L


def ssd_inter_chunk(Sc: torch.Tensor, Ltot: torch.Tensor, L: torch.Tensor,
                    Cc: torch.Tensor, h0: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The recurrence over chunk index and each chunk's share of the state
    carried into it. Sc: [B,nc,H,P,N]; Ltot: [B,nc,H]; L: [B,nc,Q,H];
    Cc: [B,nc,Q,N]. Returns (y_inter [B,nc,Q,H,P] float32, h_final
    [B,H,P,N])."""
    Bsz, nc, H, P, N = Sc.shape
    h = h0 if h0 is not None else Sc.new_zeros((Bsz, H, P, N))
    decay = torch.exp(Ltot)                                       # [B,nc,H]
    h_prevs = []
    for c in range(nc):
        h_prevs.append(h)
        h = h * decay[:, c, :, None, None] + Sc[:, c]
    h_prev = torch.stack(h_prevs, dim=1)                          # [B,nc,H,P,N]
    # y_inter[q] = exp(L_q) * C_q · h_prev
    y_inter = torch.einsum("bcqh,bcqn,bchpn->bcqhp", torch.exp(L), Cc, h_prev)
    return y_inter, h


def ssd_chunked(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                Bm: torch.Tensor, Cm: torch.Tensor, chunk: int,
                h0: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD scan.

    x:  [B,S,H,P]  (dt applied inside)
    dt: [B,S,H]    (softplus'd, positive)
    A:  [H]        (negative decay rates)
    Bm, Cm: [B,S,N]
    Returns (y [B,S,H,P] in x's dtype, h_final [B,H,P,N] float32).
    """
    Bsz, S, H, P = x.shape
    N = Bm.shape[-1]
    x, dt, Bm, Cm = pad_to_chunks(chunk, x, dt, Bm, Cm)
    nc = x.shape[1] // chunk
    Cc = Cm.reshape(Bsz, nc, chunk, N)
    y_intra, Sc, L = ssd_intra_chunk(
        x.reshape(Bsz, nc, chunk, H, P), dt.reshape(Bsz, nc, chunk, H), A,
        Bm.reshape(Bsz, nc, chunk, N), Cc)
    y_inter, h_final = ssd_inter_chunk(Sc, L[:, :, -1], L, Cc, h0)
    y = (y_intra + y_inter).reshape(Bsz, nc * chunk, H, P)[:, :S]
    return y.to(x.dtype), h_final


def ssd_recurrent_step(h: torch.Tensor, x: torch.Tensor, dt: torch.Tensor,
                       A: torch.Tensor, Bm: torch.Tensor, Cm: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One decode step. h: [B,H,P,N]; x: [B,H,P]; dt: [B,H]; Bm,Cm: [B,N]."""
    a = torch.exp(dt * A[None, :])                                # [B,H]
    h_new = h * a[:, :, None, None] + \
        (dt[:, :, None] * x.float())[..., None] * Bm[:, None, None, :]
    y = torch.einsum("bhpn,bn->bhp", h_new, Cm)
    return h_new, y.to(x.dtype)


def ssm_apply(params: Params, u: torch.Tensor, cfg: SSMConfig, d_model: int,  # repro: traced
              state: Optional[Params] = None, use_kernel: bool = False
              ) -> Tuple[torch.Tensor, Params]:
    """Full Mamba2 layer. u: [B,S,d]. ``state`` enables streaming decode:
    {"h": [B,H,P,N], "conv": [B,W-1,Cch]}. Returns (out, new_state).

    ``use_kernel=True`` runs the SSD intra-chunk part through
    ``kernels.ssd.ops.ssd``. A carried state with S > 1 raises there: the
    reference's kernel branch drops ``h0`` (ROADMAP queue 3)."""
    B, S, d = u.shape
    d_in, H, P = ssm_dims(d_model, cfg)
    N = cfg.state_dim
    if use_kernel and state is not None and S > 1:
        raise NotImplementedError(
            "ssm_apply(use_kernel=True) with a carried state: the reference's "
            "kernel branch drops h0 (ROADMAP queue 3); use use_kernel=False")
    z, xBC, dt_raw = _split_proj(params, u, d_in, N, H)
    conv_state = state["conv"] if state is not None else None
    xBC, new_conv = _causal_conv(params, xBC, conv_state)
    xs = xBC[..., :d_in].reshape(B, S, H, P)
    Bm = xBC[..., d_in:d_in + N]
    Cm = xBC[..., d_in + N:]
    dt = F.softplus(dt_raw.float() + params["dt_bias"].float())   # [B,S,H]
    A = -torch.exp(params["A_log"].float())                        # [H]

    if S == 1 and state is not None:
        h_new, y = ssd_recurrent_step(state["h"], xs[:, 0], dt[:, 0], A,
                                      Bm[:, 0].float(), Cm[:, 0].float())
        y = y[:, None]
    elif use_kernel:
        from repro_torch.kernels.ssd import ops as ssd_ops
        y, h_new = ssd_ops.ssd(xs, dt, A, Bm.float(), Cm.float(),
                               cfg.chunk_size)
    else:
        h0 = state["h"] if state is not None else None
        y, h_new = ssd_chunked(xs, dt, A, Bm.float(), Cm.float(),
                               cfg.chunk_size, h0)

    y = y + xs * params["D"].to(y.dtype)[None, None, :, None]
    y = y.reshape(B, S, d_in)
    y = rms_norm(y, params["norm"]["scale"]) * F.silu(z.float()).to(y.dtype)
    out = torch.matmul(y, params["out_proj"].to(y.dtype)).to(u.dtype)
    return out, {"h": h_new, "conv": new_conv}


def init_ssm_state(batch: int, d_model: int, cfg: SSMConfig,
                   dtype: torch.dtype, device: Any = None) -> Params:
    """Zero recurrent state, on CUDA unless ``device="cpu"`` is passed."""
    device = resolve_device(device)
    d_in, H, P = ssm_dims(d_model, cfg)
    N = cfg.state_dim
    return {
        "h": torch.zeros((batch, H, P, N), dtype=torch.float32, device=device),
        "conv": torch.zeros((batch, cfg.conv_width - 1, d_in + 2 * N),
                            dtype=dtype, device=device),
    }
