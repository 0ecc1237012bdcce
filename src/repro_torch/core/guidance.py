"""Generation guidance (§3.4 + App. B.4): the per-phase ``eps_fn`` of the
sampler.

* vanilla CFG (p_cond == p_uncond): both predictions in one call at 2×
  batch;
* weak-model guidance (p_cond < p_uncond): the weak model's *conditional*
  prediction is the guidance signal, ``ε_w(c) + s₂·(ε_p(c) − ε_w(c))`` —
  two calls at different patch modes;
* the App. B.4 scale rule ``(1 − s₁)/(1 − s₂) = 2.5``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import dit as dit_mod

SCALE_RULE = 2.5


@dataclasses.dataclass(frozen=True)
class GuidanceConfig:
    scale: float = 4.0           # s_cfg (vanilla scale, s₁)
    mode_cond: int = 0           # patch mode for the conditional NFE
    mode_uncond: int = 0         # patch mode for the guidance NFE
    # 'uncond'   → guidance signal is the unconditional prediction
    # 'weak_cond'→ guidance signal is the weak model's *conditional* pred.
    kind: str = "uncond"

    def effective_scale(self) -> float:
        if self.kind == "uncond":
            return self.scale
        # (1 - s1)/(1 - s2) = 2.5  →  s2 = 1 - (1 - s1)/2.5
        return 1.0 - (1.0 - self.scale) / SCALE_RULE


def split_model_out(out: torch.Tensor, cfg: ModelConfig
                    ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    c_in = cfg.dit.latent_shape[-1]
    if cfg.dit.learn_sigma:
        return out[..., :c_in], out[..., c_in:]
    return out, None


def make_eps_fn(params: Any, cfg: ModelConfig, cond: Any, null_cond: Any,
                g: GuidanceConfig,
                text_mask: Optional[torch.Tensor] = None,
                null_text_mask: Optional[torch.Tensor] = None,
                guidance_params: Any = None,
                parallel: Any = None,
                attn_backend: str = "auto",
                cache_split: Optional[int] = None) -> Callable:
    """Returns eps_fn(x, t) → (eps_guided, logvar_frac).

    ``guidance_params``: optional separate tree for the guidance call of
    the two-call path (e.g. the LoRA-merged weights of the weak mode).

    ``cache_split``: the activation cache's shallow/deep split. The fn is
    then eps_fn(x, t, delta, refresh) → (eps, logvar, new_delta): ``delta``
    covers the NFE's full token stream ([2B, N, d] under CFG: both
    branches share the request's staleness clock but carry their own
    features) and ``refresh`` is a host bool."""
    if cache_split is not None and (g.kind != "uncond"
                                    or g.mode_cond != g.mode_uncond):
        raise ValueError("the activation cache supports plain and "
                         "vanilla-CFG guidance only (weak_cond mixes "
                         "patch modes inside one step)")
    s = g.effective_scale()
    g_params = params if guidance_params is None else guidance_params

    def fwd(p, x, t, c, mode, mask, cache=()):
        """The model output and, with ``cache`` = (delta, refresh), the
        new delta (else None)."""
        bc = dit_mod.BlockCache(*cache, cache_split) if cache else None
        out = dit_mod.dit_forward(p, x, t, c, cfg, mode=mode, text_mask=mask,
                                  parallel=parallel, attn_backend=attn_backend,
                                  block_cache=bc)
        return out if cache else (out, None)

    def with_delta(result, cache, new_delta):
        return result + (new_delta,) if cache else result

    if g.scale == 0.0 or cond is None:
        def eps_plain(x, t, *cache):
            out, nd = fwd(params, x, t, cond, g.mode_cond, text_mask, cache)
            return with_delta(split_model_out(out, cfg), cache, nd)
        return eps_plain

    if g.mode_cond == g.mode_uncond and g.kind == "uncond":
        # vanilla CFG — one call at 2× batch (same sequence length)
        def eps_cfg(x, t, *cache):
            x2 = torch.cat([x, x], dim=0)
            t2 = torch.cat([t, t], dim=0)
            c2 = torch.cat([cond, null_cond], dim=0)
            m2 = None
            if cond.ndim >= 2 and text_mask is not None:
                m2 = torch.cat([text_mask, null_text_mask], dim=0)
            out, nd = fwd(params, x2, t2, c2, g.mode_cond, m2, cache)
            eps, logvar = split_model_out(out, cfg)
            e_c, e_u = torch.chunk(eps, 2, dim=0)
            lv = None if logvar is None else torch.chunk(logvar, 2, dim=0)[0]
            return with_delta((e_u + g.scale * (e_c - e_u), lv), cache, nd)
        return eps_cfg

    # mixed patch sizes — two calls
    def eps_weak_guided(x, t):
        e_c, lv = split_model_out(fwd(params, x, t, cond, g.mode_cond,
                                      text_mask)[0], cfg)
        if g.kind == "weak_cond":
            # paper: guidance = weak *conditional* prediction
            out_g = fwd(g_params, x, t, cond, g.mode_uncond, text_mask)[0]
        else:
            out_g = fwd(g_params, x, t, null_cond, g.mode_uncond,
                        null_text_mask)[0]
        e_g, _ = split_model_out(out_g, cfg)
        return e_g + s * (e_c - e_g), lv

    return eps_weak_guided
