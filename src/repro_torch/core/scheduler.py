"""FlexiDiT inference scheduler (§3.3) and the analytic FLOPs ledger.

Host numpy, the reference's arithmetic term for term, so every count
equals ``repro.core.scheduler``'s exactly: weak mode for the first
``T_weak`` steps, powerful mode for the rest; FLOPs per NFE with mul and
add counted separately (paper App. C.1).
"""
from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.attention import costing
from repro_torch.models import dit as dit_mod


@dataclasses.dataclass(frozen=True)
class FlexiSchedule:
    """phases: ((mode, n_steps), ...) executed in order from t=T-1 down."""
    phases: Tuple[Tuple[int, int], ...]

    @property
    def total_steps(self) -> int:
        return sum(n for _, n in self.phases)

    def split_timesteps(self, timesteps: np.ndarray) -> List[Tuple[int, np.ndarray]]:
        """Split a descending timestep ladder across phases."""
        assert len(timesteps) == self.total_steps, (len(timesteps), self)
        out, i = [], 0
        for mode, n in self.phases:
            out.append((mode, timesteps[i:i + n]))
            i += n
        return out

    @staticmethod
    def weak_first(T: int, T_weak: int, weak_mode: int = 1) -> "FlexiSchedule":
        """The paper's scheduler: weak for the first T_weak steps."""
        assert 0 <= T_weak <= T
        return FlexiSchedule(((weak_mode, T_weak), (0, T - T_weak)))

    @staticmethod
    def powerful_first(T: int, T_weak: int, weak_mode: int = 1) -> "FlexiSchedule":
        """Ablation scheduler (App. B.4, shown to be worse)."""
        return FlexiSchedule(((0, T - T_weak), (weak_mode, T_weak)))


def dit_block_flops(cfg: ModelConfig, n_tokens: int,
                    text_len: Optional[int] = None,
                    attn_backend: str = "dense") -> float:
    """FLOPs of all transformer blocks over ``n_tokens`` tokens (batch 1).
    ``attn_backend='pallas'``/``'auto'`` prices self-attention at the flash
    kernel's block-map granularity (tiles of 128) instead of the exact N²."""
    N = n_tokens
    d, L, f = cfg.d_model, cfg.num_layers, cfg.d_ff
    per_layer = 0.0
    per_layer += 2 * N * d * (3 * d)          # qkv proj
    per_layer += 2 * N * d * d                # out proj
    if attn_backend in ("pallas", "auto"):
        per_layer += costing.block_sparse_attention_flops([N], N, d)
    else:
        per_layer += 2 * 2 * N * N * d        # QK^T and PV
    per_layer += 2 * 2 * N * d * f            # mlp in/out
    per_layer += 2 * d * 6 * d                # adaLN linear (per sample)
    if cfg.dit.conditioning == "text":
        T = text_len or cfg.dit.text_len
        dc = cfg.dit.text_dim or d
        per_layer += 2 * N * d * d            # xattn q
        per_layer += 2 * 2 * T * dc * d       # xattn k,v
        per_layer += 2 * 2 * N * T * d        # scores + values
        per_layer += 2 * N * d * d            # xattn out
    return float(L * per_layer)


def dit_nfe_flops(cfg: ModelConfig, mode: int = 0,
                  text_len: Optional[int] = None,
                  attn_backend: str = "dense") -> float:
    """FLOPs of one DiT forward (batch 1) at the given patch mode."""
    N = dit_mod.tokens_for_mode(cfg, mode)
    d = cfg.d_model
    p = dit_mod.patch_sizes(cfg)[mode]
    c_in = cfg.dit.latent_shape[-1]
    c_out = dit_mod.c_out_dim(cfg)
    npix = math.prod(p)

    total = dit_block_flops(cfg, N, text_len, attn_backend=attn_backend)
    total += 2 * N * npix * c_in * d          # embed
    total += 2 * N * d * npix * c_out         # de-embed
    total += 2 * d * 2 * d                    # final adaLN
    return float(total)


def lora_nfe_overhead(cfg: ModelConfig, mode: int) -> float:
    """Extra FLOPs/NFE when LoRAs stay unmerged (paper §3.2)."""
    if cfg.dit.lora_rank <= 0 or mode == 0:
        return 0.0
    N = dit_mod.tokens_for_mode(cfg, mode)
    d, L, f, r = cfg.d_model, cfg.num_layers, cfg.d_ff, cfg.dit.lora_rank
    per_layer = 0.0
    for d_in, d_out in [(d, d)] * 4 + [(d, f), (f, d)]:
        per_layer += 2 * N * (d_in * r + r * d_out)
    return float(L * per_layer)


def schedule_flops(cfg: ModelConfig, schedule: FlexiSchedule, *,
                   cfg_scale_active: bool = True,
                   guidance_modes: Optional[Sequence[Tuple[int, int]]] = None,
                   lora_unmerged: bool = False,
                   attn_backend: str = "dense") -> float:
    """Total denoising FLOPs for a batch-1 sample under the scheduler.
    ``guidance_modes``: optional per-phase (mode_cond, mode_uncond)."""
    total = 0.0
    for i, (mode, n) in enumerate(schedule.phases):
        def nfe(m: int) -> float:
            fl = dit_nfe_flops(cfg, m, attn_backend=attn_backend)
            if lora_unmerged:
                fl += lora_nfe_overhead(cfg, m)
            return fl
        if cfg_scale_active:
            mc, mu = (guidance_modes[i] if guidance_modes is not None
                      else (mode, mode))
            total += n * (nfe(mc) + nfe(mu))
        else:
            total += n * nfe(mode)
    return total


def relative_compute(cfg: ModelConfig, schedule: FlexiSchedule, **kw) -> float:
    """Compute fraction vs the all-powerful baseline with the same T."""
    base = FlexiSchedule(((0, schedule.total_steps),))
    return schedule_flops(cfg, schedule, **kw) / schedule_flops(cfg, base, **kw)
