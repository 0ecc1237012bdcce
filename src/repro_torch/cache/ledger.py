"""Analytic FLOPs / bytes costing for cache-hit steps, the port of
``repro.cache.ledger`` (host arithmetic, term for term).

Layered on ``core.scheduler.dit_block_flops``: a cache-skip step pays the
shallow blocks, the (de-)embedding, and the conditioning projections,
but not the deep blocks it replays. All functions are pure arithmetic
over static shapes — the serving controller prices cache-adjusted
budgets from them, and benches report FLOPs saved without touching the
device.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

from repro_torch.cache.policy import CacheSpec, refresh_mask
from repro_torch.configs.base import ModelConfig
from repro_torch.core.scheduler import (FlexiSchedule, dit_block_flops,
                                        dit_nfe_flops, lora_nfe_overhead,
                                        schedule_flops)
from repro_torch.models import dit as dit_mod

_DTYPE_BYTES = {"float32": 4, "bfloat16": 2, "float16": 2}


def deep_block_flops(cfg: ModelConfig, mode: int, split: int,
                     attn_backend: str = "dense") -> float:
    """FLOPs of the deep blocks ``[split, L)`` a cache-skip step avoids
    (batch 1, one NFE). ``dit_block_flops`` is linear in the layer count,
    so the deep share is exact, not an estimate. ``attn_backend`` prices
    attention at what the serving backend actually issues (block-granular
    under the flash kernel)."""
    L = cfg.num_layers
    N = dit_mod.tokens_for_mode(cfg, mode)
    return dit_block_flops(cfg, N, attn_backend=attn_backend) \
        * (L - split) / L


def cached_nfe_flops(cfg: ModelConfig, mode: int, split: int,
                     refresh: bool, attn_backend: str = "dense") -> float:
    """FLOPs of one NFE at ``mode`` under the cache: full on refresh,
    shallow-only (plus embed/de-embed/conditioning) on skip."""
    full = dit_nfe_flops(cfg, mode, attn_backend=attn_backend)
    if refresh:
        return full
    return full - deep_block_flops(cfg, mode, split,
                                   attn_backend=attn_backend)


def delta_bytes(cfg: ModelConfig, mode: int, guided: bool = True) -> int:
    """Bytes one request's cached deep-block residual occupies: one
    ``[N_mode, d]`` activation delta per CFG branch at compute dtype."""
    mult = 2 if guided else 1
    n_bytes = _DTYPE_BYTES.get(cfg.compute_dtype, 4)
    return mult * dit_mod.tokens_for_mode(cfg, mode) * cfg.d_model * n_bytes


def schedule_cached_flops(cfg: ModelConfig, schedule: FlexiSchedule,
                          ts: np.ndarray, spec: CacheSpec, *,
                          cfg_scale_active: bool = True,
                          lora_unmerged: bool = False,
                          attn_backend: str = "dense"
                          ) -> Tuple[float, int, int]:
    """Denoising FLOPs of one batch-1 sample under ``spec``'s refresh
    policy (both CFG branches share the request's staleness clock).
    Unmerged-LoRA overhead scales with the blocks that actually run:
    full on refresh, the shallow ``split/L`` share on skip. Returns
    ``(flops, n_refresh, n_steps)``."""
    split = spec.resolve_split(cfg.num_layers)
    mult = 2.0 if cfg_scale_active else 1.0
    skip_frac = split / cfg.num_layers
    total, n_refresh, n_steps = 0.0, 0, 0
    for mode, tsub in schedule.split_timesteps(np.asarray(ts)):
        mask = refresh_mask(spec, tsub)
        lora = lora_nfe_overhead(cfg, mode) if lora_unmerged else 0.0
        for rf in mask:
            total += mult * (cached_nfe_flops(cfg, mode, split, bool(rf),
                                              attn_backend=attn_backend)
                             + lora * (1.0 if rf else skip_frac))
        n_refresh += int(mask.sum())
        n_steps += len(mask)
    return total, n_refresh, n_steps


def cache_savings(cfg: ModelConfig, schedule: FlexiSchedule, ts: np.ndarray,
                  spec: CacheSpec, *, cfg_scale_active: bool = True
                  ) -> Dict[str, float]:
    """FLOPs ledger of a cached run vs its own uncached baseline (same
    schedule, same T): absolute FLOPs, the saved fraction, and the
    realized refresh rate."""
    cached, n_refresh, n_steps = schedule_cached_flops(
        cfg, schedule, ts, spec, cfg_scale_active=cfg_scale_active)
    base = schedule_flops(cfg, schedule, cfg_scale_active=cfg_scale_active)
    return {"flops": cached, "flops_uncached": base,
            "flops_saved_frac": 1.0 - cached / base if base else 0.0,
            "refresh_rate": n_refresh / n_steps if n_steps else 1.0,
            "n_refresh": float(n_refresh), "n_steps": float(n_steps)}


def store_bytes(cfg: ModelConfig, slot_counts: Dict[int, int],
                guided: bool = True) -> int:
    """Total bytes a :class:`~repro_torch.cache.store.CacheStore` holds for
    ``{mode: n_slots}``."""
    return sum(n * delta_bytes(cfg, m, guided)
               for m, n in slot_counts.items())
