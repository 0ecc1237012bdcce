"""Attention-mask algebra shared by the flash kernel's wrapper, its plain
version and the dense DiT path, on torch tensors or numpy arrays.

* :func:`segment_allowed` — tokens attend only within their segment; ids
  < 0 mark padding, which neither attends nor is attended to.
* :func:`position_allowed` — causal / sliding-window mask (``window`` 0
  means no window).
* :func:`attention_block_map` — the per-(q block, k block) int32 map the
  kernel uses to skip kv tiles whose segment range cannot meet the query
  block's: exact for row-sorted segment ids, a superset otherwise.
"""
from __future__ import annotations

import functools
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.runtime import graphs

_BIG = int(np.iinfo(np.int32).max)


def _is_torch(*arrays) -> bool:
    return any(isinstance(a, torch.Tensor) for a in arrays)


def segment_allowed(q_seg, k_seg):
    """[..., Sq] x [..., Sk] segment ids → [..., Sq, Sk] bool allowed."""
    qs = q_seg[..., :, None]
    ks = k_seg[..., None, :]
    return (qs == ks) & (qs >= 0) & (ks >= 0)


def position_allowed_grid(q_pos, k_pos, *, causal: bool, window: int = 0):
    """Elementwise position mask over broadcast-compatible position grids."""
    window = int(window)
    if window > 0:
        allowed = (q_pos - k_pos < window) & (k_pos - q_pos < window)
    elif _is_torch(q_pos, k_pos):
        allowed = torch.ones(torch.broadcast_shapes(q_pos.shape, k_pos.shape),
                             dtype=torch.bool, device=q_pos.device)
    else:
        allowed = np.ones(np.broadcast_shapes(q_pos.shape, k_pos.shape), bool)
    if causal:
        allowed = allowed & (q_pos >= k_pos)
    return allowed


def position_allowed(q_pos, k_pos, *, causal: bool, window: int = 0):
    """[..., Sq] x [..., Sk] positions → [..., Sq, Sk] bool allowed."""
    return position_allowed_grid(q_pos[..., :, None], k_pos[..., None, :],
                                 causal=causal, window=window)


def _block_seg_ranges(seg, block: int):
    """[B, S] ids → per-block (min, max) over real (id >= 0) tokens; a block
    with no real token gets the empty interval (BIG, -1)."""
    B, S = seg.shape
    assert S % block == 0, (S, block)
    tiles = seg.reshape(B, S // block, block)
    if _is_torch(seg):
        lo = torch.where(tiles >= 0, tiles, _BIG).amin(dim=2)
        hi = torch.where(tiles >= 0, tiles, -1).amax(dim=2)
    else:
        lo = np.where(tiles >= 0, tiles, np.int32(_BIG)).min(axis=2)
        hi = np.where(tiles >= 0, tiles, -1).max(axis=2)
    return lo, hi


def block_position_envelope(n_q: int, n_k: int, block_q: int, block_k: int, *,
                            causal: bool, window: int = 0) -> np.ndarray:
    """Static [n_q, n_k] bool: can ANY (q, k) pair of the block pair be
    position-visible?"""
    q_lo = np.arange(n_q) * block_q
    q_hi = q_lo + block_q - 1
    k_lo = np.arange(n_k) * block_k
    k_hi = k_lo + block_k - 1
    env = np.ones((n_q, n_k), bool)
    if causal:
        env &= q_hi[:, None] >= k_lo[None, :]
    if int(window) > 0:
        w = int(window)
        env &= (q_lo[:, None] - k_hi[None, :] < w) \
            & (k_lo[None, :] - q_hi[:, None] < w)
    return env


@functools.lru_cache(maxsize=256)
def _device_envelope(n_q: int, n_k: int, block_q: int, block_k: int,
                     causal: bool, window: int,
                     device: torch.device) -> torch.Tensor:
    """:func:`block_position_envelope` on ``device``, copied there once
    (no host copy inside a captured runner)."""
    env = block_position_envelope(n_q, n_k, block_q, block_k, causal=causal,
                                  window=window)
    with torch.inference_mode(False):
        return torch.from_numpy(env).to(device)


def attention_block_map(q_seg, k_seg, *, block_q: int, block_k: int,
                        causal: bool = False, window: int = 0):
    """[B, Sq] x [B, Sk] segment ids (block multiples) → [B, n_q, n_k]
    int32 block map (1 = visit, 0 = provably fully masked)."""
    q_lo, q_hi = _block_seg_ranges(q_seg, block_q)
    k_lo, k_hi = _block_seg_ranges(k_seg, block_k)
    active = ((q_lo[:, :, None] <= k_hi[:, None, :])
              & (k_lo[:, None, :] <= q_hi[:, :, None]))
    env = block_position_envelope(q_lo.shape[1], k_lo.shape[1],
                                  block_q, block_k,
                                  causal=causal, window=window)
    if _is_torch(q_seg, k_seg):
        env_t = _device_envelope(q_lo.shape[1], k_lo.shape[1], block_q,
                                 block_k, bool(causal), int(window),
                                 q_seg.device)
        graphs.hold(env_t)
        return (active & env_t[None]).to(torch.int32)
    return (active & env[None]).astype(np.int32)


def pad_to_block_multiple(seg: Optional[torch.Tensor], B: int, S: int,
                          block: int, device=None) -> Tuple[torch.Tensor, int]:
    """Segment ids padded to a block multiple (-1 = padding), all zeros
    when none were given. Returns (ids [B, S_pad] int32, S_pad)."""
    target = -(-S // block) * block
    if seg is None:
        seg = torch.zeros((B, S), dtype=torch.int32, device=device)
    seg = seg.to(torch.int32)
    if target != S:
        pad = torch.full((B, target - S), -1, dtype=torch.int32,
                         device=seg.device)
        seg = torch.cat([seg, pad], dim=1)
    return seg, target
