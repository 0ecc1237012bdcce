"""Analytic FLOPs of dense vs block-sparse attention, priced from the same
block-map code the kernel's wrapper runs (``kernels.attention.mask``), on
the host with numpy. Counts are per layer, batch 1, mul+add counted
separately, as in ``core.scheduler``."""
from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np

from repro_torch.kernels.attention.mask import attention_block_map

# The flash_attention defaults: the ledger prices a default launch.
DEFAULT_BLOCK_Q = 128
DEFAULT_BLOCK_K = 128


def effective_blocks(S: int, block_q: int = DEFAULT_BLOCK_Q,
                     block_k: int = DEFAULT_BLOCK_K) -> Tuple[int, int]:
    """The (block_q, block_k) the block map of an S-token launch uses."""
    return min(block_q, S), min(block_k, S)


def dense_attention_flops(n_q: int, n_k: int, d_model: int) -> float:
    """QK^T + PV over full [n_q, n_k] scores (one layer, all heads)."""
    return float(2 * 2 * n_q * n_k * d_model)


def segments_to_ids(seg_lengths: Sequence[int], capacity: int) -> np.ndarray:
    """One packed row's segment ids [1, capacity]: segments in order,
    -1 padding to capacity."""
    total = int(sum(seg_lengths))
    if total > capacity:
        raise ValueError(f"segments ({total} tokens) exceed row capacity "
                         f"{capacity}")
    ids = np.full((1, capacity), -1, np.int32)
    off = 0
    for s, n in enumerate(seg_lengths):
        ids[0, off:off + n] = s
        off += n
    return ids


def block_map_counts(seg_ids: np.ndarray, *, block_q: int = DEFAULT_BLOCK_Q,
                     block_k: int = DEFAULT_BLOCK_K, causal: bool = False,
                     window: int = 0) -> Tuple[int, int, int, int]:
    """(active, total, bq, bk) block visits for [B, S] segment ids, padded
    to block multiples as the wrapper pads them."""
    B, S = seg_ids.shape
    bq, bk = effective_blocks(S, block_q, block_k)

    def padded(ids, b):
        pad = (-S) % b
        if not pad:
            return ids
        return np.concatenate([ids, np.full((B, pad), -1, np.int32)], axis=1)

    bm = attention_block_map(padded(seg_ids, bq), padded(seg_ids, bk),
                             block_q=bq, block_k=bk, causal=causal,
                             window=window)
    return int(bm.sum()), int(bm.size), bq, bk


def block_sparse_attention_flops(seg_lengths: Sequence[int], capacity: int,
                                 d_model: int, *,
                                 block_q: int = DEFAULT_BLOCK_Q,
                                 block_k: int = DEFAULT_BLOCK_K) -> float:
    """Score/value FLOPs (one layer) of one packed row: 4·d per visited
    (block_q · block_k) score tile."""
    ids = segments_to_ids(seg_lengths, capacity)
    active, _total, bq, bk = block_map_counts(ids, block_q=block_q,
                                              block_k=block_k)
    return float(active) * dense_attention_flops(bq, bk, d_model)


def pack_attention_stats(row_seg_lengths: Sequence[Sequence[int]],
                         capacity: int, *,
                         block_q: int = DEFAULT_BLOCK_Q,
                         block_k: int = DEFAULT_BLOCK_K
                         ) -> Tuple[int, int]:
    """(active, total) block visits for a whole pack, one entry per row,
    each a list of segment lengths. ``1 - active/total`` is the skip rate
    ``serving.metrics`` reports per engine step."""
    active = total = 0
    for lengths in row_seg_lengths:
        ids = segments_to_ids(lengths, capacity)
        a, t, _bq, _bk = block_map_counts(ids, block_q=block_q,
                                          block_k=block_k)
        active += a
        total += t
    return active, total
