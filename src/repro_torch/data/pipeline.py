"""Deterministic synthetic data pipelines with host-sharded loading and
background prefetch — the port's own copy of ``repro.data.pipeline``
(numpy only, so the same seed yields the same arrays in both packages).

Batches are numpy; the trainer moves each one to its device. Real
deployments swap ``*_batch`` for array-record/TFDS readers; the
sharding/prefetch/straggler plumbing stays identical.
"""
from __future__ import annotations

import queue
import threading
from typing import Any, Callable, Dict, Iterator, Optional, Tuple

import numpy as np


class HostShardedLoader:
    """Splits the global batch across data-parallel hosts and prefetches.

    ``make_batch(step, shard_id, n_shards, rng)`` returns this host's shard.
    """

    def __init__(self, make_batch: Callable[..., Dict[str, np.ndarray]],
                 shard_id: int = 0, n_shards: int = 1, seed: int = 0,
                 prefetch: int = 2):
        self.make_batch = make_batch
        self.shard_id = shard_id
        self.n_shards = n_shards
        self.seed = seed
        self._q: "queue.Queue" = queue.Queue(maxsize=max(1, prefetch))
        self._step = 0
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self):
        step = 0
        while not self._stop.is_set():
            rng = np.random.default_rng(
                (self.seed * 1_000_003 + step) * 65_537 + self.shard_id)
            batch = self.make_batch(step, self.shard_id, self.n_shards, rng)
            self._q.put(batch)
            step += 1

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        return self

    def __next__(self) -> Dict[str, np.ndarray]:
        return self._q.get()

    def close(self):
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass


# ---------------------------------------------------------------------------
# LM synthetic corpus: a deterministic Markov-ish token stream so the loss
# has learnable structure (bigram statistics), not uniform noise.


def make_lm_batch_fn(vocab: int, seq_len: int, global_batch: int,
                     structure: int = 16):
    def make_batch(step, shard, n_shards, rng):
        b = global_batch // n_shards
        base = rng.integers(0, vocab, size=(b, seq_len + 1), dtype=np.int32)
        # inject learnable bigram structure: every token at even positions
        # determines the next token modulo `structure`.
        nxt = (base[:, :-1] * 31 + 7) % max(1, vocab // structure)
        mask = (np.arange(seq_len) % 2 == 0)[None, :]
        tok = base.copy()
        tok[:, 1:] = np.where(mask, nxt, base[:, 1:])
        return {"tokens": tok[:, :-1], "targets": tok[:, 1:]}
    return make_batch


# ---------------------------------------------------------------------------
# DiT synthetic latents: class-dependent low-frequency patterns + noise, so
# FID-proxies and weak/powerful comparisons have real signal.


def class_pattern(c: int, latent_shape: Tuple[int, int, int, int],
                  seed: int = 1234, hf_scale: float = 0.4) -> np.ndarray:
    """Class-dependent pattern = low-frequency structure + class-specific
    HIGH-frequency detail (so coarse-patch weak models genuinely cannot
    represent everything — required for the Fig. 4 / spectral claims to be
    observable at toy scale)."""
    F, H, W, C = latent_shape
    rng = np.random.default_rng(seed + c)
    low = rng.normal(size=(max(1, F // 2), max(2, H // 4), max(2, W // 4), C))
    reps = (-(-F // low.shape[0]), -(-H // low.shape[1]),
            -(-W // low.shape[2]), 1)
    up = np.kron(low, np.ones((reps[0], reps[1], reps[2], 1)))[:F, :H, :W]
    hf = rng.normal(size=(F, H, W, C))          # pixel-rate detail
    checker = ((np.arange(H)[None, :, None, None]
                + np.arange(W)[None, None, :, None]) % 2) * 2.0 - 1.0
    return (up + hf_scale * hf * checker).astype(np.float32)


def make_dit_batch_fn(latent_shape, num_classes: int, global_batch: int,
                      noise_scale: float = 0.25):
    def make_batch(step, shard, n_shards, rng):
        b = global_batch // n_shards
        cond = rng.integers(0, num_classes, size=(b,), dtype=np.int32)
        x0 = np.stack([class_pattern(int(c), latent_shape) for c in cond])
        x0 = x0 + noise_scale * rng.normal(size=x0.shape).astype(np.float32)
        return {"x0": x0, "cond": cond}
    return make_batch


def make_text_cond_batch_fn(latent_shape, text_len: int, text_dim: int,
                            global_batch: int, n_concepts: int = 32):
    """T2I synthetic pairs: the text embedding is a fixed random projection
    of the class concept that also drives the image pattern."""
    rng0 = np.random.default_rng(999)
    concept_emb = rng0.normal(size=(n_concepts, text_len, text_dim)) \
        .astype(np.float32)

    def make_batch(step, shard, n_shards, rng):
        b = global_batch // n_shards
        cid = rng.integers(0, n_concepts, size=(b,), dtype=np.int32)
        x0 = np.stack([class_pattern(int(c), latent_shape, seed=777)
                       for c in cid])
        x0 = x0 + 0.25 * rng.normal(size=x0.shape).astype(np.float32)
        return {"x0": x0, "cond": concept_emb[cid], "concept": cid}
    return make_batch
