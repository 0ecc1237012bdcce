"""Serving metrics, the port of ``repro.serving.metrics`` (host-pure).

Tracks per-request lifecycle (arrival → admit → finish, requested vs
served budget, deadline) and per-step token ledgers (real segment tokens
vs what the packed layout computed). All timestamps come from the
engine's clock; percentiles are computed at summary time so a simulated
clock gives deterministic numbers.
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Dict, Optional

import numpy as np


@dataclasses.dataclass
class RequestRecord:
    id: int
    arrival: float
    admit: float
    finish: float
    deadline: float
    budget_requested: float
    budget_served: float
    tokens: int                  # useful token-steps this request consumed
    flops: float

    @property
    def latency(self) -> float:
        return self.finish - self.arrival

    @property
    def met_deadline(self) -> bool:
        return self.finish <= self.deadline

    @property
    def degraded(self) -> bool:
        return self.budget_served < self.budget_requested


@dataclasses.dataclass
class StepRecord:
    time: float
    real_tokens: int             # tokens belonging to live requests
    packed_tokens: int           # rows x capacity the hardware computed
    n_requests: int


class ServingMetrics:
    """Lifetime counters plus a bounded sliding window of recent records:
    an engine serving indefinitely must not grow memory per step, and
    percentiles should reflect recent traffic, not the process lifetime.
    ``window=None`` keeps everything (fine for tests and benches)."""

    def __init__(self, window: Optional[int] = 8192):
        self.requests: collections.deque = collections.deque(maxlen=window)
        self.steps: collections.deque = collections.deque(maxlen=window)
        self.total_served = 0
        self.total_steps = 0
        self.total_request_steps = 0   # request-dispatches (Σ cohort sizes)
        self.total_tokens = 0
        self.total_flops = 0.0
        self.total_degraded = 0
        # activation-cache ledger: refresh vs skip
        # request-steps, a refresh-interval histogram (gap in denoise
        # steps between consecutive refreshes), and a bytes-resident
        # gauge fed by the engine's CacheStore
        self.cache_refreshes = 0
        self.cache_skips = 0
        self.cache_bytes_resident = 0
        self.refresh_interval_hist: collections.Counter = \
            collections.Counter()
        # segment-aware attention ledger:
        # score-block tiles the flash kernel visited vs the dense grid —
        # the skip rate is packing's cross-segment work never issued
        self.attn_blocks_active = 0
        self.attn_blocks_total = 0
        # resilience ledger: terminal expiries,
        # non-finite quarantines (each one re-enqueued at full compute),
        # injected poisonings observed, transient slot-alloc failures
        # absorbed, and checksum-forced cache refreshes
        self.total_expired = 0
        self.total_quarantined = 0
        self.total_poisoned = 0
        self.total_alloc_failures = 0
        self.total_integrity_refreshes = 0

    def record_step(self, now: float, real_tokens: int, packed_tokens: int,
                    n_requests: int) -> None:
        self.steps.append(StepRecord(now, real_tokens, packed_tokens,
                                     n_requests))
        self.total_steps += 1
        self.total_request_steps += n_requests

    def record_request(self, rec: RequestRecord) -> None:
        self.requests.append(rec)
        self.total_served += 1
        self.total_tokens += rec.tokens
        self.total_flops += rec.flops
        self.total_degraded += int(rec.degraded)

    def record_cache(self, refreshes: int, skips: int) -> None:
        """One dispatch's refresh/skip request-step counts."""
        self.cache_refreshes += refreshes
        self.cache_skips += skips

    def record_attention_blocks(self, active: int, total: int) -> None:
        """One dispatch's attention block-tile ledger (active <= total)."""
        self.attn_blocks_active += int(active)
        self.attn_blocks_total += int(total)

    def set_cache_bytes(self, n_bytes: int) -> None:
        self.cache_bytes_resident = int(n_bytes)

    def record_refresh_intervals(self, intervals) -> None:
        """A retired request's realized refresh gaps (denoise steps)."""
        self.refresh_interval_hist.update(int(i) for i in intervals)

    # ------------------------------------------------------------------

    @property
    def packing_efficiency(self) -> float:
        """Real segment tokens / packed (computed) tokens, over all steps.
        1.0 means no row padding and no dummy slots."""
        packed = sum(s.packed_tokens for s in self.steps)
        return sum(s.real_tokens for s in self.steps) / packed if packed \
            else 1.0

    @property
    def attn_block_skip_rate(self) -> float:
        """Fraction of score-block tiles the segment-aware kernel skipped
        (cross-segment / padding blocks); 0.0 before any dispatch."""
        if not self.attn_blocks_total:
            return 0.0
        return 1.0 - self.attn_blocks_active / self.attn_blocks_total

    @property
    def cache_hit_rate(self) -> float:
        """Skipped (deep-block replay) request-steps / all cached
        request-steps; 0.0 before any cached dispatch."""
        total = self.cache_refreshes + self.cache_skips
        return self.cache_skips / total if total else 0.0

    def cache_summary(self) -> Dict[str, object]:
        """Activation-cache ledger view (json-friendly; the histogram
        maps refresh gap → count)."""
        return {
            "enabled": bool(self.cache_refreshes + self.cache_skips),
            "hit_rate": self.cache_hit_rate,
            "refreshes": self.cache_refreshes,
            "skips": self.cache_skips,
            "bytes_resident": self.cache_bytes_resident,
            "refresh_interval_hist": {
                str(k): v for k, v in
                sorted(self.refresh_interval_hist.items())},
        }

    def latency_percentiles(self, qs=(50, 99)) -> Dict[str, float]:
        """Latency percentiles over the window; empty window → empty
        dict (absent beats NaN: exporters and log lines just omit the
        keys instead of printing a poisoned value)."""
        if not self.requests:
            return {}
        lat = np.asarray([r.latency for r in self.requests])
        return {f"p{q}": float(np.percentile(lat, q)) for q in qs}

    def summary(self, wall: Optional[float] = None) -> Dict[str, float]:
        """Aggregate view; ``wall`` (seconds of serving) prices tokens/s.
        ``tokens`` counts only useful (real-request) token-steps, so the
        throughput number is directly comparable across batching
        strategies with different padding waste. Counts/tokens/FLOPs are
        lifetime totals; percentiles, hit rates, and packing efficiency
        cover the sliding window."""
        out: Dict[str, float] = {
            "served": float(self.total_served),
            "steps": float(self.total_steps),
            "tokens": float(self.total_tokens),
            "packing_efficiency": self.packing_efficiency,
            "degraded": float(self.total_degraded),
        }
        if self.requests:
            out.update(self.latency_percentiles())
            out["deadline_hit_rate"] = float(
                np.mean([r.met_deadline for r in self.requests]))
            out["flops"] = self.total_flops
        if self.cache_refreshes + self.cache_skips:
            out["cache_hit_rate"] = self.cache_hit_rate
            out["cache_bytes_resident"] = float(self.cache_bytes_resident)
        if self.attn_blocks_total:
            out["attn_block_skip_rate"] = self.attn_block_skip_rate
        # resilience counters appear only once the corresponding event
        # class has occurred, keeping the summary key set stable for
        # clean runs
        if self.total_expired:
            out["expired"] = float(self.total_expired)
        if self.total_quarantined:
            out["quarantined"] = float(self.total_quarantined)
        if self.total_poisoned:
            out["poisoned"] = float(self.total_poisoned)
        if self.total_alloc_failures:
            out["alloc_failures"] = float(self.total_alloc_failures)
        if self.total_integrity_refreshes:
            out["integrity_refreshes"] = float(self.total_integrity_refreshes)
        if wall is not None:
            # wall_s always reports what was passed; rates only when the
            # denominator is meaningful (a zero-wall snapshot — e.g. a
            # simulated clock that has not advanced — must not divide)
            out["wall_s"] = float(wall)
            if wall > 0:
                out["tokens_per_s"] = self.total_tokens / wall
                out["requests_per_s"] = self.total_served / wall
        return out
