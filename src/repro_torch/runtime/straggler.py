"""Straggler mitigation for the synchronous-SPMD data path — the port's
own copy of ``repro.runtime.straggler`` (numpy only).

In a synchronous data-parallel step every device waits for the slowest
participant, so the lever is *upstream of the step*: detect persistently
slow data workers and rebalance their shards (or schedule backup
fetches). The detector keeps an EWMA of per-worker step times and flags
anything beyond ``threshold ×`` the median; the balancer reassigns shard
counts inversely proportional to observed speed.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np


@dataclasses.dataclass
class StragglerReport:
    step: int
    stragglers: List[int]
    median_ms: float
    worst_ms: float


class StragglerDetector:
    def __init__(self, n_workers: int, threshold: float = 2.0,
                 ewma: float = 0.7):
        self.n = n_workers
        self.threshold = threshold
        self.ewma = ewma
        self.times = np.zeros(n_workers)
        self.seen = np.zeros(n_workers, bool)

    def record(self, worker_id: int, ms: float):
        if self.seen[worker_id]:
            self.times[worker_id] = (self.ewma * self.times[worker_id]
                                     + (1 - self.ewma) * ms)
        else:
            self.times[worker_id] = ms
            self.seen[worker_id] = True

    def report(self, step: int) -> StragglerReport:
        active = self.times[self.seen]
        med = float(np.median(active)) if active.size else 0.0
        stragglers = [i for i in range(self.n)
                      if self.seen[i] and med > 0
                      and self.times[i] > self.threshold * med]
        worst = float(self.times[self.seen].max()) if active.size else 0.0
        return StragglerReport(step, stragglers, med, worst)


def rebalance_shards(n_shards: int, worker_times_ms: np.ndarray
                     ) -> List[int]:
    """Assign shard counts ∝ 1/time so the slowest worker stops gating the
    step. Always ≥1 shard per worker; deterministic largest-remainder split."""
    speed = 1.0 / np.maximum(np.asarray(worker_times_ms, float), 1e-6)
    frac = speed / speed.sum() * n_shards
    base = np.maximum(np.floor(frac).astype(int), 1)
    while base.sum() > n_shards:
        base[np.argmax(base)] -= 1
    rem = n_shards - base.sum()
    order = np.argsort(-(frac - np.floor(frac)))
    for i in range(rem):
        base[order[i % len(order)]] += 1
    return base.tolist()


def backup_request_schedule(pending_ms, deadline_ms: float) -> List[int]:
    """Hedged-request policy: workers predicted to miss the step deadline
    get a backup fetch scheduled on the fastest idle worker. Accepts any
    array-like (the fleet health layer passes plain host lists)."""
    pending = np.asarray(pending_ms, float)
    return [int(i) for i in np.nonzero(pending > deadline_ms)[0]]
