"""Fleet health: straggler down-weighting + hedged re-dispatch — HOST-PURE;
the port's copy of ``repro.fleet.health``.

Wires :mod:`repro_torch.runtime.straggler` into routing. Every pump of a
replica engine reports its dispatch wall time (virtual or measured
milliseconds) to a :class:`StragglerDetector`; routing then multiplies
each replica's placement score by ``weight = clamp(ewma / median, 1,
max_weight)`` so persistently slow replicas receive proportionally less
new work — smooth degradation, with the detector's ``threshold x
median`` flag reserved for the health report.

Hedging: for deadline-critical requests stuck on a slow replica the
fleet computes a *lateness* estimate (predicted finish minus deadline)
and :func:`runtime.straggler.backup_request_schedule` picks which ones
get a backup copy submitted to the fastest admitting replica — same
seed, so whichever copy lands first yields the identical sample and
the loser is dropped at completion (first-wins dedup in the router).

This module does the *policy* arithmetic only; the numpy-backed EWMA
lives in ``runtime.straggler`` (host arrays, no device work). Like the
other fleet control modules it imports no torch and no numpy and makes
no device syncs.
"""
from __future__ import annotations

from typing import Dict, List, Sequence

from repro_torch.runtime.straggler import (StragglerDetector, StragglerReport,
                                     backup_request_schedule)


class FleetHealth:
    """Per-replica dispatch-time EWMA -> routing weights + hedge picks."""

    def __init__(self, n_replicas: int, *, threshold: float = 2.0,
                 ewma: float = 0.7, max_weight: float = 4.0):
        self.detector = StragglerDetector(n_replicas, threshold=threshold,
                                          ewma=ewma)
        self.max_weight = max_weight
        self._ticks = 0

    def grow(self, n_replicas: int) -> None:
        """Widen to ``n_replicas`` (a joined replica starts unseen —
        weight 1.0 until it reports)."""
        if n_replicas <= self.detector.n:
            return
        old = self.detector
        new = StragglerDetector(n_replicas, threshold=old.threshold,
                                ewma=old.ewma)
        for i in range(old.n):
            if old.seen[i]:
                new.times[i] = old.times[i]
                new.seen[i] = True
        self.detector = new

    def record_dispatch(self, rid: int, wall_ms: float) -> None:
        self.detector.record(rid, wall_ms)

    def report(self) -> StragglerReport:
        self._ticks += 1
        return self.detector.report(self._ticks)

    def weights(self) -> Dict[int, float]:
        """Routing multiplier per replica: EWMA time over the fleet
        median, clamped to [1, max_weight]. Unseen replicas (just
        joined, never dispatched) route at 1.0."""
        rep = self.detector.report(self._ticks)
        out: Dict[int, float] = {}
        for i in range(self.detector.n):
            w = 1.0
            if self.detector.seen[i] and rep.median_ms > 0:
                w = min(max(float(self.detector.times[i]) / rep.median_ms,
                            1.0), self.max_weight)
            out[i] = w
        return out

    def ewma_ms(self, rid: int) -> float:
        """This replica's smoothed dispatch wall (0.0 before any
        report) — the fleet's per-request finish predictor."""
        if rid < self.detector.n and self.detector.seen[rid]:
            return float(self.detector.times[rid])
        return 0.0

    def hedge_candidates(self, request_ids: Sequence[int],
                         lateness_ms: Sequence[float]
                         ) -> List[int]:
        """Which of ``request_ids`` deserve a backup copy: exactly the
        seed hedged-request policy, applied to predicted lateness
        (``predicted_finish - deadline`` in ms; positive = will miss)."""
        if not request_ids:
            return []
        idx = backup_request_schedule(list(lateness_ms), 0.0)
        return [request_ids[i] for i in idx]
