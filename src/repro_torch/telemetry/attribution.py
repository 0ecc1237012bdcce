"""Per-request served-cost attribution, the port of
``repro.telemetry.attribution`` (host arithmetic, kept as the port's own
copy).

Splits each packed dispatch's measured cost — wall-clock, FLOPs, bytes —
across the requests in the pack by their
block-granular analytic ledger share (attention-skip- and
cache-refresh-aware weights computed by the engine), producing
per-request :class:`ServedCost` records with an **exact conservation
property**: for every dispatch, the attributed integer shares sum to
precisely the dispatch total. Dummy-slot padding and dispatch-wide
overhead (the deep blocks run for everyone when anyone refreshes) smear proportionally over the real requests — that
*is* the attribution: a request is charged for the hardware cost its
presence in the pack implied, not only its private arithmetic.

Exactness is engineered, not hoped for: totals are attributed as
integers (wall in nanoseconds, FLOPs and bytes as integer counts) via
largest-remainder apportionment (:func:`exact_shares`), so conservation
is integer equality — no float non-associativity, no epsilon.

This module is deliberately **host-pure**: no torch, no numpy, no device
values. It runs on the serving hot path after each dispatch, so it can
never force a device sync.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Deque, Dict, List, Optional, Sequence, Tuple


def exact_shares(total: int, weights: Sequence[float]) -> List[int]:
    """Apportion integer ``total`` across ``weights`` by the
    largest-remainder method. The returned shares are non-negative ints
    summing EXACTLY to ``total``; zero/degenerate weights fall back to
    an equal split. Ties in fractional remainder break toward earlier
    indices (deterministic)."""
    n = len(weights)
    if n == 0:
        return []
    wsum = float(sum(w for w in weights if w > 0))
    if wsum <= 0:
        weights = [1.0] * n
        wsum = float(n)
    quotas = [total * max(float(w), 0.0) / wsum for w in weights]
    shares = [int(q) for q in quotas]
    leftover = total - sum(shares)
    # leftover in [0, n): hand one unit each to the largest remainders
    order = sorted(range(n), key=lambda i: (shares[i] - quotas[i], i))
    for i in range(leftover):
        shares[order[i]] += 1
    return shares


@dataclasses.dataclass
class ServedCost:
    """What serving one request actually cost, measured."""
    request_id: int
    flops: int = 0                  # attributed analytic FLOPs
    bytes: int = 0                  # attributed bytes (0: not counted)
    wall_ns: int = 0                # attributed dispatch wall-clock
    dispatches: int = 0             # packed dispatches this request rode
    queue_wait_s: float = 0.0       # arrival -> admission
    budget: Optional[str] = None

    @property
    def wall_ms(self) -> float:
        return self.wall_ns / 1e6


@dataclasses.dataclass
class DispatchRecord:
    """One dispatch's attribution, kept (bounded) for the post-mortem
    bundle and the bench conservation check."""
    time: float
    label: str
    wall_ns: int
    flops: int
    bytes: int
    request_ids: Tuple[int, ...]
    shares_wall_ns: Tuple[int, ...]
    shares_flops: Tuple[int, ...]
    shares_bytes: Tuple[int, ...]

    @property
    def conserved(self) -> bool:
        return (sum(self.shares_wall_ns) == self.wall_ns
                and sum(self.shares_flops) == self.flops
                and sum(self.shares_bytes) == self.bytes)


class AttributionLedger:
    """Accumulates per-request attributed cost across dispatches and
    finalizes a :class:`ServedCost` when the request retires."""

    def __init__(self, max_dispatch_records: int = 1024):
        self._open: Dict[int, ServedCost] = {}
        self.finalized: Dict[int, ServedCost] = {}
        self.dispatches: Deque[DispatchRecord] = deque(
            maxlen=max_dispatch_records)
        self.total_wall_ns = 0
        self.total_flops = 0
        self.total_bytes = 0

    def attribute_dispatch(self, *, time: float, label: str,
                           request_ids: Sequence[int],
                           weights: Sequence[float], wall_ns: int,
                           flops: int,
                           bytes_: int = 0) -> DispatchRecord:
        """Split one dispatch's totals over ``request_ids`` by
        ``weights`` (each request's refresh-aware analytic cost share).
        Conservation per component is exact by construction."""
        sw = exact_shares(int(wall_ns), weights)
        sf = exact_shares(int(flops), weights)
        sb = exact_shares(int(bytes_), weights)
        for rid, w_ns, fl, by in zip(request_ids, sw, sf, sb):
            cost = self._open.get(rid)
            if cost is None:
                cost = self._open[rid] = ServedCost(request_id=rid)
            cost.wall_ns += w_ns
            cost.flops += fl
            cost.bytes += by
            cost.dispatches += 1
        self.total_wall_ns += int(wall_ns)
        self.total_flops += int(flops)
        self.total_bytes += int(bytes_)
        rec = DispatchRecord(
            time=time, label=label, wall_ns=int(wall_ns),
            flops=int(flops), bytes=int(bytes_),
            request_ids=tuple(request_ids),
            shares_wall_ns=tuple(sw), shares_flops=tuple(sf),
            shares_bytes=tuple(sb))
        self.dispatches.append(rec)
        return rec

    def finalize(self, request_id: int, *, queue_wait_s: float = 0.0,
                 budget: Optional[str] = None) -> ServedCost:
        """Close out a retiring request's record (idempotent — a request
        that never rode a dispatch finalizes to zeros)."""
        cost = self._open.pop(request_id, None)
        if cost is None:
            cost = self.finalized.get(request_id,
                                      ServedCost(request_id=request_id))
        cost.queue_wait_s = queue_wait_s
        cost.budget = budget
        self.finalized[request_id] = cost
        return cost

    # -- conservation & reporting --------------------------------------

    def conservation(self) -> Dict[str, int]:
        """Ledger-wide conservation check: attributed totals (open +
        finalized) vs dispatch totals. All deltas are exactly 0 by
        construction; the tests assert it."""
        att_wall = att_flops = att_bytes = 0
        for cost in list(self._open.values()) + list(
                self.finalized.values()):
            att_wall += cost.wall_ns
            att_flops += cost.flops
            att_bytes += cost.bytes
        return {
            "wall_ns_delta": att_wall - self.total_wall_ns,
            "flops_delta": att_flops - self.total_flops,
            "bytes_delta": att_bytes - self.total_bytes,
        }

    def snapshot(self) -> Dict[str, object]:
        """Flight-recorder view: totals, open requests, recent
        dispatch records."""
        return {
            "totals": {"wall_ns": self.total_wall_ns,
                       "flops": self.total_flops,
                       "bytes": self.total_bytes},
            "conservation": self.conservation(),
            "open": {rid: dataclasses.asdict(c)
                     for rid, c in self._open.items()},
            "n_finalized": len(self.finalized),
            "recent_dispatches": [
                {"time": d.time, "label": d.label, "wall_ns": d.wall_ns,
                 "flops": d.flops, "bytes": d.bytes,
                 "request_ids": list(d.request_ids)}
                for d in list(self.dispatches)[-32:]],
        }
