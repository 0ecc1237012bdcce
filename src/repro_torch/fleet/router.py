"""Fleet request router — HOST-PURE; the port's copy of
``repro.fleet.router``.

One front door, N replica engines. The router owns the fleet-level
request ledger and the placement decision; the per-replica admission
queues live inside the engines themselves (a placement is an
``engine.submit`` by the fleet). Everything here is plain host
bookkeeping: a request's randomness (its ``key``) passes through as an
opaque object, timestamps come from the caller's clock, and the module
stays host-pure (no torch, no numpy, no device syncs;
``tests/test_torch_fleet.py`` checks the imports) — routing runs once
per scheduling round on the serving hot path.

Placement scoring (policy ``cheapest``)::

    score(replica) = (backlog_seconds + price_seconds[level]) * weight

``backlog_seconds`` is the replica's priced queue+in-flight work and
``price_seconds`` the per-level cost, both in the replica
``BudgetController``'s calibrated seconds (measured wall-per-FLOP);
``weight >= 1`` is the straggler down-weight from ``fleet.health``. The
``affinity`` policy additionally pins a request to its *home* replica —
the replica that first dispatched it, where its ``CacheStore`` slots
live — and shards fresh requests by class label so repeat conditions
land together; ``rr`` is round-robin over admitting replicas.

Cache affinity is measured per request-dispatch: every dispatch runs on
the replica owning the request's cache slots *except* the first dispatch
after a placement that abandoned established state (a dead replica's
re-admission, which forces a refresh). So
``hit_rate = 1 - state_readmits / total_request_dispatches``; handing
back a still-queued request (drain) moves no state and costs nothing.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional

ROUTER_POLICIES = ("cheapest", "affinity", "rr")


@dataclasses.dataclass
class FleetRequest:
    """Fleet-level lifecycle record; ``key`` is what seeds the request's
    randomness (opaque here; the fleet's engine ``submit`` keywords) — it
    rides through every re-admission, so a restarted request reproduces
    the uninterrupted trajectory bit-for-bit."""
    rid: int
    cond: int
    budget: float
    deadline: float
    key: Any
    arrival: float
    state: str = "pending"        # pending | placed | done | expired
    owner: int = -1               # replica currently responsible
    engine_id: int = -1           # request id inside the owner's engine
    home: int = -1                # affinity home (first placement)
    dispatched: bool = False      # has device/cache state on the owner
    placements: int = 0
    handbacks: int = 0            # drain handbacks (stateless)
    readmits: int = 0             # death re-admissions (state lost)
    hedged: bool = False
    hedge_owner: int = -1
    hedge_engine_id: int = -1
    served_by: int = -1
    done_at: float = math.nan
    # quarantine escalation: a non-finite latent
    # re-admits the request at the most powerful level; ``not_before``
    # is its deadline-aware backoff gate for the next placement round
    retries: int = 0
    escalated: bool = False
    not_before: float = 0.0


@dataclasses.dataclass
class ReplicaView:
    """One replica's routing snapshot for a placement round. Mutable on
    purpose: the router charges each placement's price onto the view's
    backlog so a burst placed in one round spreads instead of piling
    onto whoever was cheapest at the round's start."""
    rid: int
    admitting: bool
    backlog_seconds: float
    prices: Dict[float, float]    # menu level -> calibrated seconds
    weight: float = 1.0           # straggler down-weight (>= 1 is slow)

    def score(self, level: float) -> float:
        return (self.backlog_seconds
                + self.prices.get(level, 0.0)) * self.weight


class Router:
    """Placement policy + fleet request ledger."""

    def __init__(self, policy: str = "cheapest"):
        if policy not in ROUTER_POLICIES:
            raise ValueError(f"unknown router policy {policy!r}; known: "
                             f"{ROUTER_POLICIES}")
        self.policy = policy
        self.requests: Dict[int, FleetRequest] = {}
        self._pending: List[int] = []
        self._next_id = 0
        self._rr = 0
        # affinity / churn counters (see module docstring for hit rate)
        self.placements = 0
        self.affine_placements = 0
        self.state_readmits = 0
        self.handbacks = 0
        self.hedges = 0
        self.hedge_wins = 0
        # resilience counters
        self.escalations = 0
        self.escalation_overflows = 0
        self.expirations = 0

    # ------------------------------------------------------------------
    # Ledger

    def register(self, cond: int, budget: float, deadline: float,
                 key: Any, now: float) -> FleetRequest:
        req = FleetRequest(rid=self._next_id, cond=int(cond),
                           budget=float(budget), deadline=deadline,
                           key=key, arrival=now)
        self._next_id += 1
        self.requests[req.rid] = req
        self._pending.append(req.rid)
        return req

    def pending(self, now: Optional[float] = None) -> List[FleetRequest]:
        """Routable pending requests; with ``now`` given, requests still
        inside their escalation backoff window are held back."""
        reqs = [self.requests[r] for r in self._pending]
        if now is None:
            return reqs
        return [r for r in reqs if r.not_before <= now]

    @property
    def n_pending(self) -> int:
        return len(self._pending)

    def unfinished(self) -> List[FleetRequest]:
        return [r for r in self.requests.values()
                if r.state not in ("done", "expired")]

    # ------------------------------------------------------------------
    # Placement

    def _choose(self, req: FleetRequest, views: List[ReplicaView],
                level: float) -> ReplicaView:
        live = sorted((v for v in views if v.admitting),
                      key=lambda v: v.rid)
        if not live:
            raise RuntimeError("no admitting replica to place on")
        if self.policy == "rr":
            v = live[self._rr % len(live)]
            self._rr += 1
            return v
        cheapest = min(live, key=lambda v: (v.score(level), v.rid))
        if self.policy == "affinity":
            by_rid = {v.rid: v for v in live}
            if req.home in by_rid:
                return by_rid[req.home]      # sticky: slots live there
            # fresh request: shard by class label so repeat conditions
            # share a replica (warm executables, dense cohorts) — unless
            # that shard is badly behind the cheapest choice
            shard = live[req.cond % len(live)]
            if shard.score(level) <= 2.0 * cheapest.score(level) + 1e-12:
                return shard
        return cheapest

    def place(self, req: FleetRequest, views: List[ReplicaView],
              level: float) -> int:
        """Place one pending request; returns the chosen replica id and
        charges its price onto that replica's view backlog."""
        if req.state != "pending":
            raise RuntimeError(f"request {req.rid} is {req.state}, "
                               f"not pending")
        v = self._choose(req, views, level)
        self.placements += 1
        if req.home < 0:
            req.home = v.rid
            self.affine_placements += 1
        elif v.rid == req.home:
            self.affine_placements += 1
        else:
            # moving an established request: only costs cache state if it
            # ever dispatched (slots allocated) on the old home
            if req.dispatched:
                self.state_readmits += 1
            req.home = v.rid
            req.dispatched = False
        req.state = "placed"
        req.owner = v.rid
        req.placements += 1
        self._pending.remove(req.rid)
        v.backlog_seconds += v.prices.get(level, 0.0)
        return v.rid

    def bind(self, req: FleetRequest, engine_id: int) -> None:
        req.engine_id = engine_id

    # ------------------------------------------------------------------
    # Drain / death / completion

    def handback(self, req: FleetRequest, *, lost_state: bool) -> None:
        """Return a placed request to the pending pool. ``lost_state``
        distinguishes a death re-admission (cache slots gone, forced
        refresh ahead) from a drain handback of a never-dispatched
        request (free to move)."""
        if req.state == "done":
            return
        req.state = "pending"
        req.owner = -1
        req.engine_id = -1
        if lost_state:
            req.readmits += 1
        else:
            req.handbacks += 1
            if not req.dispatched:
                req.home = -1     # no state anywhere: next home is free
        self.handbacks += 1
        self._pending.append(req.rid)

    def mark_done(self, req: FleetRequest, now: float,
                  served_by: int) -> bool:
        """First completion wins (a hedged twin may land later); returns
        False for the loser so the caller drops the duplicate."""
        if req.state == "done":
            return False
        if req.rid in self._pending:
            # a hedged twin can win while the original sits re-admitted
            # (e.g. quarantine escalation backoff): drop it from the pool
            self._pending.remove(req.rid)
        req.state = "done"
        req.done_at = now
        req.served_by = served_by
        return True

    def escalate(self, req: FleetRequest, *, now: float, level: float,
                 max_retries: int = 2,
                 backoff_base: float = 0.05) -> bool:
        """Re-admit a quarantined (non-finite) request at the most
        powerful menu ``level`` — weak→powerful escalation. The same key
        restarts the trajectory from step 0, so the recovered sample is
        exactly the clean powerful-path sample. Backoff doubles per
        retry and is capped at a quarter of the remaining deadline slack
        so escalation never *causes* the expiry it is racing. A request
        is never dropped: past ``max_retries`` it still re-enqueues (at
        the capped backoff) but the overflow is counted and False
        returned so the caller can alarm."""
        if req.state == "done":
            return False
        self.handback(req, lost_state=True)
        req.budget = float(level)
        req.retries += 1
        req.escalated = True
        self.escalations += 1
        n = min(req.retries, max(1, max_retries))
        backoff = backoff_base * (2.0 ** (n - 1))
        if math.isfinite(req.deadline):
            backoff = min(backoff, max(0.0, (req.deadline - now) * 0.25))
        req.not_before = now + backoff
        if req.retries > max_retries:
            self.escalation_overflows += 1
            return False
        return True

    def mark_expired(self, req: FleetRequest, now: float) -> bool:
        """Terminal deadline expiry: the request leaves the unfinished
        set without a result (counted, journaled, never silently lost)."""
        if req.state in ("done", "expired"):
            return False
        if req.rid in self._pending:
            self._pending.remove(req.rid)
        req.state = "expired"
        req.owner = -1
        req.engine_id = -1
        req.done_at = now
        self.expirations += 1
        return True

    def mark_hedged(self, req: FleetRequest, replica: int,
                    engine_id: int) -> None:
        req.hedged = True
        req.hedge_owner = replica
        req.hedge_engine_id = engine_id
        self.hedges += 1

    # ------------------------------------------------------------------

    def affinity_hit_rate(self, total_request_dispatches: int) -> float:
        """1 - state-losing re-admissions / request-dispatches (every
        dispatch runs on the replica holding the request's slots except
        the forced-refresh one right after a state-losing move)."""
        if total_request_dispatches <= 0:
            return 1.0
        return 1.0 - min(self.state_readmits,
                         total_request_dispatches) / total_request_dispatches

    def summary(self) -> Dict[str, object]:
        return {
            "policy": self.policy,
            "registered": float(self._next_id),
            "pending": float(len(self._pending)),
            "placements": float(self.placements),
            "affine_placements": float(self.affine_placements),
            "state_readmits": float(self.state_readmits),
            "handbacks": float(self.handbacks),
            "hedges": float(self.hedges),
            "hedge_wins": float(self.hedge_wins),
            "escalations": float(self.escalations),
            "escalation_overflows": float(self.escalation_overflows),
            "expirations": float(self.expirations),
        }
