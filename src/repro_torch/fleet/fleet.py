"""The fleet front door, the port of ``repro.fleet.fleet``.

``Fleet`` runs one serving engine per data-parallel replica behind a
single submit/tick surface and glues the three control modules
together: :class:`~repro.fleet.router.Router` decides placement,
:class:`~repro.fleet.membership.FleetMembership` tracks
drain/join/death over heartbeats, and
:class:`~repro.fleet.health.FleetHealth` down-weights stragglers and
picks hedge candidates. The scheduling loop is ``tick()``:

1. **place** every routable pending request (scored by priced backlog +
   per-level calibrated price x straggler weight; see router.py);
2. **pump** each live replica one engine iteration — a pump is also the
   replica's heartbeat, so a hung replica stops beating and the monitor
   declares it dead after the timeout;
3. **retire** finished drains (in-flight cohort emptied);
4. **detect** deaths and re-admit the dead replica's
   accepted-but-unfinished requests elsewhere (same seed, or the same
   given prior → restart from step 0 reproduces the uninterrupted
   sample; fresh slot allocation on the new replica forces the cache
   refresh);
5. **hedge** deadline-critical requests predicted late on a slow
   replica (first completion wins, the twin is cancelled if still
   queued, dropped at completion otherwise).

Time: with the default wall clock every engine shares
``time.monotonic``. With an injected simulated clock the fleet runs in
*virtual time* — each replica's clock advances by modeled dispatch cost
(replica.py) — which is how one card demonstrates N-replica aggregate
throughput honestly.

Devices: ``device_ids`` are bookkeeping for the membership planner.
Every packed replica runs on its pipeline's device (``pipes`` gives one
pipeline per replica; by default all share ``pipe``), so N replicas fit
one card.

Randomness: request ``rid`` is seeded with ``request_seed(base_seed,
rid)`` unless the submitter gives a ``seed`` or ``x_T`` / ``noise``; the
fleet hands the same to every engine the request lands on.
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.fleet.health import FleetHealth
from repro_torch.fleet.membership import FleetMembership, init_process_group
from repro_torch.fleet.replica import (DEFAULT_SECONDS_PER_TOKEN, Replica,
                                       ReplicaClock)
from repro_torch.fleet.router import FleetRequest, ReplicaView, Router
from repro_torch.fleet.warmup import BackgroundCompiler
from repro_torch.pipeline.pipeline import FlexiPipeline
from repro_torch.pipeline.plan import SamplingPlan
from repro_torch.resilience.faults import (ALLOC_FAIL, CORRUPT_SLOT, CRASH,
                                           HANG, HEARTBEAT_DELAY, PARTITION,
                                           POISON, SLOWDOWN, UNHANG,
                                           FaultInjector, FaultPlan)
from repro_torch.resilience.journal import RequestJournal
from repro_torch.serving.metrics import RequestRecord
from repro_torch.serving.scheduler import ServedResult, request_seed
from repro_torch.telemetry import Telemetry


@dataclasses.dataclass
class FleetResult:
    """One served request, fleet view."""
    rid: int
    cond: int
    x0: torch.Tensor
    budget_served: float
    replica: int
    record: RequestRecord
    arrival: float
    done_at: float

    @property
    def latency(self) -> float:
        return self.done_at - self.arrival


class Fleet:
    """N replica engines behind one router.

    >>> fleet = Fleet(pipe, plans, n_replicas=4, clock=FakeClock())
    >>> fleet.submit(cond=3, budget=0.6)
    >>> results = fleet.run()
    """

    def __init__(self, pipe: FlexiPipeline,
                 plans: Dict[float, SamplingPlan],
                 n_replicas: int, *,
                 router: str = "cheapest",
                 clock: Optional[Callable[[], float]] = None,
                 virtual: Optional[bool] = None,
                 seconds_per_token: float = DEFAULT_SECONDS_PER_TOKEN,
                 speed_factors: Optional[Dict[int, float]] = None,
                 heartbeat_timeout_s: float = 10.0,
                 telemetry: Optional[Telemetry] = None,
                 base_seed: int = 0xf1ee,
                 engine_kind: str = "packed",
                 batch_size: int = 4,
                 pipes: Optional[Sequence[FlexiPipeline]] = None,
                 device_ids: Optional[Sequence[int]] = None,
                 seq_parallel: int = 1,
                 process_group=None,
                 warm_background: bool = False,
                 faults: Optional[FaultPlan] = None,
                 journal: Optional[RequestJournal] = None,
                 expire_queued: bool = False,
                 max_retries: int = 2,
                 backoff_base_s: float = 0.05,
                 engine_kwargs: Optional[Dict[str, Any]] = None):
        if n_replicas < 1:
            raise ValueError("a fleet needs at least one replica")
        self._clock = clock or time.monotonic
        # resilience: a scripted FaultPlan arms the injection seams; with
        # faults=None every seam is a no-op and the engines run exactly
        # the operations they run without this layer
        self._injector = (FaultInjector(faults)
                          if faults is not None else None)
        self._journal = journal
        self._expire_queued = bool(expire_queued)
        self._max_retries = int(max_retries)
        self._backoff_base = float(backoff_base_s)
        self._escalate_pending: Dict[int, float] = {}
        self.escalation_latencies: List[float] = []
        # a caller-injected clock means simulated time (tests, benches)
        # unless explicitly overridden; wall serving passes no clock
        self.virtual = virtual if virtual is not None else clock is not None
        self.plans = plans
        self.group = (process_group if process_group is not None
                      else init_process_group())
        if device_ids is None:
            device_ids = list(range(n_replicas * seq_parallel))
        self.membership = FleetMembership(
            n_replicas, device_ids, seq_parallel=seq_parallel,
            timeout_s=heartbeat_timeout_s, clock=self._clock)
        self.health = FleetHealth(n_replicas)
        self.router = Router(router)
        self.telemetry = telemetry
        self._rec = telemetry.recorder if telemetry is not None else None
        if telemetry is not None:
            telemetry.bind_clock(self._clock)
        self._base_seed = int(base_seed)
        self._spt = seconds_per_token
        self._engine_kind = engine_kind
        self._batch_size = batch_size
        self._engine_kwargs = dict(engine_kwargs or {})
        speed_factors = speed_factors or {}
        if pipes is not None and len(pipes) != n_replicas:
            raise ValueError(f"pipes: got {len(pipes)} for "
                             f"{n_replicas} replicas")
        self._default_pipe = pipe
        self.replicas: Dict[int, Replica] = {}
        for i in range(n_replicas):
            self.replicas[i] = self._build_replica(
                i, pipes[i] if pipes is not None else pipe,
                speed_factors.get(i, 1.0))
        # (replica id, engine-local request id) -> fleet request id
        self._emap: Dict[Tuple[int, int], int] = {}
        self.results: Dict[int, FleetResult] = {}
        self._hung: set = set()           # fault injection: stop pumping
        self._death_pending: Dict[int, float] = {}
        self.readmit_latencies: List[float] = []
        self._hedge_losses = 0
        self._t0 = self._clock()
        self.warmers: Dict[int, BackgroundCompiler] = {}
        if warm_background:
            for i, rep in self.replicas.items():
                if self._engine_kind == "packed":
                    self.warmers[i] = BackgroundCompiler(
                        rep.engine, name=f"fleet-warm-r{i}").start()

    def _build_replica(self, rid: int, pipe: FlexiPipeline,
                       speed_factor: float) -> Replica:
        kw = dict(self._engine_kwargs)
        faults = None
        if self._injector is not None:
            faults = self._injector.for_replica(rid)
            # engines park quarantined requests for the router (fleet
            # owns escalation) and checksum their cache slots so the
            # corruption seam is detectable
            kw["faults"] = faults
            kw["self_heal"] = False
            kw.setdefault("cache_integrity", True)
        if self._expire_queued and self._engine_kind == "packed":
            kw["expire_queued"] = True
        return Replica(rid, pipe, self.plans,
                       engine_kind=self._engine_kind,
                       virtual=self.virtual,
                       seconds_per_token=self._spt,
                       speed_factor=speed_factor,
                       clock=self._clock,
                       batch_size=self._batch_size,
                       faults=faults,
                       engine_kwargs=kw)

    # ------------------------------------------------------------------
    # Submission

    @property
    def now(self) -> float:
        return self._clock()

    def request_seed(self, rid: int) -> int:
        """The seed fleet request ``rid`` is served with unless its
        submitter gave one (or ``x_T`` / ``noise``)."""
        return request_seed(self._base_seed, rid)

    def submit(self, cond: int, budget: float,
               deadline: float = math.inf, seed: Optional[int] = None, *,
               x_T: Optional[torch.Tensor] = None,
               noise: Optional[torch.Tensor] = None) -> int:
        """Accept one request into the fleet; returns its fleet id. Its
        randomness — ``x_T`` (and, for DDPM, ``noise``) when given, else
        ``seed``, else :meth:`request_seed` of the fleet id — pins the
        sample: any replica, including a post-kill re-admission target,
        produces the same latents."""
        rid = self.router._next_id
        key: Dict[str, Any] = {"seed": self.request_seed(rid) if seed is None
                               else int(seed)}
        if x_T is not None:
            key["x_T"] = x_T
        if noise is not None:
            key["noise"] = noise
        now = self.now
        if self._journal is not None:
            # write-ahead: the admit record lands on disk BEFORE the
            # router ledger accepts the request, so a crash after this
            # line can replay it and a crash before it never saw it
            self._journal.admit(rid, cond=int(cond), budget=float(budget),
                                deadline=float(deadline), time=now)
        req = self.router.register(cond, budget, deadline, key, now)
        return req.rid

    # ------------------------------------------------------------------
    # Placement

    def _views(self) -> List[ReplicaView]:
        weights = self.health.weights()
        views = []
        for rid, rep in self.replicas.items():
            views.append(ReplicaView(
                rid=rid,
                admitting=(self.membership.admitting(rid)
                           and rid not in self._hung),
                backlog_seconds=rep.backlog_seconds(),
                prices=rep.prices(),
                weight=weights.get(rid, 1.0)))
        return views

    def _place_pending(self, now: float) -> int:
        pending = self.router.pending(now)
        if not pending:
            return 0
        views = self._views()
        if not any(v.admitting for v in views):
            return 0                  # wait for a join/rejoin
        t0 = now
        placed = 0
        for req in pending:
            level = self._quantize(req.budget)
            target = self.router.place(req, views, level)
            rep = self.replicas[target]
            if self.virtual:
                rep.rclock.catch_up(now)
            eid = rep.submit(req.cond, req.budget, req.deadline, req.key)
            self.router.bind(req, eid)
            self._emap[(target, eid)] = req.rid
            placed += 1
            if self._journal is not None:
                self._journal.dispatch(req.rid, replica=target, time=now)
            if req.rid in self._death_pending:
                self.readmit_latencies.append(
                    now - self._death_pending.pop(req.rid))
        if self._rec is not None and placed:
            self._rec.complete("route", t0, self.now,
                               args={"placed": placed,
                                     "policy": self.router.policy})
        return placed

    def _quantize(self, budget: float) -> float:
        return next(iter(self.replicas.values())).engine.quantize(budget)

    # ------------------------------------------------------------------
    # The scheduling loop

    def tick(self) -> List[FleetResult]:
        """One scheduling round; returns requests finished this round."""
        now = self.now
        out: List[FleetResult] = []
        if self._injector is not None:
            self._apply_faults(now)
        self._place_pending(now)
        for rid, rep in sorted(self.replicas.items()):
            if not self.membership.pumpable(rid) or rid in self._hung:
                continue
            if rep.has_work:
                results, dt = rep.pump(now)
                if dt > 0:
                    self.health.record_dispatch(rid, dt * 1e3)
                for f in getattr(rep.engine, "_inflight", ()):
                    frid = self._emap.get((rid, f.req.id))
                    if frid is not None:
                        self.router.requests[frid].dispatched = True
                for sr in results:
                    r = self._finish(rid, sr)
                    if r is not None:
                        out.append(r)
            self._intake_recovery(rid, rep, now)
            # pumping (even an idle pass) is the in-process heartbeat;
            # an armed injector may drop (partition) or hold (skew) it
            if self._injector is not None:
                stamp = self._injector.route_beat(rid, now)
                if stamp is not None:
                    self.membership.beat(rid, at=stamp)
            else:
                self.membership.beat(rid)
        if self._injector is not None:
            # delayed heartbeats arrive late with their ORIGINAL stamp —
            # the monitor's max() guard keeps them from rewinding
            for brid, stamp in self._injector.due_beats(now):
                self.membership.beat(brid, at=stamp)
        for rid in list(self.replicas):
            if self.membership.state(rid) == "draining" \
                    and self.replicas[rid].engine.idle:
                self.membership.finish_drain(rid)
        for rid in self.membership.check():
            self._on_death(rid)
        self._maybe_hedge(self.now)
        if self._rec is not None:
            self._rec.counter("fleet", {
                "pending": self.router.n_pending,
                **{f"r{rid}_inflight": self.replicas[rid].engine.n_inflight
                   for rid in sorted(self.replicas)},
                **{f"r{rid}_queued": self.replicas[rid].engine.n_queued
                   for rid in sorted(self.replicas)}})
        return out

    def run(self, max_ticks: int = 100_000) -> List[FleetResult]:
        """Drain: tick until every accepted request is served."""
        out: List[FleetResult] = []
        ticks = 0
        while self.router.unfinished() and ticks < max_ticks:
            out.extend(self.tick())
            ticks += 1
            if self.router.unfinished() and self.membership.alive_count == 0:
                raise RuntimeError("fleet has no live replicas but "
                                   f"{len(self.router.unfinished())} "
                                   "unfinished requests")
            self._advance_past_backoff()
        return out

    def _advance_past_backoff(self) -> None:
        """With a simulated clock, time only moves when a replica pumps
        work — so if every unfinished request sits in an escalation
        backoff window and every live replica is idle, the clock must be
        advanced to the earliest ``not_before`` or ``run`` spins
        forever. No-op on wall clocks (time passes by itself) and
        whenever any replica still has work."""
        held = [r.not_before for r in self.router.requests.values()
                if r.state == "pending" and r.not_before > self.now]
        if not held or not hasattr(self._clock, "advance"):
            return
        if self.router.pending(self.now):
            return                    # something is routable right now
        for rid, rep in self.replicas.items():
            if self.membership.pumpable(rid) and rid not in self._hung \
                    and rep.has_work:
                return
        self._clock.advance(min(held) - self.now + 1e-9)

    def _finish(self, rid: int, sr: ServedResult) -> Optional[FleetResult]:
        frid = self._emap.pop((rid, sr.request.id), None)
        if frid is None:
            return None               # stale (pre-death incarnation)
        req = self.router.requests[frid]
        now = (self.replicas[rid].rclock() if self.virtual else self.now)
        if not self.router.mark_done(req, now, rid):
            self._hedge_losses += 1   # the twin won earlier
            return None
        if self._journal is not None:
            self._journal.finish(frid, replica=rid, time=now)
        if frid in self._escalate_pending:
            # fleet-clock on both ends (the quarantine intake stamped
            # fleet time; replica virtual clocks run on another scale)
            self.escalation_latencies.append(
                self.now - self._escalate_pending.pop(frid))
        req.dispatched = True
        if req.hedged:
            if rid == req.hedge_owner:
                self.router.hedge_wins += 1
            self._cancel_copy(req, winner=rid)
        res = FleetResult(rid=frid, cond=req.cond, x0=sr.x0,
                          budget_served=sr.budget_served, replica=rid,
                          record=sr.record, arrival=req.arrival,
                          done_at=now)
        self.results[frid] = res
        return res

    # ------------------------------------------------------------------
    # Resilience

    def _apply_faults(self, now: float) -> None:
        """Pop due scripted fault events and apply each at its seam.
        Events whose target is not actionable yet (a poison for a not
        yet placed request, a corruption with no resident slot) are
        deferred and retried next tick."""
        inj = self._injector
        if inj is None:
            return
        for ev in inj.due(now):
            if ev.kind == CRASH:
                if self.membership.state(ev.replica) in ("active",
                                                         "draining"):
                    self.kill_replica(ev.replica)
            elif ev.kind == HANG:
                self.inject_hang(ev.replica)
            elif ev.kind == UNHANG:
                self._hung.discard(ev.replica)
            elif ev.kind == HEARTBEAT_DELAY:
                inj.delay_beats(ev.replica, now + ev.duration, ev.delay)
            elif ev.kind == PARTITION:
                inj.partition(ev.replica, now + ev.duration)
            elif ev.kind == SLOWDOWN:
                inj.slow(ev.replica, now + ev.duration, ev.factor)
            elif ev.kind == POISON:
                req = self.router.requests.get(ev.rid)
                if req is None or req.state == "pending":
                    inj.defer(ev)     # not placed yet: retry next tick
                elif req.state == "placed":
                    inj.add_poison(req.owner, req.engine_id)
                # done/expired: nothing left to poison — event dropped
            elif ev.kind == CORRUPT_SLOT:
                engine = self.replicas[ev.replica].engine
                store = getattr(engine, "store", None)
                slots = store.active_slots() if store is not None else []
                if not slots:
                    inj.defer(ev)     # nothing resident yet
                else:
                    # prefer a slot whose owner still has same-mode
                    # steps ahead (it re-packs this slot, so the
                    # checksum mismatch is actually observed instead of
                    # the slot being released at a phase switch or
                    # retire first) and is not itself marked for
                    # poisoning (quarantine would release the slot
                    # unverified); fall back to a seeded random pick
                    best, best_rem = None, 0
                    for f in getattr(engine, "_inflight", ()):
                        if (f.cache_slot >= 0 and not f.done
                                and int(f.lp.modes[f.step]) == f.cache_mode
                                and not inj.is_poison_target(ev.replica,
                                                             f.req.id)
                                and store.owner_of(
                                    f.cache_mode,
                                    f.cache_slot) == f.req.id):
                            rem = int(f.lp.run_len[f.step])
                            if rem > best_rem:
                                best = (f.cache_mode, f.cache_slot)
                                best_rem = rem
                    mode, slot = (best if best is not None
                                  else slots[inj.rng.randrange(
                                      len(slots))])
                    store.corrupt_slot(mode, slot)
                    inj.note_corruption()
            elif ev.kind == ALLOC_FAIL:
                inj.add_alloc_failures(ev.replica, ev.count)

    def _intake_recovery(self, rid: int, rep: Replica, now: float) -> None:
        """Drain one engine's quarantined/expired request pools into
        fleet-level recovery: quarantined requests escalate (re-admit at
        the most powerful level, deadline-aware backoff), expired ones
        turn terminal. Both paths journal."""
        eng = rep.engine
        take_q = getattr(eng, "take_quarantined", None)
        if take_q is not None:
            for r in take_q():
                frid = self._emap.pop((rid, r.id), None)
                if frid is None:
                    continue
                fr = self.router.requests[frid]
                self.router.escalate(
                    fr, now=now, level=max(rep._levels),
                    max_retries=self._max_retries,
                    backoff_base=self._backoff_base)
                self._escalate_pending.setdefault(frid, now)
                if self._journal is not None:
                    self._journal.escalate(frid, time=now,
                                           retries=fr.retries)
                if self._rec is not None:
                    self._rec.instant("escalate",
                                      args={"rid": frid, "replica": rid,
                                            "retries": fr.retries})
        take_e = getattr(eng, "take_expired", None)
        if take_e is not None:
            for r in take_e():
                frid = self._emap.pop((rid, r.id), None)
                if frid is None:
                    continue
                if self.router.mark_expired(self.router.requests[frid],
                                            now) \
                        and self._journal is not None:
                    self._journal.expire(frid, time=now)

    def resubmit_from_journal(self, journal: RequestJournal) -> List[int]:
        """Exactly-once replay after a front-door crash: re-admit every
        journaled request without a terminal record. Seeds re-derive from
        the journaled fleet rid (``request_seed(base_seed, rid)``), so a
        replayed request reproduces the latents the lost router would
        have served. This fleet must share the crashed fleet's
        ``base_seed``. Returns the new fleet ids, in original admission
        order."""
        out: List[int] = []
        for rec in journal.unfinished():
            out.append(self.submit(int(rec["cond"]), float(rec["budget"]),
                                   deadline=math.inf,
                                   seed=self.request_seed(int(rec["rid"]))))
        return out

    # ------------------------------------------------------------------
    # Drain / join / death

    def drain_replica(self, rid: int) -> int:
        """Stop admissions on ``rid``, hand its queued requests back to
        the router (they re-place immediately), let the in-flight cohort
        finish on subsequent ticks. Returns how many were handed back."""
        self.membership.start_drain(rid)
        eng = self.replicas[rid].engine
        eng.stop_admissions()
        handed = 0
        for r in eng.extract_queued():
            frid = self._emap.pop((rid, r.id), None)
            if frid is None:
                continue
            self.router.handback(self.router.requests[frid],
                                 lost_state=False)
            handed += 1
        if self._rec is not None:
            self._rec.complete("drain", self.now, self.now,
                               args={"replica": rid, "handed_back": handed})
        self._place_pending(self.now)
        return handed

    def kill_replica(self, rid: int) -> int:
        """Crash ``rid`` now (observed failure): everything it accepted
        and hadn't finished is re-admitted elsewhere. Returns the count
        of re-admitted requests."""
        self.membership.mark_dead(rid)
        return self._on_death(rid)

    def inject_hang(self, rid: int) -> None:
        """Fault injection: the replica stops being pumped (so stops
        heartbeating); membership declares it dead after the timeout."""
        self._hung.add(rid)

    def rejoin_replica(self, rid: int, *,
                       speed_factor: float = 1.0) -> int:
        """Bring a dead/drained replica id back with a FRESH engine (the
        old incarnation's state is untrusted); returns the incarnation."""
        inc = self.membership.rejoin(rid)
        self._hung.discard(rid)
        self.replicas[rid] = self._build_replica(
            rid, self._default_pipe, speed_factor)
        if self.virtual:
            self.replicas[rid].rclock.catch_up(self.now)
        return inc

    def join_replica(self, *, device_ids: Optional[Sequence[int]] = None,
                     speed_factor: float = 1.0,
                     warm_background: bool = False) -> int:
        """Grow the fleet by one replica; optionally warm its ladder on
        a background thread while it already takes traffic."""
        if device_ids is None:
            hi = max((max(i.device_ids) for i in
                      self.membership.replicas.values()), default=-1)
            device_ids = list(range(hi + 1,
                                    hi + 1 + self.membership.seq_parallel))
        rid = self.membership.join(device_ids)
        self.health.grow(rid + 1)
        self.replicas[rid] = self._build_replica(
            rid, self._default_pipe, speed_factor)
        if self.virtual:
            self.replicas[rid].rclock.catch_up(self.now)
        if warm_background and self._engine_kind == "packed":
            self.warmers[rid] = BackgroundCompiler(
                self.replicas[rid].engine,
                name=f"fleet-warm-r{rid}").start()
        return rid

    def _on_death(self, rid: int) -> int:
        now = self.now
        orphans = [r for r in self.router.requests.values()
                   if r.state == "placed" and r.owner == rid]
        for req in orphans:
            self._emap.pop((rid, req.engine_id), None)
            self.router.handback(req, lost_state=req.dispatched)
            self._death_pending[req.rid] = now
        # a dead replica's hedge COPIES die with it; the originals live
        for req in self.router.requests.values():
            if req.hedged and req.hedge_owner == rid:
                self._emap.pop((rid, req.hedge_engine_id), None)
                req.hedged = False
                req.hedge_owner = req.hedge_engine_id = -1
        if self._rec is not None:
            self._rec.complete("readmit", now, self.now,
                               args={"replica": rid,
                                     "orphans": len(orphans)})
        self._place_pending(self.now)
        return len(orphans)

    # ------------------------------------------------------------------
    # Hedging

    def _maybe_hedge(self, now: float) -> None:
        cands: List[FleetRequest] = []
        lateness: List[float] = []
        weights = self.health.weights()
        for req in self.router.requests.values():
            if (req.state != "placed" or req.hedged
                    or not math.isfinite(req.deadline)):
                continue
            if weights.get(req.owner, 1.0) <= 1.5:
                continue              # owner is healthy; don't double-spend
            est = self.replicas[req.owner].estimated_finish(
                req.engine_id, now)
            if est is None:
                continue
            cands.append(req)
            lateness.append((est - req.deadline) * 1e3)
        if not cands:
            return
        picked = self.health.hedge_candidates(
            [r.rid for r in cands], lateness)
        if not picked:
            return
        by_rid = {r.rid: r for r in cands}
        views = [v for v in self._views() if v.admitting]
        for rid in picked:
            req = by_rid[rid]
            targets = [v for v in views if v.rid != req.owner]
            if not targets:
                continue
            best = min(targets, key=lambda v: (v.weight, v.score(
                self._quantize(req.budget)), v.rid))
            rep = self.replicas[best.rid]
            if self.virtual:
                rep.rclock.catch_up(now)
            eid = rep.submit(req.cond, req.budget, req.deadline, req.key)
            self._emap[(best.rid, eid)] = req.rid
            self.router.mark_hedged(req, best.rid, eid)
            if self._rec is not None:
                self._rec.complete("hedge", now, self.now,
                                   args={"rid": req.rid,
                                         "from": req.owner,
                                         "to": best.rid})

    def _cancel_copy(self, req: FleetRequest, winner: int) -> None:
        """Drop the losing copy of a hedged request if it is still only
        queued (in-flight copies run to completion and are dropped at
        finish by first-wins)."""
        loser, eid = ((req.hedge_owner, req.hedge_engine_id)
                      if winner != req.hedge_owner
                      else (req.owner, req.engine_id))
        if loser < 0 or loser not in self.replicas:
            return
        eng = self.replicas[loser].engine
        for r in list(eng._queue._pending):
            if r.id == eid:
                eng._queue._pending.remove(r)
                self._emap.pop((loser, eid), None)
                break

    # ------------------------------------------------------------------
    # Warm-set

    def precapture(self, max_per_mode: int = 2) -> int:
        """Synchronous warm-set build on every packed replica (shared
        pipelines make replicas after the first free)."""
        n = 0
        for rep in self.replicas.values():
            if self._engine_kind == "packed":
                n += rep.engine.precapture_warm_set(max_per_mode)
        return n

    def wait_warm(self, timeout: Optional[float] = None) -> None:
        """Join every background warmer and prove the ladders warm."""
        for w in self.warmers.values():
            if not w.wait(timeout):
                raise TimeoutError("background warm-set build still "
                                   "running")
            w.assert_warm()

    # ------------------------------------------------------------------
    # Introspection

    def cache_stats(self) -> Dict[str, int]:
        """Aggregated runner-cache counters over the DISTINCT pipelines
        the replicas use (shared pipelines count once)."""
        seen: Dict[int, Dict[str, int]] = {}
        for rep in self.replicas.values():
            p = rep.engine.pipe
            seen[id(p)] = p.cache_stats()
        agg = {"pipes": len(seen), "runners": 0, "hits": 0, "misses": 0,
               "compiled": 0}
        for st in seen.values():
            for k in ("runners", "hits", "misses", "compiled"):
                agg[k] += st[k]
        return agg

    def makespan(self) -> float:
        if self.virtual:
            clocks = [rep.rclock() for rep in self.replicas.values()
                      if isinstance(rep.rclock, ReplicaClock)]
            return (max(clocks) if clocks else self.now) - self._t0
        return self.now - self._t0

    def summary(self) -> Dict[str, Any]:
        tokens = sum(r.record.tokens for r in self.results.values())
        makespan = self.makespan()
        dispatches = sum(
            rep.engine.metrics.total_request_steps
            for rep in self.replicas.values())
        rep_report = self.health.report()
        out: Dict[str, Any] = {
            "replicas": len(self.replicas),
            "served": len(self.results),
            "tokens": float(tokens),
            "makespan_s": makespan,
            "tokens_per_s": tokens / makespan if makespan > 0 else 0.0,
            "request_dispatches": float(dispatches),
            "affinity_hit_rate":
                self.router.affinity_hit_rate(dispatches),
            "router": self.router.summary(),
            "membership": self.membership.summary(),
            "straggler": {"stragglers": list(rep_report.stragglers),
                          "median_ms": rep_report.median_ms,
                          "worst_ms": rep_report.worst_ms},
            "readmit": {
                "count": float(len(self.readmit_latencies)),
                "mean_s": (sum(self.readmit_latencies)
                           / len(self.readmit_latencies)
                           if self.readmit_latencies else 0.0),
                "max_s": (max(self.readmit_latencies)
                          if self.readmit_latencies else 0.0)},
            "hedge_losses": float(self._hedge_losses),
            "escalation": {
                "count": float(len(self.escalation_latencies)),
                "outstanding": float(len(self._escalate_pending)),
                "mean_s": (sum(self.escalation_latencies)
                           / len(self.escalation_latencies)
                           if self.escalation_latencies else 0.0),
                "max_s": (max(self.escalation_latencies)
                          if self.escalation_latencies else 0.0)},
            "cache": self.cache_stats(),
            "per_replica": {
                str(rid): rep.engine.metrics.summary()
                for rid, rep in sorted(self.replicas.items())},
        }
        if self._injector is not None:
            out["faults"] = self._injector.summary()
        if self._journal is not None:
            out["journal"] = self._journal.summary()
        return out
