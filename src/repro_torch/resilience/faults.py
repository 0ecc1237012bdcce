"""Deterministic fault injection for the serving fleet (host-pure), the
port's copy of ``repro.resilience.faults``.

A :class:`FaultPlan` is a scripted schedule of :class:`FaultEvent`\\ s on
the fleet's injectable clock; the :class:`FaultInjector` is the armed
referee the control plane consults at its existing seams (replica pump,
heartbeat delivery, cache-slot alloc, post-dispatch step outputs).  The
module is deliberately **host-pure** — no torch, no numpy — it only
*decides* what goes wrong and when; the data plane (scheduler / store /
fleet) performs the actual device mutations.  Both halves of that
contract hold: this module stays host-pure (``tests/test_torch_
resilience.py`` checks its imports), and every seam call is guarded by
an ``is not None`` armed check so a disarmed run executes the exact same
device-op sequence as an engine without this layer.

Fault taxonomy:

======================  =====================================================
kind                    effect when due
======================  =====================================================
``crash``               replica killed (heartbeats stop, in-flight orphaned)
``hang``                replica stops pumping but keeps heart beating
``unhang``              lifts a prior ``hang``
``heartbeat_delay``     beats from the replica delivered late, out of order,
                        with their *original* send timestamp
``partition``           beats from the replica dropped for a window
``slowdown``            replica's modeled dispatch time multiplied
``poison``              one fleet request's next packed-step latent row
                        overwritten with NaN (post-dispatch host hook)
``corrupt_slot``        one resident cache slot's delta overwritten with
                        finite garbage (only the checksum can tell)
``alloc_fail``          the replica's next N cache-slot allocations fail
                        transiently
======================  =====================================================
"""
from __future__ import annotations

import heapq
import random
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set, Tuple

CRASH = "crash"
HANG = "hang"
UNHANG = "unhang"
HEARTBEAT_DELAY = "heartbeat_delay"
PARTITION = "partition"
SLOWDOWN = "slowdown"
POISON = "poison"
CORRUPT_SLOT = "corrupt_slot"
ALLOC_FAIL = "alloc_fail"

FAULT_KINDS = (CRASH, HANG, UNHANG, HEARTBEAT_DELAY, PARTITION, SLOWDOWN,
               POISON, CORRUPT_SLOT, ALLOC_FAIL)


@dataclass(frozen=True)
class FaultEvent:
    """One scripted fault, due at fleet-clock time ``at``."""

    at: float
    kind: str
    replica: int = -1       # target replica (all kinds except poison-by-rid)
    rid: int = -1           # target fleet request id (poison)
    duration: float = 0.0   # window length (delay / partition / slowdown)
    delay: float = 0.0      # heartbeat delivery delay (heartbeat_delay)
    factor: float = 1.0     # dispatch-time multiplier (slowdown)
    count: int = 1          # number of transient failures (alloc_fail)

    def __post_init__(self):
        if self.kind not in FAULT_KINDS:
            raise ValueError(
                f"unknown fault kind {self.kind!r}; known: {FAULT_KINDS}")


@dataclass
class FaultPlan:
    """A seeded, scripted schedule of faults on the injectable clock."""

    events: List[FaultEvent] = field(default_factory=list)
    seed: int = 0

    def add(self, at: float, kind: str, **kw) -> FaultEvent:
        ev = FaultEvent(at=at, kind=kind, **kw)
        self.events.append(ev)
        return ev

    def __len__(self) -> int:
        return len(self.events)


class FaultInjector:
    """Armed referee over a :class:`FaultPlan`.

    The fleet pops :meth:`due` events each tick and applies them; window
    faults (slowdown / beat delay / partition) are recorded here and
    consulted by the seams through cheap host-pure queries.  Events whose
    target is not actionable yet (e.g. poisoning a request that has not
    been placed) are re-queued via :meth:`defer` and retried next tick.
    """

    def __init__(self, plan: FaultPlan):
        self.plan = plan
        self.rng = random.Random(plan.seed)
        self._queue: List[Tuple[float, int, FaultEvent]] = []
        for i, ev in enumerate(plan.events):
            heapq.heappush(self._queue, (ev.at, i, ev))
        self._seq = len(plan.events)
        # window state
        self._slow: Dict[int, Tuple[float, float]] = {}      # rid -> (until, x)
        self._beat_delay: Dict[int, Tuple[float, float]] = {}
        self._partition: Dict[int, float] = {}               # rid -> until
        self._held_beats: List[Tuple[float, int, int, float]] = []
        self._beat_seq = 0
        # targeted state
        self.pending_poison: Set[Tuple[int, int]] = set()    # (replica, erid)
        self.poison_targets: Set[Tuple[int, int]] = set()    # ever poisoned
        self.alloc_failures: Dict[int, int] = {}
        self.counters: Dict[str, int] = {
            "applied": 0, "deferred": 0, "poisoned": 0, "alloc_failed": 0,
            "beats_dropped": 0, "beats_delayed": 0, "corrupted": 0,
        }

    # ------------------------------------------------------------- schedule
    def due(self, now: float) -> List[FaultEvent]:
        """Pop every event whose time has come (stable order)."""
        out: List[FaultEvent] = []
        while self._queue and self._queue[0][0] <= now:
            out.append(heapq.heappop(self._queue)[2])
        self.counters["applied"] += len(out)
        return out

    def defer(self, ev: FaultEvent) -> None:
        """Re-queue an event whose target is not actionable yet."""
        self.counters["applied"] -= 1
        self.counters["deferred"] += 1
        self._seq += 1
        heapq.heappush(self._queue, (ev.at, self._seq, ev))

    def exhausted(self) -> bool:
        return not self._queue

    # -------------------------------------------------------------- windows
    def slow(self, replica: int, until: float, factor: float) -> None:
        self._slow[replica] = (until, factor)

    def slowdown_factor(self, replica: int, now: float) -> float:
        w = self._slow.get(replica)
        if w is None or now >= w[0]:
            return 1.0
        return w[1]

    def delay_beats(self, replica: int, until: float, delay: float) -> None:
        self._beat_delay[replica] = (until, delay)

    def partition(self, replica: int, until: float) -> None:
        self._partition[replica] = until

    def route_beat(self, replica: int, now: float) -> Optional[float]:
        """Decide the fate of a heartbeat sent by ``replica`` at ``now``.

        Returns the timestamp to deliver immediately, or ``None`` when the
        beat is dropped (partition) or buffered (delay).  Buffered beats
        surface later through :meth:`due_beats` carrying their *original*
        send time — deliberately out of order with fresher direct beats,
        exercising the monitor's clock-skew tolerance.
        """
        until = self._partition.get(replica)
        if until is not None and now < until:
            self.counters["beats_dropped"] += 1
            return None
        w = self._beat_delay.get(replica)
        if w is not None and now < w[0]:
            self._beat_seq += 1
            heapq.heappush(self._held_beats,
                           (now + w[1], self._beat_seq, replica, now))
            self.counters["beats_delayed"] += 1
            return None
        return now

    def due_beats(self, now: float) -> List[Tuple[int, float]]:
        """Buffered ``(replica, original_stamp)`` beats due for delivery."""
        out: List[Tuple[int, float]] = []
        while self._held_beats and self._held_beats[0][0] <= now:
            _, _, rid, stamp = heapq.heappop(self._held_beats)
            out.append((rid, stamp))
        return out

    # ------------------------------------------------------------- targeted
    def add_poison(self, replica: int, engine_rid: int) -> None:
        self.pending_poison.add((replica, engine_rid))
        self.poison_targets.add((replica, engine_rid))

    def take_poison(self, replica: int, engine_rid: int) -> bool:
        try:
            self.pending_poison.remove((replica, engine_rid))
        except KeyError:
            return False
        self.counters["poisoned"] += 1
        return True

    def is_poison_target(self, replica: int, engine_rid: int) -> bool:
        """True when the request was ever scheduled for poisoning on
        this replica (pending *or* already applied) — such a request is
        headed for quarantine, so its cache slot is a poor corruption
        target (released before any pack could verify it)."""
        return (replica, engine_rid) in self.poison_targets

    def add_alloc_failures(self, replica: int, count: int) -> None:
        self.alloc_failures[replica] = \
            self.alloc_failures.get(replica, 0) + int(count)

    def take_alloc_failure(self, replica: int) -> bool:
        left = self.alloc_failures.get(replica, 0)
        if left <= 0:
            return False
        self.alloc_failures[replica] = left - 1
        self.counters["alloc_failed"] += 1
        return True

    def note_corruption(self) -> None:
        self.counters["corrupted"] += 1

    # ---------------------------------------------------------------- views
    def for_replica(self, rid: int) -> "ReplicaFaults":
        return ReplicaFaults(self, rid)

    def summary(self) -> Dict[str, int]:
        out = dict(self.counters)
        out["events"] = len(self.plan.events)
        out["pending"] = len(self._queue)
        return out


class ReplicaFaults:
    """Per-replica facade handed to a ServingEngine / Replica.

    Engine request ids are replica-local, so the engine-facing queries
    carry the replica id implicitly.  Also usable standalone (tests) by
    constructing ``FaultInjector(plan).for_replica(0)``.
    """

    __slots__ = ("_inj", "rid")

    def __init__(self, injector: FaultInjector, rid: int):
        self._inj = injector
        self.rid = rid

    def take_poison(self, engine_rid: int) -> bool:
        return self._inj.take_poison(self.rid, engine_rid)

    def take_alloc_failure(self) -> bool:
        return self._inj.take_alloc_failure(self.rid)

    def slowdown_factor(self, now: float) -> float:
        return self._inj.slowdown_factor(self.rid, now)
