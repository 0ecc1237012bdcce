"""Fleet membership: drain/join/death state machine — HOST-PURE; the
port's copy of ``repro.fleet.membership``.

Wires two runtime modules into serving:

* :class:`repro_torch.runtime.fault_tolerance.HeartbeatMonitor` is the
  liveness source of truth. In-process replicas "heartbeat" every time
  the fleet pumps them; a replica that stops being pumped (hung,
  killed) misses beats and :meth:`FleetMembership.check` declares it
  dead after ``timeout_s`` on the injected clock. The monitor's
  incarnation counter survives a comeback, so stale completions from a
  previous incarnation are droppable.
* :func:`repro_torch.runtime.elastic.plan_mesh_shape` plans the device
  partition: ``(data, seq) = plan_mesh_shape(n_devices, seq_parallel)``
  caps how many sequence-parallel replicas the device pool sustains;
  each replica owns a contiguous ``seq``-wide device slice. On replica
  loss the surviving partition is replanned the same way, which is
  exactly what transfers to a real cluster.

Replica lifecycle::

    active --start_drain--> draining --finish_drain--> drained
    active/draining --(missed beats | mark_dead)--> dead --rejoin--> active

A *draining* replica stops taking placements but keeps finishing its
in-flight cohort; a *dead* one is gone now — its accepted-but-unfinished
requests are the router's to re-admit (see fleet.fleet).

The module is host-pure (no torch, no numpy): it reasons about integer
device *ids*, never device objects — on one card every packed replica
runs on the pipeline's device, whatever its ids say.
:func:`init_process_group` is the multi-host init seam — in-process
fleets get a simulated group; a real multi-host launcher passes a
function taking the same keywords (e.g. one calling
``torch.distributed.init_process_group`` with
``init_method=coordinator_address``, ``world_size=num_processes``,
``rank=process_id``) and runs one process per replica.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from repro_torch.runtime.elastic import plan_mesh_shape
from repro_torch.runtime.fault_tolerance import HeartbeatMonitor, WorkerState

REPLICA_STATES = ("active", "draining", "drained", "dead")


@dataclasses.dataclass(frozen=True)
class ProcessGroup:
    """What a multi-host process-group init would have established."""
    coordinator_address: str
    num_processes: int
    process_id: int
    simulated: bool


def init_process_group(coordinator_address: str = "local://fleet",
                       num_processes: int = 1, process_id: int = 0,
                       initialize_fn: Optional[Callable] = None
                       ) -> ProcessGroup:
    """The multi-host init seam. In-process fleets (this repo's runnable
    configuration) pass no ``initialize_fn`` and get a simulated group.
    A real launcher passes its init function here (called with these
    keywords) and each process then builds ONE replica
    over its local devices instead of N over subsets."""
    if initialize_fn is not None:
        initialize_fn(coordinator_address=coordinator_address,
                      num_processes=num_processes, process_id=process_id)
        return ProcessGroup(coordinator_address, num_processes,
                            process_id, simulated=False)
    return ProcessGroup(coordinator_address, num_processes, process_id,
                        simulated=True)


def partition_devices(device_ids: Sequence[int], n_replicas: int,
                      seq_parallel: int = 1
                      ) -> List[Tuple[int, ...]]:
    """Contiguous ``seq_parallel``-wide device slices, one per replica,
    feasibility-checked through :func:`plan_mesh_shape` (the same
    planner elastic restore uses, so a post-loss replan agrees with
    training-side rescale)."""
    data, seq = plan_mesh_shape(len(device_ids), seq_parallel)
    if seq != seq_parallel:
        raise ValueError(
            f"seq_parallel={seq_parallel} does not divide "
            f"{len(device_ids)} devices (plan_mesh_shape says "
            f"{(data, seq)})")
    if n_replicas > data:
        raise ValueError(f"{n_replicas} replicas x {seq_parallel} devices "
                         f"need {n_replicas * seq_parallel}, have "
                         f"{len(device_ids)}")
    ids = list(device_ids)
    return [tuple(ids[i * seq:(i + 1) * seq]) for i in range(n_replicas)]


@dataclasses.dataclass
class ReplicaInfo:
    rid: int
    device_ids: Tuple[int, ...]
    state: str = "active"


class FleetMembership:
    """Replica states + heartbeat liveness over an injectable clock."""

    def __init__(self, n_replicas: int, device_ids: Sequence[int], *,
                 seq_parallel: int = 1, timeout_s: float = 10.0,
                 clock: Callable[[], float] = time.monotonic):
        self.clock = clock
        self.seq_parallel = seq_parallel
        parts = partition_devices(device_ids, n_replicas, seq_parallel)
        self.replicas: Dict[int, ReplicaInfo] = {
            i: ReplicaInfo(i, parts[i]) for i in range(n_replicas)}
        self.monitor = HeartbeatMonitor(n_replicas, timeout_s, clock)

    # ------------------------------------------------------------------
    # Liveness

    def beat(self, rid: int, at: Optional[float] = None) -> None:
        """Deliver a heartbeat; ``at`` is the sender's send-time for
        delayed/out-of-order delivery (the monitor max-guards the stamp,
        so duplicates and stale beats are harmless)."""
        if self.replicas[rid].state in ("active", "draining"):
            self.monitor.heartbeat(rid, at=at)

    def check(self) -> List[int]:
        """Newly dead replica ids (missed-heartbeat path); marks them."""
        dead = [r for r in self.monitor.check()
                if self.replicas[r].state not in ("dead", "drained")]
        for r in dead:
            self.replicas[r].state = "dead"
        return dead

    def mark_dead(self, rid: int) -> None:
        """Explicit kill (the crash was observed, not inferred)."""
        self.replicas[rid].state = "dead"
        self.monitor.workers[rid].alive = False

    def incarnation(self, rid: int) -> int:
        return self.monitor.workers[rid].incarnation

    # ------------------------------------------------------------------
    # Drain / join

    def start_drain(self, rid: int) -> None:
        info = self.replicas[rid]
        if info.state != "active":
            raise RuntimeError(f"replica {rid} is {info.state}; only an "
                               f"active replica can start draining")
        info.state = "draining"

    def finish_drain(self, rid: int) -> None:
        info = self.replicas[rid]
        if info.state != "draining":
            raise RuntimeError(f"replica {rid} is {info.state}, not "
                               f"draining")
        info.state = "drained"

    def rejoin(self, rid: int) -> int:
        """Bring a dead/drained replica back (same device slice); the
        monitor bumps its incarnation so pre-death attribution can't be
        confused with the new life. Returns the new incarnation."""
        info = self.replicas[rid]
        # heartbeat() on a dead worker revives it and bumps incarnation —
        # exactly the comeback semantics we want; on a drained one it
        # just refreshes the stamp
        self.monitor.heartbeat(rid)
        info.state = "active"
        return self.monitor.workers[rid].incarnation

    def join(self, device_ids: Sequence[int]) -> int:
        """Admit a brand-new replica over ``device_ids``; returns its
        id. The monitor grows — fresh incarnation 0."""
        _data, seq = plan_mesh_shape(len(device_ids), self.seq_parallel)
        if seq != self.seq_parallel:
            raise ValueError(
                f"seq_parallel={self.seq_parallel} does not divide the "
                f"joining replica's {len(device_ids)} devices "
                f"(plan_mesh_shape says {(_data, seq)})")
        rid = max(self.replicas) + 1 if self.replicas else 0
        self.replicas[rid] = ReplicaInfo(rid, tuple(device_ids))
        self.monitor.workers[rid] = WorkerState(rid, self.clock())
        return rid

    # ------------------------------------------------------------------

    def state(self, rid: int) -> str:
        return self.replicas[rid].state

    def admitting(self, rid: int) -> bool:
        """Can the router place new work here?"""
        return (self.replicas[rid].state == "active"
                and self.monitor.workers[rid].alive)

    def pumpable(self, rid: int) -> bool:
        """Should the fleet keep stepping this replica's engine?"""
        return self.replicas[rid].state in ("active", "draining")

    @property
    def alive_count(self) -> int:
        return sum(1 for i in self.replicas
                   if self.replicas[i].state in ("active", "draining")
                   and self.monitor.workers[i].alive)

    def summary(self) -> Dict[str, object]:
        return {
            "replicas": {str(i): {"state": info.state,
                                  "devices": list(info.device_ids),
                                  "incarnation": self.incarnation(i)}
                         for i, info in sorted(self.replicas.items())},
            "alive": self.alive_count,
        }
