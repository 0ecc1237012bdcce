"""Fleet serving: a replica router in front of per-replica engines, the
port of ``repro.fleet``.

Control plane (host-pure: no torch, no numpy): ``router`` (placement +
affinity ledger), ``membership`` (heartbeat drain/join/death), ``health``
(straggler weights + hedging). Data plane: ``replica`` (engine + clock
+ price), ``fleet`` (the front door), ``warmup`` (background warm-set
building), ``groups`` (a pipeline over a persistent rank group: the
sequence-parallel replicas of ``launch/serve.py --mesh DATAxSEQ
--replicas N``; imported by name, as the reference has no such module).
On one card every packed replica shares the pipeline's device.
"""
from repro_torch.fleet.fleet import Fleet, FleetResult
from repro_torch.fleet.health import FleetHealth
from repro_torch.fleet.membership import (FleetMembership, ProcessGroup,
                                          init_process_group,
                                          partition_devices)
from repro_torch.fleet.replica import FixedSlotEngine, Replica, ReplicaClock
from repro_torch.fleet.router import (ROUTER_POLICIES, FleetRequest,
                                      ReplicaView, Router)
from repro_torch.fleet.warmup import BackgroundCompiler

__all__ = [
    "Fleet", "FleetResult", "FleetHealth", "FleetMembership",
    "ProcessGroup", "init_process_group", "partition_devices",
    "FixedSlotEngine", "Replica", "ReplicaClock", "ROUTER_POLICIES",
    "FleetRequest", "ReplicaView", "Router", "BackgroundCompiler",
]
