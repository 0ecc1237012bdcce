"""Deterministic fault injection and end-to-end recovery, the port of
``repro.resilience``.

``faults`` and ``journal`` are host-pure (no torch, no numpy); the chaos
harness ``repro_torch.resilience.chaos`` pulls in the full fleet stack
and is imported explicitly, not here, to keep this package importable
from control-plane code without touching torch.
"""
from repro_torch.resilience.faults import (ALLOC_FAIL,  # noqa: F401
                                           CORRUPT_SLOT, CRASH, FAULT_KINDS,
                                           HANG, HEARTBEAT_DELAY, PARTITION,
                                           POISON, SLOWDOWN, UNHANG,
                                           FaultEvent, FaultInjector,
                                           FaultPlan, ReplicaFaults)
from repro_torch.resilience.journal import RequestJournal  # noqa: F401
