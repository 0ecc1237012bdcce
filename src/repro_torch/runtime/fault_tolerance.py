"""Fault tolerance for 1000+-node runs: heartbeat failure detection,
checkpoint/restart supervision, and elastic rescaling — the port's own
copy of ``repro.runtime.fault_tolerance`` (pure Python and numpy).

On a single device, node failures are *simulated* via an injectable
clock and fault hooks — the control logic (detection thresholds,
restart policy, rescale planning) is the part that transfers to a real
cluster, where heartbeats arrive over the coordination service.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np


@dataclasses.dataclass
class WorkerState:
    worker_id: int
    last_heartbeat: float
    alive: bool = True
    incarnation: int = 0


class HeartbeatMonitor:
    """Declares a worker dead after ``timeout_s`` without a heartbeat."""

    def __init__(self, n_workers: int, timeout_s: float = 60.0,
                 clock: Callable[[], float] = time.monotonic):
        self.clock = clock
        self.timeout_s = timeout_s
        now = clock()
        self.workers = {i: WorkerState(i, now) for i in range(n_workers)}

    def heartbeat(self, worker_id: int, at: Optional[float] = None):
        """Record a heartbeat, optionally with the sender's send-time.

        Beats may arrive duplicated or out of order (delayed delivery,
        clock skew): ``last_heartbeat`` is monotone under ``max`` so a
        stale beat landing after a fresher one can never move the stamp
        backwards and spuriously age a live worker toward its timeout.
        """
        w = self.workers[worker_id]
        t = self.clock() if at is None else at
        w.last_heartbeat = max(w.last_heartbeat, t)
        if not w.alive:           # worker came back (restarted)
            w.alive = True
            w.incarnation += 1

    def check(self) -> List[int]:
        """Returns newly-dead worker ids."""
        now = self.clock()
        dead = []
        for w in self.workers.values():
            if w.alive and now - w.last_heartbeat > self.timeout_s:
                w.alive = False
                dead.append(w.worker_id)
        return dead

    @property
    def alive_count(self) -> int:
        return sum(w.alive for w in self.workers.values())


@dataclasses.dataclass
class RecoveryEvent:
    step: int
    kind: str                 # 'failure' | 'restart' | 'rescale'
    detail: str


class TrainingSupervisor:
    """Checkpoint/restart + elastic-rescale policy around a step function.

    The training loop calls ``on_step``; injected faults raise
    ``WorkerFailure``; the supervisor restores from the last committed
    checkpoint (possibly on a smaller device count — elastic) and replays.
    """

    def __init__(self, checkpointer, monitor: HeartbeatMonitor,
                 checkpoint_every: int = 50,
                 rescale_plan: Optional[Callable[[int], Any]] = None):
        self.ckpt = checkpointer
        self.monitor = monitor
        self.checkpoint_every = checkpoint_every
        self.rescale_plan = rescale_plan
        self.events: List[RecoveryEvent] = []

    def maybe_checkpoint(self, step: int, state: Any):
        if step % self.checkpoint_every == 0:
            self.ckpt.save(step, state)

    def handle_failure(self, step: int, dead: List[int]
                       ) -> Tuple[int, Any, Any]:
        """Returns (restart_step, restored_state, new_layout)."""
        self.events.append(RecoveryEvent(step, "failure",
                                         f"workers {dead} lost"))
        self.ckpt.wait()
        restart = self.ckpt.latest_step()
        if restart is None:
            raise RuntimeError("failure before first checkpoint")
        layout = None
        if self.rescale_plan is not None:
            layout = self.rescale_plan(self.monitor.alive_count)
            self.events.append(RecoveryEvent(
                step, "rescale",
                f"alive={self.monitor.alive_count} layout={layout}"))
        state, _ = self.ckpt.restore(restart)
        self.events.append(RecoveryEvent(restart, "restart",
                                         f"resumed from step {restart}"))
        return restart, state, layout


class WorkerFailure(Exception):
    def __init__(self, worker_ids: List[int]):
        super().__init__(f"workers failed: {worker_ids}")
        self.worker_ids = worker_ids


def run_with_recovery(train_fn: Callable[[int, Any], Any], state: Any,
                      n_steps: int, supervisor: TrainingSupervisor,
                      fault_hook: Optional[Callable[[int], Optional[List[int]]]]
                      = None) -> Tuple[Any, List[RecoveryEvent]]:
    """Drive training with simulated failures.

    ``fault_hook(step)`` may return worker ids to kill at that step.
    """
    step = 0
    supervisor.maybe_checkpoint(0, state)
    while step < n_steps:
        if fault_hook is not None:
            dead = fault_hook(step)
            if dead:
                for w in dead:
                    supervisor.monitor.workers[w].alive = False
                step, state, _ = supervisor.handle_failure(step, dead)
                # simulated repair: workers rejoin next step
                for w in dead:
                    supervisor.monitor.heartbeat(w)
                continue
        state = train_fn(step, state)
        step += 1
        supervisor.maybe_checkpoint(step, state)
    supervisor.ckpt.wait()
    return state, supervisor.events
