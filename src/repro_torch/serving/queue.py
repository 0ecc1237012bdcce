"""Request admission queue, the port of ``repro.serving.queue``.

A :class:`Request` is one image to generate: class label, requested
relative-compute budget, optional latency deadline, and what seeds its
randomness, as ``FlexiPipeline.sample`` takes it: a caller's
``generator``, caller-given ``x_T`` / ``noise`` tensors, or else a
``seed`` the engine derives from the request id (it draws the prior and
the solver noise from a ``torch.Generator`` with it, on the engine's
device). So a served request reproduces the standalone call that is
given the same. The queue orders admission by
policy: ``fifo`` (arrival order) or ``edf`` (earliest deadline first).
Timestamps come from the caller's clock, so tests drive a simulated one.
"""
from __future__ import annotations

import dataclasses
import math
from typing import List, Optional

import torch

POLICIES = ("fifo", "edf")


@dataclasses.dataclass
class Request:
    id: int
    cond: int                            # class label
    budget: float                        # requested relative-compute level
    deadline: float = math.inf           # absolute time (caller's clock)
    seed: Optional[int] = None           # generator seed the engine derived
    generator: Optional[torch.Generator] = None   # caller's generator
    x_T: Optional[torch.Tensor] = None   # caller's prior [1, F, H, W, C]
    noise: Optional[torch.Tensor] = None  # caller's DDPM noise [T, 1, F, H, W, C]
    arrival: float = 0.0                 # stamped by the queue
    _seq: int = dataclasses.field(default=0, repr=False)


class RequestQueue:
    """Pending requests, ordered by an admission policy at pop time."""

    def __init__(self):
        self._pending: List[Request] = []
        self._seq = 0

    def __len__(self) -> int:
        return len(self._pending)

    def __bool__(self) -> bool:
        return bool(self._pending)

    def submit(self, req: Request, now: float) -> Request:
        req.arrival = now
        req._seq = self._seq
        self._seq += 1
        self._pending.append(req)
        return req

    def pop(self, policy: str = "fifo") -> Request:
        if policy not in POLICIES:
            raise ValueError(f"unknown policy {policy!r}; known: {POLICIES}")
        if not self._pending:
            raise IndexError("pop from empty request queue")
        if policy == "edf":
            req = min(self._pending, key=lambda r: (r.deadline, r._seq))
        else:
            req = min(self._pending, key=lambda r: r._seq)
        self._pending.remove(req)
        return req

    def take_expired(self, now: float) -> List[Request]:
        """Remove and return every queued request whose deadline has
        already passed (dispatching one would burn compute on a certain
        SLA miss), in arrival order."""
        expired = [r for r in self._pending if r.deadline < now]
        for r in expired:
            self._pending.remove(r)
        return sorted(expired, key=lambda r: r._seq)

    def peek_deadlines(self) -> List[float]:
        return sorted(r.deadline for r in self._pending)
