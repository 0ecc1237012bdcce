"""Span/event recorder with Chrome-trace export, the port of
``repro.telemetry.trace`` (host-pure, kept as the port's own copy).

Host-side only: records what the *engine* does (admit, pack, dispatch,
materialize, retire, build), never what the device computes — device
observability is :mod:`repro_torch.telemetry.taps`. The buffer is a bounded
ring (``collections.deque(maxlen=...)``): an engine serving indefinitely
must not grow memory per dispatch; drops are counted, not silent.

Timestamps come from an injected ``clock()`` — the serving engine's
simulated clock in tests (deterministic traces) or ``time.monotonic``
in production. Export renders the buffer as Chrome trace-event JSON
(``{"traceEvents": [...]}``) loadable in Perfetto / ``chrome://tracing``:
complete events (``ph="X"``) for spans, instants (``ph="i"``) for
events, counters (``ph="C"``) for gauges. Request lifecycles render as
one row per request (``tid`` = request id) under the "requests" track;
engine activity renders under ``tid=0``.
"""
from __future__ import annotations

import collections
import dataclasses
import json
import time
from contextlib import contextmanager
from typing import Any, Callable, Dict, List, Optional

#: trace rows: engine-wide activity vs per-request lifecycle tracks
ENGINE_PID = 1
REQUEST_PID = 2


@dataclasses.dataclass
class TraceEvent:
    name: str
    ph: str                      # 'X' complete | 'i' instant | 'C' counter
    ts: float                    # seconds (exported as µs)
    dur: float = 0.0             # seconds, complete events only
    pid: int = ENGINE_PID
    tid: int = 0
    args: Optional[Dict[str, Any]] = None

    def to_chrome(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {
            "name": self.name, "ph": self.ph, "pid": self.pid,
            "tid": self.tid, "ts": self.ts * 1e6,
        }
        if self.ph == "X":
            out["dur"] = max(self.dur, 0.0) * 1e6
        if self.ph == "i":
            out["s"] = "t"       # thread-scoped instant
        if self.args:
            out["args"] = self.args
        return out


class SpanRecorder:
    """Bounded ring buffer of :class:`TraceEvent`.

    >>> rec = SpanRecorder(clock=engine.clock)
    >>> with rec.span("dispatch", args={"k": 4}):
    ...     run()
    >>> rec.dump("trace.json")          # open in ui.perfetto.dev
    """

    def __init__(self, clock: Optional[Callable[[], float]] = None,
                 max_events: int = 65536):
        self.clock = clock or time.monotonic
        self.events: collections.deque = collections.deque(maxlen=max_events)
        self.events_recorded = 0
        self.events_dropped = 0

    # -- recording -----------------------------------------------------

    def _push(self, ev: TraceEvent) -> None:
        if len(self.events) == self.events.maxlen:
            self.events_dropped += 1
        self.events.append(ev)
        self.events_recorded += 1

    @contextmanager
    def span(self, name: str, tid: int = 0,
             args: Optional[Dict[str, Any]] = None):
        """Time a with-block as a complete event."""
        t0 = self.clock()
        try:
            yield
        finally:
            self._push(TraceEvent(name, "X", t0, self.clock() - t0,
                                  tid=tid, args=args))

    def complete(self, name: str, start: float, end: float, *,
                 pid: int = ENGINE_PID, tid: int = 0,
                 args: Optional[Dict[str, Any]] = None) -> None:
        """A span whose endpoints were stamped elsewhere (request
        lifecycles: admit/finish stamps come from the engine)."""
        self._push(TraceEvent(name, "X", start, end - start,
                              pid=pid, tid=tid, args=args))

    def instant(self, name: str, tid: int = 0,
                args: Optional[Dict[str, Any]] = None) -> None:
        self._push(TraceEvent(name, "i", self.clock(), tid=tid, args=args))

    def counter(self, name: str, values: Dict[str, float],
                ts: Optional[float] = None) -> None:
        """Gauge sample; ``ts`` backdates it (tap values are synced at
        export time but belong at their dispatch timestamp)."""
        self._push(TraceEvent(name, "C",
                              self.clock() if ts is None else ts,
                              args=dict(values)))

    @property
    def occupancy(self) -> float:
        """Ring-buffer fill fraction in [0, 1] — 1.0 means the next
        event evicts the oldest (drops are already being counted)."""
        cap = self.events.maxlen or 1
        return len(self.events) / cap

    def counters(self) -> Dict[str, float]:
        """Exporter-facing health counters (satellite: silent span loss
        must be observable in Prometheus/metrics_line)."""
        return {
            "events_recorded": float(self.events_recorded),
            "events_dropped": float(self.events_dropped),
            "occupancy": self.occupancy,
            "capacity": float(self.events.maxlen or 0),
        }

    # -- export --------------------------------------------------------

    def to_chrome_trace(self) -> Dict[str, Any]:
        """Chrome trace-event JSON object (Perfetto-loadable)."""
        meta = [
            {"name": "process_name", "ph": "M", "pid": ENGINE_PID,
             "args": {"name": "engine"}},
            {"name": "process_name", "ph": "M", "pid": REQUEST_PID,
             "args": {"name": "requests"}},
        ]
        return {"traceEvents": meta + [e.to_chrome() for e in self.events],
                "displayTimeUnit": "ms"}

    def dump(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_chrome_trace(), f)

    def by_name(self, name: str) -> List[TraceEvent]:
        return [e for e in self.events if e.name == name]
