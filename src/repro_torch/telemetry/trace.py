"""Span/event recorder with Chrome-trace export, the port of
``repro.telemetry.trace`` (host-pure, kept as the port's own copy), plus
device spans timed by CUDA events (:class:`DeviceSpans`).

The recorder holds what the *engine* does (admit, plan, pack, compile,
dispatch, materialize, retire); tap values are
:mod:`repro_torch.telemetry.taps`'. The buffer is a bounded ring
(``collections.deque(maxlen=...)``): an engine serving indefinitely must
not grow memory per dispatch; drops are counted, not silent.

Timestamps come from an injected ``clock()`` — the serving engine's
simulated clock in tests (deterministic traces) or ``time.monotonic``
in production. Export renders the buffer as Chrome trace-event JSON
(``{"traceEvents": [...]}``) loadable in Perfetto / ``chrome://tracing``:
complete events (``ph="X"``) for spans, instants (``ph="i"``) for
events, counters (``ph="C"``) for gauges. Request lifecycles render as
one row per request (``tid`` = request id) under the "requests" track;
engine activity renders under ``tid=0``, device spans under
``tid=DEVICE_TID``.

One clock with ``torch.profiler``: binding a clock stamps the pair
``(clock(), time.time_ns())``, and ``to_chrome_trace(unix=True)`` stamps
a second pair and maps every time linearly through the two, so ``ts`` is
in µs of Unix time with the drift between the two clocks over the run
taken out. A profiler's Chrome trace stamps ``ts`` in µs of Unix time
less its ``baseTimeNanoseconds``; subtract that to lay the recorder's
spans over it. Nothing is added per span.
"""
from __future__ import annotations

import collections
import dataclasses
import json
import time
from contextlib import contextmanager
from typing import Any, Callable, Dict, List, Optional, Tuple

#: trace rows: engine-wide activity vs per-request lifecycle tracks
ENGINE_PID = 1
REQUEST_PID = 2
#: the engine's device track: spans timed on the device by CUDA events
DEVICE_TID = 1


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
        self.events: collections.deque = collections.deque(maxlen=max_events)
        self.events_recorded = 0
        self.events_dropped = 0
        # run before every export: device spans whose events were not
        # read yet (DeviceSpans.read)
        self._readers: List[Callable[[], None]] = []
        self.bind(clock or time.monotonic)

    def bind(self, clock: Callable[[], float]) -> None:
        """Adopt ``clock`` and stamp the pair ``(clock(), Unix ns)`` that
        anchors its times to Unix time at export."""
        self.clock = clock
        self._anchor: Tuple[float, int] = (clock(), time.time_ns())

    def add_reader(self, read: Callable[[], None]) -> None:
        """Call ``read()`` before every export (pending device spans)."""
        self._readers.append(read)

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

    def read_pending(self) -> None:
        """Record the device spans whose events have completed (no
        wait)."""
        for read in self._readers:
            read()

    def _unix_us(self) -> Tuple[float, float, float]:
        """``(c0, u0, rate)``: a time ``t`` of the clock is Unix µs
        ``u0 + (t - c0) * rate``, through the bind-time pair and one
        stamped now."""
        c0, u0 = self._anchor
        c1, u1 = self.clock(), time.time_ns()
        rate = (u1 - u0) / ((c1 - c0) * 1e3) if c1 > c0 else 1e6
        return c0, u0 / 1e3, rate

    def to_chrome_trace(self, unix: bool = False) -> Dict[str, Any]:
        """Chrome trace-event JSON object (Perfetto-loadable); ``unix``:
        ``ts`` in µs of Unix time (see the module's docstring), else the
        clock's own seconds in µs."""
        self.read_pending()
        events = [e.to_chrome() for e in self.events]
        if unix:
            c0, u0, rate = self._unix_us()
            for ev in events:
                ev["ts"] = u0 + (ev["ts"] * 1e-6 - c0) * rate
                if "dur" in ev:
                    ev["dur"] *= rate * 1e-6
        meta = [
            {"name": "process_name", "ph": "M", "pid": ENGINE_PID,
             "args": {"name": "engine"}},
            {"name": "process_name", "ph": "M", "pid": REQUEST_PID,
             "args": {"name": "requests"}},
        ]
        return {"traceEvents": meta + events, "displayTimeUnit": "ms"}

    def dump(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_chrome_trace(), f)

    def by_name(self, name: str) -> List[TraceEvent]:
        return [e for e in self.events if e.name == name]


@dataclasses.dataclass
class EventPair:
    """One interval of device work: CUDA events and the recorder clock's
    time at which each was recorded; ``seconds`` once read."""
    start: Any
    t_start: float
    end: Any = None
    t_end: float = 0.0
    args: Optional[Dict[str, Any]] = None
    seconds: Optional[float] = None


class DeviceSpans:
    """Spans of device work timed by CUDA event pairs, written into a
    recorder's device track (``tid=DEVICE_TID``) without a wait of their
    own: :meth:`read` turns only pairs whose end event has completed into
    spans, so the owner calls it after a wait it makes anyway, and the
    recorder calls it before every export. Read events go back to a pool.

    Placement: each event is stamped with the recorder's clock just before
    it is recorded, and the device cannot run it earlier. A span is placed
    at its origin's time (the last read pair's end, the first event at
    first) plus the device time since it, raised where it would start or
    end before its own stamp: exact once an event was recorded on an idle
    stream, which happens after every wait.

    >>> dev = DeviceSpans(recorder, "dispatch.device")
    >>> pair = dev.begin(); run(); dev.end(pair, k=4)
    >>> wait(); dev.read(); pair.seconds
    """

    def __init__(self, recorder: SpanRecorder, name: str):
        self.recorder = recorder
        self.name = name
        self._free: List[Any] = []
        self._open: collections.deque = collections.deque()
        self._origin: Optional[Tuple[Any, float]] = None
        recorder.add_reader(self.read)

    def _record(self) -> Tuple[Any, float]:
        if self._free:
            ev = self._free.pop()
        else:
            import torch
            ev = torch.cuda.Event(enable_timing=True)
        t = self.recorder.clock()
        ev.record()
        return ev, t

    def begin(self) -> EventPair:
        """Record the start event on the current stream."""
        if self._origin is None:
            self._origin = self._record()
        return EventPair(*self._record())

    def end(self, pair: EventPair, **args: Any) -> None:
        """Record the end event; the pair is read later."""
        pair.end, pair.t_end = self._record()
        pair.args = args or None
        self._open.append(pair)

    def read(self) -> None:
        """Record a span for every pair whose end event has completed, in
        the order they were recorded (one stream completes in order)."""
        while self._open and self._open[0].end.query():
            p = self._open.popleft()
            origin, at = self._origin
            a = at + origin.elapsed_time(p.start) * 1e-3
            b = at + origin.elapsed_time(p.end) * 1e-3
            late = max(0.0, p.t_start - a, p.t_end - b)
            a, b = a + late, b + late
            p.seconds = b - a
            self.recorder.complete(self.name, a, b, tid=DEVICE_TID,
                                   args=p.args)
            self._free += [origin, p.start]
            self._origin = (p.end, b)
