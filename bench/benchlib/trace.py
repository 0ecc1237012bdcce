"""Reading a ``torch.profiler`` trace of the traced part of a window: the
device's busy time as the union of its kernel, copy and fill intervals
(the method of the port's ``tools/serving_trace.py``), the idle gaps
between them named by the harness's span the host was in when each gap
began, the device operations that took most time, and the flash kernel's
launches.

The harness marks its own calls into the program with
``torch.profiler.record_function("bench.<what>")``; the traced part of the
window is the span ``bench.window``.
"""
from __future__ import annotations

import bisect
import json
import os
from contextlib import contextmanager
from pathlib import Path
from typing import Any, Dict, Iterator, List, Optional, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
WINDOW = "bench.window"
TOP = 10


class Tracer:
    """The profiler over the traced part of a window (``on=False``: no
    profiler, every span a no-op)."""

    def __init__(self, on: bool, path: Path):
        self.on = on
        self.path = path
        self.prof = None
        self.active = False
        self.summary: Optional[Dict[str, Any]] = None

    def start(self) -> None:
        """Start the profiler (its own start-up takes seconds: before the
        window opens)."""
        if not self.on:
            return
        from torch.profiler import ProfilerActivity, profile
        self.prof = profile(activities=[ProfilerActivity.CPU,
                                        ProfilerActivity.CUDA])
        self.prof.start()

    def open_window(self) -> None:
        """Open the traced part of the window."""
        if self.prof is None:
            return
        self.active = True
        self._window = self.span(WINDOW)
        self._window.__enter__()

    def stop(self) -> None:
        """End the traced part (the caller has synchronised the device)."""
        if not self.active:
            return
        self._window.__exit__(None, None, None)
        self.active = False
        self.prof.stop()

    def read(self) -> Optional[Dict[str, Any]]:
        """After the window: the trace's summary (None untraced)."""
        if self.prof is None:
            return None
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self.prof.export_chrome_trace(str(self.path))
        self.prof = None
        try:
            with open(self.path) as f:
                events = json.load(f)["traceEvents"]
        finally:
            os.remove(self.path)
        self.summary = summarize(events)
        return self.summary

    @contextmanager
    def span(self, name: str) -> Iterator[None]:
        if not self.active:
            yield
            return
        from torch.profiler import record_function
        with record_function(name):
            yield


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1] = (out[-1][0], b)
        else:
            out.append((a, b))
    return out


def summarize(events: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Busy and window seconds, the top device ops, the longest idle gaps
    named by host span, and the flash kernel's launch durations, all
    within the ``bench.window`` span."""
    win = [e for e in events if e.get("name") == WINDOW
           and e.get("ph") == "X" and e.get("cat") == "user_annotation"]
    if not win:
        raise RuntimeError("the trace holds no bench.window span")
    w0 = float(win[0]["ts"])
    w1 = w0 + float(win[0]["dur"])
    dev, spans = [], []
    by_name: Dict[str, float] = {}
    flash: List[float] = []
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat", "")
        a = float(e["ts"])
        b = a + float(e.get("dur", 0.0))
        if cat in DEVICE_CATS:
            a, b = max(a, w0), min(b, w1)
            if b <= a:
                continue
            dev.append((a, b))
            name = str(e.get("name", "?"))
            by_name[name] = by_name.get(name, 0.0) + (b - a)
            if cat == "kernel" and "flash" in name.lower():
                flash.append(float(e.get("dur", 0.0)) * 1e-6)
        elif cat == "user_annotation" and str(e.get("name", "")).startswith(
                "bench.") and e["name"] != WINDOW:
            spans.append((a, b, e["name"]))
    busy = _union(dev)
    busy_us = sum(b - a for a, b in busy)
    gaps = []
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    spans.sort()
    starts = [s[0] for s in spans]
    for g0, g1 in zip(edges[0::2], edges[1::2]):
        if g1 <= g0:
            continue
        gaps.append((g1 - g0, _host_at(spans, starts, g0)))
    gaps.sort(reverse=True)
    top_ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
    return {
        "window_s": (w1 - w0) * 1e-6,
        "busy_s": busy_us * 1e-6,
        "device_ops": [[n[:160], s * 1e-6] for n, s in top_ops],
        "idle_gaps": [[n, s * 1e-6] for s, n in gaps[:TOP]],
        "flash_s": flash,
    }


def _host_at(spans, starts, t: float) -> str:
    """The innermost harness span open on the host at ``t``."""
    i = bisect.bisect_right(starts, t)
    best = None
    for a, b, name in reversed(spans[max(0, i - 64):i]):
        if a <= t < b and (best is None or a > best[0]):
            best = (a, name)
    return best[1] if best else "bench.other"
