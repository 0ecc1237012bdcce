"""The port's own spans on one clock with ``torch.profiler``: the
recorder's Unix-time export, the device spans' lazy reads and placement,
and the engine's spans-only telemetry, which must serve what it serves
without it, with the same waits.

This file imports neither JAX nor the JAX package. The device spans' CUDA
events are stood in for by a simulated stream here; the card's own events
are held in ``tests/test_torch_gpu.py``.
"""
import dataclasses
import json
import time

import pytest
import torch
from torch_threads import one_torch_thread  # noqa: F401

from repro_torch.configs import get_config
from repro_torch.core.scheduler import FlexiSchedule
from repro_torch.diffusion.schedule import linear_schedule
from repro_torch.models import dit as dit_mod
from repro_torch.pipeline import FlexiPipeline, SamplingPlan
from repro_torch.serving import ServingEngine
from repro_torch.telemetry import Telemetry
from repro_torch.telemetry import trace as ttrace


# ---------------------------------------------------------------------------
# One clock with the profiler


def test_recorder_spans_land_on_the_profilers_clock(tmp_path):
    """A recorder span and a ``record_function`` around the same block
    land within 1 ms of each other once the recorder's Unix-time export
    is laid over the profiler's trace through ``baseTimeNanoseconds``."""
    from torch.profiler import ProfilerActivity, profile, record_function
    rec = ttrace.SpanRecorder(clock=time.perf_counter)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("warm"):       # the first one sets up
            pass
        for i in range(3):
            with rec.span("probe", args={"i": i}), record_function("probe"):
                time.sleep(0.005 * (i + 1))
    path = tmp_path / "prof.json"
    prof.export_chrome_trace(str(path))
    trace = json.loads(path.read_text())
    base_us = trace["baseTimeNanoseconds"] / 1e3
    theirs = sorted((e for e in trace["traceEvents"]
                     if e.get("name") == "probe"
                     and e.get("cat") == "user_annotation"),
                    key=lambda e: e["ts"])
    ours = [e for e in rec.to_chrome_trace(unix=True)["traceEvents"]
            if e["name"] == "probe"]
    assert len(ours) == len(theirs) == 3
    for a, b in zip(ours, theirs):
        assert abs(a["ts"] - base_us - b["ts"]) < 1000.0
        assert abs(a["dur"] - b["dur"]) < 1000.0


def test_unix_export_takes_out_the_clocks_drift():
    """A clock running at half speed from an arbitrary origin: its times
    map onto Unix time through the bind-time pair and the export's, so an
    instant lands where ``time.time_ns`` stood when it was recorded. The
    default export keeps the clock's own times."""
    slow = lambda: 100.0 + 0.5 * time.perf_counter()  # noqa: E731
    rec = ttrace.SpanRecorder(clock=slow)
    time.sleep(0.02)
    rec.instant("mark")
    mark_us = time.time_ns() / 1e3
    time.sleep(0.02)
    (ev,) = [e for e in rec.to_chrome_trace(unix=True)["traceEvents"]
             if e["name"] == "mark"]
    assert abs(ev["ts"] - mark_us) < 1000.0
    (own,) = [e for e in rec.to_chrome_trace()["traceEvents"]
              if e["name"] == "mark"]
    assert own["ts"] == rec.by_name("mark")[0].ts * 1e6


# ---------------------------------------------------------------------------
# Device spans on a simulated stream


class FakeStream:
    """A device stream on a fake host clock: work runs in issue order,
    starting no earlier than it was issued; an event completes when the
    stream reaches it."""

    def __init__(self, clock):
        self.clock = clock
        self.tail = 0.0

    def run(self, seconds: float) -> None:
        self.tail = max(self.tail, self.clock()) + seconds


class FakeEvent:
    stream: FakeStream = None
    made = 0

    def __init__(self, enable_timing=False):
        assert enable_timing
        FakeEvent.made += 1
        self.at = None

    def record(self):
        s = FakeEvent.stream
        self.at = max(s.tail, s.clock())

    def query(self):
        return self.at <= FakeEvent.stream.clock()

    def elapsed_time(self, end):
        assert self.query() and end.query(), "read before completion"
        return (end.at - self.at) * 1e3


class FakeClock:
    def __init__(self, t: float = 0.0):
        self.t = t

    def __call__(self) -> float:
        return self.t


@pytest.fixture
def fake_cuda(monkeypatch):
    clk = FakeClock(1.0)
    FakeEvent.stream = FakeStream(clk)
    FakeEvent.made = 0
    monkeypatch.setattr(torch.cuda, "Event", FakeEvent)
    return clk, FakeEvent.stream


def test_device_spans_read_only_what_completed_and_place_it(fake_cuda):
    clk, stream = fake_cuda
    rec = ttrace.SpanRecorder(clock=clk)
    dev = ttrace.DeviceSpans(rec, "dispatch.device")
    pairs = []
    for i in range(2):            # the second is queued behind the first
        p = dev.begin()
        stream.run(0.005)
        dev.end(p, k=i)
        pairs.append(p)
        clk.t += 0.001
    dev.read()                    # at 1.002 nothing has completed
    assert rec.by_name("dispatch.device") == [] and pairs[0].seconds is None
    clk.t = 1.0075                # the first has
    dev.read()
    (first,) = rec.by_name("dispatch.device")
    assert (first.ts, first.tid, first.args) == (1.0, ttrace.DEVICE_TID,
                                                 {"k": 0})
    assert first.dur == pytest.approx(0.005)
    assert pairs[1].seconds is None
    clk.t = 2.0
    rec.to_chrome_trace()         # export reads the rest, waiting for none
    second = rec.by_name("dispatch.device")[1]
    assert second.ts == pytest.approx(1.005) and pairs[1].seconds == \
        pytest.approx(0.005)
    # read events go back to the pool: a third pair makes no new event
    made = FakeEvent.made
    p = dev.begin()
    stream.run(0.002)
    dev.end(p)
    clk.t = 3.0
    dev.read()
    assert FakeEvent.made == made
    assert rec.by_name("dispatch.device")[2].ts == pytest.approx(2.0)


def test_device_spans_catch_up_with_a_busy_origin(fake_cuda):
    """The first event is recorded behind a second of queued work, so its
    stamp is a second early; the first pair issued on an idle stream
    shows it, and from then on spans sit where the device ran them."""
    clk, stream = fake_cuda
    rec = ttrace.SpanRecorder(clock=clk)
    dev = ttrace.DeviceSpans(rec, "dispatch.device")
    stream.run(1.0)               # someone else's work, until 2.0
    p = dev.begin()
    stream.run(0.5)
    dev.end(p)
    clk.t = 3.0                   # idle since 2.5
    q = dev.begin()
    stream.run(0.25)
    dev.end(q)
    clk.t = 4.0
    dev.read()
    a, b = rec.by_name("dispatch.device")
    # the first read knows only the lower bound of its stamps
    assert a.ts >= 1.0 and a.dur == pytest.approx(0.5)
    assert b.ts == pytest.approx(3.0) and b.dur == pytest.approx(0.25)
    assert (p.seconds, q.seconds) == (pytest.approx(0.5),
                                      pytest.approx(0.25))


# ---------------------------------------------------------------------------
# Spans-only engine on the CPU


def _cfg():
    cfg = get_config("dit-xl-2").reduced()
    return dataclasses.replace(cfg, param_dtype="float32",
                               compute_dtype="float32")


@pytest.fixture(scope="module")
def pipe_parts():
    cfg = _cfg()
    gen = torch.Generator().manual_seed(0)
    params = dit_mod.init_dit(cfg, gen)
    for node, key in [(params["deembed"], "w_flex"),
                      (params["final"]["ada"], "w"),
                      (params["blocks"]["ada"], "w")]:
        node[key] = torch.randn(node[key].shape, generator=gen) * 0.05
    return params, cfg, linear_schedule(100)


def _plans():
    return {0.6: SamplingPlan(T=6, budget=FlexiSchedule.weak_first(6, 3),
                              guidance_scale=1.5, attn_backend="pallas"),
            1.0: SamplingPlan(T=6, budget=1.0, guidance_scale=1.5,
                              attn_backend="pallas")}


def test_spans_only_engine_serves_the_same_latents_and_waits(pipe_parts):
    """``Telemetry(taps=False)``: the same latents bit for bit and the
    same ``waits`` as no telemetry; one plan, pack, dispatch and retire
    span a dispatch, abutting from admit to retire, and no device span on
    the CPU."""
    params, cfg, sched = pipe_parts
    runs = {}
    for tel in (None, Telemetry(taps=False)):
        eng = ServingEngine(FlexiPipeline(params, cfg, sched, device="cpu"),
                            _plans(), max_tokens_per_step=256,
                            steps_per_dispatch=2, telemetry=tel)
        for i in range(5):
            eng.submit(cond=i, budget=(0.6, 1.0)[i % 2])
        out = eng.run()
        runs[tel is None] = ({r.request.id: r.x0 for r in out}, eng.waits,
                             eng.metrics.total_steps, tel)
    (plain, w0, n0, _), (spans, w1, n1, tel) = runs[True], runs[False]
    assert sorted(plain) == sorted(spans)
    assert all(torch.equal(plain[i], spans[i]) for i in plain)
    assert (w1, n1) == (w0, n0) and w0 > 0
    rec = tel.recorder
    for name in ("plan", "pack", "dispatch", "retire", "admit"):
        assert len(rec.by_name(name)) == n0, name
    assert len(rec.by_name("materialize")) == w0
    assert rec.by_name("dispatch.device") == []
    engine = sorted((e for e in rec.events if e.ph == "X" and e.tid == 0
                     and e.pid == ttrace.ENGINE_PID),
                    key=lambda e: e.ts)
    for prev, nxt in zip(engine, engine[1:]):
        if nxt.name != "admit":   # a new step starts with its admit
            assert nxt.ts == pytest.approx(prev.ts + prev.dur, abs=1e-9), \
                (prev.name, nxt.name)


def test_dispatch_device_pair_closes_after_the_cache_scatter(pipe_parts,
                                                            fake_cuda):
    """On a cached engine the ``dispatch.device`` pair opens before the
    runner call and closes after the cache store's scatter, so the span
    (and the profiled wall read from the same pair) covers the whole
    dispatch. The card's events are stood in for by the simulated
    stream."""
    from repro_torch.serving import CacheSpec
    params, cfg, sched = pipe_parts
    tel = Telemetry(taps=False)
    eng = ServingEngine(FlexiPipeline(params, cfg, sched, device="cpu"),
                        _plans(), max_tokens_per_step=256,
                        steps_per_dispatch=2, telemetry=tel,
                        cache=CacheSpec(policy="interval", interval=2))
    log = []
    dev = eng._dev = ttrace.DeviceSpans(tel.recorder, "dispatch.device")
    begin, end, scatter = dev.begin, dev.end, eng.store.scatter
    dev.begin = lambda: log.append("begin") or begin()
    dev.end = lambda pair, **a: log.append("end") or end(pair, **a)
    eng.store.scatter = lambda *a: log.append("scatter") or scatter(*a)
    for i in range(4):
        eng.submit(cond=i, budget=(0.6, 1.0)[i % 2])
    eng.run()
    n = eng.metrics.total_steps
    assert log.count("begin") == log.count("end") == n
    assert "scatter" in log
    for seg in "".join(w[0] for w in log).split("b")[1:]:
        assert seg.endswith("e") and seg.count("e") == 1, log
    tel.recorder.to_chrome_trace()
    assert len(tel.recorder.by_name("dispatch.device")) == n
