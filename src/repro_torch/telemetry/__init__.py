"""Inference telemetry of the port, the port of ``repro.telemetry``.

Three layers, one rule — **observability must be data, not structure**:

* :mod:`repro_torch.telemetry.trace` — host-side span/event recorder
  (bounded ring buffer, the engine's clock) with Chrome-trace/Perfetto
  export: admit → plan → pack → dispatch → materialize → retire, plus
  runner builds;
* :mod:`repro_torch.telemetry.taps` — on-device scalar taps, extra data
  outputs of the packed step (per-request eps norm and finite flag,
  realized cache replay drift, the kernel ledger's attention block
  counts): latents equal the untapped step's bit for bit, and no tap is
  read on the dispatch path;
* :mod:`repro_torch.telemetry.export` — Prometheus text-format + JSON
  snapshot exporters (duck-typed: this package never imports the engine).

``Telemetry`` bundles a recorder + tap aggregator for the serving engine,
with optional cost profiling (:mod:`~repro_torch.telemetry.profile`,
:mod:`~repro_torch.telemetry.attribution`) and an SLO watchdog
(:mod:`~repro_torch.telemetry.watchdog`). Device values reach the host
only inside ``TapAggregator.aggregate()`` / trace export, and, with
profiling on, at the one wait per dispatch that measures its wall time.
"""
from repro_torch.telemetry.taps import TapAggregator, TapSample  # noqa: F401
from repro_torch.telemetry.trace import SpanRecorder, TraceEvent  # noqa: F401


class Telemetry:
    """One serving session's telemetry bundle.

    ``taps=False`` keeps the engine on the untapped step family (spans
    only); ``taps=True`` routes dispatches through the tapped runners —
    same latents bit for bit, plus per-dispatch tap samples.

    ``profile=True`` adds the cost registry + per-request attribution
    ledger: the engine then measures each dispatch's wall time (CUDA
    events and one wait per dispatch — latents unchanged) and splits it
    across requests with exact conservation. ``watchdog`` /
    ``postmortem_dir`` wire the SLO detector bank and crash flight
    recorder; passing only ``postmortem_dir`` builds a default-config
    watchdog.
    """

    def __init__(self, clock=None, taps: bool = False,
                 max_events: int = 65536, max_samples: int = 4096,
                 profile: bool = False, watchdog=None,
                 postmortem_dir=None):
        self.recorder = SpanRecorder(clock=clock, max_events=max_events)
        self.taps = TapAggregator(max_samples=max_samples)
        self.taps_enabled = bool(taps)
        self.profile = None
        self.attribution = None
        if profile:
            # lazy: profile.py imports the pipeline and the model costing;
            # the plain spans+taps bundle stays importable without them
            from repro_torch.telemetry.attribution import AttributionLedger
            from repro_torch.telemetry.profile import CompiledCostRegistry
            self.profile = CompiledCostRegistry()
            self.attribution = AttributionLedger()
        if watchdog is None and postmortem_dir is not None:
            from repro_torch.telemetry.watchdog import Watchdog
            watchdog = Watchdog()
        self.watchdog = watchdog
        if self.watchdog is not None:
            self.watchdog.recorder = self.recorder
            if postmortem_dir is not None:
                self.watchdog.postmortem_dir = postmortem_dir

    @property
    def profiling(self) -> bool:
        return self.profile is not None

    def bind_clock(self, clock) -> None:
        """Adopt the engine's clock (simulated or wall) if the recorder
        was built before the engine existed."""
        self.recorder.clock = clock

    def snapshot(self) -> dict:
        """JSON-friendly view: tap aggregates + recorder counters."""
        out = {"taps_enabled": self.taps_enabled,
               "tap_aggregates": self.taps.aggregate(),
               "events_recorded": self.recorder.events_recorded,
               "events_dropped": self.recorder.events_dropped,
               "span_occupancy": self.recorder.occupancy}
        if self.attribution is not None:
            out["attribution"] = self.attribution.snapshot()
        if self.watchdog is not None:
            out["alerts"] = [a.as_dict() for a in self.watchdog.alerts]
        return out
