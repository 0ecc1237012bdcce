"""SLO watchdog and crash flight recorder, the port of
``repro.telemetry.watchdog``.

Rolling detectors over the engine's per-step observables:

* **recompile** — the pipeline's ``compiled`` counter (runners built)
  moved after warm-up: the build-once invariant broke in production, not
  in a test;
* **queue** — admission queue depth exceeded its limit (the controller
  is mispricing or traffic outran capacity);
* **p99** — rolling p99 of completed-request latency breached the SLO;
* **drift** — cache replay drift (the taps' ``‖h_fresh − h_replay‖``)
  spiked past the configured limit, checked every ``taps_every`` engine
  steps (each check is one host read of the tap window);
* **nonfinite** — the engine's quarantine count grew.

Each firing emits a structured ``alert.<kind>`` instant event into the
:class:`~repro_torch.telemetry.trace.SpanRecorder` (so alerts land in the
same Chrome trace as the spans they explain) and, when a post-mortem
directory is configured, dumps a flight-recorder bundle: last-N spans,
engine/cache/queue snapshot, in-flight request states, attribution
totals, and the cost registry. The same ``dump()`` path runs on an
uncaught engine exception, so a crash leaves evidence.

Detectors are host-only arithmetic over numbers the engine already has —
the watchdog never reads the device itself. Per-kind cooldowns and a
max-dump cap keep a persistent breach from flooding the disk.
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Dict, List, Optional, Sequence

from repro_torch.telemetry.trace import SpanRecorder

ALERT_RECOMPILE = "recompile"
ALERT_QUEUE = "queue"
ALERT_P99 = "p99"
ALERT_DRIFT = "drift"
ALERT_NONFINITE = "nonfinite"


@dataclasses.dataclass(frozen=True)
class WatchdogConfig:
    p99_slo_s: Optional[float] = None   # None disables the p99 detector
    queue_limit: int = 256
    drift_limit: float = 1e-2
    warmup_steps: int = 8               # ignore runner builds before this
    taps_every: int = 16                # engine steps between tap drift
    #                                     checks (each is one host sync)
    window: int = 64                    # latency window for rolling p99
    min_latencies: int = 8              # need this many before p99 fires
    cooldown_steps: int = 50            # per-kind re-fire suppression
    max_dumps: int = 4


@dataclasses.dataclass
class Alert:
    kind: str
    step: int
    time: float
    value: float
    limit: float
    detail: str = ""

    def as_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


def _p99(sorted_vals: Sequence[float]) -> float:
    if not sorted_vals:
        return 0.0
    idx = min(len(sorted_vals) - 1, int(0.99 * len(sorted_vals)))
    return sorted_vals[idx]


class Watchdog:
    """Per-step detector bank + post-mortem dumper. ``recorder`` and
    ``postmortem_dir`` are bound by
    :class:`~repro_torch.telemetry.Telemetry`."""

    def __init__(self, config: Optional[WatchdogConfig] = None,
                 recorder: Optional[SpanRecorder] = None,
                 postmortem_dir: Optional[str] = None):
        self.config = config or WatchdogConfig()
        self.recorder = recorder
        self.postmortem_dir = postmortem_dir
        self.alerts: List[Alert] = []
        self.dumps_written: List[str] = []
        self._step = 0
        self._compiled_baseline: Optional[int] = None
        self._last_fire: Dict[str, int] = {}
        self._pending_dump = False
        self._nonfinite_seen = 0

    # -- detection ------------------------------------------------------

    def _fire(self, kind: str, now: float, value: float, limit: float,
              detail: str) -> Optional[Alert]:
        last = self._last_fire.get(kind)
        if last is not None and self._step - last < self.config.cooldown_steps:
            return None
        self._last_fire[kind] = self._step
        alert = Alert(kind=kind, step=self._step, time=now, value=value,
                      limit=limit, detail=detail)
        self.alerts.append(alert)
        self._pending_dump = True
        if self.recorder is not None:
            self.recorder.instant(f"alert.{kind}", args=alert.as_dict())
        return alert

    def observe_step(self, *, now: float, queued: int, inflight: int,
                     compiled: int,
                     latencies: Sequence[float] = (),
                     drift_max: Optional[float] = None,
                     nonfinite: int = 0) -> List[Alert]:
        """Run all detectors against one engine step's observables.
        Returns the alerts that fired (already recorded as events)."""
        self._step += 1
        cfg = self.config
        fired: List[Alert] = []

        if self._step <= cfg.warmup_steps or self._compiled_baseline is None:
            self._compiled_baseline = compiled
        elif compiled > self._compiled_baseline:
            a = self._fire(ALERT_RECOMPILE, now, float(compiled),
                           float(self._compiled_baseline),
                           f"runners built {self._compiled_baseline}"
                           f" -> {compiled} after warmup")
            self._compiled_baseline = compiled
            if a:
                fired.append(a)

        if queued > cfg.queue_limit:
            a = self._fire(ALERT_QUEUE, now, float(queued),
                           float(cfg.queue_limit),
                           f"{queued} queued / {inflight} in flight")
            if a:
                fired.append(a)

        if cfg.p99_slo_s is not None and len(latencies) >= cfg.min_latencies:
            recent = sorted(list(latencies)[-cfg.window:])
            p99 = _p99(recent)
            if p99 > cfg.p99_slo_s:
                a = self._fire(ALERT_P99, now, p99, cfg.p99_slo_s,
                               f"rolling p99 over last {len(recent)}"
                               " completions")
                if a:
                    fired.append(a)

        if drift_max is not None and drift_max > cfg.drift_limit:
            a = self._fire(ALERT_DRIFT, now, float(drift_max),
                           cfg.drift_limit, "cache replay drift spike")
            if a:
                fired.append(a)

        # nonfinite is the engine's lifetime quarantine count: any growth
        # means NaN/Inf latents were detected and recovery (weak→powerful
        # re-enqueue) engaged — alert so the recovery action is visible in
        # the same trace. The seen-mark only advances on an actual fire,
        # so growth suppressed by the cooldown re-fires once it expires.
        if nonfinite > self._nonfinite_seen:
            a = self._fire(ALERT_NONFINITE, now, float(nonfinite),
                           float(self._nonfinite_seen),
                           "non-finite latents quarantined; escalated to"
                           " full compute")
            if a:
                fired.append(a)
                self._nonfinite_seen = nonfinite
        return fired

    def should_dump(self) -> bool:
        return (self._pending_dump and self.postmortem_dir is not None
                and len(self.dumps_written) < self.config.max_dumps)

    # -- the flight recorder -------------------------------------------

    def dump(self, *, reason: str,
             engine_snapshot: Optional[Dict[str, Any]] = None,
             attribution: Optional[Any] = None,
             registry: Optional[Any] = None,
             taps: Optional[Dict[str, Any]] = None,
             last_spans: int = 512) -> Optional[str]:
        """Write one post-mortem bundle to ``postmortem_dir``. Never
        raises (a broken dumper must not mask the original failure);
        returns the path, or None when disabled/capped/failed."""
        self._pending_dump = False
        if (self.postmortem_dir is None
                or len(self.dumps_written) >= self.config.max_dumps):
            return None
        try:
            bundle: Dict[str, Any] = {
                "reason": reason,
                "step": self._step,
                "alerts": [a.as_dict() for a in self.alerts],
                "engine": engine_snapshot or {},
            }
            if self.recorder is not None:
                bundle["spans"] = [
                    dataclasses.asdict(e)
                    for e in list(self.recorder.events)[-last_spans:]]
                bundle["span_counters"] = self.recorder.counters()
            if attribution is not None:
                bundle["attribution"] = attribution.snapshot()
            if registry is not None:
                bundle["compiled_costs"] = registry.reconcile()
            if taps:
                bundle["taps"] = taps
            os.makedirs(self.postmortem_dir, exist_ok=True)
            path = os.path.join(
                self.postmortem_dir,
                f"postmortem_{len(self.dumps_written)}.json")
            with open(path, "w") as f:
                json.dump(bundle, f, indent=1, default=str)
            self.dumps_written.append(path)
            return path
        except Exception:                         # noqa: BLE001
            return None
