"""Metrics exporters, the port of ``repro.telemetry.export`` (host-pure,
kept as the port's own copy).

Renders ``ServingMetrics`` summaries, cache summaries, the pipeline's
runner-cache counters, and tap aggregates as:

* **Prometheus text format** (``prometheus_text``) — flat
  ``repro_<name>`` gauges with nested dicts flattened into label-free
  suffixed names (scrape endpoint / node-exporter textfile collector);
* **JSON snapshot** (``json_snapshot``) — one nested dict for dashboards
  and the bench artifacts;
* **structured log line** (``metrics_line``) — the ``--metrics-interval``
  one-liner: ``[metrics] k=v ...`` with stable key order.

Everything here is duck-typed over plain dicts — the engine imports
telemetry, so telemetry must never import the engine.
"""
from __future__ import annotations

import json
import math
from typing import Any, Dict, Mapping, Optional


def _flatten(prefix: str, node: Any, out: Dict[str, float]) -> None:
    if isinstance(node, Mapping):
        for k, v in node.items():
            key = f"{prefix}_{k}" if prefix else str(k)
            _flatten(_sanitize(key), v, out)
        return
    if isinstance(node, bool):
        out[prefix] = float(node)
        return
    if isinstance(node, (int, float)):
        v = float(node)
        if not math.isnan(v):
            out[prefix] = v


def _sanitize(name: str) -> str:
    return "".join(c if c.isalnum() or c == "_" else "_" for c in name)


def flatten_metrics(snapshot: Mapping[str, Any],
                    prefix: str = "repro") -> Dict[str, float]:
    """Nested summary dicts → flat ``{metric_name: value}`` (non-numeric
    leaves and NaNs dropped — absent beats poisoned)."""
    out: Dict[str, float] = {}
    _flatten(_sanitize(prefix), snapshot, out)
    return out


def build_snapshot(summary: Optional[Mapping[str, Any]] = None,
                   cache: Optional[Mapping[str, Any]] = None,
                   compile_stats: Optional[Mapping[str, Any]] = None,
                   taps: Optional[Mapping[str, Any]] = None,
                   spans: Optional[Mapping[str, Any]] = None
                   ) -> Dict[str, Any]:
    """Assemble the canonical snapshot from the engine's pieces
    (``metrics.summary(wall)``, ``metrics.cache_summary()``,
    ``pipe.cache_stats()``, ``telemetry.taps.aggregate()``,
    ``recorder.counters()``)."""
    snap: Dict[str, Any] = {}
    if summary:
        snap["serving"] = dict(summary)
    if cache:
        snap["cache"] = dict(cache)
    if compile_stats:
        snap["compile"] = dict(compile_stats)
    if taps:
        snap["taps"] = dict(taps)
    if spans:
        snap["spans"] = dict(spans)
    return snap


def json_snapshot(summary: Optional[Mapping[str, Any]] = None,
                  cache: Optional[Mapping[str, Any]] = None,
                  compile_stats: Optional[Mapping[str, Any]] = None,
                  taps: Optional[Mapping[str, Any]] = None,
                  spans: Optional[Mapping[str, Any]] = None) -> str:
    return json.dumps(build_snapshot(summary, cache, compile_stats, taps,
                                     spans),
                      sort_keys=True)


def prometheus_text(summary: Optional[Mapping[str, Any]] = None,
                    cache: Optional[Mapping[str, Any]] = None,
                    compile_stats: Optional[Mapping[str, Any]] = None,
                    taps: Optional[Mapping[str, Any]] = None,
                    spans: Optional[Mapping[str, Any]] = None,
                    prefix: str = "repro") -> str:
    """Prometheus exposition text (type: gauge) for the snapshot."""
    flat = flatten_metrics(build_snapshot(summary, cache, compile_stats,
                                          taps, spans), prefix)
    lines = []
    for name in sorted(flat):
        lines.append(f"# TYPE {name} gauge")
        lines.append(f"{name} {flat[name]:.10g}")
    return "\n".join(lines) + ("\n" if lines else "")


#: metrics_line key order — SLA signals first, then throughput, then
#: device-side health; anything else appends alphabetically
_LINE_ORDER = ("served", "p50", "p99", "deadline_hit_rate", "tokens_per_s",
               "packing_efficiency", "cache_hit_rate",
               "attn_block_skip_rate", "drift_mean", "drift_max",
               "eps_norm_mean", "compiled", "span_dropped",
               "span_occupancy")


def metrics_line(summary: Mapping[str, Any],
                 taps: Optional[Mapping[str, Any]] = None,
                 compile_stats: Optional[Mapping[str, Any]] = None,
                 spans: Optional[Mapping[str, Any]] = None,
                 tag: str = "metrics") -> str:
    """The periodic structured log line: ``[metrics] served=12 ...``."""
    flat: Dict[str, float] = {}
    _flatten("", dict(summary), flat)
    if taps:
        for k in ("drift", "eps_norm"):
            sub = taps.get(k)
            if isinstance(sub, Mapping):
                for stat in ("mean", "max"):
                    if stat in sub:
                        flat[f"{k}_{stat}"] = float(sub[stat])
    if compile_stats and "compiled" in compile_stats:
        flat["compiled"] = float(compile_stats["compiled"])
    if spans:
        if "events_dropped" in spans:
            flat["span_dropped"] = float(spans["events_dropped"])
        if "occupancy" in spans:
            flat["span_occupancy"] = float(spans["occupancy"])
    keys = [k for k in _LINE_ORDER if k in flat]
    keys += sorted(k for k in flat if k not in _LINE_ORDER)
    body = " ".join(f"{k}={flat[k]:.4g}" for k in keys)
    return f"[{tag}] {body}"
