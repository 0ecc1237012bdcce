"""On-device scalar taps, the port of ``repro.telemetry.taps``.

A *tap* is an extra **data** output of the packed step — never a host
callback, never a print, never a host read. The tapped step family
computes, beside its latents (which stay equal bit for bit to the
untapped family's):

* ``eps_norm`` — per-request RMS of the post-guidance eps prediction
  (the solver's actual input);
* ``finite`` — per-request all-finite flag of the step's output latents;
* ``drift`` — the realized cache replay error. The cached forward writes
  ``new_delta = h_deep − h_shallow`` at refresh steps and keeps the old
  delta at skip steps, so ``‖new_delta − old_delta‖ = ‖h_fresh −
  h_replay‖`` exactly at refresh steps and exactly 0 at skip steps: a
  subtraction of two tensors the step already holds;
* ``attn_blocks`` — the kernel ledger's (active, total) score-tile counts
  for the dispatch layout (``PackLayout.attention_block_stats``). It is a
  layout constant, so it rides along as host integers: making it a
  device tensor per dispatch would be a host-to-device copy.

The helpers below reduce on the device to tiny [n] vectors.
:class:`TapAggregator` holds samples as device tensors and brings them to
the host ONLY in :meth:`TapAggregator.aggregate` (and
:meth:`~TapAggregator.counter_series`, at trace export) — a dispatch
never waits on a tap.
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

#: keys a tapped step emits per group (drift only on the cached family)
TAP_NAMES = ("eps_norm", "finite", "drift", "attn_blocks")


def _rest(x: torch.Tensor) -> Tuple[int, ...]:
    return tuple(range(1, x.ndim))


def eps_norm_tap(eps: torch.Tensor) -> torch.Tensor:  # repro: traced
    """Per-request RMS of an eps batch [n, F, H, W, C] → [n] (float32)."""
    return torch.sqrt(torch.mean(torch.square(eps.float()), dim=_rest(eps)))


def finite_tap(x: torch.Tensor) -> torch.Tensor:  # repro: traced
    """Per-request all-finite flag of a latent batch [n, ...] → [n] bool
    (False: the row carries a NaN/Inf)."""
    return torch.isfinite(x).flatten(1).all(dim=1)


def drift_tap(new_delta: torch.Tensor,  # repro: traced
              old_delta: torch.Tensor) -> torch.Tensor:
    """Per-request RMS replay drift ``‖h_fresh − h_replay‖`` from the
    deep-block residuals [n, mult, N, d] → [n] (0 at skip steps)."""
    d = new_delta.float() - old_delta.float()
    return torch.sqrt(torch.mean(torch.square(d), dim=_rest(d)))


def _host(a: Any) -> np.ndarray:
    """A tap value on the host (the aggregator's one device read)."""
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


@dataclasses.dataclass
class TapSample:
    """One dispatch's tap outputs, still on the device.

    ``eps_norm[g]`` is [k, n_g]; ``drift[g]`` is [k, n_g] (cached step
    family only); ``attn_blocks`` is (active, total) per micro-step, host
    integers. ``n_real[g]`` masks dummy tail slots out of aggregation.
    """
    time: float
    k: int
    groups: Tuple[Tuple[int, int], ...]      # ((mode, capacity), ...)
    n_real: Tuple[int, ...]                  # live requests per group
    eps_norm: Tuple[Any, ...]
    drift: Optional[Tuple[Any, ...]] = None
    attn_blocks: Optional[Any] = None
    finite: Optional[Tuple[Any, ...]] = None  # [k, n_g] bool per group


class TapAggregator:
    """Bounded window of :class:`TapSample` + lifetime scalars.

    Device tensors are held as-is until :meth:`aggregate` — the single
    host-read point of the tap pipeline (export/summary time, off the
    dispatch path)."""

    def __init__(self, max_samples: int = 4096):
        self.samples: collections.deque = collections.deque(
            maxlen=max_samples)
        self.samples_recorded = 0

    def add(self, sample: TapSample) -> None:
        self.samples.append(sample)
        self.samples_recorded += 1

    def __len__(self) -> int:
        return len(self.samples)

    def aggregate(self) -> Dict[str, Any]:
        """Materialize the window into JSON-friendly aggregates — mean /
        max eps norm and replay drift over live request-steps, per-mode
        drift means (the online refresh-threshold signal), and the
        summed attention block ledger."""
        eps_all, drift_all = [], []
        per_mode: Dict[int, list] = {}
        blk_active = blk_total = 0
        n_request_steps = 0
        n_nonfinite = 0
        saw_finite = False
        for s in self.samples:
            for g, (mode, _cap) in enumerate(s.groups):
                n = s.n_real[g]
                if not n:
                    continue
                e = _host(s.eps_norm[g])[:, :n].ravel()
                eps_all.append(e)
                n_request_steps += e.size
                if s.drift is not None:
                    d = _host(s.drift[g])[:, :n].ravel()
                    drift_all.append(d)
                    per_mode.setdefault(mode, []).append(d)
                if s.finite is not None:
                    saw_finite = True
                    fi = _host(s.finite[g])[:, :n]
                    n_nonfinite += int((~fi).sum())
            if s.attn_blocks is not None:
                a, t = (int(v) for v in _host(s.attn_blocks))
                blk_active += a * s.k
                blk_total += t * s.k
        out: Dict[str, Any] = {
            "samples": len(self.samples),
            "samples_recorded": self.samples_recorded,
            "request_steps": n_request_steps,
        }
        if eps_all:
            e = np.concatenate(eps_all)
            out["eps_norm"] = {"mean": float(e.mean()),
                               "max": float(e.max())}
        if drift_all:
            d = np.concatenate(drift_all)
            out["drift"] = {"mean": float(d.mean()), "max": float(d.max()),
                            "p99": float(np.percentile(d, 99))}
            out["drift_per_mode"] = {
                str(m): float(np.concatenate(v).mean())
                for m, v in sorted(per_mode.items())}
        if blk_total:
            out["attn_blocks"] = {
                "active": blk_active, "total": blk_total,
                "skip_rate": 1.0 - blk_active / blk_total}
        if saw_finite:
            out["nonfinite_request_steps"] = n_nonfinite
        return out

    def counter_series(self):
        """Per-sample ``(time, {name: value})`` series for trace counter
        tracks — drift/eps means per dispatch, so the Perfetto timeline
        shows WHEN replay error spiked, not just that it did. Same sync
        discipline as :meth:`aggregate` (export time only)."""
        series = []
        for s in self.samples:
            eps_all, drift_all = [], []
            for g in range(len(s.groups)):
                n = s.n_real[g]
                if not n:
                    continue
                eps_all.append(_host(s.eps_norm[g])[:, :n].ravel())
                if s.drift is not None:
                    drift_all.append(_host(s.drift[g])[:, :n].ravel())
            if not eps_all:
                continue
            vals = {"eps_norm_mean": float(np.concatenate(eps_all).mean())}
            if drift_all:
                d = np.concatenate(drift_all)
                vals["drift_mean"] = float(d.mean())
                vals["drift_max"] = float(d.max())
            series.append((s.time, vals))
        return series
