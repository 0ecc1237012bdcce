"""Cross-step activation-cache refresh policies, the port of
``repro.cache.policy`` (host numpy, as in the reference).

A :class:`CacheSpec` declares how a sampling run reuses deep-block
features across denoise steps: the *split point* (how many shallow
blocks always recompute) and the *refresh policy* deciding, per step of
the timestep ladder, whether the deep blocks recompute (refresh) or
replay the cached residual delta (skip).

Every policy resolves ON THE HOST to a boolean refresh mask over a
phase's timestep ladder. The mask is data handed to the runner, never
part of its key, so switching policies or thresholds builds nothing. The
clock resets at every phase boundary (the token count changes with the
patch mode, so the cache cannot carry over) and index 0 of each phase is
always a refresh.

Policies:

* ``interval`` — refresh every ``interval`` steps (interval=1 refreshes
  every step, which is bit-identical to uncached sampling);
* ``banded`` — per timestep band: ``bands = ((t_lo, k), ...)`` uses
  interval ``k`` while ``t >= t_lo`` (first match in descending ``t_lo``
  order), falling back to ``interval`` below all bands;
* ``proxy`` — analytic error proxy: refresh when the *conditioning
  drift* since the last refresh exceeds ``threshold``. The conditioning
  vector is an MLP of the sinusoidal timestep embedding (plus a
  step-constant class/text term), so its drift is driven entirely by
  the embedding: we use the cosine distance between sinusoidal
  embeddings, computed analytically from the ladder with no model
  evaluation.
"""
from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

import numpy as np

CACHE_POLICIES = ("interval", "banded", "proxy")


def _temb_half() -> int:
    # derived from the model's embedding width so the analytic drift
    # cannot diverge from the conditioning it stands in for
    from repro_torch.models.dit import T_EMB_DIM
    return T_EMB_DIM // 2


_TEMB_MAX_PERIOD = 10_000.0   # models.common.timestep_embedding default


@dataclasses.dataclass(frozen=True)
class CacheSpec:
    """Declarative cross-step cache config (hashable — joins plan/runner
    cache keys). ``split=0`` resolves to ``max(1, num_layers // 4)``
    shallow blocks at apply time."""
    policy: str = "proxy"
    interval: int = 2                             # 'interval' + band fallback
    bands: Tuple[Tuple[int, int], ...] = ()       # ((t_lo, interval), ...)
    threshold: float = 0.05                       # 'proxy' drift trigger
    split: int = 0                                # shallow blocks (0 = auto)

    def __post_init__(self):
        if self.policy not in CACHE_POLICIES:
            raise ValueError(f"unknown cache policy {self.policy!r}; known: "
                             f"{CACHE_POLICIES}")
        if self.interval < 1:
            raise ValueError(f"interval must be >= 1, got {self.interval}")
        if self.threshold <= 0:
            raise ValueError(f"threshold must be > 0, got {self.threshold}")
        if self.split < 0:
            raise ValueError(f"split must be >= 0, got {self.split}")
        for band in self.bands:
            if len(band) != 2 or band[0] < 0 or band[1] < 1:
                raise ValueError(f"bands entries are (t_lo >= 0, "
                                 f"interval >= 1), got {band}")

    def resolve_split(self, num_layers: int) -> int:
        split = self.split or max(1, num_layers // 4)
        if not 1 <= split < num_layers:
            raise ValueError(f"cache split {split} must leave at least one "
                             f"deep block (model has {num_layers} layers)")
        return split

    @property
    def exact(self) -> bool:
        """Whether this spec can never skip (bit-identical to uncached)."""
        return (self.policy == "interval" and self.interval == 1
                and not self.bands)


# ---------------------------------------------------------------------------
# Analytic conditioning drift (the 'proxy' policy)


def timestep_embedding_np(t: np.ndarray,
                          low_frac: float = 1.0) -> np.ndarray:
    """Host-side sinusoidal timestep embedding, numerically matching
    ``models.common.timestep_embedding`` at ``models.dit.T_EMB_DIM``.
    ``low_frac`` keeps only the lowest-frequency fraction of the
    spectrum."""
    half = _temb_half()
    freqs = np.exp(-np.log(_TEMB_MAX_PERIOD)
                   * np.arange(half, dtype=np.float64) / half)
    if low_frac < 1.0:
        freqs = freqs[int(half * (1.0 - low_frac)):]
    args = np.asarray(t, np.float64).reshape(-1, 1) * freqs[None]
    return np.concatenate([np.cos(args), np.sin(args)], axis=-1)


def conditioning_drift(t_a, t_b) -> np.ndarray:
    """Cosine distance between the sinusoidal embeddings of two timestep
    ladders (elementwise over the leading axis) — the analytic stand-in
    for how far the adaLN conditioning has moved between two steps.

    Only the lowest-frequency HALF of the spectrum enters the metric:
    the high-frequency components rotate through full periods within a
    single ladder gap (they exist to make nearby timesteps separable,
    not to track closeness), so including them saturates the distance at
    ~O(1) for ANY gap and destroys the knob. The low half drifts
    smoothly and superlinearly with the gap — thresholding its
    accumulated value since the last refresh is a usable error proxy at
    every ladder density, and denser ladders (less change per step)
    naturally earn longer skip runs."""
    ea = timestep_embedding_np(t_a, low_frac=0.5)
    eb = timestep_embedding_np(t_b, low_frac=0.5)
    num = np.sum(ea * eb, axis=-1)
    den = np.linalg.norm(ea, axis=-1) * np.linalg.norm(eb, axis=-1)
    return 1.0 - num / np.maximum(den, 1e-20)


# ---------------------------------------------------------------------------
# Mask resolution


def _interval_for(spec: CacheSpec, t: int) -> int:
    for t_lo, k in sorted(spec.bands, key=lambda b: -b[0]):
        if t >= t_lo:
            return k
    return spec.interval


def refresh_mask(spec: CacheSpec, ts: np.ndarray) -> np.ndarray:
    """Boolean refresh mask over ONE phase's (descending) timestep
    ladder. Index 0 is always True (a fresh phase has no cache)."""
    ts = np.asarray(ts)
    n = len(ts)
    mask = np.zeros(n, bool)
    if n == 0:
        return mask
    mask[0] = True
    if spec.policy == "proxy":
        ref = ts[0]
        for i in range(1, n):
            if conditioning_drift(ts[i:i + 1], np.asarray([ref]))[0] \
                    > spec.threshold:
                mask[i] = True
                ref = ts[i]
        return mask
    since = 0
    for i in range(1, n):
        since += 1
        if since >= _interval_for(spec, int(ts[i])):
            mask[i] = True
            since = 0
    return mask


def ladder_refresh_mask(spec: CacheSpec,
                        phases: Sequence[Tuple[int, np.ndarray]]
                        ) -> np.ndarray:
    """Refresh mask over a full multi-phase ladder (``FlexiSchedule
    .split_timesteps`` output). The staleness clock resets at every phase
    boundary — the patch mode (and hence the token count) changes there,
    so the first step of each phase always refreshes."""
    parts: List[np.ndarray] = [refresh_mask(spec, tsub)
                               for _mode, tsub in phases]
    return np.concatenate(parts) if parts else np.zeros(0, bool)


def refresh_intervals(mask: np.ndarray) -> List[int]:
    """Gaps between consecutive refreshes in a realized mask (for the
    serving ledger's refresh-interval histogram)."""
    idx = np.flatnonzero(np.asarray(mask))
    return np.diff(idx).tolist()
