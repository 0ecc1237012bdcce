"""Cost registry of the packed runners, the port of
``repro.telemetry.profile``.

The analytic FLOPs ledger (``core.scheduler`` / ``core.packing`` /
``cache.ledger``) prices every budget decision the serving stack makes.
This module sets three numbers side by side per packed step family, keyed
by the same :class:`~repro_torch.pipeline.pipeline.PackedStepKey` the
pipeline's runner cache uses:

* **analytic** — the ledger's count of useful work for the whole padded
  pack (block-sparse attention priced at the tiles the kernel visits;
  the cached family at its refresh upper bound) per micro-step (``body``)
  and per runner call (``dispatch`` = k bodies);
* **counted** — what one eager call of the runner computes, counted by
  ``torch.utils.flop_counter.FlopCounterMode`` on dummy inputs (every
  cached micro-step refreshing), plus the FLOPs of the flash kernel's
  launches in that call, which the counter cannot see (a ctypes launch):
  each launch is priced from ``kernels/attention/costing`` at the tiles
  the layout's segment ids leave active. On the CPU the kernel's plain
  version runs instead and the counter sees it. It takes the place of the
  reference's XLA ``cost_analysis`` column, which has no counterpart in
  eager PyTorch; the port counts no bytes;
* **wall** — measured dispatch wall time (EWMA + min), fed by the serving
  engine when profiling is on (CUDA events around the dispatch, one wait
  per dispatch). The per-dispatch analytic total over wall is the
  achieved GFLOP/s.

:meth:`CompiledCostRegistry.harvest` counts each packed runner once, off
the dispatch path, and builds nothing: ``cache_stats()["compiled"]`` is
flat across a harvest.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.scheduler import dit_block_flops
from repro_torch.kernels.attention import costing
from repro_torch.kernels.attention import ops as attn_ops
from repro_torch.models import dit as dit_mod
from repro_torch.models.common import dtype_of
from repro_torch.pipeline.pipeline import PackedStepKey
from repro_torch.runtime import graphs

#: reconciliation flag ids (the drift report's vocabulary)
FLAG_COUNTED_DENSE = "counted-dense"
FLAG_NO_COUNT = "flops-missing"
FLAG_COUNT_DRIFT = "count-analytic-drift"

#: |log(counted/analytic)| beyond this raises the drift flag (the counter
#: counts only matrix products; the ledger counts adaLN and embeddings
#: that way too, so the bound is loose by design)
DRIFT_LOG_RATIO = 2.3                     # ~10x either way


def packed_key(layout: Any, **kw: Any) -> PackedStepKey:
    """The runner-cache key of ``FlexiPipeline.packed_step(layout, **kw)``
    (the fields of :class:`PackedStepKey`)."""
    return PackedStepKey(layout, **kw)


def packed_analytic(cfg: ModelConfig, key: PackedStepKey) -> Dict[str, float]:
    """Analytic ledger numbers for the packed runner at ``key``: ``body``
    (one micro-step of the whole padded pack, dummy slots included — what
    the hardware computes), ``dense_body`` (same work priced at the
    dense-attention convention), ``deep_body`` (the deep-block share a
    cached all-skip micro-step avoids), and the per-dispatch totals."""
    layout, k = key.layout, key.k_steps
    split, backend = key.cache_split, key.attn_backend
    body = layout.cost(cfg, attn_backend=backend).flops
    dense = layout.cost(cfg, attn_backend="dense").flops
    deep = 0.0
    if split is not None:
        rows = layout.cost(cfg, attn_backend=backend).rows
        C = layout.resolve_capacity(cfg)
        deep = (rows * dit_block_flops(cfg, C, attn_backend=backend)
                * (cfg.num_layers - split) / cfg.num_layers)
    return {"body": float(body), "dense_body": float(dense),
            "deep_body": float(deep), "dispatch": float(k * body),
            "dispatch_skip": float(k * (body - deep))}


def flash_launch_flops(cfg: ModelConfig, key: PackedStepKey) -> float:
    """FLOPs of one flash-kernel launch (one block's self-attention over
    the whole pack) at ``key``'s layout: 4·d per active score tile."""
    active, _total = key.layout.attention_block_stats(cfg)
    bq, bk = costing.effective_blocks(key.layout.resolve_capacity(cfg))
    return float(active) * costing.dense_attention_flops(bq, bk, cfg.d_model)


def dummy_packed_args(cfg: ModelConfig, key: PackedStepKey, device: Any,
                      refresh: bool = False) -> Tuple:
    """Inputs of the packed runner at ``key`` with zero latents, every
    request at its final step, and (cached family) every micro-step
    refreshing or none: the engine's warm-up dispatches and the cost
    harvest run these."""
    k = key.k_steps
    shape = tuple(cfg.dit.latent_shape)
    mult = 2 if key.layout.guided else 1
    xs, metas, noises, deltas, refreshes = [], [], [], [], []
    for mode, cap in key.layout.groups:
        xs.append(torch.zeros((cap,) + shape, device=device))
        meta = np.zeros((k, 3, cap), np.int32)
        meta[:, 1, :] = -1
        metas.append(torch.from_numpy(meta).to(device))
        noises.append(torch.zeros((k, cap) + shape, device=device))
        if key.cache_split is not None:
            deltas.append(torch.zeros(
                (cap, mult, dit_mod.tokens_for_mode(cfg, mode), cfg.d_model),
                dtype=dtype_of(cfg.compute_dtype), device=device))
            refreshes.append(np.full((k, cap), refresh, bool))
    args: Tuple = (tuple(xs), tuple(metas), tuple(noises))
    if key.cache_split is not None:
        args += (tuple(deltas), tuple(refreshes))
    return args


@dataclasses.dataclass
class CompiledCost:
    """One packed runner's reconciled record."""
    key: PackedStepKey
    family: str                      # packed | packed-cached
    label: str
    analytic_body: float             # one micro-step (refresh upper bound)
    analytic_body_skip: float        # cached all-skip lower bound
    analytic_dense_body: float       # dense-attention convention
    analytic_dispatch: float         # per runner call (x k micro-steps)
    counted_flops: Optional[float] = None   # one call: counter + kernel
    kernel_flops: Optional[float] = None    # ... of which flash launches
    kernel_launches: Optional[int] = None

    @property
    def counted_over_analytic(self) -> Optional[float]:
        if not self.counted_flops or self.analytic_dispatch <= 0:
            return None
        return self.counted_flops / self.analytic_dispatch


@dataclasses.dataclass
class WallStats:
    ewma_s: float
    min_s: float
    n: int
    total_s: float


class CompiledCostRegistry:
    """Counts, stores, and reconciles cost records of the packed runners,
    keyed by the same keys as ``FlexiPipeline``'s runner cache."""

    def __init__(self, alpha: float = 0.3):
        self.alpha = alpha
        self.records: Dict[PackedStepKey, CompiledCost] = {}
        self.walls: Dict[PackedStepKey, WallStats] = {}

    # -- wall observations (fed per dispatch by the engine) -------------

    def observe_wall(self, key: PackedStepKey, wall_s: float) -> None:
        if wall_s <= 0:
            return
        w = self.walls.get(key)
        if w is None:
            self.walls[key] = WallStats(wall_s, wall_s, 1, wall_s)
        else:
            w.ewma_s = (1 - self.alpha) * w.ewma_s + self.alpha * wall_s
            w.min_s = min(w.min_s, wall_s)
            w.n += 1
            w.total_s += wall_s

    # -- harvest --------------------------------------------------------

    def harvest(self, pipe: Any) -> Dict[str, int]:
        """Count every packed runner in ``pipe``'s cache once, on dummy
        inputs under ``FlopCounterMode`` (off the dispatch path; builds
        no runner). The runner's body runs eagerly
        (``runtime.graphs.disabled``): a graph replay dispatches no op
        the counter could see. Other runners are skipped."""
        from torch.utils.flop_counter import FlopCounterMode
        harvested = skipped = 0
        for key, fn in list(pipe._runners.items()):
            if not isinstance(key, PackedStepKey):
                skipped += 1
                continue
            if key in self.records:
                continue
            an = packed_analytic(pipe.cfg, key)
            cached = key.cache_split is not None
            rec = CompiledCost(
                key=key, family="packed-cached" if cached else "packed",
                label=(f"packed{'+cache' if cached else ''} k={key.k_steps}"
                       f" groups={key.layout.groups} attn={key.attn_backend}"
                       f" taps={key.taps}"),
                analytic_body=an["body"],
                analytic_body_skip=an["body"] - an["deep_body"],
                analytic_dense_body=an["dense_body"],
                analytic_dispatch=an["dispatch"])
            args = dummy_packed_args(pipe.cfg, key, pipe.device, refresh=True)
            n0 = attn_ops.flash_attention.launches
            with torch.inference_mode(), graphs.disabled(), \
                    FlopCounterMode(display=False) as counter:
                fn(pipe.params, *args)
            launches = attn_ops.flash_attention.launches - n0
            rec.kernel_launches = launches
            rec.kernel_flops = launches * flash_launch_flops(pipe.cfg, key)
            rec.counted_flops = (float(counter.get_total_flops())
                                 + rec.kernel_flops)
            harvested += 1
            self.records[key] = rec
        return {"harvested": harvested, "skipped": skipped,
                "total": len(self.records)}

    # -- the drift report ----------------------------------------------

    def _flags(self, rec: CompiledCost) -> List[str]:
        flags: List[str] = []
        if not rec.counted_flops:
            flags.append(FLAG_NO_COUNT)
            return flags
        k = rec.key.k_steps
        # a block-sparse layout whose counted work lands at the dense
        # convention never skipped its cross-segment tiles
        sparse_claimed = (rec.key.attn_backend in ("pallas", "auto")
                          and rec.analytic_body
                          < 0.97 * rec.analytic_dense_body)
        if sparse_claimed and \
                rec.counted_flops >= 0.9 * k * rec.analytic_dense_body:
            flags.append(FLAG_COUNTED_DENSE)
        lo = k * min(rec.analytic_body_skip, rec.analytic_body)
        hi = k * max(rec.analytic_body, rec.analytic_dense_body)
        if lo > 0:
            drift = max(math.log(rec.counted_flops / hi),
                        math.log(lo / rec.counted_flops), 0.0)
            if drift > DRIFT_LOG_RATIO:
                flags.append(FLAG_COUNT_DRIFT)
        return flags

    def reconcile(self) -> Dict[str, Any]:
        """Per-step-family report: analytic vs counted vs measured wall."""
        rows: List[Dict[str, Any]] = []
        ratios: List[float] = []
        n_flagged = 0
        for key, rec in sorted(self.records.items(),
                               key=lambda kv: repr(kv[0])):
            flags = self._flags(rec)
            n_flagged += bool(flags)
            row: Dict[str, Any] = {
                "label": rec.label, "family": rec.family,
                "analytic_body_gflops": rec.analytic_body / 1e9,
                "analytic_dispatch_gflops": rec.analytic_dispatch / 1e9,
                "flags": flags,
            }
            if rec.counted_flops is not None:
                row["counted_gflops"] = rec.counted_flops / 1e9
                row["kernel_gflops"] = rec.kernel_flops / 1e9
                row["kernel_launches"] = rec.kernel_launches
                if rec.counted_over_analytic is not None:
                    row["counted_over_analytic"] = rec.counted_over_analytic
                    ratios.append(rec.counted_over_analytic)
            w = self.walls.get(key)
            if w is not None:
                row["wall_ms_ewma"] = w.ewma_s * 1e3
                row["wall_ms_min"] = w.min_s * 1e3
                row["dispatches"] = w.n
                if w.ewma_s > 0:
                    row["achieved_gflops_per_s"] = \
                        rec.analytic_dispatch / w.ewma_s / 1e9
                    row["wall_per_analytic_flop"] = \
                        w.ewma_s / max(rec.analytic_dispatch, 1.0)
            rows.append(row)
        out: Dict[str, Any] = {
            "rows": rows,
            "n_records": len(self.records),
            "n_flagged": n_flagged,
        }
        if ratios:
            out["max_counted_over_analytic"] = max(ratios)
            out["min_counted_over_analytic"] = min(ratios)
        return out

    def report_lines(self) -> List[str]:
        """Human-readable report (the ``--profile`` serve print)."""
        rep = self.reconcile()
        lines = [f"[profile] {rep['n_records']} packed runners counted, "
                 f"{rep['n_flagged']} flagged"]
        for row in rep["rows"]:
            bits = [f"  {row['family']:>13} "
                    f"analytic={row['analytic_dispatch_gflops']:.3f}G"]
            if "counted_gflops" in row:
                bits.append(f"counted={row['counted_gflops']:.3f}G "
                            f"(x{row.get('counted_over_analytic', 0.0):.2f})")
            if "wall_ms_ewma" in row:
                bits.append(f"wall={row['wall_ms_ewma']:.1f}ms "
                            f"({row.get('achieved_gflops_per_s', 0.0):.2f}"
                            f" GFLOP/s)")
            if row["flags"]:
                bits.append("FLAGS=" + ",".join(row["flags"]))
            bits.append("| " + row["label"])
            lines.append(" ".join(bits))
        return lines
