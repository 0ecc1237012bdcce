"""The dry-run planner — the port of ``repro.launch.dryrun``: every
(architecture × input shape) cell planned on a production mesh shape,
with its memory, its cost and its roofline terms, on the CPU with no
card and no allocation.

Usage:
  python -m repro_torch.launch.dryrun --arch mamba2-130m --shape train_4k
  python -m repro_torch.launch.dryrun --sweep                 # all cells, 16x16
  python -m repro_torch.launch.dryrun --sweep --multi-pod     # all cells, 2x16x16

Each cell traces the port's own step on ``meta`` tensors at one device's
shapes (``launch/specs.py``): a train cell the whole step (forward,
backward and AdamW, at the cell's microbatch count), a prefill, decode or
serve cell the step. The weights are each device's chunks, gathered on
use through the same code as a sharded step (``runtime/placement.py``)
over a :class:`~repro_torch.launch.roofline.PlanMesh`, whose collectives
the :class:`~repro_torch.launch.roofline.CollectiveLedger` records
instead of sending. FLOPs come from ``FlopCounterMode``; bytes accessed
from :class:`ByteCounter`. Attention runs on the dense backend: the
flash ops derive their tile map from segment-id values, which ``meta``
tensors do not have. A record whose step takes the flash kernel on the
card says so under ``attention``; for a train cell that step raises on
the card (the kernel has no backward), so its record plans a step the
port does not run.

Every rank along 'model' computes whole layers (no tensor-parallel GEMMs
in the port): the counted FLOPs are those of the device's rows, not
divided over 'model', so ``useful_flops_ratio`` (6·N·D or 2·N·D over the
counted FLOPs of every device) reads about 1 / (the model axis's size).
A Python layer loop counts every layer, so no per-layer extrapolation is
needed, and the sweep runs in-process. The collective and memory figures
of a mesh larger than one card are modelled, not measured.

Records go to ``build/dryrun/<mesh>/<arch>__<shape>.json``.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import time
import traceback
import types
import weakref
from pathlib import Path
from typing import Any, Dict, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves as pt_leaves
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs import (ASSIGNED_ARCHS, DIT_ARCHS, LM_SHAPES,
                                 cell_is_skipped, get_config, get_shape)
from repro_torch.configs.base import ModelConfig, TrainConfig
from repro_torch.launch import roofline as rl
from repro_torch.launch import specs as sp
from repro_torch.launch import steps as st
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import attention as attn_mod
from repro_torch.models import dit as dit_mod
from repro_torch.models.common import dtype_of, tree_leaves, tree_map
from repro_torch.optim.adamw import adamw_update
from repro_torch.runtime import placement as plc
from repro_torch.runtime import sharding as shd

RESULTS = Path(__file__).resolve().parents[3] / "build" / "dryrun"
NOTE = ("every rank along 'model' computes whole layers (no tensor-parallel "
        "GEMMs): useful_flops_ratio reads about 1 / model-axis size; "
        "collectives and memory beyond one card are modelled")
FLASH_NOTE = ("planned on dense attention; on the card this step runs the "
              "flash kernel, whose FLOPs and bytes the dense count bounds "
              "from above")
FLASH_TRAIN_NOTE = ("planned on dense attention; on the card this step "
                    "resolves attention to the flash kernel, which has no "
                    "backward, so the port's step raises there")

# ---------------------------------------------------------------------------
# Counting a trace


def _writes_alias(func: Any) -> Tuple[bool, bool]:
    """(a view: its output aliases an input without writing it, in place:
    it writes an input)."""
    rets = func._schema.returns
    view = any(r.alias_info is not None and not r.alias_info.is_write
               for r in rets)
    inplace = any(r.alias_info is not None and r.alias_info.is_write
                  for r in rets)
    return view, inplace


class ByteCounter(TorchDispatchMode):
    """Each aten op's input and output bytes, summed (views move none),
    and the peak of the bytes that ops' outputs keep alive (a model of
    the step's temporary memory)."""

    def __init__(self):
        super().__init__()
        self.bytes = 0
        self.live = 0
        self.peak = 0

    def _free(self, n: int) -> None:
        self.live -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        view, inplace = _writes_alias(func)
        if view:
            return out
        self.bytes += sp.tree_bytes((args, kwargs, out))
        if not inplace:
            for t in (t for t in pt_leaves(out) if torch.is_tensor(t)):
                n = t.numel() * t.element_size()
                self.live += n
                weakref.finalize(t, self._free, n)
            self.peak = max(self.peak, self.live)
        return out


@contextlib.contextmanager
def dense_attention():
    """Attention on the dense backend wherever ``auto`` would pick the
    flash kernel (which reads segment-id values ``meta`` lacks). Yields
    the list of swaps made, one ``True`` for each."""
    sound = attn_mod.resolve_backend
    swapped: list = []

    def resolve(backend, **kw):
        got = sound(backend, **kw)
        if got != "pallas":
            return got
        swapped.append(True)
        return "dense"
    attn_mod.resolve_backend = resolve
    try:
        yield swapped
    finally:
        attn_mod.resolve_backend = sound


class Trace:
    """FLOPs, bytes accessed, the temporaries' peak and the collectives of
    everything run inside ``with trace:`` (under the plan's mesh)."""

    def __init__(self, mesh: rl.PlanMesh):
        self.mesh = mesh
        self.ledger = rl.CollectiveLedger()
        self.flops = FlopCounterMode(display=False)
        self.bytes = ByteCounter()
        self.flash_swapped: list = []
        self._stack = contextlib.ExitStack()

    def __enter__(self):
        self.flash_swapped = self._stack.enter_context(dense_attention())
        for cm in (self.ledger.record(), shd.use_mesh(self.mesh), self.flops,
                   self.bytes):
            self._stack.enter_context(cm)
        return self

    def __exit__(self, *exc):
        return self._stack.__exit__(*exc)

    def cost(self) -> Dict[str, float]:
        return {"flops": float(self.flops.get_total_flops()),
                "bytes accessed": float(self.bytes.bytes)}


# ---------------------------------------------------------------------------
# The planned step: chunks gathered on use over the plan's mesh


def planned_view(local_tree: Any, specs: Any, schema: Any, mesh: rl.PlanMesh,
                 stacked: Any) -> Any:
    """The loss's view of each device's chunks, as
    ``placement.gathered`` builds it from placed leaves."""
    def walk(loc, spec, s, st_):
        if isinstance(loc, dict):
            return {k: walk(loc[k], spec[k], s[k],
                            st_.get(k) if isinstance(st_, dict) else None)
                    for k in loc}
        pl = shd.placements(mesh, spec)
        if st_ is True:
            like = types.SimpleNamespace(device_mesh=mesh, placements=pl,
                                         shape=torch.Size(s.shape))
            return plc.LayerGather(loc, like)
        return plc._GatherOnUse.apply(loc, mesh, pl)
    return walk(local_tree, specs, schema, stacked)


def planned_grads(loss_fn: Any, local_params: Any, specs: Any, schema: Any,
                  mesh: rl.PlanMesh, stacked: Any, *args: Any, **kw: Any):
    """The gradients ``optim/adamw.value_and_grad`` takes of a placed
    tree, on the chunks."""
    leaves = []

    def track(p):
        if not p.is_floating_point():
            return p
        leaf = p.detach().requires_grad_(True)
        leaves.append(leaf)
        return leaf
    tracked = tree_map(track, local_params)
    with torch.enable_grad():
        view = planned_view(tracked, specs, schema, mesh, stacked)
        loss, _ = loss_fn(view, *args, **kw)
        got = torch.autograd.grad(loss, leaves, allow_unused=True)
    by_id = {id(l): g if g is not None else torch.zeros_like(l)
             for l, g in zip(leaves, got)}
    return tree_map(lambda t: by_id.get(id(t), torch.zeros_like(t)), tracked)


def norm_all_reduces(ledger: rl.CollectiveLedger, specs: Any,
                     mesh: rl.PlanMesh) -> None:
    """``global_norm``'s sums over the shards (``sum_over_shards``): one
    float32 all-reduce a mesh dim, of one value a leaf sharded on it."""
    spec_list = tree_leaves(specs)
    for i, a in enumerate(mesh.axis_names):
        if mesh.size(i) == 1:
            continue
        n = sum(1 for spec in spec_list
                if shd.placements(mesh, spec)[i].is_shard())
        if n:
            ledger.add("all-reduce", 4 * n, 4 * n, a)


def _train_step(step: Any, params: Any, specs: Any, schema: Any,
                mesh: rl.PlanMesh, tc: TrainConfig, batch: Dict, draws: Dict,
                n_mb: int) -> list:
    """The parts of a train step, each a (trace, times) pair: the
    gradients of one of ``n_mb`` equal slices of the rows (the slices'
    traces are identical, so one is traced and counted ``n_mb`` times),
    then their float32 accumulation (``launch/steps._MicrobatchedStep``)
    and AdamW on the chunks."""
    mb = {k: v.chunk(n_mb)[0] for k, v in batch.items()} if n_mb > 1 else batch
    with Trace(mesh) as grads_part:
        grads = planned_grads(step.loss_fn, params, specs, schema, mesh,
                              step.stacked, mb, **draws)
    with Trace(mesh) as rest:
        if n_mb > 1:
            acc = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                                 device="meta"), params)
            for _ in range(n_mb):
                acc = tree_map(lambda a, b: a + b.float() / n_mb, acc, grads)
            grads = tree_map(lambda g, p: g.to(p.dtype), acc, params)
        opt = sp.abstract_opt_state(params, dtype_of(tc.opt_dtype))
        adamw_update(params, grads, opt, tc)
        norm_all_reduces(rest.ledger, specs, mesh)
    return [(grads_part, n_mb), (rest, 1)]


def merged(parts: list) -> Dict[str, Any]:
    """The cost, collectives and temporaries' peak of (trace, times)
    parts run one after another."""
    cost = {"flops": 0.0, "bytes accessed": 0.0}
    kinds = rl.CollectiveLedger().as_dict()
    axis: Dict[str, float] = {}
    peak = 0
    for tr, n in parts:
        for k, v in tr.cost().items():
            cost[k] += n * v
        for kind, rec in tr.ledger.kinds.items():
            for k, v in rec.items():
                kinds[kind][k] += n * v
        for a, w in tr.ledger.axis_wire.items():
            axis[a] = axis.get(a, 0.0) + n * w
        peak = max(peak, tr.bytes.peak)
    return {"cost_analysis": cost, "collectives": kinds,
            "collective_wire_bytes_by_axis": axis, "peak": peak,
            "flash_swapped": any(tr.flash_swapped for tr, _ in parts)}


# ---------------------------------------------------------------------------
# Cells


def tokens_for_cell(cfg: ModelConfig, shape_name: str, batch: int = 0,
                    shape: Any = None) -> float:
    if cfg.family == "dit":
        B = batch or sp.DIT_SHAPES[cfg.name][shape_name]
        n_tok = dit_mod.tokens_for_mode(
            cfg, 0 if "powerful" in shape_name or "train" in shape_name
            else len(cfg.dit.flex_patch_sizes))
        return B * n_tok
    shape = shape or get_shape(shape_name)
    if shape.kind == "decode":
        return shape.global_batch          # one new token per sequence
    return shape.global_batch * shape.seq_len


def shape_kind(cfg: ModelConfig, shape_name: str) -> str:
    if cfg.family == "dit":
        return "train" if shape_name == "train_base" else "serve"
    return get_shape(shape_name).kind


def train_config(cfg: ModelConfig) -> TrainConfig:
    """The reference's: bf16 moments past 5e10 parameters."""
    if cfg.family == "dit":
        return TrainConfig()
    return TrainConfig(opt_dtype="bfloat16" if cfg.num_params() > 5e10
                       else "float32")


def resident_bytes(cfg: ModelConfig, mesh: Any, profile: str,
                   train: bool = True) -> Dict[str, int]:
    """Parameter and AdamW-moment bytes a device by the spec arithmetic
    (``rules_for`` × ``spec_tree`` × ``shard_shape``)."""
    params, _ = sp.abstract_params(cfg, mesh, profile)
    out = {"param_bytes": sp.tree_bytes(params), "opt_bytes": 0}
    if train:
        opt = sp.abstract_opt_state(params, dtype_of(train_config(cfg).opt_dtype))
        out["opt_bytes"] = sp.tree_bytes({"m": opt["m"], "v": opt["v"]})
    return out


def _profiled_cfg(cfg: ModelConfig, profile: str) -> ModelConfig:
    if "_sp" in profile and not cfg.sequence_parallel:
        cfg = dataclasses.replace(cfg, sequence_parallel=True)
    if "_kvq" in profile and cfg.kv_cache_dtype != "int8":
        cfg = dataclasses.replace(cfg, kv_cache_dtype="int8")
    return cfg


def plan_step(cfg: ModelConfig, shape_name: str, mesh: Any,
              profile: str = "auto", *, shape: Any = None, batch: int = 0
              ) -> Dict[str, Any]:
    """Trace one cell's step at one device's shapes: its cost, collectives
    and memory. ``shape`` (a ``ShapeConfig``) overrides an LM cell's
    shape; ``batch`` a DiT cell's global batch."""
    profile = shd.resolve_profile(cfg, profile)
    cfg = _profiled_cfg(cfg, profile)
    pm = rl.PlanMesh(mesh)
    params, specs = sp.abstract_params(cfg, mesh, profile)
    schema = sp.schema_of(cfg)
    stacked = plc.stacked_leaves(schema)
    kind = shape.kind if shape is not None else shape_kind(cfg, shape_name)
    rec: Dict[str, Any] = {"kind": kind}
    t0 = time.perf_counter()
    trace = Trace(pm)
    view = lambda: planned_view(params, specs, schema, pm, stacked)
    if kind == "train":
        tc = train_config(cfg)
        opt = sp.abstract_opt_state(params, dtype_of(tc.opt_dtype))
        if cfg.family == "dit":
            step = st.make_dit_train_step(cfg, tc)
            inputs = sp.dit_inputs(cfg, shape_name, mesh, batch)
            batch_in = {k: inputs[k] for k in ("x0", "cond")}
            draws, n_mb = {k: inputs[k] for k in ("t", "noise")}, 1
        else:
            shape = shape or get_shape(shape_name)
            n_mb = sp.choose_microbatches(cfg, shape, mesh)
            rec["n_microbatches"] = n_mb
            step = st.make_train_step(cfg, tc)
            inputs = batch_in = sp.train_inputs(cfg, shape, mesh)
            draws = {}
        parts = _train_step(step, params, specs, schema, pm, tc, batch_in,
                            draws, n_mb)
        args = [params, opt, inputs]
        out_bytes = sp.tree_bytes(args[:2])
    else:
        if cfg.family == "dit":
            weak = len(cfg.dit.flex_patch_sizes)
            mode = 0 if shape_name == "serve_powerful" else weak
            fn = st.make_dit_serve_step(cfg, mode_cond=mode, mode_uncond=weak)
            inputs = sp.dit_inputs(cfg, shape_name, mesh, batch)
            call = lambda: fn(view(), inputs["x_t"], inputs["t"],
                              inputs["cond"], inputs["null_cond"])
        elif kind == "prefill":
            inputs = sp.prefill_inputs(cfg, shape or get_shape(shape_name), mesh)
            fn = st.make_prefill_step(cfg)
            call = lambda: fn(view(), inputs)
        else:
            inputs = sp.decode_inputs(cfg, shape or get_shape(shape_name), mesh)
            fn = st.make_decode_step(cfg)
            # the cache is written in place: the logits are the output
            call = lambda: fn(view(), inputs["cache"], inputs["token"],
                              inputs["pos"])[0]
        with trace, torch.no_grad():
            out = call()
        parts = [(trace, 1)]
        args = [params, inputs]
        out_bytes = sp.tree_bytes(out)
    m = merged(parts)
    rec.update({
        "profile": profile,
        "trace_s": time.perf_counter() - t0,
        "cost_analysis": m["cost_analysis"],
        "collectives": m["collectives"],
        "collective_wire_bytes_by_axis": m["collective_wire_bytes_by_axis"],
        "memory_analysis": {
            "temp_size_in_bytes": m["peak"],
            "argument_size_in_bytes": sp.tree_bytes(args),
            "output_size_in_bytes": out_bytes,
            "alias_size_in_bytes": out_bytes if kind == "train" else 0,
            "generated_code_size_in_bytes": None},
        "sharded_args_bytes_per_device": sp.tree_bytes(args),
    })
    if m["flash_swapped"]:
        rec["attention"] = FLASH_TRAIN_NOTE if kind == "train" else FLASH_NOTE
    return rec


def plan_dit_forward(cfg: ModelConfig, batch: int, mode: int
                     ) -> Dict[str, float]:
    """The counted cost of one ``dit_forward`` on one device at ``batch``
    rows and patch ``mode``."""
    mesh = shd.AxisLayout(("data", "model"), (1, 1))
    pm = rl.PlanMesh(mesh)
    params, specs = sp.abstract_params(cfg, mesh, "dp")
    schema = sp.schema_of(cfg)
    inputs = sp.dit_inputs(cfg, "serve_powerful", mesh, batch)
    with Trace(pm) as trace, torch.no_grad():
        dit_mod.dit_forward(planned_view(params, specs, schema, pm,
                                         plc.stacked_leaves(schema)),
                            inputs["x_t"], inputs["t"], inputs["cond"], cfg,
                            mode=mode)
    return trace.cost()


def mesh_name(mesh: Any) -> str:
    sizes = shd.axis_sizes(mesh)
    return "pod" + "x".join(str(sizes[a]) for a in shd.axis_names(mesh))


def run_cell(arch: str, shape_name: str, multi_pod: bool = False,
             profile: str = "auto", out_path: Optional[Path] = None, *,
             cfg: Optional[ModelConfig] = None, mesh: Any = None,
             shape: Any = None, batch: int = 0) -> Dict[str, Any]:
    """Plan one cell and write its record. ``cfg`` overrides the arch's
    config (a reduced or cut one), ``mesh`` the production mesh,
    ``shape`` an LM cell's shape and ``batch`` a DiT cell's batch."""
    cfg = cfg if cfg is not None else get_config(arch)
    hw = rl.h100()
    profile = shd.resolve_profile(cfg, profile)
    mesh = mesh if mesh is not None else make_production_mesh(multi_pod=multi_pod)
    skip = cell_is_skipped(arch, shape_name) if cfg.family != "dit" else None
    rec: Dict[str, Any] = {"arch": arch,
                           "shape": shape.name if shape else shape_name,
                           "mesh": mesh_name(mesh), "profile": profile,
                           "status": "skipped", "skip_reason": skip}
    if not skip:
        n_dev = math.prod(shd.axis_sizes(mesh).values())
        plan = plan_step(cfg, shape_name, mesh, profile, shape=shape,
                         batch=batch)
        kind = plan.pop("kind")
        mf = rl.model_flops(cfg, "train" if kind == "train" else "serve",
                            tokens_for_cell(cfg, shape_name, batch, shape))
        terms = rl.roofline_terms(plan["cost_analysis"], plan["collectives"],
                                  n_dev, mf, hw=hw, mesh=mesh,
                                  axis_wire=plan["collective_wire_bytes_by_axis"])
        res = resident_bytes(cfg, mesh, profile, train=kind == "train")
        mem = plan["memory_analysis"]
        rec.update({"status": "ok", "n_devices": n_dev, "hardware": hw.name,
                    **plan, **res, "roofline": terms,
                    "fits_hbm": (mem["argument_size_in_bytes"]
                                 + mem["temp_size_in_bytes"]) <= hw.hbm_bytes,
                    "params": cfg.num_params(),
                    "active_params": cfg.active_params(), "note": NOTE})
    if out_path:
        out_path.parent.mkdir(parents=True, exist_ok=True)
        out_path.write_text(json.dumps(rec, indent=1))
    return rec


def all_cells():
    cells = []
    for arch in ASSIGNED_ARCHS:
        for shape in LM_SHAPES:
            cells.append((arch, shape.name))
    for arch in DIT_ARCHS:
        for shape in ("train_base", "serve_powerful", "serve_weak"):
            cells.append((arch, shape))
    return cells


def summary_line(rec: Dict[str, Any]) -> str:
    if rec["status"] != "ok":
        return (f"[{rec['status']}] {rec['arch']} {rec['shape']}: "
                f"{rec.get('skip_reason') or rec.get('error', '')[-200:]}")
    r = rec["roofline"]
    return (f"[ok {rec['trace_s']:.1f}s] {rec['arch']} {rec['shape']} "
            f"({rec['mesh']}, {rec['profile']}): "
            f"{r['hlo_flops_per_device'] / 1e12:.3f} TFLOP, "
            f"{r['hlo_bytes_per_device'] / 1e9:.2f} GB, collectives "
            f"{r['collective_operand_bytes'] / 1e9:.3f} GB a device; "
            f"compute {r['compute_s'] * 1e3:.2f} / memory "
            f"{r['memory_s'] * 1e3:.2f} / collective "
            f"{r['collective_s'] * 1e3:.2f} ms ({r['dominant']}); "
            f"useful_flops_ratio {r.get('useful_flops_ratio', 0.0):.4f}")


def sweep(multi_pod: bool = False, profile: str = "auto",
          only_missing: bool = True) -> list:
    """Every cell, in this process; a cell that fails is written with its
    error and the sweep goes on."""
    mesh = make_production_mesh(multi_pod=multi_pod)
    outdir = RESULTS / mesh_name(mesh)
    outdir.mkdir(parents=True, exist_ok=True)
    recs = []
    t0 = time.perf_counter()
    for arch, shape in all_cells():
        out = outdir / f"{arch}__{shape}.json"
        if only_missing and out.exists():
            print(f"[skip-existing] {arch} {shape}")
            continue
        try:
            rec = run_cell(arch, shape, multi_pod, profile, out)
        except Exception:
            rec = {"arch": arch, "shape": shape, "mesh": mesh_name(mesh),
                   "status": "error", "error": traceback.format_exc()[-4000:]}
            out.write_text(json.dumps(rec, indent=1))
        recs.append(rec)
        print(summary_line(rec), flush=True)
    print(f"[sweep] {len(recs)} cells in {time.perf_counter() - t0:.1f}s; "
          f"{NOTE}", flush=True)
    return recs


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.dryrun")
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--profile", default="auto")
    ap.add_argument("--out", default=None)
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--force", action="store_true")
    args = ap.parse_args(argv)
    if args.sweep:
        recs = sweep(args.multi_pod, args.profile, only_missing=not args.force)
        if any(r["status"] == "error" for r in recs):
            raise SystemExit(1)
        return
    rec = run_cell(args.arch, args.shape, args.multi_pod, args.profile,
                   Path(args.out) if args.out else None)
    print(json.dumps({k: v for k, v in rec.items() if k != "collectives"},
                     indent=1, default=str))
    print(summary_line(rec))


if __name__ == "__main__":
    main()
