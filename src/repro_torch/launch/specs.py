"""Abstract inputs of every (architecture × shape) cell of the planner —
the port of ``repro.launch.specs``.

Each input is a ``meta`` tensor at one device's own shape: the chunk of
the global tensor that its partition spec leaves on a device of the mesh
(``placement.shard_shape`` of the spec, by the same rules as the weight
placement of ``runtime/placement.py``). Nothing is allocated. The mesh is
a shape (``launch.mesh.make_production_mesh``), not a process group.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Tuple

import torch
from torch.utils._pytree import tree_leaves as pt_leaves

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.models import dit as dit_mod
from repro_torch.models import lm
from repro_torch.models.common import dtype_of, spec_tree, tree_map
from repro_torch.runtime import sharding as shd
from repro_torch.runtime.placement import shard_shape

Params = Any

# Per-device activation budget used to pick gradient-accumulation depth.
ACT_BUDGET_BYTES = 3.0e9


def local(shape: Tuple[int, ...], dtype: torch.dtype, spec: Tuple[Any, ...],
          mesh: Any) -> torch.Tensor:
    """A ``meta`` tensor at one device's chunk of a global ``shape``."""
    return torch.empty(shard_shape(shape, spec, shd.axis_sizes(mesh)),
                       dtype=dtype, device="meta")


def tree_bytes(tree: Any) -> int:
    """Bytes of every tensor in nested dicts, lists and tuples."""
    return sum(x.numel() * x.element_size() for x in pt_leaves(tree)
               if torch.is_tensor(x))


def choose_microbatches(cfg: ModelConfig, shape: ShapeConfig, mesh: Any) -> int:
    sizes = shd.axis_sizes(mesh)
    n_dp = math.prod(sizes[a] for a in shd.dp_axes(mesh))
    per_dev = max(1, shape.global_batch // n_dp)
    act_per_sample = cfg.num_layers * shape.seq_len * cfg.d_model * 2
    if cfg.sequence_parallel:
        act_per_sample //= sizes.get("model", 1)
    n = math.ceil(per_dev * act_per_sample / ACT_BUDGET_BYTES)
    # microbatch count must divide per-device batch
    while per_dev % n != 0 and n < per_dev:
        n += 1
    return min(n, per_dev)


def schema_of(cfg: ModelConfig) -> Params:
    return dit_mod.dit_schema(cfg) if cfg.family == "dit" else lm.lm_schema(cfg)


def abstract_params(cfg: ModelConfig, mesh: Any, profile: str = "fsdp2d"
                    ) -> Tuple[Params, Params]:
    """(a tree of each device's parameter chunks as ``meta`` tensors, the
    partition-spec tree)."""
    schema = schema_of(cfg)
    specs = spec_tree(schema, shd.rules_for(cfg, mesh, profile),
                      shd.axis_sizes(mesh))
    dt = dtype_of(cfg.param_dtype)
    return tree_map(lambda s, sp: local(s.shape, dt, sp, mesh), schema,
                    specs), specs


def abstract_opt_state(params_abs: Params, opt_dtype: torch.dtype) -> Params:
    """AdamW's moments placed like the parameters (the ZeRO state), and
    the step."""
    mom = lambda p: torch.empty(p.shape, dtype=opt_dtype, device="meta")
    return {"m": tree_map(mom, params_abs), "v": tree_map(mom, params_abs),
            "step": torch.zeros((), dtype=torch.int32, device="meta")}


def _extra_inputs(cfg: ModelConfig, B: int, mesh: Any, b: Any
                  ) -> Dict[str, torch.Tensor]:
    """The vision model's image states and whisper's frames."""
    dt = dtype_of(cfg.compute_dtype)
    out = {}
    if cfg.family == "vlm":
        out["vision"] = local((B, cfg.vision_tokens, cfg.d_model), dt,
                              (b, None, None), mesh)
    if cfg.family == "audio":
        out["frames"] = local((B, cfg.audio_frames, cfg.d_model), dt,
                              (b, None, None), mesh)
    return out


def train_inputs(cfg: ModelConfig, shape: ShapeConfig, mesh: Any
                 ) -> Dict[str, torch.Tensor]:
    B, S = shape.global_batch, shape.seq_len
    b = shd.batch_spec(B, mesh)[0]
    batch = {k: local((B, S), torch.int32, (b, None), mesh)
             for k in ("tokens", "targets")}
    batch.update(_extra_inputs(cfg, B, mesh, b))
    return batch


def prefill_inputs(cfg: ModelConfig, shape: ShapeConfig, mesh: Any
                   ) -> Dict[str, torch.Tensor]:
    B, S = shape.global_batch, shape.seq_len
    b = shd.batch_spec(B, mesh)[0]
    inputs = {"tokens": local((B, S), torch.int32, (b, None), mesh)}
    inputs.update(_extra_inputs(cfg, B, mesh, b))
    return inputs


def cache_specs(cfg: ModelConfig, B: int, S: int, mesh: Any) -> Params:
    """Each device's chunk of the decode cache (context-parallel: the
    sequence dim over the model axis; see DESIGN.md §5)."""
    b_ax, s_ax = shd.seq_axes_for_cache(B, mesh)
    out = {}
    for k, v in lm.init_cache(cfg, B, S, device="meta").items():
        nd = v.dim()
        if k in ("k", "v"):
            if nd == 6:      # vlm self cache [G, k-1, B, S, K, hd]
                spec = (None, None, b_ax, s_ax, None, None)
            else:            # [L, B, S, K, hd]
                spec = (None, b_ax, s_ax, None, None)
        elif k in ("k_scale", "v_scale"):
            if nd == 5:      # vlm [G, k-1, B, S, K]
                spec = (None, None, b_ax, s_ax, None)
            else:            # [L, B, S, K]
                spec = (None, b_ax, s_ax, None)
        elif k in ("xk", "xv"):   # [G, B, Tv, K, hd]
            spec = (None, b_ax, None, None, None)
        elif k == "enc":          # [B, F, d]
            spec = (b_ax, None, None)
        elif k == "h":            # [L, B, H, P, N]
            spec = (None, b_ax, None, None, None)
        elif k == "conv":         # [L, B, W-1, C]
            spec = (None, b_ax, None, None)
        else:
            spec = (None,) * nd
        out[k] = local(tuple(v.shape), v.dtype, spec, mesh)
    return out


def decode_inputs(cfg: ModelConfig, shape: ShapeConfig, mesh: Any
                  ) -> Dict[str, Any]:
    B, S = shape.global_batch, shape.seq_len
    b = shd.batch_spec(B, mesh)[0]
    return {"cache": cache_specs(cfg, B, S, mesh),
            "token": local((B, 1), torch.int32, (b, None), mesh),
            "pos": local((B,), torch.int32, (b,), mesh)}


# ---------------------------------------------------------------------------
# DiT cells


DIT_SHAPES = {
    "dit-xl-2": {"train_base": 256, "serve_powerful": 32, "serve_weak": 32},
    "t2i-transformer": {"train_base": 64, "serve_powerful": 32, "serve_weak": 32},
    "video-dit": {"train_base": 8, "serve_powerful": 4, "serve_weak": 4},
}


def dit_inputs(cfg: ModelConfig, shape_name: str, mesh: Any,
               batch: int = 0) -> Dict[str, torch.Tensor]:
    """A train cell's batch and the step's draws (``t``, ``noise``), or a
    serve cell's guided-NFE inputs. ``batch`` overrides the cell's global
    batch."""
    B = batch or DIT_SHAPES[cfg.name][shape_name]
    b = shd.batch_spec(B, mesh)[0]
    dt = dtype_of(cfg.compute_dtype)
    F, H, W, C = cfg.dit.latent_shape
    x = local((B, F, H, W, C), dt, (b, None, None, None, None), mesh)
    rows = (lambda d: local((B,), d, (b,), mesh))
    if cfg.dit.conditioning == "class":
        cond, null = rows(torch.int32), rows(torch.int32)
    else:
        dc = cfg.dit.text_dim or cfg.d_model
        cond, null = (local((B, cfg.dit.text_len, dc), dt, (b, None, None), mesh)
                      for _ in range(2))
    if shape_name == "train_base":
        return {"x0": x, "cond": cond, "t": rows(torch.int32),
                "noise": torch.empty_like(x)}
    return {"x_t": x, "t": rows(torch.float32), "cond": cond, "null_cond": null}
