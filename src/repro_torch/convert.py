"""Weights from the JAX package into the port.

The JAX parameter tree, given as numpy arrays (``jax.device_get`` of the
tree), becomes the port's tree: the same names, the same stacked
``[L, ...]`` block leaves, the same ``[in, out]`` matrix layout of
``_linear``. Conversion is a dtype cast and never a transpose.

numpy bfloat16 arrays (the ``ml_dtypes`` type JAX hands out) cannot go
through ``torch.from_numpy``; they pass through float32, which holds every
bfloat16 value exactly, and are cast back to ``torch.bfloat16``.

The optimizer state crosses the same way (:func:`opt_state_from_numpy`):
the moment trees ``m`` and ``v`` in their dtype and the 0-d int32
``step``, so both packages can start from one mid-run state.

Tensors land on CUDA unless the caller passes ``device="cpu"``
(:func:`repro_torch.device.resolve_device`).
"""
from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch

from repro_torch.device import resolve_device

TORCH_DTYPES = {"float32": torch.float32, "float64": torch.float64,
                 "float16": torch.float16, "bfloat16": torch.bfloat16,
                 "int8": torch.int8, "int32": torch.int32, "int64": torch.int64,
                 "bool": torch.bool}


def leaf_to_torch(leaf: Any, device: Any = None,
                  dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """One numpy (or array-like) leaf → tensor, keeping its dtype unless
    ``dtype`` is given."""
    arr = np.asarray(leaf)
    src = TORCH_DTYPES[arr.dtype.name]
    if arr.dtype.name == "bfloat16":
        arr = arr.astype(np.float32)
    t = torch.from_numpy(np.array(arr, copy=True, order="C"))
    return t.to(device=resolve_device(device), dtype=dtype or src)


def params_from_numpy(tree: Any, device: Any = None,
                      dtype: Optional[torch.dtype] = None) -> Any:
    """Nested dict of numpy arrays → the same nested dict of tensors."""
    device = resolve_device(device)
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device, dtype) for k, v in tree.items()}
    return leaf_to_torch(tree, device, dtype)


def lm_params_from_numpy(tree: Any, cfg: Any, device: Any = None) -> Any:
    """The reference's language-model tree (``repro.models.lm.init_params``
    as numpy) → the port's, cast to ``cfg.param_dtype``: names, stacked
    ``[L, ...]`` leaves (the vision model's nested ``groups`` ``[G, k-1,
    ...]`` / ``[G, ...]``, whisper's ``enc_blocks`` / ``dec_blocks`` /
    ``pos_embed``) and ``[in, out]`` matrices as they are. Raises unless
    every name and shape is the port's ``lm_schema(cfg)``'s."""
    from repro_torch.models.common import ParamSpec, dtype_of, tree_map
    from repro_torch.models.lm import lm_schema

    def same(spec, leaf):
        if not isinstance(spec, ParamSpec) or isinstance(leaf, dict) or \
                tuple(np.shape(leaf)) != spec.shape:
            raise ValueError(f"leaf of shape {np.shape(leaf)} where the "
                             f"port's schema has {spec}")
        return spec

    schema = lm_schema(cfg)
    if sorted(_paths(schema)) != sorted(_paths(tree)):
        raise ValueError(f"parameter names differ from lm_schema: "
                         f"{sorted(set(_paths(schema)) ^ set(_paths(tree)))}")
    tree_map(same, schema, tree)
    return params_from_numpy(tree, device, dtype_of(cfg.param_dtype))


def _paths(tree: Any, prefix: str = "") -> list:
    if isinstance(tree, dict):
        return [p for k, v in tree.items() for p in _paths(v, f"{prefix}/{k}")]
    return [prefix]


def opt_state_from_numpy(state: Any, device: Any = None) -> Any:
    """The reference's AdamW state ``{"m", "v", "step"}`` (numpy leaves)
    → the port's: moments keep their dtype, ``step`` is a 0-d int32."""
    device = resolve_device(device)
    return {"m": params_from_numpy(state["m"], device),
            "v": params_from_numpy(state["v"], device),
            "step": leaf_to_torch(state["step"], device, torch.int32)}


def tree_to_numpy(tree: Any) -> Any:
    """The port's tree → nested dict of numpy arrays on the host
    (bfloat16 leaves as float32, which holds every bfloat16 exactly),
    copies even of CPU tensors: a train step later writes the tree in
    place."""
    if isinstance(tree, dict):
        return {k: tree_to_numpy(v) for k, v in tree.items()}
    t = tree.detach().to("cpu", copy=True)
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
