"""Weights from the JAX package into the port.

The JAX parameter tree, given as numpy arrays (``jax.device_get`` of the
tree), becomes the port's tree: the same names, the same stacked
``[L, ...]`` block leaves, the same ``[in, out]`` matrix layout of
``_linear``. Conversion is a dtype cast and never a transpose.

numpy bfloat16 arrays (the ``ml_dtypes`` type JAX hands out) cannot go
through ``torch.from_numpy``; they pass through float32, which holds every
bfloat16 value exactly, and are cast back to ``torch.bfloat16``.
"""
from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch

_TORCH_DTYPES = {"float32": torch.float32, "float64": torch.float64,
                 "float16": torch.float16, "bfloat16": torch.bfloat16,
                 "int32": torch.int32, "int64": torch.int64, "bool": torch.bool}


def leaf_to_torch(leaf: Any, device: Any = "cpu",
                  dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """One numpy (or array-like) leaf → tensor, keeping its dtype unless
    ``dtype`` is given."""
    arr = np.asarray(leaf)
    src = _TORCH_DTYPES[arr.dtype.name]
    if arr.dtype.name == "bfloat16":
        arr = arr.astype(np.float32)
    t = torch.from_numpy(np.array(arr, copy=True, order="C"))
    return t.to(device=device, dtype=dtype or src)


def params_from_numpy(tree: Any, device: Any = "cpu",
                      dtype: Optional[torch.dtype] = None) -> Any:
    """Nested dict of numpy arrays → the same nested dict of tensors."""
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device, dtype) for k, v in tree.items()}
    return leaf_to_torch(tree, device, dtype)
