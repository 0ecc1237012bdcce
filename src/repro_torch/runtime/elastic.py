"""Elastic scaling arithmetic, the port's copy of ``plan_mesh_shape`` from
``repro.runtime.elastic``. The mesh and the elastic restore onto it come
with the distributed slice of the port (``Checkpointer.restore`` refuses
``shardings=`` until then)."""
from __future__ import annotations

from typing import Tuple


def plan_mesh_shape(n_devices: int, model_parallel: int = 0
                    ) -> Tuple[int, int]:
    """(data, model) factors for an arbitrary surviving device count.

    Keeps model-parallel width if it still divides; otherwise the largest
    power-of-two divisor ≤ the previous width.
    """
    if model_parallel <= 0:
        model_parallel = 1
    while model_parallel > 1 and n_devices % model_parallel != 0:
        model_parallel //= 2
    return n_devices // model_parallel, model_parallel
