"""Exponential moving average of parameters (paper trains with EMA
0.9999) — the port of ``repro.optim.ema``: a float32 shadow tree."""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.models.common import tree_map


def init_ema(params: Any) -> Any:
    return tree_map(lambda p: p.detach().to(torch.float32, copy=True), params)


def ema_update(ema: Any, params: Any, rate: float = 0.9999) -> Any:
    return tree_map(lambda e, p: e * rate + p.float() * (1.0 - rate),
                      ema, params)


def ema_params(ema: Any, like: Any) -> Any:
    return tree_map(lambda e, p: e.to(p.dtype), ema, like)
