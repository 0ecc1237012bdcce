"""The comparison that decides ``correct``: each number the output check
reads beside its limit (``bench/limits/<cell>.json``)."""
from __future__ import annotations

import json
import math
from pathlib import Path
from typing import Any, Dict, List, Tuple

import torch


def rel_err(x: torch.Tensor, ref: torch.Tensor) -> float:
    """||x - ref|| / ||ref||, in float64."""
    x, ref = x.double(), ref.double()
    return float((x - ref).norm() / ref.norm())


def load_limits(root: Path, workload: str) -> Dict[str, float]:
    return json.loads((root / "limits" / f"{workload}.json").read_text())[
        "limits"]


def judge(readings: Dict[str, Any], limits: Dict[str, float]
          ) -> Tuple[bool, List[Tuple[str, float, float]]]:
    """(correct, [(name, reading, limit)]): every limited number within
    its limit; a missing or non-finite reading fails."""
    rows = []
    ok = True
    for name, limit in limits.items():
        v = readings.get(name)
        v = float("nan") if v is None else float(v)
        rows.append((name, v, float(limit)))
        ok = ok and math.isfinite(v) and v <= limit
    return ok, rows
