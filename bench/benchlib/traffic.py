"""The one traffic generator: it reads a mix's parameters (a JSON file under
``bench/traffic/``) and turns a seed into the requests of a run.

Every seed gets the same work: the same sizes in the same order and the
same arrivals. The seed draws what changes no work: the weights, the
priors, the class labels and the prompt lengths. (Seeds that reordered
the budgets spread a closed loop's rate by 1.5 % against 0.3 % between
two runs of one seed, and seeds that reordered the arrival gaps spread
the open loop's latency tail by 20 %.)

- budgets: in blocks of one request per budget of the mix, each block in
  one shuffled order that every seed shares;
- open-loop arrivals (``"arrivals": "poisson"``): ``rate_per_s x
  seconds`` requests whose gaps are the exponential distribution's
  quantiles at ``(i + 0.5) / n``, in one shuffled order that every seed
  shares: a Poisson process's gaps, with a mean of exactly ``1 / rate``;
- class labels uniform over the classes, prompt lengths uniform over
  ``prompt_len``.

Priors and text embeddings are drawn on the device in chunks of requests,
each chunk from its own seed, so request ``i``'s inputs depend only on the
seed and ``i``.
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from benchlib.weights import derive_seed

CHUNK = 512
PURPOSE = {"budgets": 11, "labels": 12, "gaps": 13, "priors": 14,
           "text": 15, "prompt_len": 16, "check": 17}


def load(root: Path, name: str) -> Dict[str, Any]:
    return json.loads((root / "traffic" / f"{name}.json").read_text())


def _rng(seed: int, purpose: str, *tags: int) -> np.random.Generator:
    return np.random.default_rng(derive_seed(seed, PURPOSE[purpose], *tags))


class Stream:
    """Request ``i`` of a run: its budget, label or prompt length, and
    (open loop) its due time in seconds from the window's start."""

    def __init__(self, mix: Dict[str, Any], seed: int,
                 seconds: Optional[float] = None,
                 rate: Optional[float] = None):
        self.mix = mix
        self.seed = int(seed)
        self.budgets = list(mix.get("budgets", [mix.get("budget", 1.0)]))
        self._blocks: Dict[int, List[float]] = {}
        self.due: Optional[np.ndarray] = None
        if mix.get("arrivals") == "poisson":
            rate = float(rate if rate is not None else mix["rate_per_s"])
            n = int(round(rate * float(seconds)))
            q = (np.arange(n) + 0.5) / n
            gaps = -np.log1p(-q) / rate
            _rng(0, "gaps").shuffle(gaps)
            self.gaps = gaps
            self.due = np.cumsum(gaps) - gaps[0]
        self.n_classes = int(mix.get("num_classes", 1000))

    def __len__(self) -> int:
        if self.due is None:
            raise TypeError("a closed loop has no fixed length")
        return len(self.due)

    def budget(self, i: int) -> float:
        b = len(self.budgets)
        blk = i // b
        if blk not in self._blocks:
            order = _rng(0, "budgets", blk).permutation(b)
            self._blocks[blk] = [self.budgets[j] for j in order]
        return self._blocks[blk][i % b]

    def label(self, i: int) -> int:
        return int(_rng(self.seed, "labels", i).integers(0, self.n_classes))

    def prompt_len(self, i: int) -> int:
        lo, hi = self.mix["prompt_len"]
        return int(_rng(self.seed, "prompt_len", i).integers(lo, hi + 1))


class DeviceDraws:
    """Standard normals of a fixed shape for request ``i``, drawn on the
    device a chunk at a time."""

    def __init__(self, seed: int, purpose: str, shape, device: Any,
                 chunk: int = CHUNK):
        self.seed, self.purpose, self.size = int(seed), purpose, int(chunk)
        self.shape = tuple(shape)
        self.device = torch.device(device)
        self._chunks: Dict[int, torch.Tensor] = {}

    def chunk(self, c: int) -> torch.Tensor:
        if c not in self._chunks:
            g = torch.Generator(device=self.device).manual_seed(
                derive_seed(self.seed, PURPOSE[self.purpose], c))
            self._chunks[c] = torch.randn((self.size,) + self.shape,
                                          generator=g, device=self.device)
        return self._chunks[c]

    def __getitem__(self, i: int) -> torch.Tensor:
        return self.chunk(i // self.size)[i % self.size]

    def rows(self, idx: List[int]) -> torch.Tensor:
        return torch.stack([self[i] for i in idx])


def check_sample(seed: int, candidates: Dict[Any, List[int]],
                 per_group: int) -> List[int]:
    """``per_group`` ids drawn from each group of candidates (a group: one
    budget, so the longest requests are always in the sample)."""
    out: List[int] = []
    for j, key in enumerate(sorted(candidates)):
        ids = sorted(candidates[key])
        k = min(per_group, len(ids))
        pick = _rng(seed, "check", j).choice(len(ids), size=k, replace=False)
        out += [ids[p] for p in sorted(pick)]
    return out

