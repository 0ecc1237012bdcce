"""What rounding the DiT's linear layers once costs on a CUDA card: the
``chip_smoke.py`` phase-7 wave served with ``models/dit._linear`` as it is
(float32 results from cuBLAS's ``out_dtype=float32`` product, one cast)
and with the earlier ``_linear`` (a bf16 product, then float32, then a
second cast), in turns.

    python3 tools/linear_rounding_ab.py

DiT-XL/2 (28 layers, d=1152, bf16, random trained-like weights from a
seed), menu {0.6, 0.8, 1.0}, T=10 DDIM, CFG 1.5, flash backend, 12
requests + 3 joining after two engine steps, 8 steps a dispatch: the wave
is served once to build its layouts, then replayed in the order two,
one, one, two, two, one, one, two (ROUNDS times), each replay's wall
time ending in a device synchronisation. Prints the median img/s of
each, then the card's name and power limit.
"""
from __future__ import annotations

import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402  (puts src/ on the path)

from repro_torch.diffusion.schedule import linear_schedule  # noqa: E402
from repro_torch.models import dit as dit_mod  # noqa: E402
from repro_torch.pipeline import FlexiPipeline, SamplingPlan  # noqa: E402
from repro_torch.serving import ServingEngine  # noqa: E402

ROUNDS = 2
ONE_ROUNDING = dit_mod._linear


def two_roundings(x, w, b=None, lora=None, mode=0, lora_scale=2.0):
    """The earlier ``_linear``: a product in x's dtype, then float32."""
    y = torch.matmul(x, w.to(x.dtype)).float()
    if lora is not None and mode > 0:
        a = lora["a"][mode - 1].to(x.dtype)
        bb = lora["b"][mode - 1].to(x.dtype)
        y = y + torch.matmul(torch.matmul(x, a), bb).float() * (lora_scale / a.shape[-1])
    if b is not None:
        y = y + b.float()
    return y.to(x.dtype)


def main() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device=cs.DEV).manual_seed(cs.SEED)
    params, cfg = cs.trained_like_xl(gen)
    pipe = FlexiPipeline(params, cfg, linear_schedule(1000), device=cs.DEV)
    plans = {b: SamplingPlan(T=cs.T_STEPS, budget=b, attn_backend="pallas")
             for b in cs.BUDGETS}
    rng = np.random.default_rng(cs.SEED + 7)
    wave = [(int(rng.integers(0, cfg.dit.num_classes)), cs.BUDGETS[i % 3])
            for i in range(cs.SERVE_WAVE + cs.SERVE_JOIN)]
    engine = ServingEngine(pipe, plans, steps_per_dispatch=cs.SERVE_K)
    engine.precapture_warm_set(max_per_mode=1)
    n = len(wave)
    walls = {"one rounding": [], "two roundings": []}
    for fn in (two_roundings, ONE_ROUNDING):
        dit_mod._linear = fn
        cs.serve_wave(engine, wave)               # warm: builds the layouts
    order = ["two roundings", "one rounding", "one rounding", "two roundings"]
    for _ in range(ROUNDS):
        for name in order:
            dit_mod._linear = ONE_ROUNDING if name == "one rounding" else two_roundings
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            cs.serve_wave(engine, wave)
            torch.cuda.synchronize()
            walls[name].append(time.perf_counter() - t0)
    dit_mod._linear = ONE_ROUNDING
    for name, ws in walls.items():
        med = statistics.median(ws)
        print(f"[linear] {name}: replayed wave of {n} requests, median "
              f"{med:.3f}s = {n / med:.2f} img/s (walls "
              f"{', '.join(f'{w:.3f}' for w in ws)})", flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())


if __name__ == "__main__":
    main()
