"""Where a served wave's time goes on a CUDA card: one ``torch.profiler``
trace of the port's ``ServingEngine`` at DiT-XL/2 width.

    python3 tools/serving_trace.py

Serves the ``chip_smoke.py`` serving wave (DiT-XL/2, 28 layers, d=1152,
bf16, random trained-like weights from a seed; menu {0.6, 0.8, 1.0}, T=10
DDIM, CFG 1.5, flash backend, 12 requests + 3 joining after two engine
steps) once to build its layouts, then traces the replay of the same wave
and prints:

- the replay's wall time without the profiler, and the device's busy
  time in a traced replay (the union of kernel and copy intervals), hence
  the device's idle share (the profiler slows the host several-fold, so
  the share is taken against the untraced wall);
- device kernels, host-to-device copies and launches per packed forward;
- the device time of the top kernels by name;
- what deriving the flash kernel's tile map from the segment ids costs
  (``kernels/attention/ops.kernel_kwargs``, once per block): kernels and
  copies per call, timed alone.

Ends with the card's name and power limit.
"""
from __future__ import annotations

import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.diffusion.schedule import linear_schedule  # noqa: E402
from repro_torch.kernels.attention import ops  # noqa: E402
from repro_torch.models import dit as dit_mod  # noqa: E402
from repro_torch.pipeline import FlexiPipeline, SamplingPlan  # noqa: E402
from repro_torch.serving import ServingEngine  # noqa: E402

DEV = torch.device("cuda")
BUDGETS = (0.6, 0.8, 1.0)
WAVE, JOIN = 12, 3


def log(msg: str) -> None:
    print(msg, flush=True)


def weights(seed: int = 0):
    """DiT-XL/2 with random weights, the zero-initialized gates non-zero
    (as ``chip_smoke.py`` makes them)."""
    cfg = get_config("dit-xl-2")
    gen = torch.Generator(device=DEV).manual_seed(seed)
    params = dit_mod.init_dit(cfg, gen)
    for node, key, scale in [(params["deembed"], "w_flex", 0.1),
                             (params["final"]["ada"], "w", 0.05),
                             (params["blocks"]["ada"], "w", 0.05)]:
        node[key] = (torch.randn(node[key].shape, generator=gen, device=DEV)
                     * scale).to(node[key].dtype)
    return params, cfg


def serve_wave(engine, wave):
    for label, b in wave[:WAVE]:
        engine.submit(cond=label, budget=b)
    out = []
    for _ in range(2):
        out += engine.step()
    for label, b in wave[WAVE:]:
        engine.submit(cond=label, budget=b)
    return out + engine.run()


def busy_ms(events) -> float:
    """Union of the device intervals (kernels and copies), in ms."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in events)
    total, cur_s, cur_e = 0.0, None, None
    for s, e in spans:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total / 1e3


def device_events(prof):
    return [e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA]


def main() -> None:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    params, cfg = weights()
    pipe = FlexiPipeline(params, cfg, linear_schedule(1000), device=DEV)
    plans = {b: SamplingPlan(T=10, budget=b, attn_backend="pallas")
             for b in BUDGETS}
    rng = np.random.default_rng(7)
    wave = [(int(rng.integers(0, cfg.dit.num_classes)), BUDGETS[i % 3])
            for i in range(WAVE + JOIN)]
    engine = ServingEngine(pipe, plans, steps_per_dispatch=8)
    serve_wave(engine, wave)                      # builds the layouts
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    serve_wave(engine, wave)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    f0, d0 = engine.packed_forwards, engine.metrics.total_steps
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        res = serve_wave(engine, wave)
        torch.cuda.synchronize()
    traced = (time.perf_counter() - t0) * 1e3
    forwards = engine.packed_forwards - f0
    dispatches = engine.metrics.total_steps - d0
    dev = device_events(prof)
    is_copy = [("memcpy" in e.name.lower() or "memset" in e.name.lower())
               for e in dev]
    copies = [e for e, c in zip(dev, is_copy) if c]
    kernels = [e for e, c in zip(dev, is_copy) if not c]
    busy = busy_ms(dev)
    launches = sum(e.count for e in prof.key_averages()
                   if e.key in ("cudaLaunchKernel", "cudaLaunchKernelExC",
                                "cuLaunchKernel", "cuLaunchKernelEx"))
    log(f"[trace] replay wave: {len(res)} requests, {dispatches} dispatches, "
        f"{forwards} packed forwards; wall {wall:.1f} ms untraced, "
        f"{traced:.1f} ms traced; device busy {busy:.1f} ms, idle share "
        f"{1 - busy / wall:.1%} of the untraced wall")
    log(f"[trace] per packed forward: {len(kernels) / forwards:.0f} device "
        f"kernels, {len(copies) / forwards:.1f} copies/memsets, "
        f"{launches / forwards:.0f} kernel launches from the host, "
        f"{busy / forwards:.3f} ms device busy, {wall / forwards:.3f} ms wall "
        f"untraced")
    by_name = {}
    for e in kernels:
        n, t = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (n + 1, t + (e.time_range.end - e.time_range.start))
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:12]
    for name, (n, t) in top:
        log(f"[trace]   {t / 1e3:8.2f} ms {n:6d}x  {name[:110]}")

    # the tile map derived from the ids, as every block's call derives it
    seg = torch.full((16, 256), -1, dtype=torch.int32, device=DEV)
    for r in range(16):
        for s in range(4):
            seg[r, 64 * s:64 * s + 64] = 4 * r + s
    q = torch.empty((16, 256, 16, 72), dtype=torch.bfloat16, device=DEV)
    n_calls = 100
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n_calls):
            ops.kernel_kwargs(q, q, causal=False, segment_ids=seg)
        torch.cuda.synchronize()
    dev = device_events(prof)
    n_copy = sum(1 for e in dev if "memcpy" in e.name.lower())
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n_calls):
        ops.kernel_kwargs(q, q, causal=False, segment_ids=seg)
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3 / n_calls
    per = (len(dev) - n_copy) / n_calls
    log(f"[trace] tile map from the ids (kernel_kwargs, 16 rows x 256): "
        f"{per:.0f} kernels + {n_copy / n_calls:.0f} host-to-device copy a "
        f"call, {host_ms:.3f} ms a call on the host; x {cfg.num_layers} "
        f"blocks = {per * cfg.num_layers:.0f} kernels and "
        f"{host_ms * cfg.num_layers:.2f} ms a packed forward")
    log(smi)


if __name__ == "__main__":
    if not torch.cuda.is_available():
        sys.exit("tools/serving_trace.py: needs a CUDA card")
    main()
