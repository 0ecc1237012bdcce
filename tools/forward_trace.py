"""Where a full-width DiT forward's time goes on a CUDA card: the forward
that ``chip_smoke.py`` phase 16 holds against the planner's compute bound.

    python3 tools/forward_trace.py

DiT-XL/2 (28 layers, d=1152, bf16, random weights from a seed) at B=8,
patch modes 0 and 1, ``dit_forward`` with the flash kernel as the
attention backend, under ``torch.inference_mode``. For each mode, after
two warm calls:

- the wall a forward takes between CUDA events, and the host's time to
  enqueue it (``time.perf_counter`` around the call, between the two
  event records), both from the same calls (medians of REPS);
- one forward under ``torch.profiler``: kernels launched, the device's
  busy time (the sum of the kernels' durations), the top kernels by
  device time and the top host ops by self CPU time.

Ends with the card's name and power limit.
"""
from __future__ import annotations

import subprocess
import sys
import time
from pathlib import Path

import torch
from torch.profiler import ProfilerActivity, profile

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import dit as dit_mod  # noqa: E402

DEV = torch.device("cuda")
B, REPS, SEED = 8, 20, 16


def log(msg: str) -> None:
    print(msg, flush=True)


def trained_like(gen: torch.Generator):
    """DiT-XL/2's random weights, the zero-initialized gates made non-zero
    (``chip_smoke.trained_like_xl``'s recipe)."""
    cfg = get_config("dit-xl-2")
    params = dit_mod.init_dit(cfg, gen)
    for node, key, scale in [(params["deembed"], "w_flex", 0.1),
                             (params["final"]["ada"], "w", 0.05),
                             (params["blocks"]["ada"], "w", 0.05)]:
        node[key] = torch.randn(node[key].shape, generator=gen, device=DEV,
                                dtype=node[key].dtype) * scale
    return params, cfg


def timed(fn) -> tuple:
    """(wall between CUDA events, host enqueue) of one call, in ms: the
    enqueue is timed inside the wall, so it cannot exceed it."""
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    t0 = time.perf_counter()
    fn()
    host = (time.perf_counter() - t0) * 1e3
    end.record()
    end.synchronize()
    return start.elapsed_time(end), host


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("forward_trace.py: needs a CUDA card")
    gen = torch.Generator(device=DEV).manual_seed(SEED)
    params, cfg = trained_like(gen)
    F_, H, W, C = cfg.dit.latent_shape
    x = torch.randn((B, F_, H, W, C), generator=gen, device=DEV).to(torch.bfloat16)
    t = torch.randint(0, 1000, (B,), generator=gen, device=DEV).float()
    y = torch.randint(0, cfg.dit.num_classes, (B,), generator=gen, device=DEV)
    for mode in (0, 1):
        def fwd():
            return dit_mod.dit_forward(params, x, t, y, cfg, mode=mode,
                                       attn_backend="pallas")
        with torch.inference_mode():
            for _ in range(2):
                fwd()
            torch.cuda.synchronize()
            walls, host = (sorted(ms) for ms in
                           zip(*(timed(fwd) for _ in range(REPS))))
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                fwd()
                torch.cuda.synchronize()
        events = prof.key_averages()
        dev = [e for e in events if e.device_type.name == "CUDA"]
        busy = sum(e.self_device_time_total for e in dev) / 1e3
        n_kernels = sum(e.count for e in dev)
        log(f"[forward] mode {mode}, B={B}: wall {walls[len(walls) // 2]:.3f} ms "
            f"(median of {REPS}, min {walls[0]:.3f}); host enqueue "
            f"{host[len(host) // 2]:.3f} ms; device busy {busy:.3f} ms over "
            f"{n_kernels} device ops ({100 * busy / walls[len(walls) // 2]:.1f} "
            f"% of the wall)")
        for e in sorted(dev, key=lambda e: -e.self_device_time_total)[:8]:
            log(f"[forward]   device {e.self_device_time_total / 1e3:8.3f} ms "
                f"x{e.count:4d}  {e.key[:90]}")
        cpu = [e for e in events if e.device_type.name == "CPU"]
        for e in sorted(cpu, key=lambda e: -e.self_cpu_time_total)[:8]:
            log(f"[forward]   host   {e.self_cpu_time_total / 1e3:8.3f} ms "
                f"x{e.count:4d}  {e.key[:90]}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    log(smi)


if __name__ == "__main__":
    main()
