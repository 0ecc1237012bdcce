"""Where a full-width training step's time goes on a CUDA card: DiT-XL/2
through the port's ``make_dit_train_step``, split and traced.

    python3 tools/training_trace.py

DiT-XL/2 (28 layers, d=1152, bf16 parameters, float32 AdamW moments,
random weights from a seed), B=32, the reference's synthetic batch, at
patch modes 0 and 1. For each mode, after two warm steps, CUDA events
time (medians of 5):

- the whole step (``TrainStep.__call__``: draws, gradients, AdamW);
- the loss alone (the forward, no graph);
- the gradients (forward and backward, ``value_and_grad``);
- ``adamw_update`` alone, on those gradients;

so forward, backward and optimizer shares follow. Then one step at mode 0
runs under ``torch.profiler``: the device time of the top kernels by name,
and of the zero fills (the backward of ``_layer``'s ``a[i]`` on each
stacked leaf writes a zero-filled full-size gradient per layer, then
sums them). Ends with the card's name and power limit.
"""
from __future__ import annotations

import subprocess
import sys
from pathlib import Path

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import TrainConfig  # noqa: E402
from repro_torch.core.scheduler import dit_nfe_flops  # noqa: E402
from repro_torch.data import pipeline as dp  # noqa: E402
from repro_torch.diffusion.schedule import linear_schedule  # noqa: E402
from repro_torch.launch import steps as st  # noqa: E402
from repro_torch.models import dit as dit_mod  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402

DEV = torch.device("cuda")
B, REPS = 32, 5


def log(msg: str) -> None:
    print(msg, flush=True)


def timed(fn, reps: int = REPS) -> float:
    """Median milliseconds of ``fn`` between CUDA events."""
    out = []
    for _ in range(reps):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        fn()
        end.record()
        end.synchronize()
        out.append(start.elapsed_time(end))
    return float(np.median(out))


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("training_trace.py: needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    cfg = get_config("dit-xl-2")
    gen = torch.Generator(device=DEV).manual_seed(0)
    params = dit_mod.init_dit(cfg, gen)
    for node, key, scale in [(params["deembed"], "w_flex", 0.1),
                             (params["final"]["ada"], "w", 0.05),
                             (params["blocks"]["ada"], "w", 0.05)]:
        node[key] = (torch.randn(node[key].shape, generator=gen, device=DEV)
                     * scale).to(node[key].dtype)
    b = dp.make_dit_batch_fn(cfg.dit.latent_shape, 1000, B)(
        0, 0, 1, np.random.default_rng(0))
    batch = {k: torch.from_numpy(b[k]).to(DEV) for k in ("x0", "cond")}
    tc = TrainConfig(learning_rate=1e-4, warmup_steps=0, schedule="constant")
    sched = linear_schedule(1000)
    opt = adamw.init_opt_state(params)
    for mode in (0, 1):
        step = st.make_dit_train_step(cfg, tc, sched, mode=mode)
        draws = step.draw(batch, gen)
        for _ in range(2):
            step(params, opt, batch, gen)
        whole = timed(lambda: step(params, opt, batch, gen))
        with torch.no_grad():
            fwd = timed(lambda: step.loss_fn(params, batch, **draws))
        grads_ms = timed(lambda: step.loss_and_grads(params, batch, **draws))
        _, grads = step.loss_and_grads(params, batch, **draws)
        opt_ms = timed(lambda: adamw.adamw_update(params, grads, opt, tc))
        del grads
        flop = 3 * B * dit_nfe_flops(cfg, mode)
        log(f"[trace] mode {mode} ({dit_mod.tokens_for_mode(cfg, mode)} "
            f"tokens), B={B}: step {whole:.1f} ms ({flop / whole / 1e9:.1f} "
            f"TFLOP/s of {flop / 1e12:.2f} TFLOP); forward alone {fwd:.1f} "
            f"ms, forward + backward {grads_ms:.1f} ms (backward "
            f"{grads_ms - fwd:.1f}), adamw_update {opt_ms:.1f} ms, the rest "
            f"{whole - grads_ms - opt_ms:.1f} ms ({smi})")

    step = st.make_dit_train_step(cfg, tc, sched, mode=0)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        step(params, opt, batch, gen)
        torch.cuda.synchronize()
    by_name: dict = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            n, ms = by_name.get(e.name, (0, 0.0))
            by_name[e.name] = (n + 1, ms + (e.time_range.end
                                            - e.time_range.start) / 1e3)
    total = sum(ms for _, ms in by_name.values())
    log(f"[trace] mode 0 step under the profiler: {total:.1f} ms of device "
        f"time, {sum(n for n, _ in by_name.values())} kernels and copies")
    for name, (n, ms) in sorted(by_name.items(), key=lambda kv: -kv[1][1])[:20]:
        log(f"[trace]   {ms:8.2f} ms {n:6d}x  {name[:110]}")
    fills = [(n, ms) for name, (n, ms) in by_name.items()
             if "fill" in name.lower() or "zero" in name.lower()]
    log(f"[trace]   zero fills: {sum(n for n, _ in fills)}x, "
        f"{sum(ms for _, ms in fills):.2f} ms")
    log(smi)


if __name__ == "__main__":
    main()
