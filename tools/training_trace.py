"""Where a full-width training step's time goes on a CUDA card: DiT-XL/2
through the port's ``make_dit_train_step``, eager and captured, split and
traced.

    python3 tools/training_trace.py

DiT-XL/2 (28 layers, d=1152, bf16 parameters, float32 AdamW moments,
random weights from a seed), B=32, the reference's synthetic batch, at
patch modes 0 and 1. For each mode, one step object, run two ways on the
same trees (the step writes them in place):

- eager (under ``runtime.graphs.disabled()``), after two warm steps:
  CUDA events time the whole step (``TrainStep.__call__``: draws,
  gradients, AdamW) and the host's time to enqueue it (medians of 5),
  then the loss alone (the forward, no graph), the gradients (forward
  and backward, ``value_and_grad``) and ``adamw_update`` alone on those
  gradients, so forward, backward and optimizer shares follow;
- captured (one CUDA graph, the parameters and the AdamW state donated):
  its first call (eager, then the capture) timed once, then the replays'
  wall and host time (medians of 5);
- one eager step and one replay under ``torch.profiler``: the device's
  busy time (the sum of the kernels' durations) against the wall, and
  the top kernels by device time.

At mode 0 the profile also sums the zero fills (the backward of
``_layer``'s ``a[i]`` on each stacked leaf writes a zero-filled
full-size gradient per layer, then sums them). Ends with the card's name
and power limit.
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
from repro_torch.configs.base import TrainConfig  # noqa: E402
from repro_torch.core.scheduler import dit_nfe_flops  # noqa: E402
from repro_torch.data import pipeline as dp  # noqa: E402
from repro_torch.diffusion.schedule import linear_schedule  # noqa: E402
from repro_torch.launch import steps as st  # noqa: E402
from repro_torch.models import dit as dit_mod  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.runtime import graphs  # noqa: E402

DEV = torch.device("cuda")
B, REPS = 32, 5


def log(msg: str) -> None:
    print(msg, flush=True)


def timed(fn, reps: int = REPS):
    """Median milliseconds of ``fn`` between CUDA events, and the median
    host time to enqueue it, from the same calls."""
    walls, host = [], []
    for _ in range(reps):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        t0 = time.perf_counter()
        fn()
        host.append((time.perf_counter() - t0) * 1e3)
        end.record()
        end.synchronize()
        walls.append(start.elapsed_time(end))
    return float(np.median(walls)), float(np.median(host))


def profiled(fn, label: str, wall: float, top: int) -> dict:
    """``fn`` once under ``torch.profiler``: device busy time against
    ``wall`` and the top kernels; returns the kernels' ms by name."""
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    by_name: dict = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            n, ms = by_name.get(e.name, (0, 0.0))
            by_name[e.name] = (n + 1, ms + (e.time_range.end
                                            - e.time_range.start) / 1e3)
    busy = sum(ms for _, ms in by_name.values())
    log(f"[trace] {label} under the profiler: device busy {busy:.1f} ms "
        f"({100 * busy / wall:.1f} % of the {wall:.1f} ms wall), "
        f"{sum(n for n, _ in by_name.values())} kernels and copies")
    for name, (n, ms) in sorted(by_name.items(), key=lambda kv: -kv[1][1])[:top]:
        log(f"[trace]   {ms:8.2f} ms {n:6d}x  {name[:110]}")
    return by_name


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
        call = lambda: step(params, opt, batch, gen)
        flop = 3 * B * dit_nfe_flops(cfg, mode)
        with graphs.disabled():
            for _ in range(2):
                call()
            whole, host = timed(call)
            draws = step.draw(batch, gen)
            with torch.no_grad():
                fwd, _ = timed(lambda: step.loss_fn(params, batch, **draws))
            grads_ms, _ = timed(lambda: step.loss_and_grads(params, batch, **draws))
            _, grads = step.loss_and_grads(params, batch, **draws)
            opt_ms, _ = timed(lambda: adamw.adamw_update(params, grads, opt, tc))
            del grads
            log(f"[trace] mode {mode} ({dit_mod.tokens_for_mode(cfg, mode)} "
                f"tokens), B={B}, eager: step {whole:.1f} ms "
                f"({flop / whole / 1e9:.1f} TFLOP/s of {flop / 1e12:.2f} "
                f"TFLOP), host enqueue {host:.1f} ms; forward alone "
                f"{fwd:.1f} ms, forward + backward {grads_ms:.1f} ms (backward "
                f"{grads_ms - fwd:.1f}), adamw_update {opt_ms:.1f} ms, the "
                f"rest {whole - grads_ms - opt_ms:.1f} ms ({smi})")
            eager_kernels = profiled(call, f"mode {mode} eager step", whole, 12)
        first, _ = timed(call, reps=1)
        replay, host = timed(call)
        log(f"[trace] mode {mode}, captured: first call (eager, then the "
            f"capture) {first:.1f} ms; a replay {replay:.1f} ms "
            f"({flop / replay / 1e9:.1f} TFLOP/s), host {host:.2f} ms; "
            f"{step.captures} graph, pool "
            f"{graphs.stats([step])['graph_pool_bytes'] / 1e9:.2f} GB, a "
            f"replay copies in {step.graphs()[0].in_bytes / 1e6:.3f} MB "
            f"({smi})")
        profiled(call, f"mode {mode} replay", replay, 12)
        if mode == 0:
            fills = [(n, ms) for name, (n, ms) in eager_kernels.items()
                     if "fill" in name.lower() or "zero" in name.lower()]
            log(f"[trace]   eager zero fills: {sum(n for n, _ in fills)}x, "
                f"{sum(ms for _, ms in fills):.2f} ms")
        del step
        torch.cuda.empty_cache()
    log(smi)


if __name__ == "__main__":
    main()
