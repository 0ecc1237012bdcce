"""Where a full-width language-model training step's time goes on a CUDA
card: gemma2-9b and deepseek-moe-16b through the port's
``make_train_step``, eager and captured, traced.

    python3 tools/lm_training_trace.py

The two configs and batches of ``chip_smoke.py`` phase 13 (gemma2-9b at
full width cut to 4 layers, B=1 x 8192, remat "block"; deepseek-moe-16b
cut to 2 layers, B=2 x 4096; bf16 parameters, float32 AdamW moments,
random weights from a seed, the trainer's synthetic corpus). One step
object a config, run two ways on the same trees (the step writes them in
place): under ``runtime.graphs.disabled()`` after two warm steps, then
captured (one CUDA graph, the parameters and the AdamW state donated;
its first call captures, a warm replay follows). One eager step and one
replay each run under ``torch.profiler``: the wall (CUDA events) and the
device's busy time (the sum of the kernels' durations) as a share of
it, the top kernels by name, and that time grouped into GEMMs (cuBLAS /
CUTLASS), reductions (softmax, log-softmax, norms, sums) and the other
element-wise passes, copies and fills. Ends with the card's name and
power limit.
"""
from __future__ import annotations

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")

import numpy as np  # noqa: E402
import torch  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import TrainConfig  # noqa: E402
from repro_torch.data import pipeline as dp  # noqa: E402
from repro_torch.launch import steps as st  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.runtime import graphs  # noqa: E402

DEV = torch.device("cuda")
RUNS = [("gemma2-9b", 4, 1, 8192), ("deepseek-moe-16b", 2, 2, 4096)]
GROUPS = [("GEMM", ("gemm", "cutlass", "sm90_xmma", "cublas", "nvjet")),
          ("reduction", ("softmax", "reduce", "norm", "sum", "mean")),
          ("copy / fill", ("copy", "fill", "cat", "index"))]


def log(msg: str) -> None:
    print(msg, flush=True)


def group_of(name: str) -> str:
    low = name.lower()
    for group, keys in GROUPS:
        if any(k in low for k in keys):
            return group
    return "other element-wise"


def wall_ms(fn) -> float:
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end)


def profiled(label: str, fn) -> None:
    """``fn`` timed, then once more under the profiler: busy share of the
    wall, the groups and the top kernels."""
    wall = wall_ms(fn)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    by_name: dict = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            n, ms = by_name.get(e.name, (0, 0.0))
            by_name[e.name] = (n + 1, ms + (e.time_range.end - e.time_range.start) / 1e3)
    total = sum(ms for _, ms in by_name.values())
    log(f"[trace] {label}: wall {wall:.1f} ms, device busy {total:.1f} ms "
        f"({100 * total / wall:.1f} % of the wall) under the profiler, "
        f"{sum(n for n, _ in by_name.values())} kernels and copies")
    groups: dict = {}
    for kname, (n, ms) in by_name.items():
        g = groups.setdefault(group_of(kname), [0, 0.0])
        g[0] += n
        g[1] += ms
    for g, (n, ms) in sorted(groups.items(), key=lambda kv: -kv[1][1]):
        log(f"[trace]   {g}: {ms:.1f} ms ({ms / max(total, 1e-9):.0%}), {n} launches")
    for kname, (n, ms) in sorted(by_name.items(), key=lambda kv: -kv[1][1])[:12]:
        log(f"[trace]   {ms:8.2f} ms {n:6d}x  {kname[:110]}")


def trace(name: str, keep: int, B: int, S: int) -> None:
    cfg = dataclasses.replace(get_config(name), num_layers=keep)
    gen = torch.Generator(device=DEV).manual_seed(0)
    params = lm.init_params(cfg, gen)
    b = dp.make_lm_batch_fn(cfg.vocab_size, S, B)(0, 0, 1, np.random.default_rng(0))
    batch = {k: torch.from_numpy(b[k]).to(DEV) for k in ("tokens", "targets")}
    step = st.make_train_step(cfg, TrainConfig(learning_rate=1e-4, warmup_steps=0,
                                               schedule="constant"))
    opt = adamw.init_opt_state(params)
    call = lambda: step(params, opt, batch)
    with graphs.disabled():
        for _ in range(2):
            call()
        profiled(f"{name} ({keep} layers) B={B} x S={S}, one eager step", call)
    first = wall_ms(call)
    call()
    log(f"[trace] {name} captured: first call (eager, then the capture) "
        f"{first:.1f} ms, {step.captures} graph, pool "
        f"{graphs.stats([step])['graph_pool_bytes'] / 1e9:.2f} GB")
    profiled(f"{name} ({keep} layers) B={B} x S={S}, one replay", call)
    del step, params, opt, batch
    torch.cuda.empty_cache()


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("lm_training_trace.py: needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    for run in RUNS:
        trace(*run)
    log(smi)


if __name__ == "__main__":
    main()
