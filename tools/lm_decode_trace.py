"""Where a captured language-model decode step's time goes on a CUDA card:
the step ``chip_smoke.py`` phases 11 and 12 time against its weight-bytes
bound.

    python3 tools/lm_decode_trace.py

gemma2-9b whole (42 layers, bf16) and deepseek-moe-16b whole (28 layers),
random weights from a seed, B=2 over a cache slot of 8192 + 16 positions
(``lm.serve_slot``; its contents do not change the work: every step
attends over the whole slot), one ``make_decode_step`` runner. After the
first call (eager, then the capture) and one replay:

- the wall a step takes between CUDA events and the host's time to
  enqueue it, replayed and under ``graphs.disabled()`` (medians of REPS);
- three replays under ``torch.profiler``: device ops a step, the device's
  busy time a step (the sum of the ops' durations) and the top device ops
  by time, beside the step's bound (the weights a step reads, and with
  the cache, at 3.35 TB/s).

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
from repro_torch.launch import steps  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.models.common import tree_leaves  # noqa: E402
from repro_torch.runtime import graphs  # noqa: E402

DEV = torch.device("cuda")
B, PROMPT, NEW, REPS, TRACED, SEED = 2, 8192, 16, 10, 3, 21
ARCHS = ("gemma2-9b", "deepseek-moe-16b")
HBM_BYTES_PER_S = 3.35e12


def log(msg: str) -> None:
    print(msg, flush=True)


def timed(fn) -> tuple:
    """(wall between CUDA events, host enqueue) of one call, in ms."""
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    t0 = time.perf_counter()
    fn()
    host = (time.perf_counter() - t0) * 1e3
    end.record()
    end.synchronize()
    return start.elapsed_time(end), host


def read_bytes(params) -> int:
    """The weights a step reads: all but the position table and, untied,
    the embedding (of which it reads a row)."""
    skip = {"pos_embed"} | ({"embed"} if "lm_head" in params else set())
    return sum(t.numel() * t.element_size() for k, v in params.items()
               if k not in skip for t in tree_leaves({k: v}))


def trace(name: str) -> None:
    cfg = get_config(name)
    params = lm.init_params(cfg, torch.Generator(device=DEV).manual_seed(SEED))
    slot = lm.serve_slot(cfg, B, PROMPT + NEW, DEV)
    decode = steps.make_decode_step(cfg)
    tok = torch.randint(0, cfg.vocab_size, (B, 1), device=DEV, dtype=torch.int32,
                        generator=torch.Generator(device=DEV).manual_seed(SEED))
    pos = torch.full((B,), PROMPT, dtype=torch.int32, device=DEV)

    def step():
        return decode(params, slot, tok, pos)

    w_bytes = read_bytes(params)
    c_bytes = sum(t.numel() * t.element_size() for t in slot.values())
    with torch.inference_mode():
        step()                              # eager, then the capture
        step()
        torch.cuda.synchronize()
        out = {}
        for side in ("replayed", "eager"):
            if side == "eager":
                with graphs.disabled():
                    step()
                    ms = [timed(step) for _ in range(REPS)]
            else:
                ms = [timed(step) for _ in range(REPS)]
            walls, host = (sorted(x) for x in zip(*ms))
            out[side] = (walls[len(walls) // 2], host[len(host) // 2])
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(TRACED):
                step()
            torch.cuda.synchronize()
    dev = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
    busy = sum(e.self_device_time_total for e in dev) / 1e3 / TRACED
    n_ops = sum(e.count for e in dev) / TRACED
    bound_w = w_bytes / HBM_BYTES_PER_S * 1e3
    bound_wc = (w_bytes + c_bytes) / HBM_BYTES_PER_S * 1e3
    log(f"[decode] {name} ({cfg.num_layers} layers) B={B} over {PROMPT + NEW} "
        f"positions: replayed {out['replayed'][0]:.3f} ms a step (host "
        f"{out['replayed'][1]:.3f}), eager {out['eager'][0]:.3f} ms (host "
        f"{out['eager'][1]:.3f}), medians of {REPS}; device busy {busy:.3f} ms "
        f"a replayed step over {n_ops:.0f} device ops; bound {bound_w:.3f} ms "
        f"for the weights' {w_bytes / 1e9:.2f} GB at 3.35 TB/s ({bound_wc:.3f} "
        f"with the {c_bytes / 1e9:.2f} GB cache)")
    for e in sorted(dev, key=lambda e: -e.self_device_time_total)[:12]:
        log(f"[decode]   {e.self_device_time_total / 1e3 / TRACED:8.3f} ms a step "
            f"x{e.count // TRACED:5d}  {e.key[:100]}")
    del params, slot, decode, prof
    torch.cuda.empty_cache()


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("lm_decode_trace.py: needs a CUDA card")
    for name in ARCHS:
        trace(name)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    log(smi)


if __name__ == "__main__":
    main()
