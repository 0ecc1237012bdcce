"""Where a full-width DiT forward's time goes on a CUDA card: the forward
that ``chip_smoke.py`` phase 16 holds against the planner's compute bound,
and the serving engine's packed micro-step.

    python3 tools/forward_trace.py [--packed]

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

Then (alone with ``--packed``) one packed micro-step of the serving
engine (``FlexiPipeline.packed_step``, DDIM, CFG 1.5, flash attention),
run eagerly under ``runtime.graphs.disabled()`` so that the profiler sees
the host ops a CUDA-graph replay hides, at two layouts of 8,192 tokens
(:data:`PACKED_LAYOUTS`): the full backlog's 32 rows of one 256-token
segment, and a mixed layout of 256- and 64-token segments with a
128-token padding tail. Its wall (CUDA events, median of REPS) and device
busy time, then every device kernel attributed to the code that issued
it: the PyTorch op whose correlation id the kernel carries, and the
innermost three ``repro_torch`` lines of the Python stack that called the
op (each op runs inside a profiler range named by them, :class:`CallSites`);
kernels launched through ctypes (the port's own CUDA kernels) carry no
PyTorch op and are named by kernel. Rows by code line, largest first, with
their share of the device's busy time.

Ends with the card's name and power limit.
"""
from __future__ import annotations

import collections
import subprocess
import sys
import time
from pathlib import Path

import torch
from torch.profiler import ProfilerActivity, profile, record_function
from torch.utils._python_dispatch import TorchDispatchMode

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.diffusion.schedule import linear_schedule  # noqa: E402
from repro_torch.models import dit as dit_mod  # noqa: E402
from repro_torch.pipeline import FlexiPipeline  # noqa: E402
from repro_torch.pipeline.packed import PackLayout  # noqa: E402
from repro_torch.pipeline.pipeline import PackedStepKey  # noqa: E402
from repro_torch.runtime import graphs  # noqa: E402
from repro_torch.telemetry.profile import dummy_packed_args  # noqa: E402

DEV = torch.device("cuda")
B, REPS, SEED = 8, 20, 16
# requests a mode under CFG (two segments each): 32 rows of 256 tokens
PACKED_LAYOUTS = {"full": PackLayout(((0, 16),)),
                  "mixed": PackLayout(((0, 4), (1, 47)))}


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


def call_site() -> str:
    """The innermost three ``repro_torch`` frames of the Python stack,
    innermost first, as ``path:line``."""
    f, sites = sys._getframe(2), []
    while f is not None and len(sites) < 3:
        name = f.f_code.co_filename
        if "/repro_torch/" in name:
            sites.append(f"{name.split('/repro_torch/')[1]}:{f.f_lineno}")
        f = f.f_back
    return " <- ".join(sites) or "(outside repro_torch)"


class CallSites(TorchDispatchMode):
    """Run every PyTorch op inside a profiler range named ``@`` and its
    call site: the profiler records a Python function's first line, not the
    line that called the op, and two calls of one function (the block's two
    LayerNorms) must be told apart."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        with record_function("@" + call_site()):
            return func(*args, **(kwargs or {}))


def attribute(prof) -> tuple:
    """(device busy ms, rows): every device kernel's time summed by the
    code that issued it. A row: (ms, launches, call site, PyTorch op, the
    largest kernel's name); ctypes launches, which no PyTorch op carries,
    get a row per kernel name."""
    events = prof.events()
    # the call-site ranges also show on the device's timeline: not kernels
    kernels = [e for e in events if e.device_type.name == "CUDA"
               and not e.name.startswith("@")]
    busy = sum(e.device_time_total for e in kernels) / 1e3
    rows = collections.defaultdict(lambda: [0.0, 0, collections.Counter()])
    seen = collections.Counter()
    for e in events:
        if e.device_type.name != "CPU" or not e.kernels:
            continue
        site = e.cpu_parent
        while site is not None and not site.name.startswith("@"):
            site = site.cpu_parent
        row = rows[(site.name[1:] if site else "(no call site)", e.name)]
        for k in e.kernels:
            row[0] += k.duration / 1e3
            row[1] += 1
            row[2][k.name] += k.duration
            seen[k.name] += k.duration
    left = collections.Counter()
    for e in kernels:
        left[e.name] += e.device_time_total
    for name, us in (left - seen).items():
        rows[("(no PyTorch op)", name)] = [us / 1e3, 0,
                                           collections.Counter({name: us})]
    out = sorted(((ms, n, code, op, ks.most_common(1)[0][0])
                  for (code, op), (ms, n, ks) in rows.items()), reverse=True)
    return busy, out


def trace_packed(pipe: FlexiPipeline, name: str, layout: PackLayout) -> None:
    cfg = pipe.cfg
    kw = dict(solver="ddim", guidance_scale=1.5, attn_backend="pallas")
    key = PackedStepKey(layout, **kw)
    gen = torch.Generator(device=DEV).manual_seed(SEED + 1)
    xs, metas, noises = dummy_packed_args(cfg, key, DEV)
    xs = tuple(torch.randn(x.shape, generator=gen, device=DEV) for x in xs)
    cost = layout.cost(cfg)
    with graphs.disabled(), torch.inference_mode():
        step = pipe.packed_step(layout, **kw)

        def call():
            return step(pipe.params, xs, metas, noises)
        for _ in range(2):
            call()
        torch.cuda.synchronize()
        walls = sorted(timed(call)[0] for _ in range(REPS))
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            with CallSites():
                call()
            torch.cuda.synchronize()
    busy, rows = attribute(prof)
    wall = walls[len(walls) // 2]
    log(f"[packed] {name}: groups {layout.groups} under CFG, {cost.rows} rows "
        f"x 256 ({cost.real_tokens} real tokens); micro-step wall {wall:.3f} ms "
        f"(median of {REPS}, graphs disabled), device busy {busy:.3f} ms "
        f"under the profiler")
    for ms, n, code, op, kernel in rows:
        if ms < 0.002 * busy:
            continue
        log(f"[packed]   {ms:8.3f} ms {100 * ms / busy:5.1f} % x{n:4d}  "
            f"{code}  [{op}]  {kernel[:60]}")
    small = sum(ms for ms, *_ in rows if ms < 0.002 * busy)
    log(f"[packed]   {small:8.3f} ms {100 * small / busy:5.1f} % in rows under "
        f"0.2 % each")


def main() -> None:
    if sys.argv[1:] not in ([], ["--packed"]):
        sys.exit("usage: python3 tools/forward_trace.py [--packed]")
    if not torch.cuda.is_available():
        sys.exit("forward_trace.py: needs a CUDA card")
    gen = torch.Generator(device=DEV).manual_seed(SEED)
    params, cfg = trained_like(gen)
    if sys.argv[1:] == []:
        trace_forward(params, cfg, gen)
    pipe = FlexiPipeline(params, cfg, linear_schedule(1000), device=DEV)
    for name, layout in PACKED_LAYOUTS.items():
        trace_packed(pipe, name, layout)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    log(smi)


def trace_forward(params, cfg, gen: torch.Generator) -> None:
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


if __name__ == "__main__":
    main()
