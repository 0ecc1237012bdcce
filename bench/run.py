#!/usr/bin/env python3
"""Run one benchmark cell of the PyTorch/CUDA port once.

    python3 bench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Reads the cell from ``BENCHMARK.json``; its configuration file, its
traffic mix (``bench/traffic/<traffic>.json``, whose ``driver`` names the
entry point's driver under ``bench/drivers/``), its limits
(``bench/limits/<cell>.json``) and each metric's reader
(``bench/metrics/<metric>.py``) are found by name. Set-up makes the
weights and inputs from the seed, warms every shape the traffic reaches
and opens the window; after it, with the program's state freed, the
plain reference (``bench/reference/``) recomputes a seeded sample of the
outputs. The last line of standard output is one JSON object (``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1``
``breakdown``, and last ``check``: each number compared with its limit);
the last lines of standard error repeat the check.

``--trace 0`` reports the cell's end-to-end metrics, ``--trace 1`` its
per-layer metrics, read partly from a ``torch.profiler`` trace of the
window's first part. ``--rate`` (an open-loop mix's arrival rate) and
``--skip-check`` serve the knee sweep and are not part of a cell's run.
Exits with 2 and prints no result without the CUDA cards the cell asks
for, and with 3 if JAX or the JAX package was loaded.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from types import ModuleType  # noqa: E402
from typing import Any, Callable, Dict, List, Optional  # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")

for p in (str(ROOT / "src"), str(BENCH)):
    if p not in sys.path:
        sys.path.insert(0, p)


@dataclasses.dataclass
class Ctx:
    """Everything a driver, a reader and the reference are handed."""
    bench: Path
    workload: str
    cell: Dict[str, Any]
    config: Dict[str, Any]          # the configuration file
    mix: Dict[str, Any]             # the traffic mix
    limits: Dict[str, float]
    seed: int
    seconds: float
    trace: bool
    device: Any
    t_start: float
    clock: Callable[[], float] = time.perf_counter
    rate: Optional[float] = None
    reference: Optional[ModuleType] = None
    weights: Any = None

    @property
    def model(self) -> Dict[str, Any]:
        return self.config["model"]


def load_module(path: Path, name: str) -> ModuleType:
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _mod_name(kind: str, name: str) -> str:
    return "bench_" + kind + "_" + "".join(
        c if c.isalnum() else "_" for c in name)


def load_spec(bench: Path = BENCH) -> Dict[str, Any]:
    return json.loads((bench.parent / "BENCHMARK.json").read_text())


def make_ctx(spec: Dict[str, Any], workload: str, seed: int, seconds: float,
             trace: bool, device: Any, bench: Path = BENCH,
             t_start: Optional[float] = None, rate: Optional[float] = None,
             config: Optional[Dict[str, Any]] = None) -> Ctx:
    """The context of one run of ``workload``; ``config`` replaces the
    configuration file (the tests' tiny models)."""
    from benchlib import compare, traffic
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; known: "
                         f"{sorted(cells)}")
    cell = cells[workload]
    if config is None:
        entry = {c["name"]: c for c in spec["configs"]}[cell["config"]]
        config = json.loads((bench.parent / entry["file"]).read_text())
    ctx = Ctx(bench=bench, workload=workload, cell=cell, config=config,
              mix=traffic.load(bench, cell["traffic"]),
              limits=compare.load_limits(bench, workload), seed=int(seed),
              seconds=float(seconds), trace=bool(trace), device=device,
              t_start=time.perf_counter() if t_start is None else t_start,
              rate=rate)
    ctx.reference = load_module(
        bench / "reference" / f"{config['reference']}.py",
        _mod_name("reference", config["reference"]))
    return ctx


def cell_metrics(spec: Dict[str, Any], workload: str, trace: bool
                 ) -> List[Dict[str, Any]]:
    """The metrics a run of ``workload`` reports: its end-to-end ones, or
    with a trace its per-layer ones."""
    group = spec["per_layer"] if trace else spec["end_to_end"]
    return [mt for mt in group
            if "workloads" not in mt or workload in mt["workloads"]]


def run_cell(spec: Dict[str, Any], ctx: Ctx, skip_check: bool = False
             ) -> Dict[str, Any]:
    """Set-up, window, metrics and output check of one run; returns the
    result line's object (plus ``_log``, lines for standard error)."""
    import torch
    from benchlib import compare
    from benchlib.trace import Tracer

    driver = load_module(ctx.bench / "drivers" / f"{ctx.mix['driver']}.py",
                         _mod_name("driver", ctx.mix["driver"]))
    tracer = Tracer(ctx.trace, ctx.bench.parent / "build" / "bench" /
                    "trace.json")
    r = driver.run(ctx)
    r.window(tracer)
    obs = r.obs
    obs["setup_s"] = obs["t_open"] - ctx.t_start
    obs["trace"] = tracer.read()
    cuda = ctx.device.type == "cuda"
    peak = torch.cuda.max_memory_allocated(ctx.device) if cuda else 0
    r.close()

    metrics = {}
    for mt in cell_metrics(spec, ctx.workload, ctx.trace):
        reader = load_module(ctx.bench / "metrics" / f"{mt['name']}.py",
                             _mod_name("metric", mt["name"]))
        v = reader.read(obs, ctx)
        if v is not None:
            metrics[mt["name"]] = {"value": float(v), "unit": mt["unit"]}

    t_check = time.perf_counter()
    readings = {} if skip_check else driver.check(ctx, r)
    ok, rows = compare.judge(readings, ctx.limits)
    device = {"platform": "gpu" if cuda else ctx.device.type,
              "kind": torch.cuda.get_device_name(ctx.device) if cuda
              else "cpu",
              "count": int(ctx.cell["chips"]), "memory_peak_bytes": int(peak)}
    line: Dict[str, Any] = {
        "correct": bool(ok and r.attempted > 0 and not skip_check),
        "attempted": int(r.attempted), "failed": int(r.failed),
        "metrics": metrics, "device": device}
    if obs["trace"] is not None:
        device["busy_s"] = obs["trace"]["busy_s"]
        device["window_s"] = obs["trace"]["window_s"]
        line["breakdown"] = {"device_ops": obs["trace"]["device_ops"],
                             "idle_gaps": obs["trace"]["idle_gaps"]}
    line["check"] = {n: {"value": v, "limit": lim} for n, v, lim in rows}
    info = {k: v for k, v in obs.items() if k in (
        "setup_s", "warm_s", "prime_s", "window_s", "completed", "clients",
        "layouts_warmed", "backlog", "late_s", "built_in_window",
        "batches")}
    info["check_s"] = time.perf_counter() - t_check
    log = [f"cell {ctx.workload} seed {ctx.seed}: {json.dumps(info)}"]
    if readings:
        log.append("checked " + json.dumps(
            {str(k): v for k, v in readings.get("errors", {}).items()}))
    log += [f"check {n} {v!r} limit {lim!r}" for n, v, lim in rows]
    line["_log"] = log
    return line


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--rate", type=float, default=None)
    ap.add_argument("--skip-check", action="store_true")
    args = ap.parse_args(argv)

    spec = load_spec()
    import torch
    cells = {w["name"]: w for w in spec["workloads"]}
    chips = cells.get(args.workload, {}).get("chips", 1)
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"{args.workload} needs {chips} CUDA card(s); "
              f"cuda available: {torch.cuda.is_available()}",
              file=sys.stderr)
        return 2
    ctx = make_ctx(spec, args.workload, args.seed, args.seconds,
                   bool(args.trace), torch.device("cuda", 0),
                   t_start=T_START, rate=args.rate)
    line = run_cell(spec, ctx, skip_check=args.skip_check)
    bad = forbidden_modules()
    if bad:
        print(f"forbidden modules loaded: {bad}", file=sys.stderr)
        return 3
    log = line.pop("_log")
    print(json.dumps(line), flush=True)
    for entry in log:
        print(entry, file=sys.stderr, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
