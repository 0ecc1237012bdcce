"""Tiny float32 cuts of the benchmark's configurations, for the harness's
own tests on the CPU: every cell's path (drivers, window, readers,
reference, comparison) at a size a test can hold. Never a cell."""
from __future__ import annotations

import copy
import importlib.util
import json
import sys
from pathlib import Path
from typing import Any, Dict, Optional

import torch

BENCH = Path(__file__).resolve().parents[1]


def load_run(bench: Path = BENCH):
    """``bench/run.py`` as a module (a name of its own)."""
    name = "bench_run_" + str(abs(hash(str(bench))))
    if name in sys.modules:
        return sys.modules[name]
    spec = importlib.util.spec_from_file_location(name, bench / "run.py")
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def tiny_config(config: Dict[str, Any]) -> Dict[str, Any]:
    c = copy.deepcopy(config)
    m = c["model"]
    m.update(num_layers=2, d_model=64, d_ff=256, param_dtype="float32",
             compute_dtype="float32")
    m["attn"].update(num_heads=4, num_kv_heads=4, head_dim=16)
    m["dit"]["latent_shape"] = [1, 8, 8, m["dit"]["latent_shape"][-1]]
    if m["dit"]["conditioning"] == "text":
        m["dit"].update(text_len=8, text_dim=32, lora_rank=4)
    return c


def tiny_ctx(workload: str, seed: int = 2 ** 31 + 7, seconds: float = 0.4,
             trace: bool = False, bench: Path = BENCH,
             spec: Optional[Dict[str, Any]] = None,
             rate: Optional[float] = None):
    """A CPU run's context of ``workload`` at the tiny size: T 10, a
    64-token engine step, prompts of 2 to 8 tokens, one image checked a
    budget."""
    run = load_run(bench)
    spec = spec or run.load_spec(bench)
    cell = {w["name"]: w for w in spec["workloads"]}[workload]
    entry = {c["name"]: c for c in spec["configs"]}[cell["config"]]
    cfg = tiny_config(json.loads((bench.parent / entry["file"]).read_text()))
    ctx = run.make_ctx(spec, workload, seed, seconds, trace,
                       torch.device("cpu"), bench=bench, config=cfg,
                       rate=rate)
    mix = ctx.mix
    mix["plan"]["T"] = 10
    if mix["driver"] == "engine":
        mix["engine"]["max_tokens_per_step"] = 64
        mix["engine"]["steps_per_dispatch"] = 4
        mix["check"]["per_budget"] = 1
    else:
        mix["prompt_len"] = [2, 8]
    return ctx


def cpu_run(workload: str, bench: Path = BENCH,
            spec: Optional[Dict[str, Any]] = None, **kw) -> Dict[str, Any]:
    """One whole run of ``workload`` at the tiny size on the CPU: the
    result line's object."""
    run = load_run(bench)
    spec = spec or run.load_spec(bench)
    ctx = tiny_ctx(workload, bench=bench, spec=spec, **kw)
    line = run.run_cell(spec, ctx)
    line.pop("_log")
    return line
