#!/usr/bin/env python3
"""The output check's control: the plain reference put in the program's
place at the precision below the configuration's (fp8 e4m3 for bf16),
read against the float32 reference as a run reads the program. It must
come out as not correct; the benchmark's runs do not run it.

    python3 bench/control.py --workload <name> --seeds 1,2,3 [--seconds 30]

Prints one JSON line per seed: the reading, the cell's limit, and
whether the reading fails it.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import run as bench_run


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=30.0)
    ap.add_argument("--precision", default="fp8")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("the control runs on a CUDA card", file=sys.stderr)
        return 2
    spec = bench_run.load_spec()
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        ctx = bench_run.make_ctx(spec, args.workload, seed, args.seconds,
                                 False, torch.device("cuda", 0))
        driver = bench_run.load_module(
            ctx.bench / "drivers" / f"{ctx.mix['driver']}.py",
            bench_run._mod_name("driver", ctx.mix["driver"]))
        v = driver.control_reading(ctx, args.precision)
        lim = ctx.limits["x0_rel_err"]
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "precision": args.precision, "x0_rel_err": v,
                          "limit": lim, "fails": v > lim,
                          "seconds": time.perf_counter() - t0}), flush=True)
        ctx.weights = None
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
