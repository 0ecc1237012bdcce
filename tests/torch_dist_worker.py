"""Rank-side work of ``tests/test_torch_distributed.py``: one function that
every rank of a CPU process group runs (``launch.mesh.run_ranks``). It
imports the port and numpy only, so the spawned ranks never import JAX or
``conftest.py``; inputs arrive as numpy and results go back as numpy.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict

import numpy as np
import torch


def _t(a):
    return None if a is None else torch.from_numpy(np.asarray(a))


def run_group(rank: int, device: torch.device, job: Dict[str, Any]) -> dict:
    """Build the job's mesh and run its attention calls, sampling cases,
    budget switch, fixed-slot engine and serving loop on it."""
    from repro_torch import convert
    from repro_torch.diffusion import schedule as sch
    from repro_torch.distributed import ParallelSpec
    from repro_torch.distributed import attention as dist_attn
    from repro_torch.launch.mesh import make_inference_mesh
    from repro_torch.pipeline import FlexiPipeline, SamplingPlan

    d_sz, s_sz = job["mesh"]
    mesh = make_inference_mesh(d_sz, s_sz, device=device, backend="gloo")
    seq_group = mesh.get_group("seq")
    seq_rank = mesh.get_local_rank("seq")
    out: Dict[str, Any] = {"coord": (mesh.get_local_rank("data"), seq_rank)}

    # attention per call: this rank's shard of the global inputs
    for name, impl, q, k, v, seg in job.get("attn", ()):
        n = q.shape[1] // s_sz
        sl = slice(seq_rank * n, (seq_rank + 1) * n)
        fn = dist_attn.ATTN_FNS[impl]
        o = fn(_t(q[:, sl]), _t(k[:, sl]), _t(v[:, sl]), group=seq_group,
               segment_ids=None if seg is None else _t(seg[:, sl]))
        out[name] = o.numpy()

    cfg = job["cfg"]
    params = convert.params_from_numpy(job["params"], device="cpu")
    sched = sch.linear_schedule(job["train_T"])
    pipe = FlexiPipeline(params, cfg, sched, device="cpu", mesh=mesh)
    for case in job.get("cases", ()):
        kw = dict(case["plan"])
        attn = kw.pop("parallel", None)
        plan = SamplingPlan(parallel=None if attn is None
                            else ParallelSpec(attn=attn), **kw)
        gen = (torch.Generator().manual_seed(case["seed"])
               if "seed" in case else None)
        dist_attn.reset_comm_bytes()
        res = pipe.sample(plan, case["n"], gen, cond=_t(case.get("cond")),
                          x_T=_t(case.get("x_T")), noise=_t(case.get("noise")))
        out[case["name"]] = {"x0": res.x0.numpy(), "flops": res.flops,
                             "relative_compute": res.relative_compute,
                             "bytes": dict(dist_attn.comm_bytes)}

    if "switch" in job:          # a budget switch on a fixed mesh
        plans = [SamplingPlan(T=job["switch"]["T"], budget=b,
                              parallel=ParallelSpec())
                 for b in job["switch"]["budgets"]]
        before = pipe.cache_stats()
        for i in range(2 * len(plans)):
            pipe.sample(plans[i % len(plans)], job["switch"]["n"],
                        torch.Generator().manual_seed(i))
        out["switch"] = (before, pipe.cache_stats())

    if "mesh_switch" in job:     # the same plan on a second mesh and back
        other = make_inference_mesh(*job["mesh_switch"], device=device)
        case = next(c for c in job["cases"] if c["name"] == "ddim")
        plan = SamplingPlan(parallel=ParallelSpec(), **{
            k: v for k, v in case["plan"].items() if k != "parallel"})
        fresh = FlexiPipeline(params, cfg, sched, device="cpu", mesh=mesh)
        runners, hits = [], []
        for m in (mesh, other, mesh):
            fresh.set_mesh(m)
            res = fresh.sample(plan, case["n"], None, cond=_t(case["cond"]),
                               x_T=_t(case["x_T"]))
            if m is other:
                x0 = res.x0.numpy()
            runners.append(fresh.cache_stats()["runners"])
            hits.append(fresh.cache_stats()["hits"])
        out["mesh_switch"] = (runners, hits, x0)

    if "fixed" in job:           # FixedSlotEngine on sequence-parallel plans
        from repro_torch.fleet.replica import FixedSlotEngine
        plans = {b: SamplingPlan(T=job["fixed"]["T"], budget=b,
                                 parallel=ParallelSpec())
                 for b in job["fixed"]["budgets"]}
        eng = FixedSlotEngine(pipe, plans, batch_size=2, clock=lambda: 0.0)
        for i, b in enumerate(job["fixed"]["requests"]):
            eng.submit(cond=i, budget=b, seed=50 + i)
        served = eng.run()
        # the same requests alone on this mesh, unsharded plans
        refs = {r.request.id: pipe.sample(
            dataclasses.replace(plans[r.budget_served], parallel=None), 1,
            torch.Generator().manual_seed(r.request.seed),
            cond=torch.tensor([r.request.cond])).x0[0].numpy()
            for r in served}
        out["fixed"] = [(r.request.id, r.budget_served, r.x0.numpy(),
                         refs[r.request.id]) for r in served]

    if "serve" in job:           # the --mesh serving loop of launch/serve.py
        from repro_torch.launch import serve
        cfg_s, args, plans = job["serve"]
        out["serve"] = serve._serve_mesh_rank(rank, device, cfg_s, args,
                                              plans, (d_sz, s_sz))
    return out


def fail_on_rank_one(rank: int, device: torch.device) -> int:
    """A rank that raises: the launcher must raise with its traceback."""
    if rank == 1:
        raise RuntimeError("planted failure on rank 1")
    import torch.distributed as dist
    dist.barrier()               # rank 0 waits for a rank that never comes
    return rank


# ---------------------------------------------------------------------------
# RankGroup calls: fn(rank, device, state, *args), state kept between calls


def count_calls(rank: int, device: torch.device, state: dict, add: int):
    """Adds ``add`` to this rank's running total (kept in ``state``)."""
    import os
    state["n"] = state.get("n", 0) + add
    return rank, os.getpid(), state["n"]


def raise_on_rank(rank: int, device: torch.device, state: dict, bad: int):
    """Rank ``bad`` raises; the others wait for it in a barrier."""
    import torch.distributed as dist
    if rank == bad:
        raise RuntimeError(f"planted failure on rank {rank}")
    dist.barrier()
    return rank


def sleep_then_barrier(rank: int, device: torch.device, state: dict,
                       sleeper: int, seconds: float):
    """Rank ``sleeper`` sleeps (long enough to be killed first); every rank
    then waits in a barrier."""
    import time

    import torch.distributed as dist
    if rank == sleeper:
        time.sleep(seconds)
    dist.barrier()
    return rank


def unpicklable_result(rank: int, device: torch.device, state: dict):
    """A result that cannot cross back to the parent."""
    return lambda: rank
