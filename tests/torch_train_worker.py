"""Rank-side work of ``tests/test_torch_sharded_train.py``: one function
that every rank of a CPU process group runs (``launch.mesh.run_ranks``).
It imports the port and numpy only, so the spawned ranks never import JAX
or ``conftest.py``; inputs arrive as numpy and results go back as numpy
(full tensors from rank 0 only, each rank's own chunks from every rank).
"""
from __future__ import annotations

import contextlib
from typing import Any, Dict

import numpy as np
import torch


def _np(tree):
    from repro_torch import convert
    return convert.tree_to_numpy(tree)


def _torch(tree):
    if isinstance(tree, dict):
        return {k: _torch(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_torch(v) for v in tree]
    return torch.from_numpy(np.array(tree))


def _full(tree):
    from repro_torch.models.common import tree_map
    from repro_torch.runtime import placement as plc
    return _np(tree_map(plc.gather_full, tree))


def _metrics(m):
    return {k: float(v) for k, v in m.items()}


def _chunks(tree):
    """Each placed leaf's local chunk and where it sits in the full leaf."""
    from repro_torch.models.common import tree_map
    from repro_torch.runtime import placement as plc

    def one(x):
        sl = plc.chunk_slices(x.shape, x.device_mesh, x.placements)
        return (plc.local(x).numpy().copy(), [(s.start, s.stop) for s in sl])
    return tree_map(one, tree)


def _step(case):
    """The case's train step (DiT at its mode, the LoRA distillation, the
    MMD fine-tune, or the LM's)."""
    from repro_torch.configs.base import TrainConfig
    from repro_torch.core import distill, mmd
    from repro_torch.diffusion import schedule as sch
    from repro_torch.launch import steps

    cfg, tc = case["cfg"], TrainConfig(**case["tc"])
    if case.get("kind") == "distill":
        return distill.make_distill_step(cfg, tc, sch.linear_schedule(1000))
    if case.get("kind") == "mmd":
        return mmd.make_mmd_finetune_step(cfg, tc, sch.linear_schedule(1000))
    if cfg.family == "dit":
        return steps.make_dit_train_step(cfg, tc, sch.linear_schedule(1000),
                                         mode=case["mode"])
    return steps.make_train_step(cfg, tc,
                                 n_microbatches=case.get("n_microbatches", 1))


def _placed(case, mesh):
    """The case's parameters placed on ``mesh`` by its profile's rules."""
    from repro_torch import convert
    from repro_torch.models import dit as dit_mod
    from repro_torch.models import lm
    from repro_torch.models.common import spec_tree
    from repro_torch.runtime import placement as plc
    from repro_torch.runtime import sharding as shd

    cfg = case["cfg"]
    if cfg.family == "dit":
        params = convert.params_from_numpy(case["params"], device="cpu")
        schema = dit_mod.dit_schema(cfg)
    else:
        params = convert.lm_params_from_numpy(case["params"], cfg, device="cpu")
        schema = lm.lm_schema(cfg)
    specs = spec_tree(schema, shd.rules_for(cfg, mesh, case["profile"]),
                      shd.axis_sizes(mesh))
    return plc.place_tree(params, shd.shard_tree(mesh, specs))


def _draws(d):
    return _torch(d or {})


def run_case(rank, case, mesh) -> Dict[str, Any]:
    """Gradients of step 1 (gathered), the whole steps (two unless the case
    says ``steps``; the gathered parameters after each, the collectives of
    the first counted when the case asks), the resident bytes, each
    planted fault."""
    from repro_torch.launch import roofline as rl
    from repro_torch.models.common import tree_map
    from repro_torch.optim import adamw
    from repro_torch.runtime import placement as plc

    step, params = _step(case), _placed(case, mesh)
    opt = adamw.init_opt_state(params)
    batch = _torch(case["batch"])
    draws = [_draws(d) for d in case["draws"]]
    out: Dict[str, Any] = {"bytes": (plc.resident_bytes(params),
                                     plc.resident_bytes({"m": opt["m"],
                                                         "v": opt["v"]}))}
    (loss, metrics), grads = step.grads(params, batch, **draws[0])
    full = _full(grads)
    out["loss"], out["metrics"] = float(loss), _metrics(metrics)
    # the steps write their trees in place: the faults below start from
    # copies of the first state, and step 1's state is kept as a copy
    copy = lambda tree: tree_map(torch.clone, tree)
    params0, opt0 = copy(params), copy(opt)
    p, o = params, opt
    out["steps"] = []
    for i in range(case.get("steps", 2)):
        ledger = rl.CollectiveLedger()
        counted = i == 0 and case.get("count_collectives")
        with ledger.record(send=True) if counted else contextlib.nullcontext():
            p, o, m = step.with_draws(p, o, batch, **draws[i])
        if counted:
            out["collectives"] = {
                k: {"count": v["count"], "operand_bytes": v["operand_bytes"]}
                for k, v in ledger.kinds.items() if v["count"]}
        out["steps"].append({"params": _full(p), "metrics": _metrics(m)})
        if i == 0:
            out["after1"] = (copy(p), copy(o))
    if out["steps"]:
        out["moments"] = _full({"m": o["m"], "v": o["v"]})
    for name in case.get("faults", ()):
        with planted(name):
            if name == "norm_local":
                _, _, m = step.with_draws(copy(params0), copy(opt0), batch,
                                          **draws[0])
                out[name] = float(m["grad_norm"])
            else:
                (_, fm), fg = step.grads(params0, batch, **draws[0])
                out[name] = {"metrics": _metrics(fm), "grads": _full(fg)}
    if rank != 0:
        out = {"bytes": out["bytes"], "after1": out.get("after1"),
               "collectives": out.get("collectives")}
    else:
        out["grads"] = full
    return out


@contextlib.contextmanager
def planted(name: str):
    """One planted fault of the sharded step, undone on exit:

    * ``norm_local``: ``global_norm`` over each rank's chunks only;
    * ``sp_sum``: the sequence-parallel gather's backward a sum over
      'model' (Megatron's rule, wrong for ranks holding equal copies);
    * ``lb_per_rank``: ``load_balance`` from each rank's own means, then
      averaged over the data axes;
    * ``unsummed``: each data rank's gradient left unsummed;
    * ``per_rank``: the distillation and MMD fine-tune losses over each
      rank's rows alone (a per-rank mean, a per-rank MMD statistic whose
      targets are the rank's rows reversed)."""
    import torch.distributed as dist
    from torch.distributed.tensor import Shard

    from repro_torch.core import distill, mmd
    from repro_torch.models import moe
    from repro_torch.runtime import placement as plc
    from repro_torch.runtime import sharding as shd

    def sp_sum(g, dim, group, rank, n):
        gt = g.movedim(dim, 0).contiguous()
        out = torch.empty((gt.shape[0] // n,) + tuple(gt.shape[1:]),
                          dtype=g.dtype, device=g.device)
        dist.reduce_scatter_tensor(out, gt, group=group)
        return out.movedim(0, dim)

    def lb_per_rank(me, ce, E):
        return shd.data_mean(E * torch.sum(me * ce))

    def unsummed(g, p, group, n):
        if isinstance(p, Shard):
            r = dist.get_rank(group)
            c = g.shape[p.dim] // n
            return g.narrow(p.dim, r * c, c)
        return g

    same = lambda x: x
    swaps = {
        "norm_local": [(plc, "sum_over_shards", lambda values, leaves: values)],
        "sp_sum": [(shd, "_gather_grad", sp_sum)],
        "lb_per_rank": [(moe, "_load_balance", lb_per_rank)],
        "unsummed": [(plc, "_reduce_data", unsummed)],
        "per_rank": [(distill, "data_mean", same), (mmd, "data_mean", same),
                     (mmd, "data_gather", same), (mmd, "current_mesh",
                                                  lambda: None)]}[name]
    sound = [(mod, attr, getattr(mod, attr)) for mod, attr, _ in swaps]
    for mod, attr, fn in swaps:
        setattr(mod, attr, fn)
    try:
        yield
    finally:
        for mod, attr, fn in sound:
            setattr(mod, attr, fn)


def train_group(rank: int, device: torch.device, job: Dict[str, Any]) -> dict:
    """Everything the test module asks of a (2 x 2) CPU group: the sharded
    cases, ``compressed_psum``, the elastic save and restore onto the
    (1 x 2) sub-mesh of ranks 0-1 (and a step there), and a checkpoint
    written by the JAX package restored onto the (2 x 2) mesh."""
    from repro_torch.checkpoint.checkpointer import Checkpointer
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.optim.compression import compressed_psum
    from repro_torch.runtime import elastic

    mesh = make_debug_mesh(2, 2, device="cpu", backend="gloo")
    out: Dict[str, Any] = {"coord": tuple(mesh.get_coordinate())}
    for case in job["cases"]:
        out[case["name"]] = run_case(rank, case, mesh)

    out["psum"] = {k: compressed_psum(torch.from_numpy(g[rank]).to(
        getattr(torch, k)), ("data", "model"), mesh).float().numpy()
        for k, g in job["psum"].items()}

    # elastic: the DiT after step 1 saved on (2 x 2), restored on (1 x 2)
    case = next(c for c in job["cases"] if c["name"] == job["elastic_case"])
    p1, o1 = out[case["name"]].pop("after1")
    ck = Checkpointer(job["ckpt_dir"], async_save=True, device="cpu")
    ck.save(1, {"params": p1, "opt": o1}, extra={"mesh": "2x2"})
    ck.wait()
    sub = elastic.make_elastic_mesh(2, model_parallel=2, device="cpu")
    if sub.get_coordinate() is not None:
        state, extra = elastic.elastic_restore(ck, case["cfg"], sub,
                                               profile=case["profile"],
                                               device="cpu")
        chunks = _chunks(state["params"])   # before the step writes them
        p2, _, _ = _step(case).with_draws(state["params"], state["opt"],
                                   _torch(case["batch"]),
                                   **_draws(case["draws"][1]))
        step2 = _full(p2)                 # a collective: both ranks gather
        out["elastic"] = {"chunks": chunks, "extra": extra,
                          "sub": tuple(sub.mesh.shape),
                          "step2": step2 if rank == 0 else None}
    else:
        with _refused(ValueError):
            elastic.elastic_restore(ck, case["cfg"], sub,
                                    profile=case["profile"], device="cpu")
        out["elastic"] = None

    # a checkpoint the JAX package wrote, placed on (2 x 2)
    jck = Checkpointer(job["jax_ckpt_dir"], device="cpu")
    state, _ = elastic.elastic_restore(jck, case["cfg"], mesh,
                                       profile=case["profile"], device="cpu")
    out["from_jax"] = _chunks(state["params"])
    for c in job["cases"]:
        out[c["name"]].pop("after1", None)
    return out


@contextlib.contextmanager
def _refused(exc):
    """A rank outside the sub-mesh must be refused."""
    try:
        yield
    except exc:
        return
    raise AssertionError(f"expected {exc.__name__}")


def inplace_group(rank: int, device: torch.device, job: Dict[str, Any]) -> dict:
    """The placed train step's in-place contract on a (2 x 1) CPU group:
    two steps of the DiT case through ``with_draws`` and ``__call__``; the
    trees come back as the caller's objects, each rank's chunks written
    where they lie, no graph captured; the gathered moments and the
    metrics after the steps (rank 0's)."""
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models.common import tree_leaves
    from repro_torch.optim import adamw
    from repro_torch.runtime import placement as plc

    mesh = make_debug_mesh(2, 1, device="cpu", backend="gloo")
    case = job["case"]
    step, params = _step(case), _placed(case, mesh)
    opt = adamw.init_opt_state(params)
    before = [plc.local(x).clone() for x in tree_leaves(params)]
    ptrs = [plc.local(x).data_ptr() for x in tree_leaves({"p": params, "o": opt})]
    batch = _torch(case["batch"])
    p, o, m1 = step.with_draws(params, opt, batch, **_draws(case["draws"][0]))
    same = p is params and o is opt
    gen = torch.Generator().manual_seed(job["seed"])
    p, o, m2 = step(params, opt, batch, gen)
    same = same and p is params and o is opt
    moved = sum(not torch.equal(plc.local(x), b)
                for x, b in zip(tree_leaves(params), before))
    out = {"same_objects": same, "step": int(opt["step"]), "moved": moved,
           "in_place": ptrs == [plc.local(x).data_ptr()
                                for x in tree_leaves({"p": params, "o": opt})],
           "captures": step.captures, "placed": plc.placed_mesh(params) is not None,
           "moments": _full({"m": opt["m"], "v": opt["v"]}),
           "metrics": [_metrics(m1), _metrics(m2)]}
    return out if rank == 0 else {k: out[k] for k in ("same_objects", "in_place")}
