"""Elastic scaling — the port of ``repro.runtime.elastic``: replan the
mesh for a changed device count and restore the latest checkpoint onto it
(the checkpointer loads each leaf to the host and places this rank's
chunk on the new mesh).

JAX builds a sub-mesh from one controller; here every rank of the world
runs the same program, and every rank must join the sub-mesh's group
creation (:func:`make_elastic_mesh`), those outside it too. A rank
outside the mesh holds no chunk: :func:`elastic_restore` raises there.
"""
from __future__ import annotations

from typing import Any, Optional, Tuple

import torch
import torch.distributed as dist


def plan_mesh_shape(n_devices: int, model_parallel: int = 0
                    ) -> Tuple[int, int]:
    """(data, model) factors for an arbitrary surviving device count.

    Keeps model-parallel width if it still divides; otherwise the largest
    power-of-two divisor ≤ the previous width.
    """
    if model_parallel <= 0:
        model_parallel = 1
    while model_parallel > 1 and n_devices % model_parallel != 0:
        model_parallel //= 2
    return n_devices // model_parallel, model_parallel


def make_elastic_mesh(n_devices: Optional[int] = None,
                      model_parallel: int = 1, *, device: Any = None):
    """A ``("data", "model")`` ``DeviceMesh`` of ``plan_mesh_shape``'s
    factors over the first ``data * model`` ranks of the world (the
    reference takes ``devs[:data * model]``). Every rank must call it.
    ``device``: the ranks' device type (CUDA unless 'cpu')."""
    from torch.distributed.device_mesh import DeviceMesh

    if not dist.is_initialized():
        raise RuntimeError("make_elastic_mesh runs inside a rank: start the "
                           "ranks with launch.mesh.run_ranks")
    n = n_devices if n_devices is not None else dist.get_world_size()
    data, model = plan_mesh_shape(n, model_parallel)
    if data * model > dist.get_world_size():
        raise ValueError(f"a {data}x{model} mesh needs {data * model} ranks, "
                         f"the world has {dist.get_world_size()}")
    dev_type = torch.device("cuda" if device is None else device).type
    return DeviceMesh(dev_type, torch.arange(data * model).reshape(data, model),
                      mesh_dim_names=("data", "model"))


def elastic_restore(checkpointer, cfg, mesh, profile: str = "auto",
                    step: Optional[int] = None, device: Any = None):
    """Restore a checkpoint onto a (possibly different) mesh: the state's
    ``params`` placed by ``rules_for(cfg, mesh, profile)`` over the
    model's schema, and the AdamW moments ``opt.m`` / ``opt.v`` by the
    same specs (ZeRO state inherits the weights' specs; the reference's
    jitted step reshards them on entry), every other leaf as
    ``Checkpointer.restore`` gives it. Raises on a rank outside ``mesh``.

    The restored trees are new tensors: a train step handed them writes
    them in place (a placed step runs eagerly; a single-device one drops
    the graphs of the trees it held and captures on these), so take a
    copy first where the restored values are needed after the step."""
    from repro_torch.models import dit as dit_mod
    from repro_torch.models import lm
    from repro_torch.models.common import spec_tree
    from repro_torch.runtime import sharding as shd

    if mesh.get_coordinate() is None:
        raise ValueError(f"rank {dist.get_rank()} is not in the mesh "
                         f"{mesh.mesh.tolist()}: it holds no chunk to restore")
    rules = shd.rules_for(cfg, mesh, profile)
    schema = (dit_mod.dit_schema(cfg) if cfg.family == "dit"
              else lm.lm_schema(cfg))
    specs = spec_tree(schema, rules, shd.axis_sizes(mesh))
    sh = shd.shard_tree(mesh, specs)
    return checkpointer.restore(
        step, shardings={"params": sh, "opt": {"m": sh, "v": sh}},
        device=device)
