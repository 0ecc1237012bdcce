"""Which collectives Gloo takes on CUDA tensors, for ranks that share one
card, and how a DTensor's placement and a sub-mesh behave there.

    PYTHONPATH=src python3 tools/gloo_probe.py [--device cpu]

Starts 4 ranks (``launch.mesh.run_ranks``, backend ``gloo``) and, in each,
tries every collective the sharded training step could use on float32,
bfloat16 and int32 tensors: ``all_reduce`` (SUM, MAX), ``all_gather``
(list), ``all_gather_into_tensor``, ``reduce_scatter_tensor``,
``all_to_all_single``; then ``DTensor.from_local`` / ``to_local`` on a
(2 x 2) ``DeviceMesh`` and a (1 x 2) mesh over ranks 0-1 built by every
rank. Prints one line per probe: ``ok`` with the result checked against
the arithmetic, or the exception's first line. Exits 0 whatever the
probes say: it reports, it does not gate.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))


def _try(fn):
    try:
        return "ok" if fn() else "WRONG"
    except Exception as e:          # a probe reports what it saw
        return f"{type(e).__name__}: {str(e).splitlines()[0][:160]}"


def probe_rank(rank: int, device: torch.device) -> dict:
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh, init_device_mesh
    from torch.distributed.tensor import DTensor, Shard

    W = dist.get_world_size()
    out = {}
    for dt in (torch.float32, torch.bfloat16, torch.int32):
        name = str(dt).replace("torch.", "")
        x = torch.full((8,), rank + 1, dtype=dt, device=device)

        def ar_sum():
            y = x.clone()
            dist.all_reduce(y)
            return bool((y == sum(range(1, W + 1))).all())

        def ar_max():
            y = x.clone()
            dist.all_reduce(y, op=dist.ReduceOp.MAX)
            return bool((y == W).all())

        def ag_list():
            ys = [torch.empty_like(x) for _ in range(W)]
            dist.all_gather(ys, x)
            return all(bool((y == r + 1).all()) for r, y in enumerate(ys))

        def ag_tensor():
            y = torch.empty((W * 8,), dtype=dt, device=device)
            dist.all_gather_into_tensor(y, x)
            return bool((y.view(W, 8)[:, 0].cpu()
                         == torch.arange(1, W + 1).to(dt)).all())

        def rs_tensor():
            y = torch.empty((2,), dtype=dt, device=device)
            dist.reduce_scatter_tensor(y, x)
            return bool((y == sum(range(1, W + 1))).all())

        def a2a():
            y = torch.empty_like(x)
            dist.all_to_all_single(y, x)
            return bool((y.view(W, 2)[:, 0].cpu()
                         == torch.arange(1, W + 1).to(dt)).all())

        for pname, fn in (("all_reduce_sum", ar_sum), ("all_reduce_max", ar_max),
                          ("all_gather", ag_list),
                          ("all_gather_into_tensor", ag_tensor),
                          ("reduce_scatter_tensor", rs_tensor),
                          ("all_to_all_single", a2a)):
            out[f"{pname}[{name}]"] = _try(fn)
            dist.barrier()

    mesh = init_device_mesh(device.type, (2, 2), mesh_dim_names=("data", "model"))

    def dtensor():
        local = torch.full((2, 3), float(rank), device=device)
        d = DTensor.from_local(local, mesh, [Shard(0), Shard(1)], run_check=False)
        return tuple(d.shape) == (4, 6) and bool((d.to_local() == rank).all())

    def group_gather():
        g = mesh.get_group("model")
        x = torch.full((2,), float(rank), device=device)
        ys = [torch.empty_like(x) for _ in range(2)]
        dist.all_gather(ys, x, group=g)
        base = 2 * (rank // 2)
        return [float(y[0]) for y in ys] == [base, base + 1]

    out["dtensor_from_local"] = _try(dtensor)
    out["submesh_group_all_gather"] = _try(group_gather)

    def sub_mesh():
        sub = DeviceMesh(device.type, torch.arange(2).reshape(1, 2),
                         mesh_dim_names=("data", "model"))
        coord = sub.get_coordinate()
        if rank >= 2:
            return coord is None
        x = torch.full((1,), float(rank), device=device)
        dist.all_reduce(x, group=sub.get_group("model"))
        return tuple(coord) == (0, rank) and float(x) == 1.0

    out["elastic_submesh(1x2 over ranks 0-1)"] = _try(sub_mesh)
    dist.barrier()
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    from repro_torch.launch.mesh import run_ranks

    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, device "
          f"{args.device}", flush=True)
    res = run_ranks(probe_rank, 4, backend="gloo", device=args.device,
                    timeout_s=300, threads=1)
    for key in res[0]:
        print(f"{key}: {[r[key] for r in res]}")
    print(json.dumps(res[0]))


if __name__ == "__main__":
    main()
