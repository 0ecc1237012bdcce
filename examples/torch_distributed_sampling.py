"""Sequence-parallel FlexiDiT sampling in the PyTorch port: the counterpart
of ``examples/distributed_sampling.py``.

Starts DATA x SEQ rank processes (``repro_torch.launch.mesh.run_ranks``),
builds a (data, seq) mesh in each, and samples the same plan single-device
and sequence-parallel (the batch split over 'data', the tokens over 'seq'),
printing ``max|Δ|`` and each phase's shards:

  PYTHONPATH=src python examples/torch_distributed_sampling.py --device cpu
  PYTHONPATH=src python examples/torch_distributed_sampling.py --backend gloo  # 4 ranks, 1 card
  PYTHONPATH=src python examples/torch_distributed_sampling.py                 # 4 ranks, 4 cards

The ranks run on CUDA unless ``--device cpu``; rank r takes card r. The
backend follows ``launch/mesh.py``'s rule: Gloo on the CPU, NCCL when
every rank has its own card, and ranks that share a card must ask for
Gloo (NCCL refuses them; without ``--backend gloo`` the run raises). The
weak phase (patch 4, 16 tokens) and the powerful one (patch 2, 64 tokens)
shard differently, and a budget switch on the fixed mesh builds no
runner.
"""
import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import torch  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.device import resolve_device  # noqa: E402
from repro_torch.diffusion import schedule as sch  # noqa: E402
from repro_torch.distributed import ParallelSpec, plan_partition  # noqa: E402
from repro_torch.launch.mesh import make_inference_mesh, run_ranks  # noqa: E402
from repro_torch.models import dit as dit_mod  # noqa: E402
from repro_torch.pipeline import FlexiPipeline, SamplingPlan  # noqa: E402

N = 4
TOL = 1e-4


def trained_like(cfg, device):
    """Random weights with the zero-initialised de-embedding and adaLN
    gates made non-zero, so the sample depends on every block."""
    gen = torch.Generator(device=device).manual_seed(0)
    params = dit_mod.init_dit(cfg, gen)
    for node, key, scale in [(params["deembed"], "w_flex", 0.1),
                             (params["final"]["ada"], "w", 0.05),
                             (params["blocks"]["ada"], "w", 0.05)]:
        node[key] = torch.randn(node[key].shape, generator=gen,
                                device=device) * scale
    return params


def rank_main(rank, device, data, seq):
    torch.set_num_threads(1)
    cfg = get_config("dit-xl-2").reduced()
    params = trained_like(cfg, device)
    sched = sch.linear_schedule(100)
    mesh = make_inference_mesh(data, seq, device=device)
    single = FlexiPipeline(params, cfg, sched, device=device)
    multi = FlexiPipeline(params, cfg, sched, device=device, mesh=mesh)
    lines = [f"mesh: {dict(zip(mesh.mesh_dim_names, mesh.shape))} on {device}"]
    for budget in (0.6, 1.0):
        plan = SamplingPlan(T=8, budget=budget, guidance_scale=1.5,
                            parallel=ParallelSpec())    # auto: ulysses
        part = plan_partition(cfg, plan.resolve_schedule(cfg), seq,
                              plan.parallel)
        gen = lambda: torch.Generator(device=device).manual_seed(42)  # noqa: E731
        r_sp = multi.sample(plan, N, gen())
        r_1d = single.sample(SamplingPlan(T=8, budget=budget,
                                          guidance_scale=1.5), N, gen())
        diff = (r_sp.x0 - r_1d.x0).abs().max().item()
        shards = " ".join(f"mode{p.mode}:{p.tokens}tok/{p.sp}shards"
                          f"(+{p.pad}pad)" for p, n in part.phases if n)
        lines.append(f"budget={budget}: rel_compute={r_sp.relative_compute:.3f}"
                     f" max|sp - single|={diff:.2e}")
        lines.append(f"  shards: {shards} impl={part.phases[0][0].impl} "
                     f"collectives={part.collective_bytes(cfg) / 1e6:.1f} "
                     f"MB/sample")
        assert diff < TOL, diff
    stats = multi.cache_stats()
    lines.append(f"cache: runners={stats['runners']} compiled="
                 f"{stats['compiled']} (one per budget)")
    return lines


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--data", type=int, default=2)
    ap.add_argument("--seq", type=int, default=2)
    ap.add_argument("--device", default=None,
                    help="device of the ranks (default: cuda; 'cpu' runs "
                         "them on the CPU)")
    ap.add_argument("--backend", default=None, choices=["gloo", "nccl"],
                    help="default: gloo on the CPU, nccl when every rank "
                         "has its own card; ranks sharing a card need gloo")
    args = ap.parse_args()
    device = resolve_device(args.device)
    out = run_ranks(rank_main, args.data * args.seq, backend=args.backend,
                    device=device.type, timeout_s=600,
                    args=(args.data, args.seq))
    for line in out[0]:
        print(line)


if __name__ == "__main__":
    main()
