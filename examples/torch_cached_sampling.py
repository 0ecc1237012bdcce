"""Cross-step activation cache on the PyTorch port: the FLOPs/quality dial
in one script. The counterpart of ``examples/cached_sampling.py``.

Samples a single request repeatedly under the same plan while sweeping
the cache refresh interval k (plus the analytic error-proxy policy) and
prints the trade-off table: analytic FLOPs vs the uncached run, realized
refresh rate, and x0 drift. interval=1 is bit-identical to no cache;
larger k trades drift for deep-block FLOPs. Every cached run replays ONE
runner — the refresh mask is data, not structure (on CUDA its NFEs are
captured once per refresh branch).

Run:  PYTHONPATH=src python examples/torch_cached_sampling.py [--T 20]
      (on CUDA; ``--device cpu`` runs it on the CPU)
"""
import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import torch  # noqa: E402

from repro_torch.cache import CacheSpec, cache_savings  # noqa: E402
from repro_torch.configs.base import (AttnConfig, DiTConfig,  # noqa: E402
                                      ModelConfig)
from repro_torch.convert import tree_to_numpy  # noqa: E402
from repro_torch.core import flexify  # noqa: E402
from repro_torch.core.scheduler import FlexiSchedule  # noqa: E402
from repro_torch.device import resolve_device  # noqa: E402
from repro_torch.diffusion import schedule as sch  # noqa: E402
from repro_torch.models import dit as dit_mod  # noqa: E402
from repro_torch.pipeline import FlexiPipeline, SamplingPlan  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--T", type=int, default=20)
    ap.add_argument("--train-T", type=int, default=1000)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' runs on the CPU)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = ModelConfig(
        name="cached-dit", family="dit", num_layers=4, d_model=96,
        d_ff=384, vocab_size=0, attn=AttnConfig(6, 6, 16, use_rope=False),
        dit=DiTConfig(latent_shape=(1, 16, 16, 4), patch_size=(1, 2, 2),
                      flex_patch_sizes=(), underlying_patch_size=(1, 2, 2),
                      conditioning="class", num_classes=10),
        mlp_activation="gelu", norm_type="layernorm",
        param_dtype="float32", compute_dtype="float32", remat="none",
        max_seq_len=256)
    gen = torch.Generator(device=device).manual_seed(0)
    params = dit_mod.init_dit(cfg, gen)
    # break the zero-init de-embed / adaLN gates (as training would):
    # fresh DiT weights output exact zeros, which would make every
    # policy look drift-free
    for path, scale in ((("deembed", "w_flex"), 0.1),
                        (("final", "ada", "w"), 0.05),
                        (("blocks", "ada", "w"), 0.05)):
        node = params
        for p in path[:-1]:
            node = node[p]
        node[path[-1]] = torch.randn(node[path[-1]].shape, generator=gen,
                                     device=device) * scale
    # flexify so the plan composes weak-mode token reduction WITH the
    # cache: the weak phase gets cheaper still, the powerful phase gains
    # the deep-block knob
    params, cfg = flexify(params, cfg, [(1, 4, 4)], generator=gen)
    pipe = FlexiPipeline(params, cfg, sch.linear_schedule(args.train_T),
                         device=device)

    budget = FlexiSchedule.weak_first(args.T, args.T // 2)
    x_T = torch.randn((1,) + tuple(cfg.dit.latent_shape), device=device,
                      generator=torch.Generator(device=device).manual_seed(42))
    cond = torch.tensor([7], dtype=torch.int32, device=device)
    ts = sch.respaced_timesteps(args.train_T, args.T)

    base = SamplingPlan(T=args.T, budget=budget, guidance_scale=1.5)
    ref = pipe.sample(base, 1, None, cond=cond, x_T=x_T)
    ref_pow = float(torch.mean(ref.x0 ** 2))
    split = CacheSpec().resolve_split(cfg.num_layers)
    print(f"model: {cfg.num_layers} blocks, split={split} shallow | "
          f"T={args.T} steps, uncached {ref.flops / 1e9:.2f} GFLOPs")
    print(f"{'policy':>14} {'rel FLOPs':>10} {'refresh':>8} "
          f"{'x0 rel-MSE':>12}")

    specs = [("no cache", None)]
    specs += [(f"interval k={k}",
               CacheSpec(policy="interval", interval=k))
              for k in (1, 2, 3, 4)]
    specs.append(("proxy (default)", CacheSpec(policy="proxy")))
    rows = []
    for name, spec in specs:
        plan = SamplingPlan(T=args.T, budget=budget, guidance_scale=1.5,
                            cache=spec)
        res = pipe.sample(plan, 1, None, cond=cond, x_T=x_T)
        drift = float(torch.mean((res.x0 - ref.x0) ** 2)) / ref_pow
        if spec is None:
            rel, rate = 1.0, 1.0
        else:
            led = cache_savings(cfg, budget, ts, spec)
            rel, rate = 1.0 - led["flops_saved_frac"], led["refresh_rate"]
        tag = "  (bit-identical)" if drift == 0.0 and spec is not None \
            else ""
        print(f"{name:>14} {rel:>10.3f} {rate:>8.2f} {drift:>12.2e}{tag}")
        rows.append({"name": name, "spec": spec, "rel_flops": rel,
                     "refresh_rate": rate, "drift": drift,
                     "flops": res.flops, "x0": res.x0.cpu().numpy(),
                     "stats": pipe.cache_stats()})

    stats = pipe.cache_stats()
    print(f"compiled runners: {stats['compiled']} (1 uncached + 1 cached — "
          f"policy sweeps reuse the cached one)")
    return {"cfg": cfg, "params": tree_to_numpy(pipe.params),
            "x_T": x_T.cpu().numpy(), "cond": cond.cpu().numpy(),
            "budget": budget, "T": args.T, "train_T": args.train_T,
            "ref_x0": ref.x0.cpu().numpy(), "rows": rows, "stats": stats}


if __name__ == "__main__":
    main()
