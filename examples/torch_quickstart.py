"""Quickstart on the PyTorch port: the full FlexiDiT story in one script.
The counterpart of ``examples/quickstart.py``.

1. pre-train a small class-conditional DiT on synthetic latents;
2. flexify it to also understand patch size 4 (§3.1, shared params);
3. fine-tune alternating patch sizes;
4. sample with the weak→powerful inference scheduler and compare quality
   and FLOPs against the all-powerful baseline.

Run:  PYTHONPATH=src python examples/torch_quickstart.py [--steps 400]
      (on CUDA; ``--device cpu`` runs it on the CPU)

The FID proxy is a numpy copy of ``benchmarks/common.py``'s (a fixed
random-projection feature space; trends, not absolute values), kept here
because that module imports JAX.
"""
import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.configs.base import (AttnConfig, DiTConfig,  # noqa: E402
                                      ModelConfig, TrainConfig)
from repro_torch.convert import tree_to_numpy  # noqa: E402
from repro_torch.core import FlexiSchedule, flexify  # noqa: E402
from repro_torch.data import pipeline as dp  # noqa: E402
from repro_torch.device import resolve_device  # noqa: E402
from repro_torch.diffusion import schedule as sch  # noqa: E402
from repro_torch.launch import steps as st  # noqa: E402
from repro_torch.models import dit as dit_mod  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.pipeline import FlexiPipeline, SamplingPlan  # noqa: E402

LATENT = (1, 16, 16, 4)
N_CLASSES = 8


# ---------------------------------------------------------------------------
# FID proxy (numpy; the same functions as benchmarks/common.py)


def features(x: np.ndarray, dim: int = 64) -> np.ndarray:
    """Fixed random-projection + nonlinearity feature map for FID-proxy."""
    flat = np.asarray(x, np.float32).reshape(x.shape[0], -1)
    rng = np.random.default_rng(42)
    W = rng.normal(size=(flat.shape[1], dim)).astype(np.float32) \
        / np.sqrt(flat.shape[1])
    h = flat @ W
    return np.concatenate([np.tanh(h), h], axis=1)


def frechet(a: np.ndarray, b: np.ndarray) -> float:
    """Fréchet distance between feature Gaussians (FID form, real sqrtm via
    eigendecomposition of the product)."""
    mu1, mu2 = a.mean(0), b.mean(0)
    c1 = np.cov(a, rowvar=False) + 1e-6 * np.eye(a.shape[1])
    c2 = np.cov(b, rowvar=False) + 1e-6 * np.eye(b.shape[1])
    diff = ((mu1 - mu2) ** 2).sum()
    s1_vals, s1_vecs = np.linalg.eigh(c1)
    s1_sqrt = (s1_vecs * np.sqrt(np.maximum(s1_vals, 0))) @ s1_vecs.T
    inner = s1_sqrt @ c2 @ s1_sqrt
    vals = np.linalg.eigvalsh(inner)
    tr_sqrt = np.sqrt(np.maximum(vals, 0)).sum()
    return float(diff + np.trace(c1) + np.trace(c2) - 2 * tr_sqrt)


def fid_proxy(samples: np.ndarray, reference: np.ndarray) -> float:
    return frechet(features(samples), features(reference))


def reference_set(n: int = 128, latent=LATENT):
    """The class-conditional reference latents and their labels."""
    b = dp.make_dit_batch_fn(latent, N_CLASSES, n, 0.15)(
        0, 0, 1, np.random.default_rng(555))
    return b["x0"], b["cond"]


# ---------------------------------------------------------------------------


def to_device(b: dict, device: torch.device) -> dict:
    return {k: torch.from_numpy(b[k]).to(device) for k in ("x0", "cond")}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=400)
    ap.add_argument("--sample-T", type=int, default=20)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' runs on the CPU)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = ModelConfig(
        name="quickstart-dit", family="dit", num_layers=3, d_model=96,
        d_ff=384, vocab_size=0, attn=AttnConfig(6, 6, 16, use_rope=False),
        dit=DiTConfig(latent_shape=LATENT, patch_size=(1, 2, 2),
                      conditioning="class", num_classes=N_CLASSES,
                      learn_sigma=False, underlying_patch_size=(1, 2, 2)),
        mlp_activation="gelu", norm_type="layernorm",
        param_dtype="float32", compute_dtype="float32", remat="none")
    sched = sch.linear_schedule(100)
    tc = TrainConfig(learning_rate=2e-3, warmup_steps=20,
                     total_steps=args.steps)
    make_batch = dp.make_dit_batch_fn(LATENT, N_CLASSES, 32, 0.15)
    gen = torch.Generator(device=device).manual_seed(1)
    losses = []

    # 1) pre-train (powerful patch size only)
    print("== pre-training DiT (patch 2) ==")
    params = dit_mod.init_dit(cfg, torch.Generator(device=device).manual_seed(0))
    opt = adamw.init_opt_state(params)
    pre = st.make_dit_train_step(cfg, tc, sched)
    half = args.steps // 2
    for i in range(half):
        batch = to_device(make_batch(i, 0, 1, np.random.default_rng(i)), device)
        params, opt, m = pre(params, opt, batch, gen)
        if i % 50 == 0:
            losses.append(float(m["loss"]))
            print(f"  step {i:4d} loss {losses[-1]:.4f}")

    # 2) flexify (adds patch size 4 with PI-resize init — §3.1)
    print("== flexifying to patch sizes {2, 4} ==")
    fparams, fcfg = flexify(params, cfg, [(1, 4, 4)])
    del pre, params, opt

    # 3) fine-tune, alternating patch sizes (<< pre-training compute)
    opt = adamw.init_opt_state(fparams)
    mode_steps = [st.make_dit_train_step(fcfg, tc, sched, mode=m)
                  for m in (0, 1)]
    for i in range(half, args.steps):
        batch = to_device(make_batch(i, 0, 1, np.random.default_rng(i)), device)
        fparams, opt, m = mode_steps[i % 2](fparams, opt, batch, gen)
        if i % 50 == 0:
            losses.append(float(m["loss"]))
            print(f"  step {i:4d} loss {losses[-1]:.4f} (mode {i % 2})")
    del mode_steps, opt

    # 4) sample: all-powerful vs weak→powerful scheduler, through the
    #    unified pipeline API (one runner per schedule, reused on repeats)
    ref, _ = reference_set(128)
    pipe = FlexiPipeline(fparams, fcfg, sched, device=device)
    T = args.sample_T
    n = 48
    x_T = torch.randn((n,) + LATENT, device=device,
                      generator=torch.Generator(device=device).manual_seed(42))
    rows = []
    print("== sampling ==")
    for T_weak in (0, T // 2, 3 * T // 4):
        plan = SamplingPlan(T=T, budget=FlexiSchedule.weak_first(T, T_weak),
                            guidance_scale=1.5)
        res = pipe.sample(plan, n, None, x_T=x_T)
        x0 = res.x0.cpu().numpy()
        fid = fid_proxy(x0, ref)
        rows.append({"budget": plan.budget, "T_weak": T_weak,
                     "phases": res.trace["schedule"].phases,
                     "relative_compute": res.relative_compute,
                     "flops": res.flops, "fid": fid, "x0": x0})
        print(f"  T_weak={T_weak:2d}/{T}  "
              f"compute={res.relative_compute*100:5.1f}%  "
              f"FID-proxy={fid:.3f}")
    # fraction budgets solve to the cheapest weak-first schedule themselves
    plan = SamplingPlan(T=T, budget=0.6, guidance_scale=1.5)
    res = pipe.sample(plan, n, None, x_T=x_T)
    fs = res.trace["schedule"]
    x0 = res.x0.cpu().numpy()
    fid = fid_proxy(x0, ref)
    rows.append({"budget": 0.6, "T_weak": fs.phases[0][1], "phases": fs.phases,
                 "relative_compute": res.relative_compute, "flops": res.flops,
                 "fid": fid, "x0": x0})
    print(f"  budget=0.60 → T_weak={fs.phases[0][1]}/{T}  "
          f"compute={res.relative_compute*100:5.1f}%  "
          f"FID-proxy={fid:.3f}")
    print("done — weak early steps save >40% FLOPs at comparable quality.")
    return {"cfg": fcfg, "params": tree_to_numpy(fparams),
            "x_T": x_T.cpu().numpy(), "reference": ref, "T": T,
            "losses": losses, "rows": rows, "stats": pipe.cache_stats()}


if __name__ == "__main__":
    main()
