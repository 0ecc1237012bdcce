"""LoRA-recipe flexification of a text-conditioned DiT (§3.2) on the
PyTorch port — the workflow for models whose pre-training data is
unavailable. The counterpart of ``examples/flexify_lora_t2i.py``.

1. "pre-trained" T2I DiT (cross-attention conditioning);
2. flexify with per-patch-size LoRAs — the pre-trained forward pass stays
   bit-exact at patch 2;
3. distill the powerful model's predictions into the weak mode (frozen base,
   frozen cross-attention — App. C.2);
4. compare merged vs unmerged LoRA inference (Fig. 5).

Run:  PYTHONPATH=src python examples/torch_flexify_lora_t2i.py
      (on CUDA; ``--device cpu`` runs it on the CPU; ``--pretrain-steps``
      and ``--distill-steps`` shorten the two training runs)
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
from repro_torch.core import (FlexiSchedule, flexify, merge_lora,  # noqa: E402
                              trainable_mask)
from repro_torch.core.distill import make_distill_step  # noqa: E402
from repro_torch.core.scheduler import (dit_nfe_flops,  # noqa: E402
                                        lora_nfe_overhead)
from repro_torch.data import pipeline as dp  # noqa: E402
from repro_torch.device import resolve_device  # noqa: E402
from repro_torch.diffusion import schedule as sch  # noqa: E402
from repro_torch.launch import steps as st  # noqa: E402
from repro_torch.models import dit as dit_mod  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.pipeline import FlexiPipeline, SamplingPlan  # noqa: E402

LATENT = (1, 16, 16, 4)


def to_device(b: dict, device: torch.device) -> dict:
    return {k: torch.from_numpy(b[k]).to(device) for k in ("x0", "cond")}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--pretrain-steps", type=int, default=200)
    ap.add_argument("--distill-steps", type=int, default=150)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' runs on the CPU)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = ModelConfig(
        name="t2i-example", family="dit", num_layers=3, d_model=96, d_ff=384,
        vocab_size=0, attn=AttnConfig(6, 6, 16, use_rope=False),
        dit=DiTConfig(latent_shape=LATENT, patch_size=(1, 2, 2),
                      conditioning="text", text_len=8, text_dim=96,
                      learn_sigma=False, underlying_patch_size=(1, 2, 2)),
        mlp_activation="gelu", norm_type="layernorm",
        param_dtype="float32", compute_dtype="float32", remat="none")
    sched = sch.linear_schedule(100)
    make_batch = dp.make_text_cond_batch_fn(LATENT, 8, 96, 32)
    gen = torch.Generator(device=device).manual_seed(1)

    # 1) "pre-trained" model (trained briefly here; in practice: loaded)
    print("== pre-training T2I DiT ==")
    tc = TrainConfig(learning_rate=2e-3, warmup_steps=10,
                     total_steps=args.pretrain_steps)
    params = dit_mod.init_dit(cfg, torch.Generator(device=device).manual_seed(0))
    opt = adamw.init_opt_state(params)
    pre = st.make_dit_train_step(cfg, tc, sched)
    for i in range(args.pretrain_steps):
        batch = to_device(make_batch(i, 0, 1, np.random.default_rng(i)), device)
        params, opt, m = pre(params, opt, batch, gen)
    del pre, opt

    # 2) flexify with LoRAs
    print("== flexify (LoRA rank 8) ==")
    fparams, fcfg = flexify(params, cfg, [(1, 4, 4)], lora_rank=8,
                            generator=gen)
    b0 = make_batch(0, 0, 1, np.random.default_rng(0))
    x = torch.from_numpy(b0["x0"][:2]).to(device)
    t = torch.tensor([10.0, 50.0], device=device)
    cond = torch.from_numpy(b0["cond"][:2]).to(device)
    with torch.no_grad():
        base = dit_mod.dit_forward(params, x, t, cond, cfg)
        out0 = dit_mod.dit_forward(fparams, x, t, cond, fcfg, mode=0)
    mode0 = (out0 - base).abs().max().item()
    print(f"  mode-0 bit-exactness: max|Δ| = {mode0:.2e}")
    del params

    # 3) distillation (teacher = powerful, student = weak + LoRA)
    print("== distilling powerful → weak ==")
    mask = trainable_mask(fparams, "lora")
    start = tree_to_numpy(fparams)
    tc2 = TrainConfig(learning_rate=2e-3, warmup_steps=5,
                      total_steps=args.distill_steps)
    dstep = make_distill_step(fcfg, tc2, sched, mode_weak=1, trainable=mask)
    opt = adamw.init_opt_state(fparams)
    losses = []
    for i in range(args.distill_steps):
        batch = to_device(make_batch(i, 0, 1, np.random.default_rng(5000 + i)),
                          device)
        fparams, opt, m = dstep(fparams, opt, batch, gen)
        if i % 30 == 0:
            losses.append(float(m["distill_loss"]))
            print(f"  step {i:4d} distill loss {losses[-1]:.5f}")
    del dstep, opt

    # 4) merged vs unmerged inference (Fig. 5 trade-off)
    merged = merge_lora(fparams, fcfg, 1)
    with torch.no_grad():
        w_un = dit_mod.dit_forward(fparams, x, t, cond, fcfg, mode=1)
        w_me = dit_mod.dit_forward(merged, x, t, cond, fcfg, mode=1)
    fwd_delta = (w_un - w_me).abs().max().item()
    print(f"  merged vs unmerged max|Δ| = {fwd_delta:.2e}")
    f_base = dit_nfe_flops(fcfg, 1)
    f_lora = lora_nfe_overhead(fcfg, 1)
    overhead = 100 * f_lora / f_base
    print(f"  unmerged LoRA FLOPs overhead per NFE: "
          f"{overhead:.2f}% (paper: 'minimal')")

    # 5) end-to-end sampling through the pipeline: the plan's `lora` field
    #    picks the variant; merging is handled (and cached) internally
    print("== sampling merged vs unmerged (pipeline API) ==")
    pipe = FlexiPipeline(fparams, fcfg, sched, device=device)
    T = 12
    b = make_batch(0, 0, 1, np.random.default_rng(9))
    y = torch.from_numpy(b["cond"][:8]).to(device)
    plan_un = SamplingPlan(T=T, budget=FlexiSchedule.weak_first(T, 8),
                           guidance_scale=1.5, lora="unmerged")
    plan_me = SamplingPlan(T=T, budget=FlexiSchedule.weak_first(T, 8),
                           guidance_scale=1.5, lora="merged")
    x_T = torch.randn((8,) + LATENT, device=device,
                      generator=torch.Generator(device=device).manual_seed(17))
    r_un = pipe.sample(plan_un, 8, None, cond=y, x_T=x_T)
    r_me = pipe.sample(plan_me, 8, None, cond=y, x_T=x_T)
    sample_delta = (r_un.x0 - r_me.x0).abs().max().item()
    print(f"  sampled merged vs unmerged max|Δ| = {sample_delta:.2e}")
    print(f"  FLOPs: unmerged {r_un.flops:.3e} vs merged {r_me.flops:.3e} "
          f"(+{100 * (r_un.flops / r_me.flops - 1):.2f}%)")
    print("done.")
    return {"cfg": fcfg, "start": start, "params": tree_to_numpy(fparams),
            "mask": mask, "mode0_delta": mode0, "losses": losses,
            "forward": {"x": x.cpu().numpy(), "t": t.cpu().numpy(),
                        "cond": cond.cpu().numpy(),
                        "unmerged": w_un.cpu().numpy(),
                        "merged": w_me.cpu().numpy()},
            "forward_delta": fwd_delta, "overhead_pct": overhead,
            "x_T": x_T.cpu().numpy(), "cond": y.cpu().numpy(),
            "unmerged": {"x0": r_un.x0.cpu().numpy(), "flops": r_un.flops},
            "merged": {"x0": r_me.x0.cpu().numpy(), "flops": r_me.flops},
            "sample_delta": sample_delta, "T": T, "T_weak": 8}


if __name__ == "__main__":
    main()
