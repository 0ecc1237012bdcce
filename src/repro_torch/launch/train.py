"""Training entry point of the port: the DiT branch of
``repro.launch.train``.

  python -m repro_torch.launch.train --arch dit-xl-2 --smoke --steps 50 \
      --device cpu
  python -m repro_torch.launch.train --arch dit-xl-2 --smoke --steps 50 \
      --flexi --recipe shared      # FlexiDiT fine-tune, alternating modes
  python -m repro_torch.launch.train --arch dit-xl-2 --steps 4 --flexi \
      --recipe lora                # full width on the card

``--flexi`` flexifies a freshly initialized DiT to the weak patch size
(1, 4, 4) and alternates step functions for modes 0 and 1; ``--recipe
lora`` adds rank-8 LoRAs and freezes the base (§3.2). Parameters and the
AdamW state are checkpointed to ``--ckpt-dir`` every ``--ckpt-every``
steps and at the end, in the reference's layout. Runs on CUDA unless
``--device cpu``. A language-model ``--arch`` comes with the
language-model slice of the port.
"""
from __future__ import annotations

import argparse
import tempfile
import time
from pathlib import Path
from typing import Any, Dict, Optional, Sequence

import torch

from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.configs import get_config
from repro_torch.configs.base import TrainConfig
from repro_torch.data import pipeline as dp
from repro_torch.device import resolve_device
from repro_torch.launch import steps as st
from repro_torch.models import dit as dit_mod
from repro_torch.optim import adamw, ema
from repro_torch.runtime.fault_tolerance import HeartbeatMonitor
from repro_torch.runtime.straggler import StragglerDetector


def build_dit_training(cfg, tc, batch, device, mode=0, trainable=None):
    params = dit_mod.init_dit(
        cfg, torch.Generator(device=device).manual_seed(tc.seed))
    opt = adamw.init_opt_state(params)
    step_fn = st.make_dit_train_step(cfg, tc, mode=mode, trainable=trainable)
    loader = dp.HostShardedLoader(
        dp.make_dit_batch_fn(cfg.dit.latent_shape, cfg.dit.num_classes,
                             batch), seed=tc.seed)
    return params, opt, step_fn, loader


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, Any]:
    """Train; returns the final ``params``, ``opt``, ``ema``, ``cfg``, the
    logged ``losses`` and the checkpoint directory ``ckpt_root``."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="dit-xl-2")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced same-family config (CPU-runnable)")
    ap.add_argument("--flexi", action="store_true",
                    help="FlexiDiT fine-tune: alternate patch modes")
    ap.add_argument("--recipe", default="shared", choices=["shared", "lora"])
    ap.add_argument("--ckpt-dir", default=None,
                    help="checkpoint root (default: repro_torch_ckpt in the "
                         "temporary directory)")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' runs on the "
                         "CPU)")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.smoke:
        cfg = cfg.reduced()
    if cfg.family != "dit":
        raise NotImplementedError(f"training {args.arch!r} (a language "
                                  f"model) comes with the language-model "
                                  f"slice of the port")
    device = resolve_device(args.device)
    tc = TrainConfig(learning_rate=args.lr, warmup_steps=10,
                     total_steps=args.steps)
    ckpt_dir = Path(args.ckpt_dir or Path(tempfile.gettempdir())
                    / "repro_torch_ckpt")
    ckpt = Checkpointer(ckpt_dir / cfg.name.replace("/", "_"))
    hb = HeartbeatMonitor(n_workers=1, timeout_s=600)
    sd = StragglerDetector(n_workers=1)

    if args.flexi:
        from repro_torch.core import flexify, trainable_mask
        base_params = dit_mod.init_dit(
            cfg, torch.Generator(device=device).manual_seed(0))
        params, cfg = flexify(base_params, cfg, [(1, 4, 4)],
                              lora_rank=8 if args.recipe == "lora" else 0)
        del base_params
        mask = (trainable_mask(params, args.recipe)
                if args.recipe == "lora" else None)
        opt = adamw.init_opt_state(params)
        # two step fns — the paper trains both patch sizes
        step_fns = [st.make_dit_train_step(cfg, tc, mode=m, trainable=mask)
                    for m in (0, 1)]
        loader = dp.HostShardedLoader(
            dp.make_dit_batch_fn(cfg.dit.latent_shape, cfg.dit.num_classes,
                                 args.batch))
    else:
        params, opt, fn, loader = build_dit_training(cfg, tc, args.batch,
                                                     device)
        step_fns = [fn]

    ema_state = ema.init_ema(params)
    gen = torch.Generator(device=device).manual_seed(42)
    losses = []
    t_start = time.time()
    for step in range(args.steps):
        t0 = time.time()
        batch = {k: torch.as_tensor(v).to(device)
                 for k, v in next(loader).items() if k in ("x0", "cond")}
        fn = step_fns[step % len(step_fns)]
        params, opt, metrics = fn(params, opt, batch, gen)
        ema_state = ema.ema_update(ema_state, params, tc.ema_rate)
        hb.heartbeat(0)
        sd.record(0, (time.time() - t0) * 1e3)
        if step % 10 == 0 or step == args.steps - 1:
            loss = float(metrics["loss"])    # a sync every 10 steps, to log
            losses.append((step, loss))
            print(f"step {step:5d} loss {loss:.4f} "
                  f"({(time.time() - t0) * 1e3:.0f} ms)", flush=True)
        if step and step % args.ckpt_every == 0:
            ckpt.save(step, {"params": params, "opt": opt})
    ckpt.save(args.steps, {"params": params, "opt": opt})
    ckpt.wait()
    loader.close()
    print(f"done in {time.time() - t_start:.1f}s; "
          f"checkpoints at {ckpt.root}; straggler report: "
          f"{sd.report(args.steps)}", flush=True)
    return {"params": params, "opt": opt, "ema": ema_state, "cfg": cfg,
            "losses": losses, "ckpt_root": ckpt.root}


if __name__ == "__main__":
    main()
