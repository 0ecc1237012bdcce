"""Fault-tolerant training demo on the PyTorch port: checkpoint/restart
with injected worker failures + elastic rescale planning + straggler
rebalancing, around a reduced deepseek-7b trained by the port's
``make_train_step``. The counterpart of
``examples/fault_tolerant_training.py``.

Run:  PYTHONPATH=src python examples/torch_fault_tolerant_training.py
      (on CUDA; ``--device cpu`` runs it on the CPU)
"""
import argparse
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.checkpoint.checkpointer import Checkpointer  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import TrainConfig  # noqa: E402
from repro_torch.data import pipeline as dp  # noqa: E402
from repro_torch.device import resolve_device  # noqa: E402
from repro_torch.launch import steps as st  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.runtime.elastic import plan_mesh_shape  # noqa: E402
from repro_torch.runtime.fault_tolerance import (  # noqa: E402
    HeartbeatMonitor, TrainingSupervisor, run_with_recovery)
from repro_torch.runtime.straggler import (  # noqa: E402
    StragglerDetector, rebalance_shards)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' runs on the CPU)")
    ap.add_argument("--ckpt-dir", default=None,
                    help="checkpoint root (default: a new temporary directory)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = get_config("deepseek-7b").reduced()
    tc = TrainConfig(learning_rate=1e-3, warmup_steps=5, total_steps=60)
    params = lm.init_params(cfg, torch.Generator(device=device).manual_seed(0))
    opt = adamw.init_opt_state(params)
    step_fn = st.make_train_step(cfg, tc)
    make_batch = dp.make_lm_batch_fn(cfg.vocab_size, 64, 8)

    ckdir = Path(args.ckpt_dir or tempfile.mkdtemp(prefix="repro_torch_ft_"))
    ck = Checkpointer(ckdir, keep=3, async_save=True, device=device)
    hb = HeartbeatMonitor(n_workers=8, timeout_s=1e9)
    sup = TrainingSupervisor(ck, hb, checkpoint_every=10,
                             rescale_plan=lambda n: plan_mesh_shape(n, 2))
    sd = StragglerDetector(n_workers=8)
    losses = []

    def train_fn(step, state):
        b = make_batch(step, 0, 1, np.random.default_rng(step))
        batch = {k: torch.from_numpy(b[k]).to(device)
                 for k in ("tokens", "targets")}
        p, o, m = step_fn(state["params"], state["opt"], batch)
        # simulated per-worker data-fetch timings (worker 5 is slow)
        for w in range(8):
            sd.record(w, 100.0 if w != 5 else 420.0)
        if step % 10 == 0:
            losses.append(float(m["loss"]))
            print(f"  step {step:3d} loss {losses[-1]:.4f}")
        return {"params": p, "opt": o}

    fired = []

    def fault_hook(step):
        # kill two workers at step 23 (once)
        if step == 23 and not fired:
            fired.append(step)
            print("  !! injecting failure of workers [2, 6]")
            return [2, 6]
        return None

    state = {"params": params, "opt": opt}
    state, events = run_with_recovery(train_fn, state, 40, sup, fault_hook)

    print("\nrecovery events:")
    for e in events:
        print(f"  step {e.step:3d}: {e.kind:8s} {e.detail}")
    rep = sd.report(40)
    print(f"\nstraggler report: {rep}")
    print("rebalanced shards:",
          rebalance_shards(32, np.asarray([100] * 5 + [420] + [100] * 2)))
    print(f"checkpoints kept: {ck.all_steps()} (dir {ckdir})")
    return {"state": state, "events": events, "losses": losses,
            "checkpoints": ck.all_steps()}


if __name__ == "__main__":
    main()
