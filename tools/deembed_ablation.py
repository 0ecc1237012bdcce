"""Where the split-K cluster de-embed kernel's time goes, on a CUDA card.

    python3 tools/deembed_ablation.py

Builds copies of ``src/repro_torch/csrc/patch_embed.cu`` with one part of
``deembed_cluster_kernel`` removed into ``build/ablation_deembed/`` and
times each at the DiT-XL/2 tokenizer's de-embed shapes (B = 8, d = 1152,
bf16; mode 0: N = 2048, M = 32; mode 1: N = 512, M = 128), with the tile
plan of ``deembed_plan``, in interleaved rounds with ``torch.addmm``.
Variants:

- full kernel;
- no reduction: each CTA keeps its partial; no cluster barrier before the
  sum, no distributed-shared-memory reads, no stores;
- loads only: the TMA copies and the cluster barriers, no products;
- empty: every thread returns at once (the cluster launch).

The ablated kernels compute wrong results on purpose: only their times
mean anything. Prints one line per shape, then the card's name and power
limit.
"""
from __future__ import annotations

import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from flash_ablation import _cut, compile_all  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.patch_embed.patch_embed import bind, deembed_plan  # noqa: E402
from repro_torch.kernels.timing import interleaved_ms  # noqa: E402

SOURCE = build.CSRC / "patch_embed.cu"
OUT = ROOT / "build" / "ablation_deembed"
# cut markers in deembed_cluster_kernel
KERNEL_START = "  namespace cgr = cooperative_groups;\n  using C = Cfg<BN>;"
PRODUCTS = "  float acc[BN / 2];"
FIRST_SYNC = "  cluster.sync();   // every partial tile of the cluster is written"
LAST_SYNC = "  cluster.sync();   // peers have read this CTA's partial before it exits"
SHAPES = [(2048, 1152, 32), (512, 1152, 128)]


def variants(src: str) -> dict:
    return {
        "full kernel": src,
        "no reduction": _cut(src, FIRST_SYNC, LAST_SYNC),
        "loads only": _cut(src, PRODUCTS, FIRST_SYNC),
        "empty (launch)": src.replace(
            KERNEL_START, "  if (a.N > 0) return;\n" + KERNEL_START, 1),
    }


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("deembed_ablation.py needs a CUDA card")
    libs = {name: bind(lib).patch_deembed_cluster_fwd
            for name, lib in compile_all(variants(SOURCE.read_text()), OUT).items()}
    gen = torch.Generator(device="cuda").manual_seed(0)
    for N, K, M in SHAPES:
        x, w, b = (torch.randn(shape, generator=gen, device="cuda")
                   .to(torch.bfloat16) for shape in ((N, K), (K, M), (M,)))
        o = torch.empty((N, M), device="cuda", dtype=torch.bfloat16)
        plan = deembed_plan(N, K, M)

        def call(fn):
            err = fn(x.data_ptr(), w.data_ptr(), b.data_ptr(), o.data_ptr(), N, K,
                     M, plan.col_tile, plan.cluster, plan.k_slice,
                     torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"launch failed: CUDA error {err}")

        runs = {name: (lambda fn=fn: call(fn)) for name, fn in libs.items()}
        runs["addmm"] = lambda: torch.addmm(b, x, w)
        t = interleaved_ms(runs)
        print(f"N{N} K{K} M{M} bf16 (cluster {plan.cluster} x {plan.k_slice}, "
              f"{plan.ctas(N, M)} CTAs), medians of {t['addmm']['rounds']} "
              "interleaved rounds: " + "; ".join(
                  f"{name} {r['ms']:.4f} ms" for name, r in t.items()), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())


if __name__ == "__main__":
    main()
