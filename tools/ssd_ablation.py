"""Where the bf16 SSD wgmma kernel's time goes, on a CUDA card.

    python3 tools/ssd_ablation.py

Builds copies of ``src/repro_torch/csrc/ssd_chunk.cu`` with one part of
``wg::ssd_wgmma_kernel`` removed or changed into ``build/ablation_ssd/``
(all nvcc builds at once) and times each at one mamba2-130m layer's shape
(B = 4, S = 2048, H = 24, P = 64, N = 128, chunk 128, bf16 x) with CUDA
graphs and CUDA events, in interleaved rounds with the ``"simt"`` kernel.
Variants:

- full kernel;
- no Sc: neither the Sc product nor its store;
- no y: neither the y product nor its store;
- CB and loads only: the CB prologue, the x tiles, L, dt and w, no
  products, no stores;
- loads only: as that, without the CB product;
- empty: every thread returns at once (the launch);
- the design choices, each against the kernel as it is: Sc stored from
  the accumulators directly instead of through a staging tile and TMA;
  M in 3 bf16 pieces instead of 2 for y; each k16 step, each two or
  each eight waited for before the next ones' pieces are built (the
  kernel issues 4 between waits);
- the "simt" kernel, for comparison.

The ablated kernels compute wrong results on purpose: only their times
mean anything. Prints one line, then the card's name and power limit.
"""
from __future__ import annotations

import subprocess
import sys
from pathlib import Path

import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT / "tools"))

from embed_ablation import _sub  # noqa: E402
from flash_ablation import _cut, compile_all  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.ssd.ssd_chunk import bind, heads_per_block  # noqa: E402
from repro_torch.kernels.timing import interleaved_ms  # noqa: E402

SOURCE = build.CSRC / "ssd_chunk.cu"
OUT = ROOT / "build" / "ablation_ssd"
SHAPE = (4, 2048, 24, 64, 128, 128)   # B S H P N chunk
# cut markers in ssd_wgmma_kernel
KERNEL_START = "  using C = Cfg<P>;\n  constexpr int NACC"
CB_PRODUCT = "  // CB[q][k] = C_q . B_k for every head"
CB_END = "  bf16* y = static_cast<bf16*>(a.y);"
Y_PRODUCT = "    // y = M x, GROUP k16 steps"
SC_PRODUCT = "    // Sc^T = (B^T w) x"
ARRIVE = "    hopper::mbar_arrive(&empty[st]);"
SC_STORE = "    // Sc[p][n] = Sc^T[n][p]"
END_HEAD = "    // end of head"


def variants(src: str) -> dict:
    no_products = _cut(_cut(src, Y_PRODUCT, ARRIVE), SC_STORE, END_HEAD)
    return {
        "full kernel": src,
        "no Sc": _cut(_cut(src, SC_PRODUCT, ARRIVE), SC_STORE, END_HEAD),
        "no y": _cut(src, Y_PRODUCT, SC_PRODUCT),
        "CB and loads only": no_products,
        "loads only": _cut(no_products, CB_PRODUCT, CB_END),
        "empty (launch)": _sub(src, KERNEL_START, "  if (a.B > 0) return;\n" + KERNEL_START),
        "Sc direct stores": _sub(src, "constexpr bool SC_TMA_STORE = true;",
                                 "constexpr bool SC_TMA_STORE = false;"),
        "y in 3 pieces": _sub(src, "constexpr int Y_PIECES = 2;", "constexpr int Y_PIECES = 3;"),
        "each step waited": _sub(src, "constexpr int GROUP = 4;", "constexpr int GROUP = 1;"),
        "2 steps a wait": _sub(src, "constexpr int GROUP = 4;", "constexpr int GROUP = 2;"),
        "8 steps a wait": _sub(src, "constexpr int GROUP = 4;", "constexpr int GROUP = 8;"),
    }


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("ssd_ablation.py needs a CUDA card")
    libs = {name: bind(lib) for name, lib in
            compile_all(variants(SOURCE.read_text()), OUT).items()}
    B, S, H, P, N, Q = SHAPE
    nc = S // Q
    gen = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn((B, S, H, P), generator=gen, device="cuda").to(torch.bfloat16)
    dt = F.softplus(torch.randn((B, S, H), generator=gen, device="cuda"))
    A = -torch.exp(torch.randn((H,), generator=gen, device="cuda") * 0.5)
    Bm, Cm = (torch.randn((B, S, N), generator=gen, device="cuda") for _ in range(2))
    y = torch.empty_like(x)
    sc = torch.empty((B, nc, H, P, N), device="cuda")
    ltot = torch.empty((B, nc, H), device="cuda")
    ptrs = tuple(t.data_ptr() for t in (x, dt, A, Bm, Cm, y, sc, ltot))
    hpb = heads_per_block(B * nc, H, torch.cuda.get_device_properties(0).multi_processor_count)

    def checked(err):
        if err:
            raise RuntimeError(f"launch failed: CUDA error {err}")

    def stream():   # the capturing stream, inside a CUDA graph capture
        return torch.cuda.current_stream().cuda_stream

    runs = {name: (lambda fn=lib.ssd_chunk_wgmma_fwd:
                   checked(fn(*ptrs, B, S, H, P, N, Q, hpb, stream())))
            for name, lib in libs.items()}
    runs["simt kernel"] = lambda: checked(libs["full kernel"].ssd_chunk_fwd(
        *ptrs, 1, B, S, H, P, N, Q, hpb, stream()))
    t = interleaved_ms(runs)
    print(f"B{B} S{S} H{H} P{P} N{N} Q{Q} bf16 x, {hpb} heads a CTA, medians of "
          f"{t['full kernel']['rounds']} interleaved rounds: " + "; ".join(
              f"{name} {r['ms']:.4f} ms" for name, r in t.items()), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())


if __name__ == "__main__":
    main()
