"""Where the TMA/wgmma patch-embed kernel's time goes, on a CUDA card.

    python3 tools/embed_ablation.py

Builds copies of ``src/repro_torch/csrc/patch_embed.cu`` with one part of
``embed_wgmma_kernel`` removed or changed into ``build/ablation_embed/``
and times each at the DiT-XL/2 tokenizer's embed shapes (B = 8, d = 1152,
bf16; mode 0: N = 2048, K = 16; mode 1: N = 512, K = 64), in interleaved
rounds with the ``mma.sync`` kernel and ``torch.addmm``. Variants:

- full kernel;
- no store: the products and the epilogue into the staging tiles, no
  TMA stores;
- loads only: the W and X copies and the ring's waits, no products, no
  epilogue, no stores;
- empty: every thread returns at once (the launch);
- the design choices, each against the kernel as it is: 128- and
  192-column tiles; at most 3 CTAs and 1 CTA per SM; no bias (what
  fetching it costs at all); the bias read by each thread from global
  memory, bf16 pairs, instead of one bulk copy; X at K = 16 in
  8-column boxes without swizzle instead of 16-column boxes in the 32-byte
  swizzle (mode 0 only: K = 64 takes 64-column boxes either way).

The ablated kernels compute wrong results on purpose: only their times
mean anything. Prints one line per shape (each variant with the CTAs it
launched), then the card's name and power limit.
"""
from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from flash_ablation import _cut, compile_all  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.patch_embed.patch_embed import bind  # noqa: E402
from repro_torch.kernels.timing import interleaved_ms  # noqa: E402

SOURCE = build.CSRC / "patch_embed.cu"
OUT = ROOT / "build" / "ablation_embed"
# cut markers in embed_wgmma_kernel
KERNEL_START = "  constexpr int NG = BN / 64;"
PRODUCTS = "    // products\n"
RELEASE = "    // release: stage s"
EPILOGUE = "    // epilogue: bias"
STORE = "    // store\n"
END_TILE = "    // end of tile"
# lines that the design-choice variants change
WIDTH = "constexpr int BN = 64;"
SLOTS = "  const int slots = sms * per_sm;"
BIAS_COPY = ("    hopper::mbar_expect_tx(wbar, mgroups * G.wrows * 128 + bcols * 2);\n"
             "    hopper::bulk_load(sB, bias + m0, bcols * 2, wbar);\n")
W_ONLY = "    hopper::mbar_expect_tx(wbar, mgroups * G.wrows * 128);\n"
BIAS_READ = "*reinterpret_cast<const __nv_bfloat162*>(&sB[8 * c + 2 * tg])"
SW32 = "K % 16 == 0 ? X_SW32"
SHAPES = [(2048, 16, 1152), (512, 64, 1152)]


def _sub(text: str, old: str, new: str) -> str:
    """``text`` with its one ``old`` replaced by ``new``."""
    if text.count(old) != 1:
        raise ValueError(f"marker {old!r} found {text.count(old)} times")
    return text.replace(old, new)


def variants(src: str) -> dict:
    return {
        "full kernel": src,
        "no store": _cut(src, STORE, END_TILE),
        "loads only": _cut(_cut(src, PRODUCTS, RELEASE), EPILOGUE, END_TILE),
        "empty (launch)": _sub(src, KERNEL_START,
                               "  if (N > 0) return;\n" + KERNEL_START),
        "128-col tiles": _sub(src, WIDTH, "constexpr int BN = 128;"),
        "192-col tiles": _sub(src, WIDTH, "constexpr int BN = 192;"),
        "<= 3 CTAs/SM": _sub(src, SLOTS, "  const int slots = sms * (per_sm < 3 ? per_sm : 3);"),
        "1 CTA/SM": _sub(src, SLOTS, "  const int slots = sms;"),
        "no bias": _sub(_sub(src, BIAS_COPY, W_ONLY), BIAS_READ,
                        "__floats2bfloat162_rn(0.f, 0.f)"),
        "bias by thread loads": _sub(_sub(src, BIAS_COPY, W_ONLY), BIAS_READ,
                                     BIAS_READ.replace("&sB[", "&bias[m0 + ")),
        "X 8-col boxes": _sub(src, SW32, "false ? X_SW32"),
    }


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("embed_ablation.py needs a CUDA card")
    libs = {name: bind(lib) for name, lib in
            compile_all(variants(SOURCE.read_text()), OUT).items()}
    gen = torch.Generator(device="cuda").manual_seed(0)
    for N, K, M in SHAPES:
        x, w, b = (torch.randn(shape, generator=gen, device="cuda")
                   .to(torch.bfloat16) for shape in ((N, K), (K, M), (M,)))
        o = torch.empty((N, M), device="cuda", dtype=torch.bfloat16)
        ptrs = (x.data_ptr(), w.data_ptr(), b.data_ptr(), o.data_ptr())

        def checked(err):
            if err:
                raise RuntimeError(f"launch failed: CUDA error {err}")

        def stream():   # the capturing stream, inside a CUDA graph capture
            return torch.cuda.current_stream().cuda_stream

        ctas = {}
        for name, lib in libs.items():
            plan = [ctypes.c_int() for _ in range(3)]
            checked(lib.patch_embed_wgmma_plan(N, K, M, *map(ctypes.byref, plan)))
            ctas[name] = plan[0].value
        runs = {name: (lambda fn=lib.patch_embed_wgmma_fwd:
                       checked(fn(*ptrs, N, K, M, stream())))
                for name, lib in libs.items()}
        runs["mma.sync kernel"] = lambda: checked(libs["full kernel"].patch_embed_fwd(
            *ptrs, 1, N, K, M, 1, stream()))
        runs["addmm"] = lambda: torch.addmm(b, x, w)
        t = interleaved_ms(runs)
        print(f"N{N} K{K} M{M} bf16, medians of {t['addmm']['rounds']} interleaved "
              "rounds: " + "; ".join(
                  f"{name}{f' [{ctas[name]} CTAs]' if name in ctas else ''} "
                  f"{r['ms']:.4f} ms" for name, r in t.items()), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())


if __name__ == "__main__":
    main()
