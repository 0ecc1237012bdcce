"""Where the bf16 flash-attention kernel's time goes, on a CUDA card.

    python3 tools/flash_ablation.py

Builds copies of ``src/repro_torch/csrc/flash_attention.cu`` with one part
of the TMA/wgmma kernel removed into ``build/ablation/``, all nvcc builds
at once, and times each at the DiT-XL/2 main-path shapes (B = 8 rows under
CFG, H = 16, hd = 72, bf16; S = 256 at patch 2, S = 64 at patch 4) with
CUDA graphs and CUDA events, in interleaved rounds. Variants:

- full kernel;
- no mask/softmax: the scores go to P·V as they are;
- no P·V: the softmax runs, the output product does not;
- loads only: the producer's TMA copies alone (the consumers wait for
  each tile and release it);
- empty: every thread returns at once (the launch);
- the mma.sync kernel (variant 1 of the full source), for comparison.

The ablated kernels compute wrong results on purpose: only their times
mean anything. Prints one line per shape, then the card's name and power
limit.
"""
from __future__ import annotations

import ctypes
import math
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.attention.flash_attention import VARIANTS, bind  # noqa: E402
from repro_torch.kernels.timing import interleaved_ms  # noqa: E402

SOURCE = build.CSRC / "flash_attention.cu"
OUT = ROOT / "build" / "ablation"
# cut markers in the TMA/wgmma kernel (flash_fwd_wgmma_kernel)
KERNEL_START = "  using C = Cfg<WIDE, TAILN, NWG>;\n  constexpr int NS"
S_PRODUCT = "      // S = Q K^T"
SOFTMAX = "      // softmax in base 2"
PV = "      // O += P V: the score accumulators of n8 tiles"
RELEASE = "      hopper::mbar_arrive(&empty[st]);"


def _cut(text: str, start: str, end: str) -> str:
    i = text.index(start)
    return text[:i] + text[text.index(end, i):]


def variants(src: str) -> dict:
    return {
        "full kernel": src,
        "no mask/softmax": _cut(src, SOFTMAX, PV),
        "no P.V": _cut(src, PV, RELEASE),
        "loads only": _cut(src, S_PRODUCT, RELEASE),
        "empty (launch)": src.replace(
            KERNEL_START, "  if (a.B > 0) return;\n" + KERNEL_START, 1),
    }


def compile_all(texts: dict, out: Path = OUT) -> dict:
    """Build each source text into ``out`` (all nvcc runs at once); the
    loaded libraries by name."""
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for i, (name, text) in enumerate(texts.items()):
        cu, so = out / f"v{i}.cu", out / f"v{i}.so"
        cu.write_text(text)
        procs[name] = (so, subprocess.Popen(
            [build.nvcc(), *build.NVCC_FLAGS, "-I", str(build.CSRC), "-o",
             str(so), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {name}:\n{log}")
        libs[name] = ctypes.CDLL(str(so))
    return libs


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("flash_ablation.py needs a CUDA card")
    libs = {name: bind(lib).flash_attention_fwd
            for name, lib in compile_all(variants(SOURCE.read_text())).items()}
    runs = {name: (fn, VARIANTS["wgmma"]) for name, fn in libs.items()}
    runs["mma.sync kernel"] = (libs["full kernel"], VARIANTS["mma"])
    gen = torch.Generator(device="cuda").manual_seed(0)
    for S in (256, 64):
        B, H, hd = 8, 16, 72
        q, k, v = (torch.randn((B, S, H, hd), generator=gen, device="cuda")
                   .to(torch.bfloat16) for _ in range(3))
        o = torch.empty_like(q)
        blk = min(128, S)

        def call(fn, variant):
            err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                     None, None, 1, B, S, S, H, H, hd, 0, 0.0, 0,
                     1.0 / math.sqrt(hd), blk, blk, -(-S // blk), -(-S // blk),
                     1, variant, torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"launch failed: CUDA error {err}")

        t = interleaved_ms({name: (lambda fv=fv: call(*fv))
                            for name, fv in runs.items()})
        print(f"B{B} S{S} H{H} hd{hd} bf16, medians of {t['full kernel']['rounds']} "
              "interleaved rounds: " + "; ".join(
                  f"{name} {r['ms']:.4f} ms" for name, r in t.items()), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())


if __name__ == "__main__":
    main()
