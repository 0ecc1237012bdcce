"""Where the bf16 flash-attention kernel's time goes, on a CUDA card.

    python3 tools/flash_ablation.py

Builds copies of ``src/repro_torch/csrc/flash_attention.cu`` with one part
of the bf16 tensor-core kernel removed (the mask and softmax, the P·V
product, everything but the tile loads, everything) into
``build/ablation/``, all nvcc builds at once, and times each at the
DiT-XL/2 main-path shapes (B = 8 rows under CFG, H = 16, hd = 72, bf16;
S = 256 at patch 2, S = 64 at patch 4) with CUDA graphs and CUDA events.
The ablated kernels compute wrong results on purpose: only their times
mean anything. Prints one line per variant and shape, then the card's
name and power limit.
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
from repro_torch.kernels.attention.flash_attention import bind  # noqa: E402
from repro_torch.kernels.timing import graph_ms  # noqa: E402

SOURCE = ROOT / "src" / "repro_torch" / "csrc" / "flash_attention.cu"
OUT = ROOT / "build" / "ablation"
KERNEL_START = "  const bf16* q = static_cast<const bf16*>(a.q);"
SOFTMAX = ("    // softmax. Each step", "    // O += P V")
PV = ("    // O += P V", "    __syncthreads();   // done reading this buffer")
COMPUTE = ("    float sc[NS][4];\n#pragma unroll\n    for (int n = 0; n < NS; ++n)",
           "    __syncthreads();   // done reading this buffer")


def _cut(text: str, span) -> str:
    i = text.index(span[0])
    return text[:i] + text[text.index(span[1], i):]


def variants(src: str) -> dict:
    return {
        "full kernel": src,
        "no mask/softmax": _cut(src, SOFTMAX),
        "no P.V": _cut(src, PV),
        "loads only": _cut(src, COMPUTE),
        "empty (launch)": src.replace(KERNEL_START,
                                      "  if (a.B > 0) return;\n" + KERNEL_START, 1),
    }


def compile_all(texts: dict) -> dict:
    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for i, (name, text) in enumerate(texts.items()):
        cu, so = OUT / f"v{i}.cu", OUT / f"v{i}.so"
        cu.write_text(text)
        procs[name] = (so, subprocess.Popen(
            [build.nvcc(), *build.NVCC_FLAGS, "-o", str(so), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {name}:\n{log}")
        libs[name] = bind(ctypes.CDLL(str(so))).flash_attention_fwd
    return libs


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("flash_ablation.py needs a CUDA card")
    libs = compile_all(variants(SOURCE.read_text()))
    gen = torch.Generator(device="cuda").manual_seed(0)
    for S in (256, 64):
        B, H, hd = 8, 16, 72
        q, k, v = (torch.randn((B, S, H, hd), generator=gen, device="cuda")
                   .to(torch.bfloat16) for _ in range(3))
        o = torch.empty_like(q)
        blk = min(128, S)
        for name, fn in libs.items():
            def call(fn=fn):
                err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                         None, None, 1, B, S, S, H, H, hd, 0, 0.0, 0,
                         1.0 / math.sqrt(hd), blk, blk, -(-S // blk), -(-S // blk),
                         1, torch.cuda.current_stream().cuda_stream)
                if err:
                    raise RuntimeError(f"launch failed: CUDA error {err}")
            print(f"B{B} S{S} H{H} hd{hd} bf16  {name:16s} {graph_ms(call):.4f} ms",
                  flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())


if __name__ == "__main__":
    main()
