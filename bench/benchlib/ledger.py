"""The benchmark's yardstick arithmetic, frozen here so that no change to
the program can move it: the DiT FLOPs ledger (paper App. C.1: mul and add
counted apart), the weak-first schedule a fraction budget resolves to, a
plan's FLOPs, the flash kernel's operations and bytes, and the peaks of
one NVIDIA H100 SXM.

Everything takes the ``model`` section of a configuration file (a plain
dict with the port's ``ModelConfig`` field names). Copied from the port's
``core/scheduler.py`` (``dit_block_flops``, ``dit_nfe_flops``,
``schedule_flops``), ``pipeline/plan.py`` (``SamplingPlan`` budget
resolution and ``flops``) and ``launch/roofline.py`` (``H100_SXM``), dense
attention only: the useful work, not what a tiled kernel visits.
"""
from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

# NVIDIA's data sheet, H100 SXM, dense rates at the full 700 W
PEAK_BF16_FLOPS = 989e12
HBM_BYTES_PER_S = 3.35e12

Phases = Tuple[Tuple[int, int], ...]


def patch_sizes(m: Dict) -> List[Tuple[int, int, int]]:
    dit = m["dit"]
    return [tuple(dit["patch_size"])] + [tuple(p) for p in
                                         dit["flex_patch_sizes"]]


def tokens_for_mode(m: Dict, mode: int) -> int:
    F, H, W, _ = m["dit"]["latent_shape"]
    pf, ph, pw = patch_sizes(m)[mode]
    return (F // pf) * (H // ph) * (W // pw)


def c_out(m: Dict) -> int:
    c_in = m["dit"]["latent_shape"][-1]
    return 2 * c_in if m["dit"]["learn_sigma"] else c_in


def block_flops(m: Dict, n_tokens: int) -> float:
    """All transformer blocks over one sample's ``n_tokens`` tokens."""
    N, d, L, f = n_tokens, m["d_model"], m["num_layers"], m["d_ff"]
    per_layer = 2 * N * d * (3 * d) + 2 * N * d * d   # qkv, out
    per_layer += 2 * 2 * N * N * d                     # QK^T and PV
    per_layer += 2 * 2 * N * d * f                     # mlp in, out
    per_layer += 2 * d * 6 * d                         # adaLN (a sample)
    dit = m["dit"]
    if dit["conditioning"] == "text":
        T = dit["text_len"]
        dc = dit["text_dim"] or d
        per_layer += 2 * N * d * d                     # xattn q
        per_layer += 2 * 2 * T * dc * d                # xattn k, v
        per_layer += 2 * 2 * N * T * d                 # scores, values
        per_layer += 2 * N * d * d                     # xattn out
    return float(L * per_layer)


def nfe_flops(m: Dict, mode: int) -> float:
    """One forward of one sample at patch mode ``mode``."""
    N = tokens_for_mode(m, mode)
    d = m["d_model"]
    npix = math.prod(patch_sizes(m)[mode])
    c_in = m["dit"]["latent_shape"][-1]
    total = block_flops(m, N)
    total += 2 * N * npix * c_in * d                   # embed
    total += 2 * N * d * npix * c_out(m)               # de-embed
    total += 2 * d * 2 * d                             # final adaLN
    return float(total)


def schedule_flops(m: Dict, phases: Phases, guided: bool) -> float:
    """One sample's denoising FLOPs: CFG runs two NFEs a step."""
    mult = 2 if guided else 1
    return float(sum(n * mult * nfe_flops(m, mode) for mode, n in phases))


def weak_first(T: int, t_weak: int, weak_mode: int = 1) -> Phases:
    return ((weak_mode, t_weak), (0, T - t_weak))


def resolve_schedule(m: Dict, T: int, budget: float, guided: bool,
                     weak_mode: int = 1) -> Phases:
    """The fewest weak-first steps whose relative compute meets
    ``budget`` (a fraction of the all-powerful run at the same T)."""
    base = schedule_flops(m, ((0, T),), guided)
    for t_weak in range(T + 1):
        phases = weak_first(T, t_weak, weak_mode)
        if schedule_flops(m, phases, guided) / base <= budget + 1e-12:
            return phases
    raise ValueError(f"no weak-first schedule at T={T} meets {budget}")


def relative_compute(m: Dict, phases: Phases, guided: bool) -> float:
    T = sum(n for _, n in phases)
    return (schedule_flops(m, phases, guided)
            / schedule_flops(m, ((0, T),), guided))


def step_modes(phases: Phases) -> List[int]:
    """The patch mode of each denoising step, in sampling order."""
    return [mode for mode, n in phases for _ in range(n)]


# ---------------------------------------------------------------------------
# The flash kernel's work: pairs inside segments, each byte once


def flash_work(segments: Sequence[Tuple[int, int]], d_attn: int,
               elem_bytes: int = 2) -> Tuple[float, float]:
    """(operations, bytes) of one launch over ``segments`` ((tokens,
    count) pairs): QK^T and PV over the pairs inside each segment, and
    q, k, v read and o written once, in 16-bit elements."""
    ops = sum(4.0 * n * n * d_attn * c for n, c in segments)
    nbytes = sum(4.0 * n * d_attn * elem_bytes * c for n, c in segments)
    return ops, nbytes


def least_seconds(ops: float, nbytes: float) -> float:
    """The least time a launch of that work needs on one H100."""
    return max(ops / PEAK_BF16_FLOPS, nbytes / HBM_BYTES_PER_S)
