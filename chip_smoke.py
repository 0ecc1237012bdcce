"""Drive the PyTorch port on one CUDA card and check it end to end.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with an NVIDIA Hopper card
(sm_90a) and the CUDA toolkit. Phases, each fatal on failure:

1. build every CUDA kernel of the port from ``src/repro_torch/csrc/``;
2. hold each kernel against its plain PyTorch version on the card, at
   the JAX package's kernel-test cases and at each path's shapes; the
   redesigned kernels (flash attention on TMA/wgmma, the split-K cluster
   de-embed) also against the previous kernel of the same function,
   forced with ``variant=``;
3. serve class-conditioned DiT-XL/2 requests (28 layers, d=1152, bf16,
   random trained-like weights from a seed) through
   ``FlexiPipeline.sample`` over a budget menu with the flash kernel as
   the attention backend: counts the kernel's launches (every one on the
   TMA/wgmma variant), checks x0
   against the dense backend, and checks that repeats and budget
   switches build no runner;
4. tokenize and de-tokenize a B=8 latent with those DiT-XL/2 weights at
   each patch size through ``kernels/patch_embed/ops`` (the patch
   embed / de-embed kernels; every de-embed on the cluster variant), held
   against ``core/patch.py``;
5. run one Mamba2 layer at mamba2-130m width (d=768, 24 SSD heads x 64,
   state 128, chunk 128, bf16) through ``ssm_apply(use_kernel=True)``
   (the SSD kernel) at B=4, S=2048 and S=2000, held against
   ``use_kernel=False``;
6. time each kernel, its plain version and the PyTorch library call at
   its path's shapes (CUDA graphs, CUDA events); the redesigned kernels
   in interleaved rounds with their previous kernel and the library call.

Each path resets its kernels' launch counts just before it runs and
fails unless they equal the calls it made.

The line before the last is ``{"kernels": [...]}`` (``prev_ms``: the
previous kernel of a redesigned one, timed in the same rounds); the last
line is
``{"ok": true, "device": {...}}``. Exits non-zero without a result when
there is no CUDA card or no port next to this file.
"""
from __future__ import annotations

import json
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
if not (ROOT / "src" / "repro_torch").is_dir():
    sys.exit("chip_smoke.py: run it from a checkout of the repository "
             "(src/repro_torch/ is missing)")
if not torch.cuda.is_available():
    sys.exit("chip_smoke.py: needs a CUDA card (torch.cuda.is_available() is "
             "False)")
sys.path.insert(0, str(ROOT / "src"))

import torch.nn.functional as F  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.diffusion.schedule import linear_schedule  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.attention import ops  # noqa: E402
from repro_torch.kernels.attention.flash_attention import (  # noqa: E402
    flash_attention_cuda, variant_of)
from repro_torch.kernels.attention.ref import flash_attention_ref  # noqa: E402
from repro_torch.core import patch as patch_mod  # noqa: E402
from repro_torch.kernels.patch_embed import ops as pe_ops  # noqa: E402
from repro_torch.kernels.patch_embed.patch_embed import (  # noqa: E402
    deembed_plan, deembed_variant_of, patch_deembed_cuda, patch_embed_cuda)
from repro_torch.kernels.patch_embed.ref import (  # noqa: E402
    patch_deembed_ref, patch_embed_ref)
from repro_torch.kernels.ssd import ops as ssd_ops  # noqa: E402
from repro_torch.kernels.ssd.ref import ssd_chunk_ref, ssd_chunked  # noqa: E402
from repro_torch.kernels.ssd.ssd_chunk import ssd_chunk_cuda  # noqa: E402
from repro_torch.kernels.timing import graph_ms, interleaved_ms  # noqa: E402
from repro_torch.models import dit as dit_mod  # noqa: E402
from repro_torch.models import ssm as ssm_mod  # noqa: E402
from repro_torch.models.common import init_tree  # noqa: E402
from repro_torch.pipeline import FlexiPipeline, SamplingPlan  # noqa: E402

DEV = torch.device("cuda")
SEED = 0
HBM_BYTES_PER_S = 3.35e12           # H100 SXM published peaks
BF16_FLOPS = 989e12
F32_FLOPS = 67e12
TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}   # tests/test_kernels.py
# patch embed: the JAX package's PE level (sums of up to 1152 products in
# another order; bf16 outputs within one rounding). SSD: the cumulative log
# decay of a 128-step chunk is summed in another order than torch.cumsum;
# at |L| ~ 150 a float32 ulp is 1.5e-5 and exp(L_q - L_k) turns a few into
# ~1e-4 relative (the JAX package holds its SSD kernel at 2e-3).
PE_TOL = {torch.float32: 2e-4, torch.bfloat16: 5e-2}
SSD_TOL = {torch.float32: 1e-3, torch.bfloat16: 2e-2}
BUDGETS = (0.6, 0.8, 1.0)
BATCH = 4                           # requests per batch (CFG runs 2x4 rows)
T_STEPS = 10

# the JAX package's ATTN_CASES (tests/test_kernels.py) and the main path's
# shapes: B = 2 x 4 rows under CFG, 256 tokens at patch 2, 64 at patch 4
ATTN_CASES = [
    # B, S, H, K, hd, causal, softcap, window, dtype
    (2, 128, 4, 2, 64, True, 0.0, 0, torch.float32),
    (1, 256, 4, 4, 64, True, 50.0, 0, torch.float32),
    (2, 256, 8, 2, 32, True, 0.0, 128, torch.float32),
    (1, 128, 2, 1, 128, False, 0.0, 0, torch.float32),
    (1, 256, 4, 2, 64, True, 0.0, 0, torch.bfloat16),
    (2, 384, 6, 2, 64, True, 30.0, 256, torch.float32),
    (2 * BATCH, 256, 16, 16, 72, False, 0.0, 0, torch.bfloat16),
    (2 * BATCH, 64, 16, 16, 72, False, 0.0, 0, torch.bfloat16),
]


# the JAX package's PE_CASES (N, K, M) and the DiT-XL/2 tokenizer at B=8:
# embed mode 0 / 1, de-embed mode 0 / 1 (c_out 8 x pp 4 / 16)
PE_CASES = [(512, 64, 256, torch.float32), (256, 48, 128, torch.float32),
            (1024, 128, 512, torch.bfloat16), (256, 16, 64, torch.float32)]
PE_PATH = {"patch_embed": [(2048, 16, 1152), (512, 64, 1152)],
           "patch_deembed": [(2048, 1152, 32), (512, 1152, 128)]}
# the cluster de-embed at a ragged N and at K not in whole 64-chunks (the
# last slice's box partly past K)
DEEMBED_EXTRA = [(2000, 1152, 32), (256, 1000, 64), (100, 72, 16)]
# the JAX package's SSD_CASES (B, S, H, P, N, chunk) and one mamba2-130m
# layer at B=4, S=2048
SSD_CASES = [(2, 64, 4, 16, 8, 16), (1, 96, 2, 32, 16, 32),
             (2, 48, 3, 8, 8, 16), (1, 128, 4, 16, 32, 64)]
SSD_PATH = (4, 2048, 24, 64, 128, 128)
SSM_SEQS = (2048, 2000)             # the layer path: whole chunks, then padded


def log(msg: str) -> None:
    print(msg, flush=True)


def randn(gen: torch.Generator, shape, dtype=torch.float32) -> torch.Tensor:
    return torch.randn(shape, generator=gen, device=DEV).to(dtype)


# ---------------------------------------------------------------------------
# Phase 1: build


def kernel_resources(log: str) -> list:
    """(kernel, registers, spill bytes) per entry function of nvcc's
    ``-Xptxas -v`` report; template arguments kept as <a,b,...>."""
    out, name, spill = [], None, 0
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            mangled = m.group(1)
            short = re.search(r"\d([a-z][a-z_]*_kernel)", mangled)
            args = re.findall(r"Li(\d+)E", mangled)
            name = short.group(1) if short else mangled
            name += f"<{','.join(args)}>" if args else ""
        m = re.search(r"(\d+) bytes spill stores", line)
        if m:
            spill = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out.append((name, int(m.group(1)), spill))
            name, spill = None, 0
    return out


def phase_build() -> None:
    t0 = time.perf_counter()
    report = build.build_all()
    log(f"[build] {len(report)} kernel source(s) built in "
        f"{time.perf_counter() - t0:.1f}s (one nvcc each, in parallel)")
    for name, rep in report.items():
        res = kernel_resources(rep["log"])
        log(f"[build]   {name}: {rep['seconds']:.1f}s; registers (spill bytes) "
            "per kernel: " + "; ".join(f"{k} {r} ({sp})" for k, r, sp in res))


# ---------------------------------------------------------------------------
# Phase 2: kernels against their plain versions


# bf16 cases of the TMA/wgmma kernel beyond those: ragged S, GQA, causal
# with window, softcap, hd 64 and 128, and one long causal row past the
# 8192 tokens at which the JAX package sends every sequence to this kernel
# (src/repro/models/attention.py:41)
WGMMA_CASES = [
    # B, S, H, K, hd, causal, softcap, window
    (2, 100, 4, 4, 72, False, 0.0, 0),
    (2, 200, 4, 4, 72, True, 0.0, 0),
    (2, 300, 4, 4, 72, False, 0.0, 0),
    (2, 256, 8, 2, 64, True, 0.0, 0),
    (2, 384, 4, 2, 64, True, 0.0, 128),
    (1, 256, 4, 4, 64, True, 50.0, 0),
    (2, 256, 4, 4, 128, False, 0.0, 0),
    (1, 9000, 2, 2, 64, True, 0.0, 0),
]
MAP_BLOCKS = [(64, 64), (48, 80), (128, 128)]


def packed_case(gen: torch.Generator):
    """Three requests packed in rows of 256 tokens, padding -1, and a
    caller's block map that also hides some tiles the segments allow."""
    B, S, H, hd = 2, 256, 16, 72
    seg = torch.full((B, S), -1, dtype=torch.int32)
    seg[0, :64], seg[0, 64:192] = 0, 1
    seg[1, :150] = 0
    bmap = torch.ones((B, 2, 2), dtype=torch.int32)
    bmap[0, 0, 1] = 0
    q, k, v = (randn(gen, (B, S, H, hd), torch.bfloat16) for _ in range(3))
    return q, k, v, dict(causal=False, segment_ids=seg.to(DEV),
                         block_map=bmap.to(DEV))


def packed_map_case(gen: torch.Generator, bq: int, bk: int):
    """Packed causal rows of 200 tokens with padding and a random caller's
    map at block_q x block_k (48 x 80 straddles the kernel's tiles)."""
    B, S, H, hd = 2, 200, 4, 72
    seg = torch.full((B, S), -1, dtype=torch.int32)
    seg[0, :70], seg[0, 70:150] = 0, 1
    seg[1, :30], seg[1, 30:190] = 0, 1
    bmap = (torch.rand((B, -(-S // bq), -(-S // bk)), generator=gen,
                       device=DEV) < 0.7).to(torch.int32)
    q, k, v = (randn(gen, (B, S, H, hd), torch.bfloat16) for _ in range(3))
    return q, k, v, dict(causal=True, segment_ids=seg.to(DEV), block_map=bmap,
                         block_q=bq, block_k=bk)


def phase_kernel_checks(gen: torch.Generator, gen_new: torch.Generator) -> float:
    """Flash attention against its plain version; every bf16 case also
    against the previous (mma.sync) kernel, and every bf16 case with rows
    of whole 16-byte chunks must select the TMA/wgmma kernel. The cases
    added with the TMA/wgmma kernel draw from ``gen_new``, so the earlier
    cases and the later phases keep the inputs they had."""
    worst = 0.0
    cases = [(f"B{B} S{S} H{H} K{K} hd{hd} causal={int(c)} cap={cap} "
              f"win={w} {str(dt)[6:]}",
              [randn(gen, (B, S, h, hd), dt) for h in (H, K, K)],
              dict(causal=c, softcap=cap, window=w))
             for B, S, H, K, hd, c, cap, w, dt in ATTN_CASES]
    q, k, v, kw = packed_case(gen)
    cases.append(("packed B2 S256 3 segments + padding + block map bf16",
                  [q, k, v], kw))
    cases += [(f"B{B} S{S} H{H} K{K} hd{hd} causal={int(c)} cap={cap} "
               f"win={w} bfloat16",
               [randn(gen_new, (B, S, h, hd), torch.bfloat16) for h in (H, K, K)],
               dict(causal=c, softcap=cap, window=w))
              for B, S, H, K, hd, c, cap, w in WGMMA_CASES]
    for bq, bk in MAP_BLOCKS:
        q, k, v, kw = packed_map_case(gen_new, bq, bk)
        cases.append((f"packed B2 S200 causal, map {bq}x{bk} bf16", [q, k, v], kw))
    for name, (q, k, v), kw in cases:
        got = ops.flash_attention(q, k, v, **kw)
        torch.cuda.synchronize()
        want = flash_attention_ref(q, k, v, **kw)
        err = (got.float() - want.float()).abs().max().item()
        tol = TOL[q.dtype]
        worst = max(worst, err)
        variant = variant_of(q, k, v)
        line = f"[kernel] flash_attention ({variant}) {name}: max|err|={err:.3e}"
        if q.dtype == torch.bfloat16:
            if variant != "wgmma":
                raise AssertionError(f"{name}: selects {variant}, not wgmma")
            prev = flash_attention_cuda(q, k, v, **ops.kernel_kwargs(q, k, **kw),
                                        variant="mma")
            torch.cuda.synchronize()
            err_prev = (got.float() - prev.float()).abs().max().item()
            line += f", vs mma kernel {err_prev:.3e}"
            if not err_prev <= tol:
                raise AssertionError(f"wgmma and mma kernels disagree on {name}: "
                                     f"{err_prev} > {tol}")
        log(f"{line} (tol {tol})")
        if not err <= tol:
            raise AssertionError(f"flash_attention disagrees with its plain "
                                 f"version on {name}: {err} > {tol}")
        if kw.get("segment_ids") is not None:
            seg = kw["segment_ids"]
            if not torch.all(got[seg < 0] == 0):
                raise AssertionError("padding rows must return exactly 0")
    return worst


def ssd_inputs(gen: torch.Generator, B, S, H, P, N, dtype):
    x = randn(gen, (B, S, H, P), dtype)
    dt = F.softplus(randn(gen, (B, S, H)))
    A = -torch.exp(randn(gen, (H,)) * 0.5)
    return x, dt, A, randn(gen, (B, S, N)), randn(gen, (B, S, N))


def check(name: str, got: torch.Tensor, want: torch.Tensor, tol: float) -> float:
    err = (got.float() - want.float()).abs().max().item()
    log(f"[kernel] {name}: max|err|={err:.3e} (tol {tol} abs + rel)")
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)
    return err


def phase_new_kernel_checks(gen: torch.Generator, gen_new: torch.Generator) -> dict:
    """The patch embed / de-embed and SSD kernels against their plain
    versions: the JAX package's cases, then each path's shapes; the
    cluster de-embed's extra shapes draw from ``gen_new``."""
    worst = {"patch_embed": 0.0, "patch_deembed": 0.0, "ssd_chunk": 0.0}
    kernels = {"patch_embed": (patch_embed_cuda, patch_embed_ref),
               "patch_deembed": (patch_deembed_cuda, patch_deembed_ref)}
    cases = [(name, N, K, M, dt) for N, K, M, dt in PE_CASES for name in kernels]
    cases += [(name, N, K, M, torch.bfloat16)
              for name, shapes in PE_PATH.items() for N, K, M in shapes]
    cases += [("patch_deembed", N, K, M, torch.bfloat16) for N, K, M in DEEMBED_EXTRA]
    for i, (name, N, K, M, dt) in enumerate(cases):
        g = gen_new if i >= len(cases) - len(DEEMBED_EXTRA) else gen
        x, w, b = (randn(g, shape, dt) for shape in ((N, K), (K, M), (M,)))
        kernel, plain = kernels[name]
        got = kernel(x, w, b)
        torch.cuda.synchronize()
        label = f"{name} N{N} K{K} M{M} {str(dt)[6:]}"
        if name == "patch_deembed" and dt == torch.bfloat16:
            variant = deembed_variant_of(x, w)
            if variant != "cluster":
                raise AssertionError(f"{label}: selects {variant}, not cluster")
            plan = deembed_plan(N, K, M)
            label += (f" (cluster {plan.cluster} x {plan.k_slice}-deep slices, "
                      f"{plan.ctas(N, M)} CTAs)")
            prev = patch_deembed_cuda(x, w, b, variant="mma")
            torch.cuda.synchronize()
            check(f"{label} vs mma kernel", got, prev, PE_TOL[dt])
        worst[name] = max(worst[name], check(label, got, plain(x, w, b), PE_TOL[dt]))
    for case, dt in ([(c, torch.float32) for c in SSD_CASES]
                     + [(SSD_PATH, torch.float32), (SSD_PATH, torch.bfloat16)]):
        B, S, H, P, N, Q = case
        x, dts, A, Bm, Cm = ssd_inputs(gen, B, S, H, P, N, dt)
        got = ssd_chunk_cuda(x, dts, A, Bm, Cm, Q)
        torch.cuda.synchronize()
        want = ssd_chunk_ref(x, dts, A, Bm, Cm, Q)
        label = f"ssd_chunk B{B} S{S} H{H} P{P} N{N} Q{Q} {str(dt)[6:]}"
        errs = [check(f"{label} y", got[0], want[0], SSD_TOL[dt])]
        errs += [check(f"{label} {part}", g, w, SSD_TOL[torch.float32])
                 for part, g, w in zip(("Sc", "Ltot"), got[1:], want[1:])]
        worst["ssd_chunk"] = max([worst["ssd_chunk"]] + errs)
    # S not a multiple of the chunk, with a carried state: ops.ssd pads
    B, S, H, P, N, Q = 2, 200, 4, 64, 128, 128
    x, dts, A, Bm, Cm = ssd_inputs(gen, B, S, H, P, N, torch.float32)
    h0 = randn(gen, (B, H, P, N)) * 0.1
    y, h = ssd_ops.ssd(x, dts, A, Bm, Cm, Q, h0)
    torch.cuda.synchronize()
    y_ref, h_ref = ssd_chunked(x, dts, A, Bm, Cm, Q, h0)
    worst["ssd_chunk"] = max(
        worst["ssd_chunk"],
        check(f"ssd (padded) B{B} S{S} Q{Q} + h0 y", y, y_ref, SSD_TOL[torch.float32]),
        check(f"ssd (padded) B{B} S{S} Q{Q} + h0 h", h, h_ref, SSD_TOL[torch.float32]))
    return worst


# ---------------------------------------------------------------------------
# Phase 3: the main path


def trained_like_xl(gen: torch.Generator):
    """DiT-XL/2 with random weights; the zero-initialized de-embedding and
    adaLN gates made non-zero so the sample depends on every block."""
    cfg = get_config("dit-xl-2")
    params = dit_mod.init_dit(cfg, gen)
    dt = params["deembed"]["w_flex"].dtype
    for node, key, scale in [(params["deembed"], "w_flex", 0.1),
                             (params["final"]["ada"], "w", 0.05),
                             (params["blocks"]["ada"], "w", 0.05)]:
        node[key] = randn(gen, node[key].shape, dt) * scale
    return params, cfg


def forward_calls(plan: SamplingPlan, cfg) -> int:
    """Denoiser forward calls a static plan makes for one batch."""
    per_step = {True: 2, False: 1}
    calls = sum(n * per_step[plan.guidance_active and mode == 0
                             and plan.guidance_kind == "weak_cond"]
                for mode, n in plan.resolve_schedule(cfg).phases)
    return calls * (2 if plan.solver == "dpm2" else 1)


def phase_main_path(gen: torch.Generator) -> dict:
    t0 = time.perf_counter()
    params, cfg = trained_like_xl(gen)
    pipe = FlexiPipeline(params, cfg, linear_schedule(1000), device=DEV)
    del params
    torch.cuda.synchronize()
    log(f"[main] {cfg.name}: {cfg.num_layers} layers, d={cfg.d_model}, "
        f"heads={cfg.attn.num_heads}x{cfg.attn.head_dim}, "
        f"{cfg.param_dtype}; weights in {time.perf_counter() - t0:.1f}s")
    plans = {b: SamplingPlan(T=T_STEPS, budget=b, attn_backend="pallas")
             for b in BUDGETS}
    for b, plan in plans.items():
        log(f"[main]   budget {b}: schedule {plan.resolve_schedule(cfg).phases}"
            f", relative compute {plan.relative_compute(cfg):.4f}")

    rng = np.random.default_rng(SEED)
    waves = [[(b, rng.integers(0, cfg.dit.num_classes, BATCH).tolist())
              for b in BUDGETS] for _ in range(2)]
    waves[1].reverse()          # the second wave switches budgets the other way
    expected = 0
    first_batch = None
    ops.reset_launches()
    t_serve = time.perf_counter()
    built_after_first = None
    served = 0
    for w, wave in enumerate(waves):
        for b, labels in wave:
            batch_gen = torch.Generator(device=DEV).manual_seed(1000 + served)
            t1 = time.perf_counter()
            res = pipe.sample(plans[b], BATCH, batch_gen,
                              cond=torch.tensor(labels, device=DEV))
            torch.cuda.synchronize()
            dt = time.perf_counter() - t1
            expected += cfg.num_layers * forward_calls(plans[b], cfg)
            if first_batch is None:
                first_batch = (b, labels, res.x0)
            shape = (BATCH,) + tuple(cfg.dit.latent_shape)
            if tuple(res.x0.shape) != shape or not torch.isfinite(res.x0).all():
                raise AssertionError(f"x0 {tuple(res.x0.shape)} not finite or "
                                     f"not {shape}")
            served += BATCH
            log(f"[serve] wave {w} budget {b}: {BATCH} requests in "
                f"{dt * 1e3:.1f} ms, x0 std {res.x0.float().std().item():.4f}")
        if w == 0:
            built_after_first = pipe.cache_stats()["compiled"]
    wall = time.perf_counter() - t_serve
    launches = ops.flash_attention.launches
    by_variant = dict(ops.flash_attention.launches_by_variant)
    stats = pipe.cache_stats()
    log(f"[serve] {served} requests in {wall:.2f}s ({served / wall:.2f} img/s, "
        f"first wave included); runners {stats}")
    if launches != expected:
        raise AssertionError(f"flash_attention launched {launches} times, "
                             f"expected {expected} (layers x forward calls)")
    if by_variant["wgmma"] != launches:
        raise AssertionError(f"flash_attention launches by variant {by_variant}: "
                             f"not all {launches} on the TMA/wgmma kernel")
    log(f"[serve] flash_attention launches {launches} == "
        f"{cfg.num_layers} layers x {expected // cfg.num_layers} forward calls, "
        f"by variant {by_variant}")
    if stats["compiled"] != built_after_first or built_after_first != len(BUDGETS):
        raise AssertionError(f"repeats / budget switches built runners: {stats}")

    # One forward at full width, each mode, flash vs dense backend, at the
    # bf16 kernel tolerance. (Both round the probabilities to bf16 before
    # P·V, as the TPU kernel does; they sum in other orders.)
    x = randn(gen, (2 * BATCH,) + tuple(cfg.dit.latent_shape))
    t = torch.full((2 * BATCH,), 500, device=DEV)
    y = torch.arange(2 * BATCH, device=DEV)
    for mode in range(1 + len(cfg.dit.flex_patch_sizes)):
        outs = [dit_mod.dit_forward(pipe.params, x, t, y, cfg, mode=mode,
                                    attn_backend=be).float()
                for be in ("pallas", "dense")]
        err = (outs[0] - outs[1]).abs().max().item()
        log(f"[serve] forward mode {mode} flash vs dense backend: "
            f"max|err|={err:.3e} (tol 2e-2 abs + rel)")
        torch.testing.assert_close(outs[0], outs[1], atol=2e-2, rtol=2e-2)

    # The same plan with the dense backend, same prior and labels. DDIM's
    # x0 prediction divides by sqrt(alpha_bar_t) (~0.006 at t=999), which
    # amplifies those bf16 differences step by step, so x0 is held on its
    # own scale: max|err| <= 2e-2 * max(1, max|x0|).
    b, labels, x0 = first_batch
    dense = pipe.sample(SamplingPlan(T=T_STEPS, budget=b, attn_backend="dense"),
                        BATCH, torch.Generator(device=DEV).manual_seed(1000),
                        cond=torch.tensor(labels, device=DEV)).x0
    err = (x0.float() - dense.float()).abs().max().item()
    scale = max(1.0, dense.float().abs().max().item())
    log(f"[serve] x0 flash vs dense backend (budget {b}): max|err|={err:.3e}, "
        f"max|x0|={scale:.3f} (tol {2e-2 * scale:.3e})")
    if not err <= 2e-2 * scale:
        raise AssertionError(f"x0 differs between backends: {err}")
    return {"launches": launches, "pipe": pipe}


# ---------------------------------------------------------------------------
# Phase 4: the tokenizer path


def phase_tokenizer(gen: torch.Generator, pipe: FlexiPipeline) -> dict:
    """Each patch size of DiT-XL/2: tokenize a B=8 latent and de-tokenize
    the tokens with the pipeline's weights through the kernels' ops entry,
    against the port's core/patch.py path (the tokenizer dit_forward runs)."""
    cfg = pipe.cfg
    dit = cfg.dit
    emb, de = pipe.params["embed"], pipe.params["deembed"]
    c_out = dit_mod.c_out_dim(cfg)
    # the biases are zero-initialized: give them values so the path adds them
    emb = dict(emb, b=randn(gen, emb["b"].shape, emb["b"].dtype) * 0.1)
    de = dict(de, b_flex=randn(gen, de["b_flex"].shape, de["b_flex"].dtype) * 0.1)
    x = randn(gen, (2 * BATCH,) + tuple(dit.latent_shape), torch.bfloat16)
    pp = dit.underlying_patch_size
    patches = (dit.patch_size,) + dit.flex_patch_sizes
    pe_ops.reset_launches()
    for p in patches:
        tok = pe_ops.embed_tokens_flex(emb["w_flex"], emb["b"], x, p, pp)
        out = pe_ops.deembed_tokens_flex(de["w_flex"], de["b_flex"], tok,
                                         dit.latent_shape, p, pp, c_out)
        torch.cuda.synchronize()
        tok_ref = patch_mod.embed_tokens_flex(emb["w_flex"], emb["b"], x, p, pp)
        out_ref = patch_mod.deembed_tokens_flex(de["w_flex"], de["b_flex"], tok,
                                                dit.latent_shape, p, pp, c_out)
        shape = (2 * BATCH,) + tuple(dit.latent_shape[:3]) + (c_out,)
        if tuple(out.shape) != shape or not torch.isfinite(out).all():
            raise AssertionError(f"de-tokenized {tuple(out.shape)} not finite "
                                 f"or not {shape}")
        n = tok.shape[1]
        log(f"[tokenizer] patch {p}: {n} tokens x {tok.shape[2]}")
        check(f"embed_tokens_flex patch {p} vs core/patch.py", tok, tok_ref, 2e-2)
        check(f"deembed_tokens_flex patch {p} vs core/patch.py", out, out_ref, 2e-2)
    launches = {"patch_embed": pe_ops.embed_tokens_flex.launches,
                "patch_deembed": pe_ops.deembed_tokens_flex.launches}
    by_variant = dict(pe_ops.deembed_tokens_flex.launches_by_variant)
    if any(n != len(patches) for n in launches.values()):
        raise AssertionError(f"tokenizer launches {launches}, expected "
                             f"{len(patches)} each (one per patch size)")
    if by_variant["cluster"] != len(patches):
        raise AssertionError(f"de-embed launches by variant {by_variant}: not "
                             f"all {len(patches)} on the cluster kernel")
    log(f"[tokenizer] launches {launches} == {len(patches)} patch sizes; "
        f"de-embed by variant {by_variant}")
    return launches


# ---------------------------------------------------------------------------
# Phase 5: one Mamba2 layer


def phase_mamba_layer(gen: torch.Generator) -> dict:
    """One mamba2-130m layer, bf16, random weights with decay rates and
    time steps that vary across heads, through ssm_apply(use_kernel=True)
    at S=2048 and at S=2000 (padded), against use_kernel=False."""
    cfg = get_config("mamba2-130m")
    d, scfg = cfg.d_model, cfg.ssm
    params = init_tree(ssm_mod.ssm_schema(d, scfg), gen, torch.bfloat16)
    H = params["A_log"].shape[0]
    params["A_log"] = (randn(gen, (H,)) * 0.5).to(torch.bfloat16)
    params["dt_bias"] = (randn(gen, (H,)) * 0.5).to(torch.bfloat16)
    d_in, _, P = ssm_mod.ssm_dims(d, scfg)
    log(f"[mamba] {cfg.name} layer: d={d}, d_inner={d_in}, {H} SSD heads x "
        f"{P}, state {scfg.state_dim}, chunk {scfg.chunk_size}, bf16")
    B = 4
    inputs = {S: randn(gen, (B, S, d), torch.bfloat16) for S in SSM_SEQS}
    ssd_ops.ssd.launches = 0
    outs = {}
    for S, u in inputs.items():
        t0 = time.perf_counter()
        outs[S] = ssm_mod.ssm_apply(params, u, scfg, d, use_kernel=True)
        torch.cuda.synchronize()
        log(f"[mamba] B{B} S{S}: ssm_apply(use_kernel=True) in "
            f"{(time.perf_counter() - t0) * 1e3:.1f} ms (first call of the shape)")
    launches = ssd_ops.ssd.launches
    for S, u in inputs.items():
        out, state = outs[S]
        ref, ref_state = ssm_mod.ssm_apply(params, u, scfg, d, use_kernel=False)
        if tuple(out.shape) != (B, S, d) or not torch.isfinite(out).all():
            raise AssertionError(f"layer output {tuple(out.shape)} not finite "
                                 f"or not {(B, S, d)}")
        check(f"ssm_apply B{B} S{S} out, kernel vs plain branch", out, ref, 2e-2)
        check(f"ssm_apply B{B} S{S} state h, kernel vs plain branch",
              state["h"], ref_state["h"], SSD_TOL[torch.float32])
    if launches != len(SSM_SEQS):
        raise AssertionError(f"ssd launched {launches} times, expected "
                             f"{len(SSM_SEQS)} (one per layer call)")
    log(f"[mamba] ssd launches {launches} == {len(SSM_SEQS)} layer calls")
    return {"ssd_chunk": launches}


# ---------------------------------------------------------------------------
# Phase 6: times at each path's shapes


def attention_bound_ms(B, S, H, hd, dtype) -> tuple:
    """Least time for q, k, v read once and o written once, or for the two
    products at the tensor-core peak of the dtype."""
    itemsize = torch.tensor([], dtype=dtype).element_size()
    nbytes = 4 * B * S * H * hd * itemsize
    flops = 4 * B * H * S * S * hd
    peak = BF16_FLOPS if dtype == torch.bfloat16 else F32_FLOPS
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / peak * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def turns_line(t: dict) -> str:
    return ", ".join(f"{k} {v['ms']:.4f} ms ({v['min_ms']:.4f}-{v['max_ms']:.4f})"
                     for k, v in t.items())


def phase_timing(gen: torch.Generator) -> dict:
    """The flash kernel at both main-path shapes, in interleaved rounds
    with the previous (mma.sync) kernel and SDPA; its plain version alone."""
    out = {}
    for S in (256, 64):
        B, H, hd, dt = 2 * BATCH, 16, 72, torch.bfloat16
        q, k, v = (randn(gen, (B, S, H, hd), dt) for _ in range(3))
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        kw = ops.kernel_kwargs(q, k, causal=False)
        t = interleaved_ms({
            "wgmma": lambda: flash_attention_cuda(q, k, v, **kw, variant="wgmma"),
            "mma": lambda: flash_attention_cuda(q, k, v, **kw, variant="mma"),
            "sdpa": lambda: F.scaled_dot_product_attention(qt, kt, vt)})
        plain = graph_ms(lambda: flash_attention_ref(q, k, v, causal=False))
        bound, by = attention_bound_ms(B, S, H, hd, dt)
        ms = t["wgmma"]["ms"]
        log(f"[time] flash_attention B{B} S{S} H{H} hd{hd} bf16, medians of "
            f"{t['wgmma']['rounds']} interleaved rounds (fastest-slowest): "
            f"{turns_line(t)}; plain {plain:.4f} ms; bound {bound:.4f} ms "
            f"({by}); {bound / ms:.1%} of the bound, {t['sdpa']['ms'] / ms:.2f}x "
            f"sdpa's speed, {t['mma']['ms'] / ms:.2f}x the mma kernel's")
        out[S] = dict(ms=ms, prev_ms=t["mma"]["ms"], plain_ms=plain,
                      library_ms=t["sdpa"]["ms"], bound_ms=bound, bound_by=by)
    return out[256]


def bound_ms(nbytes: float, flops: float, peak: float) -> tuple:
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / peak * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def phase_new_timing(gen: torch.Generator) -> dict:
    """Each new kernel at its path's shapes, the first shape listed being
    the one the kernels line reports. The kernels' wrappers are timed
    directly: the ops entries (which count launches) are not called."""
    out = {}
    kernels = {"patch_embed": (patch_embed_cuda, patch_embed_ref),
               "patch_deembed": (patch_deembed_cuda, patch_deembed_ref)}
    for name, shapes in PE_PATH.items():
        kernel, plain = kernels[name]
        for N, K, M in shapes:
            x, w, b = (randn(gen, shape, torch.bfloat16)
                       for shape in ((N, K), (K, M), (M,)))
            bound, by = bound_ms(2 * (N * K + K * M + M + N * M), 2 * N * K * M,
                                 BF16_FLOPS)
            plain_ms = graph_ms(lambda: plain(x, w, b))
            if name == "patch_deembed":
                # the redesigned kernel: interleaved with the previous one
                t = interleaved_ms({
                    "cluster": lambda: kernel(x, w, b, variant="cluster"),
                    "mma": lambda: kernel(x, w, b, variant="mma"),
                    "addmm": lambda: torch.addmm(b, x, w)})
                ms, lib = t["cluster"]["ms"], t["addmm"]["ms"]
                times = dict(prev_ms=t["mma"]["ms"])
                log(f"[time] {name} N{N} K{K} M{M} bf16, medians of "
                    f"{t['cluster']['rounds']} interleaved rounds (fastest-"
                    f"slowest): {turns_line(t)}; plain {plain_ms:.4f} ms; "
                    f"bound {bound:.4f} ms ({by}); {bound / ms:.1%} of the bound, "
                    f"{lib / ms:.2f}x addmm's speed, {t['mma']['ms'] / ms:.2f}x "
                    f"the mma kernel's")
            else:
                ms = graph_ms(lambda: kernel(x, w, b))
                lib = graph_ms(lambda: torch.addmm(b, x, w))
                times = {}
                log(f"[time] {name} N{N} K{K} M{M} bf16: kernel {ms:.4f} ms, plain "
                    f"{plain_ms:.4f} ms, addmm {lib:.4f} ms, bound {bound:.4f} ms "
                    f"({by}); {bound / ms:.1%} of the bound")
            out.setdefault(name, dict(ms=ms, **times, plain_ms=plain_ms,
                                      library_ms=lib, bound_ms=bound, bound_by=by))
    B, S, H, P, N, Q = SSD_PATH
    nc = S // Q
    for dt in (torch.bfloat16, torch.float32):
        x, dts, A, Bm, Cm = ssd_inputs(gen, B, S, H, P, N, dt)
        ms = graph_ms(lambda: ssd_chunk_cuda(x, dts, A, Bm, Cm, Q))
        plain_ms = graph_ms(lambda: ssd_chunk_ref(x, dts, A, Bm, Cm, Q), calls=3,
                            replays=3)
        isz = x.element_size()
        nbytes = (2 * B * S * H * P * isz + 4 * (B * S * H + H + 2 * B * S * N)
                  + 4 * (B * nc * H * P * N + B * nc * H))
        # multiply-adds the function needs: C.B and M.x over k <= q only
        tri = Q * (Q + 1) // 2
        flops = 2 * B * nc * (tri * N + H * tri * P + H * Q * P * N)
        bound, by = bound_ms(nbytes, flops, F32_FLOPS)
        log(f"[time] ssd_chunk B{B} S{S} H{H} P{P} N{N} Q{Q} x {str(dt)[6:]}: "
            f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bound:.4f} ms "
            f"({by}: {nbytes / 1e6:.1f} MB, {flops / 1e9:.3f} GFLOP at the f32 "
            f"CUDA-core peak); {bound / ms:.1%} of the bound")
        out.setdefault("ssd_chunk", dict(ms=ms, plain_ms=plain_ms, library_ms=None,
                                         bound_ms=bound, bound_by=by))
    return out


def main() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    log(f"[device] {torch.cuda.get_device_name(0)}; torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}")
    gen = torch.Generator(device=DEV).manual_seed(SEED)
    gen_new = torch.Generator(device=DEV).manual_seed(SEED + 1)
    phase_build()
    worst = phase_kernel_checks(gen, gen_new)
    worst_new = phase_new_kernel_checks(gen, gen_new)
    main_path = phase_main_path(gen)
    launches = phase_tokenizer(gen, main_path.pop("pipe"))
    launches.update(phase_mamba_layer(gen))
    times = phase_timing(gen)
    new_times = phase_new_timing(gen)
    kernels = [{
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/attention/flash_attention.py:46",
        "launches": main_path["launches"], "max_abs_err": worst,
        "ms": times["ms"], "prev_ms": times["prev_ms"], "plain_ms": times["plain_ms"],
        "bound_ms": times["bound_ms"], "bound_by": times["bound_by"],
        "library_ms": times["library_ms"]}]
    sources = {"patch_embed": ("patch_embed.cu", "patch_embed/patch_embed.py:25"),
               "patch_deembed": ("patch_embed.cu", "patch_embed/patch_embed.py:60"),
               "ssd_chunk": ("ssd_chunk.cu", "ssd/ssd_chunk.py:28")}
    for name, (src, tpu) in sources.items():
        kernels.append({"name": name, "route": "cuda",
                        "source": f"src/repro_torch/csrc/{src}",
                        "replaces": f"src/repro/kernels/{tpu}",
                        "launches": launches[name], "max_abs_err": worst_new[name],
                        **new_times[name]})
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
