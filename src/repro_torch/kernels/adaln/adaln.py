"""ctypes binding of the fused adaLN kernels (``csrc/adaln.cu``), which
replace no Pallas kernel: the JAX package leaves the DiT block's
LayerNorm, modulation and gated residuals to XLA's fusion.

:func:`adaln_cuda` checks what the kernel takes, allocates the outputs,
plans the launch (:func:`launch_plan`) and launches on PyTorch's current
stream. It raises when the launch is refused (the C entry returns
``cudaGetLastError()``). It never synchronises and never falls back to
the plain version.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Optional, Tuple

import torch

from repro_torch.kernels import build

SOURCE = "adaln.cu"
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_D = 8192              # the widest row the kernel takes
# 4-element chunks a thread holds of one row, by element size (bf16, float32)
MAX_CHUNKS = {2: 12, 4: 8}
ROW_THREADS = (32, 64, 128, 256)
CTA_THREADS = 256
THREADS_PER_SM = 512      # in flight: 16 warps an SM
# the torch release whose CUDA reduce kernel's order of a row's sums the
# kernel's LayerNorm follows (a warp a row, 128 < d): another release may
# sum in another order, and then h differs from the plain chain by an ulp
REDUCE_ORDER_TORCH = "2.11"


@dataclasses.dataclass(frozen=True)
class LaunchPlan:
    """How the kernel covers ``n_tok`` rows of ``d``: ``row_threads``
    threads share a token's row, thread l holding its 4-element chunks l,
    l + row_threads, ... (``chunks`` of them at most); a row group walks
    ``tok_per_group`` consecutive tokens; a CTA holds ``groups_per_cta`` row
    groups; ``grid`` CTAs."""
    row_threads: int
    chunks: int
    groups_per_cta: int
    tok_per_group: int
    grid: int


def check_width(d: int) -> None:
    """Raise on a row width the kernel does not take."""
    if d <= 0 or d % 8 or d > MAX_D:
        raise ValueError(f"the adaLN kernel takes d a multiple of 8 up to "
                         f"{MAX_D}, got {d}")


def launch_plan(n_tok: int, d: int, itemsize: int, sms: int) -> LaunchPlan:
    """The launch for ``n_tok`` rows of ``d`` elements of ``itemsize``
    bytes on a card of ``sms`` SMs: the narrowest row group whose threads
    hold the row in at most :data:`MAX_CHUNKS` chunks each (one warp up to
    d = 1,536 in bf16 and 1,024 in float32; where a warp holds a row of
    128 < d, LN's sums follow PyTorch's order), runs of tokens sized so
    that about :data:`THREADS_PER_SM` threads an SM are in flight, and
    CTAs (of warp-wide groups) small enough to spread over every SM.
    Raises on a d the kernel does not take."""
    check_width(d)
    nch = d // 4
    row_threads = next(t for t in ROW_THREADS
                       if -(-nch // t) <= MAX_CHUNKS[itemsize])
    chunks = -(-nch // row_threads)
    in_flight = max(1, sms * THREADS_PER_SM // row_threads)
    tok_per_group = max(1, -(-n_tok // in_flight))
    groups = -(-n_tok // tok_per_group)
    per_cta = 1 if row_threads > 32 else max(
        1, min(CTA_THREADS // row_threads, -(-groups // sms)))
    return LaunchPlan(row_threads, chunks, per_cta, tok_per_group,
                      -(-groups // per_cta))


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C entry points' signatures on a loaded library."""
    fn = lib.adaln_fwd
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, p, p,          # x y table token_idx x_out h_out
                       i, i, i, i, i,             # dtype n_tok d ld rows
                       i, i, i,                   # gate shift scale columns
                       i, i, i, i, i, p]          # the plan, stream
        fn.restype = ctypes.c_int
    return lib


def _lib() -> ctypes.CDLL:
    return bind(build.load(SOURCE))


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def adaln_cuda(x: torch.Tensor, table: torch.Tensor, token_idx: torch.Tensor,
               *, y: Optional[torch.Tensor] = None,
               gate_col: Optional[int] = None,
               shift_col: Optional[int] = None,
               scale_col: Optional[int] = None
               ) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]:
    """Launch on contiguous CUDA tensors x [..., d] and y like x (float32
    or bfloat16), table [rows, k * d] in x's dtype, token_idx [...] int64
    (values in [0, rows): the kernel traps on any other). With ``y`` and
    ``gate_col``, the residual x' = x + gate * y; with ``shift_col`` and
    ``scale_col``, the norm h = LN(x') * (1 + scale) + shift (x' = x
    without a residual). Returns (x' or None, h or None), new tensors."""
    residual, norm = y is not None, shift_col is not None
    if residual != (gate_col is not None) or norm != (scale_col is not None):
        raise ValueError("give y with gate_col, and shift_col with scale_col")
    if not (residual or norm):
        raise ValueError("nothing to compute: give a residual or a norm")
    if x.dtype not in _DTYPES:
        raise TypeError(f"the adaLN kernel takes float32 or bfloat16, got {x.dtype}")
    d = x.shape[-1]
    check_width(d)
    if table.dim() != 2 or table.shape[1] % d:
        raise ValueError(f"table {tuple(table.shape)} is not [rows, k * {d}]")
    k = table.shape[1] // d
    for name, col in (("gate_col", gate_col), ("shift_col", shift_col),
                      ("scale_col", scale_col)):
        if col is not None and not 0 <= col < k:
            raise ValueError(f"{name} {col} is not a column chunk of {k}")
    if tuple(token_idx.shape) != tuple(x.shape[:-1]):
        raise ValueError(f"token_idx {tuple(token_idx.shape)} != "
                         f"{tuple(x.shape[:-1])}")
    if token_idx.dtype != torch.int64:
        raise TypeError(f"token_idx must be int64, got {token_idx.dtype}")
    named = [("x", x), ("table", table), ("token_idx", token_idx)]
    if residual:
        if y.shape != x.shape:
            raise ValueError(f"y {tuple(y.shape)} != x {tuple(x.shape)}")
        named.append(("y", y))
    for name, t in named:
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if t is not token_idx and t.dtype != x.dtype:
            raise TypeError(f"{name} is {t.dtype}, x {x.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t is not token_idx and t.data_ptr() % 16:
            raise ValueError(f"{name} must start at a 16-byte aligned address")
    x_out = torch.empty_like(x) if residual else None
    h = torch.empty_like(x) if norm else None
    n_tok = x.numel() // d
    if n_tok == 0:
        return x_out, h
    plan = launch_plan(n_tok, d, x.element_size(), _sms(x.device.index))
    ptrs = [None if t is None else t.data_ptr()
            for t in (x, y, table, token_idx, x_out, h)]
    cols = [-1 if c is None else c for c in (gate_col, shift_col, scale_col)]
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        err = _lib().adaln_fwd(
            *ptrs, _DTYPES[x.dtype], n_tok, d, table.shape[1], table.shape[0],
            *cols, plan.row_threads, plan.chunks, plan.groups_per_cta,
            plan.tok_per_group, plan.grid, stream)
    if err != 0:
        raise RuntimeError(f"adaLN kernel launch failed: CUDA error {err}")
    return x_out, h
