"""ctypes binding of the Hopper flash-attention kernels
(``csrc/flash_attention.cu``), which replace the Pallas TPU kernel
``repro.kernels.attention.flash_attention._flash_kernel``.

Three variants of one function, chosen by :func:`select_variant` from the
inputs alone:

- ``"wgmma"``: bf16 on TMA, mbarriers and ``wgmma`` (hd a multiple of 8 up
  to 128, 16-byte aligned bases: what a tensor map can describe);
- ``"mma"``: bf16 on ``mma.sync`` with cp.async staging, for the bf16
  shapes a tensor map cannot describe (hd = 70, say);
- ``"f32"``: float32 on the CUDA cores, so float32 keeps its accuracy.

:func:`flash_attention_cuda` checks what the kernel takes, allocates the
output, and launches on PyTorch's current stream. It raises when the
launch is refused (the C entry returns ``cudaGetLastError()``). It never
synchronises and never falls back to another variant or to the plain
version.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from repro_torch.kernels import build

SOURCE = "flash_attention.cu"
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
VARIANTS = {"f32": 0, "mma": 1, "wgmma": 2}
MAX_HEAD_DIM = 128


def select_variant(dtype: torch.dtype, hd: int, aligned: bool) -> str:
    """The kernel variant for contiguous q/k/v of ``dtype`` and head width
    ``hd``; ``aligned``: every base address is a multiple of 16 bytes.
    A tensor map needs 16-byte row strides and bases, so the TMA/wgmma
    kernel takes bf16 rows of whole 16-byte chunks (hd % 8 == 0)."""
    if dtype == torch.float32:
        return "f32"
    if dtype == torch.bfloat16 and hd % 8 == 0 and hd <= MAX_HEAD_DIM and aligned:
        return "wgmma"
    return "mma"


def variant_of(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> str:
    """:func:`select_variant` for these tensors."""
    return select_variant(q.dtype, q.shape[-1],
                          all(t.data_ptr() % 16 == 0 for t in (q, k, v)))


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C entry points' signatures on a loaded library."""
    fn = lib.flash_attention_fwd
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, p, p,              # q k v o seg bmap
                       i, i, i, i, i, i, i,           # dtype B S Sk H K hd
                       i, ctypes.c_float, i, ctypes.c_float,  # causal softcap window scale
                       i, i, i, i,                    # map bq bk nq nk
                       i, i, p]                       # vec variant stream
        fn.restype = ctypes.c_int
    return lib


def _lib() -> ctypes.CDLL:
    return bind(build.load(SOURCE))


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                         causal: bool, softcap: float, window: int,
                         segment_ids: Optional[torch.Tensor],
                         block_map: Optional[torch.Tensor],
                         block_q: int, block_k: int,
                         variant: Optional[str] = None) -> torch.Tensor:
    """Launch the kernel on CUDA tensors q [B,S,H,hd], k/v [B,Sk,K,hd].

    ``variant`` (default: :func:`variant_of` the inputs) forces one kernel,
    for timing and tests; the C entry refuses one that does not take the
    inputs."""
    B, S, H, hd = q.shape
    Sk, K = k.shape[1], k.shape[2]
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention takes float32 or bfloat16 q/k/v of "
                        f"one dtype, got {q.dtype}/{k.dtype}/{v.dtype}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous [B, S, heads, hd]")
    if k.shape != v.shape or k.shape[0] != B or k.shape[3] != hd or H % K:
        raise ValueError(f"bad shapes q{tuple(q.shape)} k{tuple(k.shape)} "
                         f"v{tuple(v.shape)}")
    if hd > MAX_HEAD_DIM:
        raise ValueError(f"head_dim {hd} exceeds the kernel's limit {MAX_HEAD_DIM}")
    variant = variant or variant_of(q, k, v)
    if variant not in VARIANTS:
        raise ValueError(f"unknown flash_attention variant {variant!r}")
    seg_ptr = map_ptr = None
    map_bq, map_bk = min(block_q, S), min(block_k, Sk)
    map_nq, map_nk = -(-S // map_bq), -(-Sk // map_bk)
    if segment_ids is not None:
        segment_ids = segment_ids.to(device=q.device,
                                     dtype=torch.int32).contiguous()
        seg_ptr = segment_ids.data_ptr()
    if block_map is not None:
        block_map = block_map.to(device=q.device, dtype=torch.int32).contiguous()
        if tuple(block_map.shape) != (B, map_nq, map_nk):
            raise ValueError(f"block_map {tuple(block_map.shape)} != "
                             f"{(B, map_nq, map_nk)}")
        map_ptr = block_map.data_ptr()
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    # rows of whole 16-byte chunks at 16-byte aligned bases: vector staging
    vec = int((hd * q.element_size()) % 16 == 0
              and all(t.data_ptr() % 16 == 0 for t in (q, k, v)))
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        err = _lib().flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            seg_ptr, map_ptr, _DTYPES[q.dtype], B, S, Sk, H, K, hd,
            int(causal), float(softcap), int(window), 1.0 / math.sqrt(hd),
            map_bq, map_bk, map_nq, map_nk, vec, VARIANTS[variant], stream)
    if err != 0:
        raise RuntimeError(f"flash_attention {variant} kernel launch failed: "
                           f"CUDA error {err}")
    return out
