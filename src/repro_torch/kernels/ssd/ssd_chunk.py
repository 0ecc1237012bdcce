"""ctypes binding of the Hopper SSD intra-chunk kernel
(``csrc/ssd_chunk.cu``), which replaces the Pallas TPU kernel
``repro.kernels.ssd.ssd_chunk._ssd_kernel``.

:func:`ssd_chunk_cuda` checks what the kernel takes, allocates the three
outputs, and launches on PyTorch's current stream. It raises when the
launch is refused (the C entries return ``cudaGetLastError()``). It never
synchronises and never falls back to another kernel or to the plain
version.

Two variants, chosen by :func:`select_ssd_variant` from the inputs alone:
``"wgmma"`` (bf16 x; y and Sc on the tensor cores in split-bf16 pieces
that keep float32-level error, x by TMA) and ``"simt"`` (float32 on the
CUDA cores; every other shape, and float32 x).
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.kernels import build

SOURCE = "ssd_chunk.cu"
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
SSD_VARIANTS = ("wgmma", "simt")
# what the wgmma kernel takes: head dims (one x box of 64 columns in the
# 128-byte swizzle, or 32 in the 64-byte), states (one or two warpgroups of
# Sc^T rows) and chunks (one or two warpgroups of y rows)
WGMMA_P = (32, 64)
WGMMA_N = (64, 128)
WGMMA_Q = (64, 128)


def select_ssd_variant(dtype: torch.dtype, S: int, H: int, P: int, N: int,
                       chunk: int, aligned: bool) -> str:
    """The kernel for contiguous inputs with x of ``dtype`` [B, S, H, P]
    and B/C of N states; ``aligned``: x's, Bm's and Cm's bases are
    multiples of 16 bytes (x comes by TMA, B and C by 16-byte copies).
    The wgmma kernel takes bf16 x with P, N and the chunk among
    :data:`WGMMA_P`, :data:`WGMMA_N`, :data:`WGMMA_Q`; its shared memory
    (~190 KB at P = 64) fits at each of them."""
    if (dtype == torch.bfloat16 and P in WGMMA_P and N in WGMMA_N
            and chunk in WGMMA_Q and S % chunk == 0 and H > 0 and aligned):
        return "wgmma"
    return "simt"


def ssd_variant_of(x: torch.Tensor, Bm: torch.Tensor, Cm: torch.Tensor,
                   chunk: int) -> str:
    """:func:`select_ssd_variant` for these tensors."""
    B, S, H, P = x.shape
    return select_ssd_variant(x.dtype, S, H, P, Bm.shape[-1], chunk,
                              all(t.data_ptr() % 16 == 0 for t in (x, Bm, Cm)))


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C entry points' signatures on a loaded library."""
    fn = lib.ssd_chunk_fwd
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, p,          # x dt A Bm Cm
                       p, p, p,                # y sc ltot
                       i, i, i, i, i, i, i,    # dtype B S H P N chunk
                       i, p]                   # heads per block, stream
        fn.restype = ctypes.c_int
        lib.ssd_chunk_wgmma_fwd.argtypes = [p, p, p, p, p, p, p, p,   # x .. ltot
                                            i, i, i, i, i, i,   # B S H P N chunk
                                            i, p]               # heads per block, stream
        lib.ssd_chunk_wgmma_fwd.restype = ctypes.c_int
        lib.ssd_chunk_limits.argtypes = [ctypes.POINTER(ctypes.c_int)]
        lib.ssd_chunk_limits.restype = None
    return lib


def _lib() -> ctypes.CDLL:
    return bind(build.load(SOURCE))


def limits() -> Tuple[int, int, int]:
    """The largest (chunk, head_dim P, state N) the kernel takes."""
    out = (ctypes.c_int * 3)()
    _lib().ssd_chunk_limits(out)
    return tuple(out)


def heads_per_block(batch_chunks: int, H: int, sms: int) -> int:
    """Heads one block walks: split the heads so that the blocks fill the
    card's SMs about once (one block per SM: either kernel's shared
    memory is ~190-205 KB)."""
    groups = max(1, min(H, sms // max(1, batch_chunks)))
    return -(-H // groups)


def ssd_chunk_cuda(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                   Bm: torch.Tensor, Cm: torch.Tensor, chunk: int,
                   variant: Optional[str] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch a kernel on contiguous CUDA tensors x [B,S,H,P] (float32 or
    bfloat16), dt [B,S,H], A [H], Bm/Cm [B,S,N] (float32), S a multiple of
    ``chunk``. Returns (y_intra [B,S,H,P] in x's dtype, Sc [B,nc,H,P,N]
    float32, Ltot [B,nc,H] float32). ``variant`` forces one of
    :data:`SSD_VARIANTS` (timing and tests); by default the inputs select
    it. A forced variant that does not take the inputs raises."""
    if x.dim() != 4:
        raise ValueError(f"x must be [B, S, H, P], got {tuple(x.shape)}")
    B, S, H, P = x.shape
    N = Bm.shape[-1]
    if x.dtype not in _DTYPES:
        raise TypeError(f"ssd_chunk takes float32 or bfloat16 x, got {x.dtype}")
    shapes = {"dt": (dt, (B, S, H)), "A": (A, (H,)), "Bm": (Bm, (B, S, N)),
              "Cm": (Cm, (B, S, N))}
    for name, (t, shape) in shapes.items():
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} {tuple(t.shape)} != {shape}")
    for name, t in [("x", x)] + [(n, t) for n, (t, _) in shapes.items()]:
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if chunk <= 0 or S % chunk:
        raise ValueError(f"S={S} is not a multiple of the chunk {chunk}")
    q_max, p_max, n_max = limits()
    if chunk > q_max or P > p_max or N > n_max:
        raise ValueError(f"chunk {chunk}, head_dim {P}, state {N} exceed the "
                         f"kernel's limits {q_max}, {p_max}, {n_max}")
    # the kernel copies whole 16-byte chunks: x rows, B and C rows, Sc rows
    if (P * x.element_size()) % 16 or N % 4:
        raise ValueError(f"head_dim {P} ({x.dtype}) must fill whole 16-byte "
                         f"rows and state {N} be a multiple of 4")
    if any(t.data_ptr() % 16 for t in (x, Bm, Cm)):
        raise ValueError("x, Bm and Cm must start at 16-byte aligned addresses")
    chosen = ssd_variant_of(x, Bm, Cm, chunk)
    variant = variant or chosen
    if variant not in SSD_VARIANTS:
        raise ValueError(f"unknown ssd_chunk variant {variant!r}")
    if variant == "wgmma" and chosen != "wgmma":
        raise ValueError(f"the wgmma kernel does not take x {x.dtype} P{P} N{N} "
                         f"chunk {chunk} (or an unaligned base)")
    nc = S // chunk
    y = torch.empty_like(x)
    sc = torch.empty((B, nc, H, P, N), dtype=torch.float32, device=x.device)
    ltot = torch.empty((B, nc, H), dtype=torch.float32, device=x.device)
    if y.numel() == 0:
        return y, sc, ltot
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    hpb = heads_per_block(B * nc, H, sms)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    ptrs = (x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),
            Cm.data_ptr(), y.data_ptr(), sc.data_ptr(), ltot.data_ptr())
    with torch.cuda.device(x.device):
        lib = _lib()
        if variant == "wgmma":
            err = lib.ssd_chunk_wgmma_fwd(*ptrs, B, S, H, P, N, chunk, hpb, stream)
        else:
            err = lib.ssd_chunk_fwd(*ptrs, _DTYPES[x.dtype], B, S, H, P, N,
                                    chunk, hpb, stream)
    if err != 0:
        raise RuntimeError(f"ssd_chunk {variant} kernel launch failed: "
                           f"CUDA error {err}")
    return y, sc, ltot
