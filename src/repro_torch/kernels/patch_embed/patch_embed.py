"""ctypes binding of the Hopper patch embed / de-embed kernels
(``csrc/patch_embed.cu``), which replace the Pallas TPU kernels
``repro.kernels.patch_embed.patch_embed._embed_kernel`` and
``_deembed_kernel``.

:func:`patch_embed_cuda` and :func:`patch_deembed_cuda` check what the
kernels take, allocate the output, and launch on PyTorch's current
stream. They raise when a launch is refused (the C entries return
``cudaGetLastError()``), never synchronise, and never fall back to the
plain version.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

SOURCE = "patch_embed.cu"
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C entry points' signatures on a loaded library."""
    for name in ("patch_embed_fwd", "patch_deembed_fwd"):
        fn = getattr(lib, name)
        if fn.argtypes is None:
            p, i = ctypes.c_void_p, ctypes.c_int
            fn.argtypes = [p, p, p, p,          # x w b out
                           i, i, i, i, i,       # dtype N K M vec
                           p]                   # stream
            fn.restype = ctypes.c_int
    return lib


def _launch(entry: str, x: torch.Tensor, w: torch.Tensor,
            b: torch.Tensor) -> torch.Tensor:
    """out[N, M] = x[N, K] · w[K, M] + b[M] through the C entry ``entry``."""
    if x.dtype not in _DTYPES or w.dtype != x.dtype or b.dtype != x.dtype:
        raise TypeError(f"{entry} takes float32 or bfloat16 x/w/b of one dtype, "
                        f"got {x.dtype}/{w.dtype}/{b.dtype}")
    if x.dim() != 2 or w.dim() != 2 or b.dim() != 1 or w.shape[0] != x.shape[1] \
            or b.shape[0] != w.shape[1]:
        raise ValueError(f"bad shapes x{tuple(x.shape)} w{tuple(w.shape)} "
                         f"b{tuple(b.shape)}: want [N,K], [K,M], [M]")
    for name, t in (("x", x), ("w", w), ("b", b)):
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    N, K = x.shape
    M = w.shape[1]
    out = torch.empty((N, M), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    # rows of whole 16-byte chunks at 16-byte aligned bases: cp.async staging
    vec = int(K % 8 == 0 and M % 8 == 0
              and all(t.data_ptr() % 16 == 0 for t in (x, w)))
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        err = getattr(bind(build.load(SOURCE)), entry)(
            x.data_ptr(), w.data_ptr(), b.data_ptr(), out.data_ptr(),
            _DTYPES[x.dtype], N, K, M, vec, stream)
    if err != 0:
        raise RuntimeError(f"{entry} kernel launch failed: CUDA error {err}")
    return out


def patch_embed_cuda(patches: torch.Tensor, w: torch.Tensor,
                     b: torch.Tensor) -> torch.Tensor:
    """patches: [N, K] (K = p_f·p_h·p_w·c); w: [K, d]; b: [d] → [N, d]."""
    return _launch("patch_embed_fwd", patches, w, b)


def patch_deembed_cuda(tokens: torch.Tensor, w: torch.Tensor,
                       b: torch.Tensor) -> torch.Tensor:
    """tokens: [N, d]; w: [d, K_out]; b: [K_out] → [N, K_out]."""
    return _launch("patch_deembed_fwd", tokens, w, b)
