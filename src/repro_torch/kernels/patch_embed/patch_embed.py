"""ctypes binding of the Hopper patch embed / de-embed kernels
(``csrc/patch_embed.cu``), which replace the Pallas TPU kernels
``repro.kernels.patch_embed.patch_embed._embed_kernel`` and
``_deembed_kernel``.

:func:`patch_embed_cuda` and :func:`patch_deembed_cuda` check what the
kernels take, allocate the output, and launch on PyTorch's current
stream. They raise when a launch is refused (the C entries return
``cudaGetLastError()``), never synchronise, and never fall back to another
kernel or to the plain version.

The de-embed has three variants, chosen by :func:`select_deembed_variant`
from the inputs alone: ``"cluster"`` (bf16, the split-K thread-block
cluster kernel on TMA and ``wgmma``, with the tile plan of
:func:`deembed_plan`), ``"mma"`` (bf16 shapes a tensor map cannot
describe, on ``mma.sync``) and ``"f32"`` (float32 on the CUDA cores). The
embed has three too, chosen by :func:`select_embed_variant`: ``"wgmma"``
(bf16, persistent CTAs on TMA loads, ``wgmma`` and a TMA-store epilogue,
with the tiles of :func:`embed_plan`), ``"mma"`` (the other bf16
shapes) and ``"f32"``.
"""
from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional

import torch

from repro_torch.kernels import build

SOURCE = "patch_embed.cu"
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
DEEMBED_VARIANTS = ("cluster", "mma", "f32")
EMBED_VARIANTS = ("wgmma", "mma", "f32")

ROW_TILE = 64              # wgmma m64
K_CHUNK = 64               # rows of one W box; K slices are whole chunks
MAX_CLUSTER = 8            # the portable cluster size
SMEM_LIMIT = 232448        # bytes of shared memory a block may use (227 KB)
EMBED_COL_TILE = 64        # columns of an embed tile (`ek::BN`)
# the largest K whose 2-stage X ring fits a CTA's shared memory (`ek::geo`;
# the C entry refuses what does not fit)
EMBED_MAX_K = 544


@dataclasses.dataclass(frozen=True)
class DeembedPlan:
    """Tiles of the split-K cluster de-embed: each CTA computes a
    row_tile x col_tile output tile over one k_slice of the contraction;
    ``cluster`` CTAs along K sum their partials in rank order."""
    row_tile: int
    col_tile: int
    cluster: int
    k_slice: int

    def ctas(self, N: int, M: int) -> int:
        return (self.cluster * -(-N // self.row_tile)
                * -(-M // self.col_tile))

    def smem_bytes(self) -> int:
        """Shared memory of one CTA, as ``dk::Cfg::smem`` counts it: the X
        and W slices, the float32 partial tile, the barrier, alignment."""
        return (self.k_slice * (self.row_tile + self.col_tile) * 2
                + self.row_tile * (self.col_tile + 4) * 4 + 8 + 1024)


def deembed_plan(N: int, K: int, M: int) -> Optional[DeembedPlan]:
    """The cluster kernel's tiles for x [N, K] · w [K, M], or None when
    the K slices it would need do not fit a CTA's shared memory.

    K is cut into 64-deep chunks spread over the fewest CTAs (at most 8)
    that leave each no more chunks than the largest cluster would, with
    no slice empty: K = 1152 gives 6 slices of 192. Columns go in tiles of
    64 (W in 64-column boxes) when M is a multiple of 64, else of 32."""
    chunks = -(-K // K_CHUNK)
    per = -(-chunks // MAX_CLUSTER)
    plan = DeembedPlan(row_tile=ROW_TILE, col_tile=64 if M % 64 == 0 else 32,
                       cluster=-(-chunks // per), k_slice=per * K_CHUNK)
    return plan if plan.smem_bytes() <= SMEM_LIMIT else None


def select_deembed_variant(dtype: torch.dtype, N: int, K: int, M: int,
                           aligned: bool) -> str:
    """The de-embed kernel for contiguous inputs of ``dtype``; ``aligned``:
    x's and w's bases are multiples of 16 bytes. A tensor map needs
    16-byte row strides and a box no wider than the matrix, so the cluster
    kernel takes bf16 with K and M multiples of 8, K >= 64 (one box of X
    is 64 columns) and a plan that fits."""
    if dtype == torch.float32:
        return "f32"
    if (dtype == torch.bfloat16 and K % 8 == 0 and M % 8 == 0 and K >= K_CHUNK
            and aligned and deembed_plan(N, K, M) is not None):
        return "cluster"
    return "mma"


def deembed_variant_of(x: torch.Tensor, w: torch.Tensor) -> str:
    """:func:`select_deembed_variant` for these tensors."""
    return select_deembed_variant(x.dtype, x.shape[0], x.shape[1], w.shape[1],
                                  all(t.data_ptr() % 16 == 0 for t in (x, w)))


@dataclasses.dataclass(frozen=True)
class EmbedPlan:
    """Tiles of the persistent TMA/``wgmma`` embed: ``row_tiles`` x
    ``col_tiles`` output tiles of ``row_tile`` x ``col_tile``. The C entry
    sizes the grid on the card, from its own occupancy query: as many CTAs
    as the SMs hold, at most one a tile, each owning one column tile and
    walking row tiles (:func:`embed_launch_plan` reports it)."""
    row_tile: int
    col_tile: int
    row_tiles: int
    col_tiles: int

    @property
    def tiles(self) -> int:
        return self.row_tiles * self.col_tiles


def embed_plan(N: int, K: int, M: int) -> Optional[EmbedPlan]:
    """The persistent embed's tiles for x [N, K] · w [K, M], or None when K
    is past :data:`EMBED_MAX_K`. At DiT-XL/2 (B = 8, d = 1152): mode 0
    (N 2048, K 16) 32 x 18 = 576 tiles; mode 1 (N 512, K 64) 8 x 18 =
    144 tiles."""
    if K > EMBED_MAX_K:
        return None
    return EmbedPlan(row_tile=ROW_TILE, col_tile=EMBED_COL_TILE,
                     row_tiles=-(-N // ROW_TILE),
                     col_tiles=-(-M // EMBED_COL_TILE))


def embed_launch_plan(N: int, K: int, M: int) -> tuple[int, int, int]:
    """(CTAs, X stages, shared-memory bytes) the ``wgmma`` embed launches
    with for these sizes on the current CUDA card (``ek::plan``)."""
    lib = bind(build.load(SOURCE))
    out = [ctypes.c_int() for _ in range(3)]
    err = lib.patch_embed_wgmma_plan(N, K, M, *(ctypes.byref(v) for v in out))
    if err != 0:
        raise ValueError(f"no wgmma embed plan for N{N} K{K} M{M}: CUDA error {err}")
    return tuple(v.value for v in out)


def select_embed_variant(dtype: torch.dtype, N: int, K: int, M: int,
                         aligned: bool) -> str:
    """The embed kernel for contiguous inputs of ``dtype``; ``aligned``:
    x's, w's and b's bases are multiples of 16 bytes (the bias comes by a
    bulk copy). The TMA/``wgmma`` kernel takes bf16 with K and M multiples
    of 8 (16-byte rows for the tensor maps) and K no larger than
    :data:`EMBED_MAX_K` (its X ring fits a CTA)."""
    if dtype == torch.float32:
        return "f32"
    if (dtype == torch.bfloat16 and K % 8 == 0 and M % 8 == 0 and aligned
            and embed_plan(N, K, M) is not None):
        return "wgmma"
    return "mma"


def embed_variant_of(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> str:
    """:func:`select_embed_variant` for these tensors."""
    return select_embed_variant(x.dtype, x.shape[0], x.shape[1], w.shape[1],
                                all(t.data_ptr() % 16 == 0 for t in (x, w, b)))


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C entry points' signatures on a loaded library."""
    p, i, ip = ctypes.c_void_p, ctypes.c_int, ctypes.POINTER(ctypes.c_int)
    plain = [p, p, p, p, i, i, i, i, i, p]   # x w b out dtype N K M vec stream
    signatures = {
        "patch_embed_fwd": plain,
        "patch_deembed_fwd": plain,
        "patch_deembed_cluster_fwd": [p, p, p, p, i, i, i,   # x w b out N K M
                                      i, i, i, p],   # col_tile cluster k_slice stream
        "patch_embed_wgmma_fwd": [p, p, p, p, i, i, i, p],   # x w b out N K M stream
        "patch_embed_wgmma_plan": [i, i, i, ip, ip, ip],     # N K M -> ctas stages smem
    }
    for name, argtypes in signatures.items():
        fn = getattr(lib, name)
        if fn.argtypes is None:
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
    return lib


def _launch(entry: str, x: torch.Tensor, w: torch.Tensor,
            b: torch.Tensor, variant: str = "mma") -> torch.Tensor:
    """out[N, M] = x[N, K] · w[K, M] + b[M] through the C entry ``entry``
    (the de-embed's ``"cluster"`` and the embed's ``"wgmma"`` variants
    through their own entries)."""
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
    if (variant == "f32") != (x.dtype == torch.float32):
        raise ValueError(f"{entry}: variant {variant!r} does not take {x.dtype}")
    lib = bind(build.load(SOURCE))
    with torch.cuda.device(x.device):
        if variant == "cluster":
            plan = deembed_plan(N, K, M)
            if plan is None:
                raise ValueError(f"no cluster plan for N{N} K{K} M{M}")
            err = lib.patch_deembed_cluster_fwd(
                x.data_ptr(), w.data_ptr(), b.data_ptr(), out.data_ptr(), N, K,
                M, plan.col_tile, plan.cluster, plan.k_slice, stream)
        elif variant == "wgmma":
            err = lib.patch_embed_wgmma_fwd(
                x.data_ptr(), w.data_ptr(), b.data_ptr(), out.data_ptr(), N, K,
                M, stream)
        else:
            err = getattr(lib, entry)(
                x.data_ptr(), w.data_ptr(), b.data_ptr(), out.data_ptr(),
                _DTYPES[x.dtype], N, K, M, vec, stream)
    if err != 0:
        raise RuntimeError(f"{entry} {variant} kernel launch failed: CUDA "
                           f"error {err}")
    return out


def patch_embed_cuda(patches: torch.Tensor, w: torch.Tensor,
                     b: torch.Tensor,
                     variant: Optional[str] = None) -> torch.Tensor:
    """patches: [N, K] (K = p_f·p_h·p_w·c); w: [K, d]; b: [d] → [N, d].

    ``variant`` (default: :func:`embed_variant_of` the inputs) forces one
    kernel, for timing and tests."""
    variant = variant or embed_variant_of(patches, w, b)
    if variant not in EMBED_VARIANTS:
        raise ValueError(f"unknown embed variant {variant!r}")
    return _launch("patch_embed_fwd", patches, w, b, variant)


def patch_deembed_cuda(tokens: torch.Tensor, w: torch.Tensor,
                       b: torch.Tensor,
                       variant: Optional[str] = None) -> torch.Tensor:
    """tokens: [N, d]; w: [d, K_out]; b: [K_out] → [N, K_out].

    ``variant`` (default: :func:`deembed_variant_of` the inputs) forces one
    kernel, for timing and tests."""
    variant = variant or deembed_variant_of(tokens, w)
    if variant not in DEEMBED_VARIANTS:
        raise ValueError(f"unknown de-embed variant {variant!r}")
    return _launch("patch_deembed_fwd", tokens, w, b, variant)
