"""Packed inference (App. B.2, Fig. 12): uniform and mixed-mode packs, the
port of ``repro.core.packing``.

Segments of different patch modes (different token counts) share fixed
capacity rows; segment ids keep attention block-diagonal, so every
segment's output equals its unpacked forward. :func:`packed_mixed_forward`
is what the serving engine runs every step (``pipeline/packed.py``);
:func:`packed_weak_forward` is the uniform special case. Row assembly is
static per layout: it is planned once on the host (:func:`_pack_plan`,
memoised; its index tensors are copied to the device once) and executed
as one gather per stream on the device. The FLOPs ledger
(:func:`packing_cost`, :func:`packed_row_flops`, :func:`mixed_pack_cost`)
is the reference's host arithmetic, term for term.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.core.scheduler import dit_block_flops, dit_nfe_flops
from repro_torch.kernels.adaln import ops as adaln_ops
from repro_torch.kernels.attention import costing
from repro_torch.kernels.attention import ops as attn_ops
from repro_torch.models import attention as attn_mod
from repro_torch.models import dit as dit_mod
from repro_torch.models.common import dtype_of
from repro_torch.runtime import graphs


def pack_ratio(cfg: ModelConfig, mode: int) -> int:
    """How many mode-``mode`` sequences fit in one powerful-length row."""
    return dit_mod.tokens_for_mode(cfg, 0) // dit_mod.tokens_for_mode(cfg, mode)


# ---------------------------------------------------------------------------
# Static row assembly (shared by execution and cost accounting)


def assign_rows(seg_tokens: Sequence[int], capacity: int) -> List[List[int]]:
    """First-fit-decreasing bin packing: place segments (by token count)
    into rows of ``capacity`` tokens; a segment never splits across rows.
    Returns rows of segment *indices* (into ``seg_tokens``)."""
    for i, n in enumerate(seg_tokens):
        if n > capacity:
            raise ValueError(f"segment {i} ({n} tokens) exceeds row "
                             f"capacity {capacity}")
    order = sorted(range(len(seg_tokens)), key=lambda i: -seg_tokens[i])
    rows: List[List[int]] = []
    free: List[int] = []
    for i in order:
        n = seg_tokens[i]
        for r, rem in enumerate(free):
            if rem >= n:
                rows[r].append(i)
                free[r] = rem - n
                break
        else:
            rows.append([i])
            free.append(capacity - n)
    for row in rows:                 # deterministic within-row order
        row.sort()
    return rows


@dataclasses.dataclass(frozen=True)
class _PackPlan:
    """Host-side index plan of one pack (numpy, memoised per shape).

    ``gather``: [R*C] index into the flat token stream of all segments
    (segment-major, then token) with one trailing zero row for padding;
    ``segment_ids``: [R, C] int32 (-1 padding); ``token_idx``: [R, C]
    index of each token's segment (n_seg = padding); ``outs[g]``: [n_g*N_g]
    flat packed positions of group g's tokens, in segment order."""
    rows: int
    capacity: int
    n_seg: int
    gather: np.ndarray
    segment_ids: np.ndarray
    token_idx: np.ndarray
    outs: Tuple[np.ndarray, ...]


@functools.lru_cache(maxsize=256)
def _pack_plan(group_tokens: Tuple[Tuple[int, int], ...],
               capacity: int) -> _PackPlan:
    """``group_tokens``: ((tokens per segment, n segments), ...) per group."""
    segs: List[Tuple[int, int, int]] = []
    for g, (n_tok, n) in enumerate(group_tokens):
        segs.extend((g, i, n_tok) for i in range(n))
    n_seg = len(segs)
    rows = assign_rows([s[2] for s in segs], capacity)
    starts = np.cumsum([0] + [s[2] for s in segs])
    zero_row = int(starts[-1])
    R = len(rows)
    gather = np.full((R, capacity), zero_row, np.int64)
    seg_ids = np.full((R, capacity), -1, np.int32)
    token_idx = np.full((R, capacity), n_seg, np.int64)
    placement: Dict[Tuple[int, int], int] = {}
    sid = 0
    for r, row in enumerate(rows):
        off = 0
        for si in row:
            g, i, n = segs[si]
            gather[r, off:off + n] = np.arange(starts[si], starts[si] + n)
            seg_ids[r, off:off + n] = sid
            token_idx[r, off:off + n] = si
            placement[(g, i)] = r * capacity + off
            sid += 1
            off += n
    outs = []
    for g, (n_tok, n) in enumerate(group_tokens):
        idx = [np.arange(placement[(g, i)], placement[(g, i)] + n_tok)
               for i in range(n)]
        outs.append(np.concatenate(idx) if idx else np.zeros(0, np.int64))
    return _PackPlan(rows=R, capacity=capacity, n_seg=n_seg,
                     gather=gather.reshape(-1), segment_ids=seg_ids,
                     token_idx=token_idx, outs=tuple(outs))


@functools.lru_cache(maxsize=256)
def _device_plan(group_tokens: Tuple[Tuple[int, int], ...], capacity: int,
                 device: torch.device) -> Tuple[Any, ...]:
    """The plan and its index tensors on ``device``, copied there once per
    pack shape (a layout replayed across steps reuses them)."""
    plan = _pack_plan(group_tokens, capacity)
    return (plan, torch.from_numpy(plan.gather).to(device),
            torch.from_numpy(plan.segment_ids).to(device),
            torch.from_numpy(plan.token_idx).to(device),
            *(torch.from_numpy(o).to(device) for o in plan.outs))


def _host_flags(flags: Any) -> np.ndarray:
    """Refresh flags are host data: numpy, lists, or a CPU tensor. A CUDA
    tensor would need a device read (a sync) to decide the deep-block
    branch, so it is refused."""
    if isinstance(flags, torch.Tensor):
        if flags.device.type != "cpu":
            raise ValueError("cache_refresh flags are host data (numpy); "
                             "reading them from the device would sync")
        flags = flags.numpy()
    return np.asarray(flags, bool).reshape(-1)


# ---------------------------------------------------------------------------
# Packed forwards


def packed_mixed_forward(params: Any, cfg: ModelConfig,  # repro: traced
                         groups: Tuple[Tuple[int, int], ...],
                         xs: Sequence[torch.Tensor], ts: Sequence[torch.Tensor],
                         conds: Sequence[torch.Tensor], *,
                         row_capacity: Optional[int] = None,
                         cache_deltas: Optional[Sequence[torch.Tensor]] = None,
                         cache_refresh: Optional[Sequence[Any]] = None,
                         cache_split: Optional[int] = None,
                         cache_deep: Optional[bool] = None,
                         attn_backend: str = "auto") -> Any:
    """Run NFEs for segments of (possibly) different patch modes packed
    token-wise into fixed-capacity rows.

    ``groups``: static ``((mode, n_segments), ...)``, one entry per mode;
    ``xs[g]``: [n_g, F, H, W, C] latents; ``ts[g]``: [n_g] timesteps;
    ``conds[g]``: [n_g] class labels. Rows of ``row_capacity`` tokens
    (default: the mode-0 sequence length) are filled first-fit-decreasing,
    attention is block-diagonal via segment ids, and adaLN conditioning is
    applied per token, so each segment's output equals its unpacked NFE.
    Returns one [n_g, F, H, W, c_out] tensor per group.

    Mixing modes inside one forward requires mode-independent blocks (the
    shared-parameter recipe); uniform packs work on any recipe.

    Activation cache: with ``cache_split`` set, ``cache_deltas[g]``
    ([n_g, N_m, d]) and ``cache_refresh[g]`` ([n_g] bool) thread each
    segment's own staleness clock through the pack. Shallow blocks always
    run; the deep blocks run when ANY segment refreshes, decided on the
    host (no device read), and each token picks fresh vs replayed by its
    segment's flag. The flags are host data (numpy) unless ``cache_deep``
    is given: then they are bool tensors on the latents' device and
    ``cache_deep`` is the host's branch, so a captured step takes the
    flags as an input and keys only on the branch. Returns ``(outs,
    new_deltas)``; a step where every segment refreshes equals the
    uncached forward bit for bit.

    With the flash kernel the tile map is derived once from the layout's
    segment ids and handed to every block.
    """
    modes_present = [m for m, n in groups if n > 0]
    if len(modes_present) > 1 and cfg.dit.lora_rank > 0:
        raise ValueError("mixed-mode packs need mode-independent blocks "
                         "(LoRA recipe adapters are per-mode); pack "
                         "uniformly or merge/disable LoRA")
    block_mode = modes_present[0] if len(modes_present) == 1 else 0
    d = cfg.d_model
    dtype = dtype_of(cfg.compute_dtype)
    seg_n = [dit_mod.tokens_for_mode(cfg, m) for m, _ in groups]
    capacity = row_capacity or max([dit_mod.tokens_for_mode(cfg, 0)] + seg_n)
    key = tuple((seg_n[g], n) for g, (_m, n) in enumerate(groups))
    dev = next(x for x in xs if x is not None).device
    plan, gather, segment_ids, token_idx, *outs_idx = _device_plan(
        key, capacity, dev)
    graphs.hold(gather, segment_ids, token_idx, *outs_idx)
    R, C = plan.rows, capacity

    # per-group token streams and conditioning vectors, segment-major
    toks, cvecs = [], []
    for g, (mode, n) in enumerate(groups):
        if n == 0:
            continue
        toks.append(dit_mod.embed_mode_tokens(params, xs[g], cfg, mode)
                    .reshape(-1, d))
        cvecs.append(dit_mod.condition_vector(params, ts[g], conds[g], cfg,
                                              dtype))
    zero = torch.zeros((1, d), dtype=dtype, device=dev)
    # adaLN is applied per token but computed per segment: each block
    # projects the [S+1, d] segment conditioning (last row zeros for
    # padding), and each token reads its segment's row via token_idx
    seg_c = torch.cat(cvecs + [zero])
    packed = torch.cat(toks + [zero])[gather].reshape(R, C, d)

    block_map = None
    if attn_mod.resolve_backend(attn_backend, n_tokens=C,
                                segmented=True) == "pallas":
        block_map = attn_ops.segment_block_map(segment_ids, C, C)

    def run(h: torch.Tensor, blocks: Any, n: int) -> torch.Tensor:
        for i in range(n):
            h = _packed_block(dit_mod._layer(blocks, i), h, seg_c, token_idx,
                              cfg, block_mode, segment_ids, attn_backend,
                              block_map)
        return h

    L = cfg.num_layers
    cached = cache_split is not None
    if not cached:
        tok = run(packed, params["blocks"], L)
    else:
        # cached deltas packed row-wise with the SAME placement as the
        # tokens; each token selects fresh vs replayed by its segment's
        # flag (padding rides along with flag False, delta 0)
        dparts = [cache_deltas[g].to(dtype).reshape(-1, d)
                  for g, (_m, n) in enumerate(groups) if n > 0]
        delta_rows = torch.cat(dparts + [zero])[gather].reshape(R, C, d)
        if cache_deep is None:
            refresh_flat = np.concatenate(
                [_host_flags(cache_refresh[g])
                 for g, (_m, n) in enumerate(groups) if n > 0]
                or [np.zeros(0, bool)])
            cache_deep = bool(refresh_flat.any())
            seg_flags = [torch.from_numpy(refresh_flat).to(dev)]
        else:
            seg_flags = [cache_refresh[g].reshape(-1)
                         for g, (_m, n) in enumerate(groups) if n > 0]
        shallow, deep = dit_mod.split_blocks(params["blocks"], cache_split)
        h_s = run(packed, shallow, cache_split)
        if cache_deep:
            # each token's segment flag, gathered on the device (padding
            # takes the trailing False)
            no = torch.zeros(1, dtype=torch.bool, device=dev)
            rmask = torch.cat(seg_flags + [no])[token_idx][..., None]
            h_d = run(h_s, deep, L - cache_split)
            tok = torch.where(rmask, h_d, h_s + delta_rows)
            new_rows = torch.where(rmask, h_d - h_s, delta_rows)
        else:
            tok, new_rows = h_s + delta_rows, delta_rows

    ada = dit_mod._linear(F.silu(seg_c.float()).to(dtype),
                          params["final"]["ada"]["w"],
                          params["final"]["ada"]["b"])     # [S+1, 2d]: shift, scale
    tok = adaln_ops.adaln_norm(tok, ada, token_idx, 0, 1)

    tok_flat = tok.reshape(R * C, d)
    outs: List[torch.Tensor] = []
    new_deltas: List[torch.Tensor] = []
    out_shape = tuple(cfg.dit.latent_shape[:-1]) + (dit_mod.c_out_dim(cfg),)
    j = 0
    for g, (mode, n) in enumerate(groups):
        if n == 0:
            outs.append(torch.zeros((0,) + out_shape, dtype=dtype, device=dev))
            if cached:
                new_deltas.append(torch.zeros((0, seg_n[g], d), dtype=dtype,
                                              device=dev))
            j += 1
            continue
        idx = outs_idx[j]
        j += 1
        outs.append(dit_mod.deembed_mode_tokens(
            params, tok_flat[idx].reshape(n, seg_n[g], d), cfg, mode))
        if cached:
            new_deltas.append(new_rows.reshape(R * C, d)[idx]
                              .reshape(n, seg_n[g], d))
    return (outs, new_deltas) if cached else outs


def packed_weak_forward(params: Any, x_ts: torch.Tensor, t: torch.Tensor,
                        conds: torch.Tensor, cfg: ModelConfig, mode: int
                        ) -> torch.Tensor:
    """Run ``r`` weak NFEs packed into one sequence row per batch element
    (the uniform special case of :func:`packed_mixed_forward`).

    x_ts: [r, B, F, H, W, C]: r independent latents (e.g. the conditional
    and unconditional branches of several samples); t: [B]; conds: [r, B]
    class labels. Returns eps for each: [r, B, F, H, W, c_out].
    """
    r, B = x_ts.shape[:2]
    N_w = dit_mod.tokens_for_mode(cfg, mode)
    # flatten b-major so first-fit fills row b with that element's r segments
    xs = x_ts.transpose(0, 1).reshape((B * r,) + tuple(x_ts.shape[2:]))
    ts = t.repeat_interleave(r)
    cs = conds.T.reshape(-1)
    out = packed_mixed_forward(params, cfg, ((mode, B * r),), [xs], [ts],
                               [cs], row_capacity=r * N_w)[0]
    out = out.reshape((B, r) + tuple(out.shape[1:]))
    return out.transpose(0, 1)


def _packed_block(p: Any, x: torch.Tensor, seg_c: torch.Tensor,
                  token_idx: torch.Tensor, cfg: ModelConfig, mode: int,
                  segment_ids: torch.Tensor,
                  attn_backend: str = "auto",
                  block_map: Optional[torch.Tensor] = None) -> torch.Tensor:
    """DiT block with per-segment adaLN conditioning and segment-masked
    attention. The adaLN projection stays per segment ([S+1, 6d]): the
    fused adaLN kernels (``kernels/adaln``) read each token's row through
    ``token_idx``, so nothing is gathered to token level."""
    H = cfg.attn.num_heads
    dtype = x.dtype
    # columns of d: shift, scale, gate before attention; the same before the MLP
    ada = dit_mod._linear(F.silu(seg_c.float()).to(dtype),
                          p["ada"]["w"], p["ada"]["b"])
    lora = p.get("lora", {})
    h = adaln_ops.adaln_norm(x, ada, token_idx, 0, 1)
    attn = dit_mod._mha(p["attn"], h, H, lora=lora.get("attn"), mode=mode,
                        segment_ids=segment_ids, attn_backend=attn_backend,
                        block_map=block_map)
    x, h2 = adaln_ops.adaln_residual_norm(x, attn, ada, token_idx, 2, 3, 4)
    mlp_lora = lora.get("mlp", {})
    h2 = dit_mod._linear(h2, p["mlp"]["w_in"], p["mlp"]["b_in"],
                         lora=mlp_lora.get("w_in"), mode=mode)
    h2 = F.gelu(h2.float(), approximate="tanh").to(dtype)
    h2 = dit_mod._linear(h2, p["mlp"]["w_out"], p["mlp"]["b_out"],
                         lora=mlp_lora.get("w_out"), mode=mode)
    return adaln_ops.adaln_residual_norm(x, h2, ada, token_idx, 5)[0]


# ---------------------------------------------------------------------------
# FLOPs / latency accounting (Fig. 12 + serving packs)


@dataclasses.dataclass(frozen=True)
class PackingCost:
    approach: int
    nfe_calls: int          # sequential NFE launches
    flops: float            # total FLOPs
    longest_row_tokens: int  # latency proxy: tokens in the critical NFE


def packed_row_flops(cfg: ModelConfig, modes: Sequence[int],
                     capacity: Optional[int] = None,
                     attn_backend: str = "dense") -> float:
    """FLOPs of ONE packed row holding segments of the given modes.

    Every packed segment carries its own adaLN conditioning (the 6d block
    projection and the 2d final projection run once per segment), the
    blocks see the full (padded) row, and (de-)embedding runs per segment
    at that segment's real length. ``attn_backend`` 'pallas'/'auto' prices
    only the block tiles the segment-aware flash kernel visits."""
    seg_tokens = [dit_mod.tokens_for_mode(cfg, m) for m in modes]
    C = capacity if capacity is not None else sum(seg_tokens)
    if sum(seg_tokens) > C:
        raise ValueError(f"segments ({sum(seg_tokens)} tokens) exceed row "
                         f"capacity {C}")
    d, L = cfg.d_model, cfg.num_layers
    S = len(modes)
    fl = dit_block_flops(cfg, C)
    if attn_backend in ("pallas", "auto"):
        fl += L * (costing.block_sparse_attention_flops(seg_tokens, C, d)
                   - costing.dense_attention_flops(C, C, d))
    fl += L * 2 * (S - 1) * d * 6 * d        # block adaLN: one per SEGMENT
    fl += 2 * S * d * 2 * d                  # final adaLN, per segment
    c_in = cfg.dit.latent_shape[-1]
    c_out = dit_mod.c_out_dim(cfg)
    for m, N in zip(modes, seg_tokens):
        npix = int(np.prod(dit_mod.patch_sizes(cfg)[m]))
        fl += 2 * N * npix * c_in * d        # per-segment embed
        fl += 2 * N * d * npix * c_out       # per-segment de-embed
    return float(fl)


@dataclasses.dataclass(frozen=True)
class MixedPackCost:
    """Static cost of one mixed pack: rows assembled (first-fit, as in
    :func:`packed_mixed_forward`), total FLOPs, and the token ledger used
    for packing-efficiency metrics."""
    rows: int
    flops: float
    real_tokens: int        # sum of segment lengths
    packed_tokens: int      # rows * capacity (what the hardware computes)

    @property
    def efficiency(self) -> float:
        return self.real_tokens / self.packed_tokens if self.packed_tokens \
            else 1.0


def mixed_pack_cost(cfg: ModelConfig, modes: Sequence[int],
                    row_capacity: Optional[int] = None,
                    attn_backend: str = "dense") -> MixedPackCost:
    """Cost of packing one segment per entry of ``modes`` into rows of
    ``row_capacity`` tokens (default: the mode-0 length)."""
    seg_tokens = [dit_mod.tokens_for_mode(cfg, m) for m in modes]
    capacity = row_capacity or max([dit_mod.tokens_for_mode(cfg, 0)]
                                   + seg_tokens)
    rows = assign_rows(seg_tokens, capacity)
    fl = sum(packed_row_flops(cfg, [modes[i] for i in row], capacity,
                              attn_backend=attn_backend)
             for row in rows)
    return MixedPackCost(rows=len(rows), flops=fl,
                         real_tokens=sum(seg_tokens),
                         packed_tokens=len(rows) * capacity)


def pack_attention_block_stats(cfg: ModelConfig, modes: Sequence[int],
                               row_capacity: Optional[int] = None
                               ) -> Tuple[int, int]:
    """(active, total) attention block-tile visits for the pack one
    segment-per-``modes``-entry assembles. ``1 - active/total`` is the
    cross-segment block skip rate ``serving.metrics`` reports."""
    seg_tokens = [dit_mod.tokens_for_mode(cfg, m) for m in modes]
    capacity = row_capacity or max([dit_mod.tokens_for_mode(cfg, 0)]
                                   + seg_tokens)
    rows = assign_rows(seg_tokens, capacity)
    return costing.pack_attention_stats(
        [[seg_tokens[i] for i in row] for row in rows], capacity)


def packing_cost(cfg: ModelConfig, mode_weak: int, n_images: int
                 ) -> List[PackingCost]:
    """Costs for generating ``n_images`` with CFG where the conditional runs
    powerful and the guidance weak (per denoising step)."""
    f_p = dit_nfe_flops(cfg, 0)
    f_w = dit_nfe_flops(cfg, mode_weak)
    N_p = dit_mod.tokens_for_mode(cfg, 0)
    N_w = dit_mod.tokens_for_mode(cfg, mode_weak)
    r = max(1, N_p // N_w)
    n = n_images
    n_rows = int(np.ceil(n / r))
    packed_rows = n_rows * packed_row_flops(cfg, [mode_weak] * r,
                                            capacity=N_p)
    return [
        PackingCost(1, 2, n * (f_p + f_w), N_p),   # separate calls per branch
        PackingCost(2, 2, n * (f_p + f_w), N_p),   # batch each branch
        PackingCost(3, 1, n * 2 * f_p, N_p),       # pad weak to powerful
        PackingCost(4, 1, n * f_p + packed_rows, N_p),  # pack r weak per row
    ]
