"""Int8 gradient compression with error feedback — the port of
``repro.optim.compression`` (the data-parallel all-reduce's trick).

``compress_decompress`` simulates the wire round trip (per-tensor absmax
int8); the residual is carried in an error-feedback buffer, so the scheme
is unbiased over time (EF-SGD). ``compressed_psum`` is the collective:
the absmax is max-reduced over the axis first so every rank quantizes on
one grid, the int32 codes are summed (exact in any order), then
dequantized: 4x fewer bytes than float32 on the wire.

``TrainConfig.grad_compression`` names this scheme, but no train step
reads it, in the reference or here.
"""
from __future__ import annotations

from typing import Any, Sequence, Tuple, Union

import torch
import torch.distributed as dist

from repro_torch.models.common import tree_map
from repro_torch.runtime import placement as plc
from repro_torch.runtime.sharding import current_mesh

Params = Any


def init_error_feedback(params: Params) -> Params:
    """float32 zeros of each leaf's (local) shape."""
    return tree_map(lambda p: plc.map_local(
        lambda l: torch.zeros(l.shape, dtype=torch.float32, device=l.device),
        p), params)


def _compress_one(g: torch.Tensor, ef: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    gf = g.float() + ef
    scale = torch.clamp(torch.max(torch.abs(gf)), min=1e-12) / 127.0
    q = torch.clamp(torch.round(gf / scale), -127, 127).to(torch.int8)
    deq = q.float() * scale
    return deq.to(g.dtype), gf - deq


def _compress_placed(g: Any, ef: Any) -> Tuple[Any, Any]:
    """:func:`_compress_one` on a placed leaf's chunk (per chunk, as the
    reference's per-tensor absmax inside ``shard_map``)."""
    if not plc.is_placed(g):
        return _compress_one(g, ef)
    deq, new_ef = _compress_one(g.to_local(), plc.local(ef))
    return plc.wrap(deq, g), plc.wrap(new_ef, g)


def compress_decompress(grads: Params, ef_state: Params
                        ) -> Tuple[Params, Params]:
    """(dequantized gradients in their dtypes, new float32 residuals)."""
    out = tree_map(_compress_placed, grads, ef_state)
    return tree_map(lambda t: t[0], out), tree_map(lambda t: t[1], out)


def compressed_psum(g: torch.Tensor, axis_name: Union[str, Sequence[str]],
                    mesh: Any = None) -> torch.Tensor:
    """``g`` summed over the mesh axis (or axes) ``axis_name`` of ``mesh``
    (the ambient mesh by default) through int8-range codes: the absmax
    ``all_reduce(MAX)``, the int32 codes ``all_reduce(SUM)``, then
    dequantized in g's dtype."""
    mesh = mesh if mesh is not None else current_mesh()
    if mesh is None:
        raise ValueError("compressed_psum needs a mesh (pass mesh= or run "
                         "under runtime.sharding.use_mesh)")
    names = (axis_name,) if isinstance(axis_name, str) else tuple(axis_name)
    groups = [mesh.get_group(a) for a in names]
    gf = g.float()
    amax = torch.max(torch.abs(gf))
    for grp in groups:
        dist.all_reduce(amax, op=dist.ReduceOp.MAX, group=grp)
    scale = torch.clamp(amax, min=1e-12) / 127.0
    q = torch.clamp(torch.round(gf / scale), -127, 127).to(torch.int32)
    for grp in groups:
        dist.all_reduce(q, group=grp)
    return (q.float() * scale).to(g.dtype)
