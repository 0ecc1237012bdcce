"""Mesh-bound sequence-parallel engine — the port of
``repro.distributed.engine``.

:class:`SeqParallel` is the runtime object the pipeline threads through
``make_eps_fn`` → ``dit_forward`` → ``_mha``: it holds the mesh (a
``torch.distributed`` ``DeviceMesh``), the resolved implementation and the
token plumbing. Every rank runs the same program; each holds its own
token shard ``[B, N_pad/sp, d]`` through every block (adaLN, the MLP and
cross-attention work on each token alone), self-attention exchanges
shards through ``distributed.attention``, and the tokens are gathered
once, before the de-embedding.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import attention as dist_attn
from repro_torch.distributed.partition import ParallelSpec, resolve_impl
from repro_torch.runtime.padding import pad_to, round_up_to_multiple
from repro_torch.runtime.sharding import axis_names, axis_sizes


def mesh_fingerprint(mesh: Optional[Any]) -> Optional[Tuple]:
    """Hashable identity of a mesh for runner keys: the dim names, the
    shape and the global ranks (a new mesh of the same layout over the
    same ranks reuses runners)."""
    if mesh is None:
        return None
    return (axis_names(mesh), tuple(int(s) for s in mesh.shape),
            tuple(int(r) for r in mesh.mesh.flatten().tolist()))


@dataclasses.dataclass(frozen=True)
class SeqParallel:
    """A ParallelSpec bound to a mesh."""
    mesh: Any
    axis: str
    impl: str                    # 'ulysses' | 'ring' (resolved)
    # the backend of Ulysses' inner attend: 'auto' → the flash kernel
    attn_backend: str = "auto"

    @classmethod
    def create(cls, mesh: Optional[Any], spec: ParallelSpec,
               cfg: ModelConfig, attn_backend: str = "auto") -> "SeqParallel":
        if mesh is None:
            raise ValueError("plan.parallel needs a device mesh; construct "
                             "FlexiPipeline(..., mesh=...) or set_mesh()")
        if spec.axis not in axis_names(mesh):
            raise ValueError(f"mesh has no '{spec.axis}' axis "
                             f"(axes: {axis_names(mesh)})")
        return cls(mesh=mesh, axis=spec.axis,
                   impl=resolve_impl(cfg, spec, axis_sizes(mesh)[spec.axis]),
                   attn_backend=attn_backend)

    @property
    def sp(self) -> int:
        return axis_sizes(self.mesh)[self.axis]

    @property
    def group(self) -> dist.ProcessGroup:
        return self.mesh.get_group(self.axis)

    # ------------------------------------------------------------------
    # Token plumbing

    def pad_and_shard(self, tok: torch.Tensor,
                      segment_ids: Optional[torch.Tensor] = None
                      ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """Pad [B, N, d] tokens to a multiple of sp and keep this rank's
        slice. Padding tokens get segment id -1, so they never contribute
        as attention keys."""
        B, N = tok.shape[:2]
        target = round_up_to_multiple(N, self.sp)
        if target != N:
            tok = pad_to(tok, target, axis=1)
            if segment_ids is None:
                segment_ids = torch.zeros((B, N), dtype=torch.int32,
                                          device=tok.device)
            segment_ids = pad_to(segment_ids, target, axis=1, value=-1)
        n = target // self.sp
        lo = self.mesh.get_local_rank(self.axis) * n
        tok = tok[:, lo:lo + n].contiguous()
        if segment_ids is not None:
            segment_ids = segment_ids[:, lo:lo + n].contiguous()
        return tok, segment_ids

    def unshard(self, tok: torch.Tensor, n_tokens: int) -> torch.Tensor:
        """Gather the shards and drop the padding rows (before the
        de-embedding)."""
        full = dist_attn.all_gather(tok, self.group, "tokens", dim=1)
        return full[:, :n_tokens]

    def attend(self, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               segment_ids: Optional[torch.Tensor] = None) -> torch.Tensor:
        fn = dist_attn.ATTN_FNS[self.impl]
        return fn(q, k, v, group=self.group, segment_ids=segment_ids,
                  attn_backend=self.attn_backend)
