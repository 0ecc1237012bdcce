"""Sequence-parallel partitioning for FlexiDiT sampling — the port of
``repro.distributed.partition``.

FlexiDiT's token count changes at phase boundaries, when the model drops
to a weak patch size. This module owns the static arithmetic of that:
per-mode token shardings (padded to a multiple of the sequence axis), the
re-shard points between phases, and the analytic costs, padding FLOPs and
collective bytes, layered on ``core.scheduler``'s per-NFE accounting.
Nothing here touches devices or process groups.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

from repro_torch.configs.base import ModelConfig
from repro_torch.core.scheduler import (FlexiSchedule, dit_block_flops,
                                        dit_nfe_flops)
from repro_torch.models import dit as dit_mod
from repro_torch.runtime.padding import round_up_to_multiple

ATTN_IMPLS = ("auto", "ulysses", "ring")


@dataclasses.dataclass(frozen=True)
class ParallelSpec:
    """Declarative sequence-parallel request on a ``SamplingPlan``.

    ``axis`` names the mesh axis the sequence is scattered over; ``attn``
    picks the implementation: ``'ulysses'`` (heads gathered, sequence
    scattered; needs heads % axis size == 0), ``'ring'`` (K/V chunks
    rotate, any head count) or ``'auto'`` (ulysses when the heads divide,
    ring otherwise). The spec is mesh-free and hashable; the pipeline binds
    the mesh at sample time."""
    axis: str = "seq"
    attn: str = "auto"

    def __post_init__(self):
        if not self.axis or not isinstance(self.axis, str):
            raise ValueError(f"parallel axis must be a non-empty mesh axis "
                             f"name, got {self.axis!r}")
        if self.attn not in ATTN_IMPLS:
            raise ValueError(f"unknown parallel attn {self.attn!r}; "
                             f"known: {ATTN_IMPLS}")


def padded_tokens(n_tokens: int, sp: int) -> int:
    """Smallest multiple of ``sp`` holding ``n_tokens`` tokens."""
    return round_up_to_multiple(n_tokens, sp)


@dataclasses.dataclass(frozen=True)
class ModePartition:
    """How one patch mode's token sequence lands on ``sp`` shards."""
    mode: int
    sp: int
    tokens: int                  # real tokens N of this mode
    tokens_padded: int           # N padded up to a multiple of sp
    impl: str                    # 'ulysses' | 'ring' (resolved)

    @property
    def pad(self) -> int:
        return self.tokens_padded - self.tokens

    @property
    def shard_tokens(self) -> int:
        return self.tokens_padded // self.sp

    def pad_flops_per_nfe(self, cfg: ModelConfig) -> float:
        """Extra block FLOPs one NFE spends on padding tokens (batch 1).
        Padding is added after the embedding, so only the blocks see it."""
        if self.pad == 0:
            return 0.0
        return (dit_block_flops(cfg, self.tokens_padded)
                - dit_block_flops(cfg, self.tokens))

    def collective_bytes_per_nfe(self, cfg: ModelConfig) -> float:
        """Bytes crossing devices for one NFE (batch 1), summed over all
        shards and layers.

        Ulysses: 4 all-to-alls per attention (q, k, v in; output back),
        each redistributing the full [N_pad, d] activation: every shard
        keeps 1/sp of what it holds, so (sp-1)/sp of the tensor moves.
        Ring: (sp-1) rotation steps per attention, each moving the local K
        and V chunks [N_pad/sp, d] from every shard."""
        if self.sp <= 1:
            return 0.0
        d, L = cfg.d_model, cfg.num_layers
        elt = _dtype_bytes(cfg.compute_dtype)
        if self.impl == "ulysses":
            per_a2a = self.tokens_padded * d * elt * (self.sp - 1) / self.sp
            return float(L * 4 * per_a2a)
        per_hop = self.shard_tokens * d * elt * self.sp   # all shards send
        return float(L * 2 * (self.sp - 1) * per_hop)


def _dtype_bytes(name: str) -> int:
    return {"float32": 4, "bfloat16": 2, "float16": 2}.get(name, 4)


def resolve_impl(cfg: ModelConfig, spec: ParallelSpec, sp: int) -> str:
    """The concrete implementation for ``sp`` shards."""
    divides = cfg.attn.num_heads % sp == 0
    if spec.attn == "ulysses" and not divides:
        raise ValueError(
            f"ulysses attention needs num_heads ({cfg.attn.num_heads}) "
            f"divisible by the '{spec.axis}' axis size {sp}; use "
            f"attn='ring' or 'auto'")
    if spec.attn == "auto":
        return "ulysses" if divides else "ring"
    return spec.attn


@dataclasses.dataclass(frozen=True)
class PartitionPlan:
    """The static sharding of one sampling schedule: one
    :class:`ModePartition` per phase plus the re-shard boundaries."""
    phases: Tuple[Tuple[ModePartition, int], ...]   # (partition, n_steps)
    sp: int

    @property
    def reshard_boundaries(self) -> Tuple[int, ...]:
        """Step indices (into the flat ladder) where the token count
        changes and the sequence must be re-scattered."""
        out: List[int] = []
        step = 0
        for i, (part, n) in enumerate(self.phases):
            step += n
            if i + 1 < len(self.phases) and n:
                nxt = self.phases[i + 1][0]
                if nxt.tokens != part.tokens:
                    out.append(step)
        return tuple(out)

    def pad_flops(self, cfg: ModelConfig, *, cfg_scale_active: bool = True
                  ) -> float:
        mult = 2.0 if cfg_scale_active else 1.0
        return mult * sum(n * p.pad_flops_per_nfe(cfg)
                          for p, n in self.phases)

    def collective_bytes(self, cfg: ModelConfig, *,
                         cfg_scale_active: bool = True) -> float:
        """Collective traffic of one full sample (batch 1). CFG doubles the
        effective batch of every NFE, hence the bytes."""
        mult = 2.0 if cfg_scale_active else 1.0
        return mult * sum(n * p.collective_bytes_per_nfe(cfg)
                          for p, n in self.phases)

    def parallel_efficiency(self, cfg: ModelConfig) -> float:
        """Useful FLOPs / (useful + padding) FLOPs; 1.0 means no waste."""
        useful = sum(n * dit_nfe_flops(cfg, p.mode) for p, n in self.phases)
        padded = useful + sum(n * p.pad_flops_per_nfe(cfg)
                              for p, n in self.phases)
        return useful / padded if padded else 1.0


def mode_partition(cfg: ModelConfig, mode: int, sp: int,
                   spec: Optional[ParallelSpec] = None) -> ModePartition:
    spec = spec or ParallelSpec()
    n = dit_mod.tokens_for_mode(cfg, mode)
    return ModePartition(mode=mode, sp=sp, tokens=n,
                         tokens_padded=padded_tokens(n, sp),
                         impl=resolve_impl(cfg, spec, sp))


def plan_partition(cfg: ModelConfig, schedule: FlexiSchedule, sp: int,
                   spec: Optional[ParallelSpec] = None) -> PartitionPlan:
    """The static sharding plan of a resolved :class:`FlexiSchedule`."""
    if sp < 1:
        raise ValueError(f"sp must be >= 1, got {sp}")
    parts = tuple((mode_partition(cfg, mode, sp, spec), n)
                  for mode, n in schedule.phases)
    return PartitionPlan(phases=parts, sp=sp)
