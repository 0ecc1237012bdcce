"""Sequence-parallel FlexiDiT sampling over ``torch.distributed`` — the
port of ``repro.distributed``.

``partition`` owns the static sharding and cost arithmetic (per-mode
token shards, phase-boundary re-shards, padding FLOPs, collective bytes),
``attention`` the collectives (Ulysses all-to-all and the ring), and
``engine`` the mesh-bound runtime the pipeline threads through the
model. User code enables it by putting a :class:`ParallelSpec` on a
``SamplingPlan`` and giving ``FlexiPipeline`` a mesh
(``launch.mesh.make_inference_mesh``) in every rank
(``launch.mesh.run_ranks``).
"""
from repro_torch.distributed.attention import ring_attention, ulysses_attention
from repro_torch.distributed.engine import SeqParallel, mesh_fingerprint
from repro_torch.distributed.partition import (ModePartition, ParallelSpec,
                                               PartitionPlan, mode_partition,
                                               padded_tokens, plan_partition,
                                               resolve_impl)

__all__ = [
    "ModePartition", "ParallelSpec", "PartitionPlan", "SeqParallel",
    "mesh_fingerprint", "mode_partition", "padded_tokens", "plan_partition",
    "resolve_impl", "ring_attention", "ulysses_attention",
]
