"""Logical→mesh sharding rules: the host half of ``repro.runtime.sharding``.

The rules read only a mesh's axis names and sizes, so they take any
mesh-like object: a ``torch.distributed.device_mesh.DeviceMesh`` (names
in ``mesh_dim_names``, sizes in ``shape``) or anything with
``axis_names`` and a ``shape`` tuple (:class:`AxisLayout`). A
partition spec is a plain tuple, one entry per array dim: ``None``
(replicated), an axis name, or a tuple of axis names.

Baseline profile ``fsdp2d``: weights 2D-sharded over ('data','model') —
'embed'-type dims over the data axes and 'mlp'/'heads'/'vocab'/'expert'
dims over the model axis. ``tp_only``: weights over 'model' only. ``dp``:
replicated weights, batch-sharded data. Weight placement (``named``,
``shard_tree``, ``constrain``) comes with the distributed-training slice.
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple, Tuple

from repro_torch.configs.base import ModelConfig

PROFILES = ("auto", "fsdp2d", "fsdp2d_sp", "tp_only", "dp")

# Named mesh axis of the sequence-parallel inference engine
# (repro_torch.distributed): activations scatter their token dim over it;
# weights never map a dim onto it (replicated across the axis).
SEQ_AXIS = "seq"

# Models whose bf16 params fit comfortably replicated skip FSDP: pure DP
# avoids per-layer weight all-gathers on sub-3B models.
DP_PARAM_THRESHOLD = 3e9


class AxisLayout(NamedTuple):
    """A mesh's axis names and sizes, without devices."""
    axis_names: Tuple[str, ...]
    shape: Tuple[int, ...]


def axis_names(mesh: Any) -> Tuple[str, ...]:
    names = getattr(mesh, "axis_names", None)
    if names is None:
        names = mesh.mesh_dim_names
    return tuple(names)


def axis_sizes(mesh: Any) -> Dict[str, int]:
    return dict(zip(axis_names(mesh), (int(s) for s in tuple(mesh.shape))))


def resolve_profile(cfg: ModelConfig, profile: str) -> str:
    if profile != "auto":
        return profile
    return "dp" if cfg.num_params() < DP_PARAM_THRESHOLD else "fsdp2d"


def base_profile(profile: str) -> str:
    """Strip feature suffixes (_sp sequence-parallel, _kvq int8 KV cache):
    the sharding rules are identical."""
    for suf in ("_sp", "_kvq"):
        profile = profile.replace(suf, "")
    return profile


def dp_axes(mesh: Any) -> Tuple[str, ...]:
    """Axes used for data parallelism (batch sharding)."""
    return tuple(a for a in axis_names(mesh) if a in ("pod", "data"))


def rules_for(cfg: ModelConfig, mesh: Any, profile: str = "auto"
              ) -> Dict[str, Any]:
    """Logical axis rules. Every profile also carries the activation-side
    ``tokens`` rule: on meshes with a ``'seq'`` axis the sequence-parallel
    engine scatters the token dim over it."""
    profile = base_profile(resolve_profile(cfg, profile))
    tokens = SEQ_AXIS if SEQ_AXIS in axis_names(mesh) else None
    if profile == "dp":
        rules = {k: None for k in ("embed", "mlp", "heads", "kv_heads",
                                   "vocab", "expert", "layers")}
        rules["tokens"] = tokens
        return rules
    fsdp = dp_axes(mesh) if profile == "fsdp2d" else None
    return {"embed": fsdp, "mlp": "model", "heads": "model",
            "kv_heads": "model", "vocab": "model", "expert": "model",
            "layers": None, "tokens": tokens}


def batch_spec(batch: int, mesh: Any) -> Tuple[Any]:
    """Shard batch over as many data axes as divide it."""
    axes = []
    prod = 1
    sizes = axis_sizes(mesh)
    for a in dp_axes(mesh):
        prod *= sizes[a]
        if batch % prod == 0:
            axes.append(a)
        else:
            prod //= sizes[a]
    return (tuple(axes) if axes else None,)


def seq_axes_for_cache(batch: int, mesh: Any) -> Tuple[Any, Any]:
    """(batch_sharding, seq_sharding) for KV caches: batch over data axes
    when divisible, sequence over the model axis; when batch == 1 the idle
    data axes also shard the sequence."""
    sizes = axis_sizes(mesh)
    b_axes, s_axes = [], []
    prod = 1
    for a in dp_axes(mesh):
        prod *= sizes[a]
        if batch % prod == 0:
            b_axes.append(a)
        else:
            prod //= sizes[a]
            s_axes.append(a)
    s_axes.append("model")
    return (tuple(b_axes) if b_axes else None,
            tuple(s_axes) if len(s_axes) > 1 else s_axes[0])


def token_spec(batch: int, mesh: Any) -> Tuple[Any, Any]:
    """[B, N, ...] activation spec of the sequence-parallel engine: batch
    over whichever data axes divide it, tokens over the 'seq' axis."""
    b = batch_spec(batch, mesh)[0]
    seq = SEQ_AXIS if SEQ_AXIS in axis_names(mesh) else None
    return (b, seq)
