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
replicated weights, batch-sharded data. Optimizer state takes the
weights' placements.

Placement: :func:`named` / :func:`shard_tree` pair a mesh with specs (the
port's ``NamedSharding``), :func:`placements` translates a spec into one
``Shard(tensor_dim)`` or ``Replicate()`` per mesh dim, and
``runtime/placement.py`` puts tensors there. :func:`use_mesh` sets the
ambient mesh (``with mesh:`` in the reference) under which
:func:`constrain` acts and the losses reduce over the data axes.

Inside a sharded step every tensor already holds this rank's rows of the
global batch (the step splits it over the data axes), so a data axis in
an activation spec names a layout the tensor has. Each other mesh axis
takes this rank's chunk of its dim: :func:`constrain` keeps the chunk,
:func:`gather_layout` joins the chunks again. The ranks along such an
axis compute the same values, so the two collectives' backward rules are
the reverse of Megatron's: the gather's backward takes the rank's slice
(no sum: the ranks' gradients are equal copies, and a sum would multiply
them by the axis size), the chunk's backward gathers the slices.
"""
from __future__ import annotations

import contextlib
from typing import Any, Dict, Iterator, List, NamedTuple, Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch.configs.base import ModelConfig
from repro_torch.models.common import tree_map

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


# ---------------------------------------------------------------------------
# Placement: specs on a mesh


class NamedSharding(NamedTuple):
    """A mesh and a partition spec (one entry per tensor dim)."""
    mesh: Any
    spec: Tuple[Any, ...]

    @property
    def placements(self) -> list:
        return placements(self.mesh, self.spec)


def named(mesh: Any, spec: Tuple[Any, ...]) -> NamedSharding:
    return NamedSharding(mesh, tuple(spec))


def shard_tree(mesh: Any, spec_pytree: Any) -> Any:
    """A spec tree (``models.common.spec_tree``) as a tree of
    :class:`NamedSharding` on ``mesh``."""
    return tree_map(lambda s: NamedSharding(mesh, tuple(s)), spec_pytree)


def entry_axes(entry: Any) -> Tuple[str, ...]:
    """A spec entry's mesh axes: () for None, (name,) for a name."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def placements(mesh: Any, spec: Tuple[Any, ...]) -> list:
    """One ``Shard(tensor_dim)`` or ``Replicate()`` per mesh dim. A tuple
    entry shards one tensor dim over several mesh dims, the first named
    the outermost, as the mesh orders them (DTensor's rule)."""
    from torch.distributed.tensor import Replicate, Shard

    names = axis_names(mesh)
    out: list = [Replicate() for _ in names]
    for t, entry in enumerate(spec):
        axes = entry_axes(entry)
        idx = []
        for a in axes:
            if a not in names:
                raise ValueError(f"spec {spec} names axis {a!r}; the mesh "
                                 f"has {names}")
            idx.append(names.index(a))
        if idx != sorted(idx):
            raise ValueError(f"spec entry {entry} must list its axes in the "
                             f"mesh's order {names}")
        for i in idx:
            if not isinstance(out[i], Replicate):
                raise ValueError(f"mesh axis {names[i]!r} used twice in {spec}")
            out[i] = Shard(t)
    return out


# ---------------------------------------------------------------------------
# The ambient mesh


_AMBIENT: List[Any] = []      # process-wide: remat recomputes on autograd's thread


@contextlib.contextmanager
def use_mesh(mesh: Any) -> Iterator[Any]:
    """Make ``mesh`` the ambient mesh inside the block (``with mesh:``)."""
    _AMBIENT.append(mesh)
    try:
        yield mesh
    finally:
        _AMBIENT.pop()


def current_mesh() -> Optional[Any]:
    return _AMBIENT[-1] if _AMBIENT else None


def _known(spec: Tuple[Any, ...], names: Tuple[str, ...]) -> list:
    """The spec with axis names the mesh lacks dropped, as the
    reference's ``constrain`` drops them."""
    flat = []
    for part in spec:
        if part is None:
            flat.append(None)
        elif isinstance(part, str):
            flat.append(part if part in names else None)
        else:
            kept = tuple(a for a in part if a in names)
            flat.append(kept if kept else None)
    return flat


def _chunked_dims(mesh: Any, spec: Tuple[Any, ...]) -> List[Tuple[int, str]]:
    """(tensor dim, mesh axis) for each non-data axis the spec names, in
    the mesh's order (outermost first)."""
    names = axis_names(mesh)
    data = set(dp_axes(mesh))
    out = []
    for t, entry in enumerate(_known(spec, names)):
        for a in entry_axes(entry):
            if a not in data:
                out.append((t, a))
    return sorted(out, key=lambda ta: names.index(ta[1]))


def _chunk(x: torch.Tensor, dim: int, rank: int, n: int) -> torch.Tensor:
    if x.shape[dim] % n:
        raise ValueError(f"dim {dim} of size {x.shape[dim]} does not divide "
                         f"over {n} ranks")
    c = x.shape[dim] // n
    return x.narrow(dim, rank * c, c).contiguous()


def all_gather_dim(x: torch.Tensor, dim: int, group: Any, n: int
                   ) -> torch.Tensor:
    """The group's tensors joined along ``dim`` in group-rank order (a
    contiguous tensor, as the unsharded one is)."""
    xt = x.movedim(dim, 0).contiguous()
    out = torch.empty((n * xt.shape[0],) + tuple(xt.shape[1:]),
                      dtype=x.dtype, device=x.device)
    dist.all_gather_into_tensor(out, xt, group=group)
    return out.movedim(0, dim).contiguous()


def _gather_grad(g: torch.Tensor, dim: int, group: Any, rank: int, n: int
                 ) -> torch.Tensor:
    """The gather's backward: this rank's slice of the (equal) full
    gradients."""
    return _chunk(g, dim, rank, n)


class _KeepChunk(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group, rank, n):
        ctx.args = (dim, group, n)
        return _chunk(x, dim, rank, n)

    @staticmethod
    def backward(ctx, g):
        dim, group, n = ctx.args
        return all_gather_dim(g.contiguous(), dim, group, n), None, None, None, None


class _GatherChunks(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group, rank, n):
        ctx.args = (dim, group, rank, n)
        return all_gather_dim(x, dim, group, n)

    @staticmethod
    def backward(ctx, g):
        return _gather_grad(g, *ctx.args), None, None, None, None


def constrain(x: torch.Tensor, spec: Tuple[Any, ...]) -> torch.Tensor:
    """The layout ``spec`` under the ambient mesh; the identity without
    one. Axis names the mesh lacks are dropped; data axes name the rows
    the tensor already holds; each other axis keeps this rank's chunk of
    its dim (outermost axis first)."""
    mesh = current_mesh()
    if mesh is None:
        return x
    sizes = axis_sizes(mesh)
    for dim, a in _chunked_dims(mesh, spec):
        if sizes[a] > 1:
            x = _KeepChunk.apply(x, dim, mesh.get_group(a),
                                 mesh.get_local_rank(a), sizes[a])
    return x


def gather_layout(x: torch.Tensor, spec: Tuple[Any, ...]) -> torch.Tensor:
    """The inverse of :func:`constrain`: join the chunks ``spec`` keeps
    on each non-data axis (innermost axis first)."""
    mesh = current_mesh()
    if mesh is None:
        return x
    sizes = axis_sizes(mesh)
    for dim, a in reversed(_chunked_dims(mesh, spec)):
        if sizes[a] > 1:
            x = _GatherChunks.apply(x, dim, mesh.get_group(a),
                                    mesh.get_local_rank(a), sizes[a])
    return x


# ---------------------------------------------------------------------------
# Reductions over the data axes


def data_groups(mesh: Any) -> List[Tuple[Any, int]]:
    """(group, size) of each data axis of size > 1."""
    sizes = axis_sizes(mesh)
    return [(mesh.get_group(a), sizes[a]) for a in dp_axes(mesh)
            if sizes[a] > 1]


class _DataSum(torch.autograd.Function):
    """Sum over the data axes; the backward hands each rank its own
    share (identity), so the data-axis sum of the gradients the ranks
    compute is the gradient of the one global value."""

    @staticmethod
    def forward(ctx, x, groups):
        y = x.clone()
        for g, _ in groups:
            dist.all_reduce(y, group=g)
        return y

    @staticmethod
    def backward(ctx, g):
        return g, None


def data_sum(x: torch.Tensor) -> torch.Tensor:
    """``x`` summed over the ambient mesh's data axes (the identity
    without a mesh), differentiably."""
    mesh = current_mesh()
    groups = [] if mesh is None else data_groups(mesh)
    return _DataSum.apply(x, groups) if groups else x


def data_mean(x: torch.Tensor) -> torch.Tensor:
    """The mean over the data axes of a value each rank computed over an
    equal share of the global batch: the global value, on every rank."""
    mesh = current_mesh()
    groups = [] if mesh is None else data_groups(mesh)
    if not groups:
        return x
    n = 1
    for _, size in groups:
        n *= size
    return _DataSum.apply(x, groups) / n
