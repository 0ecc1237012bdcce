"""Weight placement over a ``("data", "model")`` mesh: the port's
``jax.device_put(tree, shardings)`` and the collectives a sharded train
step runs around its local compute.

A placed leaf is a ``torch.distributed.tensor.DTensor`` holding this
rank's chunk of the global tensor, on the placements its spec gives
(``runtime/sharding.placements``). The DTensor is the container: every
collective here is an explicit ``torch.distributed`` call on the local
chunks, over the mesh's per-axis groups.

The step computes on full tensors. :func:`gathered` hands the loss a view
of the placed tree in which each leaf is gathered on use: a stacked
``[L, ...]`` leaf (its ``layers`` axis is never sharded) one layer at a
time, when the layer loop slices it (``models/lm._layer``,
``models/dit._layer``), every other leaf once. The gather's backward
(:func:`reduce_grad`) hands back the gradient of this rank's chunk:

* summed over the data axes, in float32, and rounded once to the leaf's
  dtype (a reduce-scatter where the leaf is sharded over the axis, an
  all-reduce where it is replicated): each data rank computed its own
  rows;
* not summed over any other axis: the ranks along it computed the same
  rows, so their gradients are equal copies and the rank takes its slice.
"""
from __future__ import annotations

import math
from typing import Any, Callable, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Shard

from repro_torch.models.common import tree_leaves, tree_map
from repro_torch.runtime import sharding as shd

Params = Any


def is_placed(x: Any) -> bool:
    return isinstance(x, DTensor)


def local(x: Any) -> Any:
    """A placed leaf's local chunk; anything else as it is."""
    return x.to_local() if isinstance(x, DTensor) else x


def placed_mesh(tree: Params) -> Optional[Any]:
    """The mesh of a tree's placed leaves, None when no leaf is placed.
    Raises when the tree mixes meshes."""
    meshes = {id(x.device_mesh): x.device_mesh for x in tree_leaves(tree)
              if isinstance(x, DTensor)}
    if len(meshes) > 1:
        raise ValueError("a tree's placed leaves sit on different meshes")
    return next(iter(meshes.values()), None)


def _coord(mesh: Any) -> Tuple[int, ...]:
    c = mesh.get_coordinate()
    if c is None:
        raise ValueError(f"rank {dist.get_rank()} is not in the mesh "
                         f"{mesh.mesh.tolist()}")
    return tuple(c)


def chunk_slices(shape: Sequence[int], mesh: Any, pl: Sequence[Any]
                 ) -> Tuple[slice, ...]:
    """Where this rank's chunk sits in a full tensor of ``shape`` under
    the placements ``pl`` (outer mesh dims first: a tensor dim sharded
    over two mesh dims takes chunk ``c_outer * n_inner + c_inner``)."""
    coord = _coord(mesh)
    lo, size = [0] * len(shape), list(shape)
    for i, p in enumerate(pl):
        if isinstance(p, Shard):
            n = mesh.size(i)
            if size[p.dim] % n:
                raise ValueError(f"dim {p.dim} of {tuple(shape)} does not "
                                 f"divide over mesh dim {i} of size {n}")
            size[p.dim] //= n
            lo[p.dim] += coord[i] * size[p.dim]
    return tuple(slice(a, a + n) for a, n in zip(lo, size))


def chunk_of(full: torch.Tensor, mesh: Any, pl: Sequence[Any]) -> torch.Tensor:
    """This rank's chunk (a view) of a full tensor under ``pl``."""
    return full[chunk_slices(full.shape, mesh, pl)]


def from_chunk(loc: torch.Tensor, sharding: "shd.NamedSharding",
               shape: Sequence[int]) -> DTensor:
    """This rank's chunk of a global tensor of ``shape`` as a DTensor on
    ``sharding``'s mesh and placements."""
    shape = tuple(shape)
    return DTensor.from_local(loc, sharding.mesh, sharding.placements,
                              run_check=False, shape=shape,
                              stride=torch.empty(shape, device="meta").stride())


def wrap(loc: torch.Tensor, like: DTensor) -> DTensor:
    """A local chunk as a DTensor placed like ``like``."""
    return DTensor.from_local(loc, like.device_mesh, like.placements,
                              run_check=False, shape=like.shape,
                              stride=like.stride())


def map_local(fn: Callable, x: Any, *rest: Any) -> Any:
    """``fn`` on local chunks: a placed ``x`` (and ``rest``, placed like
    it) gives a DTensor placed like ``x``; a plain ``x`` gives
    ``fn(x, *rest)``."""
    if not isinstance(x, DTensor):
        return fn(x, *rest)
    return wrap(fn(x.to_local(), *(local(r) for r in rest)), x)


def place(x: torch.Tensor, sharding: "shd.NamedSharding",
          device: Any = None) -> DTensor:
    """A full tensor (or numpy array) placed by ``sharding``: this rank
    keeps its chunk, on ``device`` (the tensor's own by default)."""
    if not torch.is_tensor(x):
        x = torch.as_tensor(x)
    loc = chunk_of(x, sharding.mesh, sharding.placements).contiguous()
    if device is not None:
        loc = loc.to(device)
    return from_chunk(loc, sharding, x.shape)


def place_tree(tree: Params, shardings: Any, device: Any = None) -> Params:
    """``jax.device_put(tree, shardings)``: each leaf placed by its
    :class:`~repro_torch.runtime.sharding.NamedSharding`."""
    return tree_map(lambda x, s: place(x, s, device), tree, shardings)


def _gather(loc: torch.Tensor, mesh: Any, pl: Sequence[Any]) -> torch.Tensor:
    """The full tensor from every rank's chunk (inner mesh dims first)."""
    for i in reversed(range(mesh.ndim)):
        if isinstance(pl[i], Shard) and mesh.size(i) > 1:
            loc = shd.all_gather_dim(loc, pl[i].dim, mesh.get_group(i),
                                     mesh.size(i))
    return loc


def gather_full(x: Any) -> Any:
    """A placed leaf as the full tensor on every rank (no autograd);
    anything else as it is."""
    if not isinstance(x, DTensor):
        return x
    return _gather(x.to_local(), x.device_mesh, x.placements)


# ---------------------------------------------------------------------------
# The gather on use and its backward


def _data_dims(mesh: Any) -> set:
    names = shd.axis_names(mesh)
    return {names.index(a) for a in shd.dp_axes(mesh)}


def _reduce_data(g: torch.Tensor, p: Any, group: Any, n: int) -> torch.Tensor:
    """A gradient summed over one data axis in float32: reduce-scattered
    along the dim the leaf is sharded on there, all-reduced where it is
    replicated (on a copy: autograd may hold ``g``)."""
    if isinstance(p, Shard):
        gt = g.movedim(p.dim, 0).to(torch.float32,
                                    memory_format=torch.contiguous_format)
        out = torch.empty((gt.shape[0] // n,) + tuple(gt.shape[1:]),
                          dtype=torch.float32, device=g.device)
        dist.reduce_scatter_tensor(out, gt, group=group)
        return out.movedim(0, p.dim)
    g = g.to(torch.float32, memory_format=torch.contiguous_format, copy=True)
    dist.all_reduce(g, group=group)
    return g


def _narrow(g: torch.Tensor, dim: int, c: int, n: int) -> torch.Tensor:
    size = g.shape[dim] // n
    return g.narrow(dim, c * size, size)


def reduce_grad(g: torch.Tensor, mesh: Any, pl: Sequence[Any],
                dtype: torch.dtype) -> torch.Tensor:
    """The gradient of this rank's chunk from the full-tensor gradient it
    computed: sliced on the non-data axes, summed over the data axes in
    float32, rounded once to ``dtype``. A slice on a tensor dim no data
    axis shards is taken first (the two commute), so the sum moves only
    this rank's share; the rest go in mesh order, outer dims first."""
    data = _data_dims(mesh)
    coord = _coord(mesh)
    summed = {p.dim for i, p in enumerate(pl) if i in data and isinstance(p, Shard)}
    later = []
    for i, p in enumerate(pl):
        if mesh.size(i) == 1:
            continue
        if i not in data and isinstance(p, Shard) and p.dim not in summed:
            g = _narrow(g, p.dim, coord[i], mesh.size(i))
        else:
            later.append(i)
    for i in later:
        p, n = pl[i], mesh.size(i)
        if i in data:
            g = _reduce_data(g, p, mesh.get_group(i), n)
        elif isinstance(p, Shard):
            g = _narrow(g, p.dim, coord[i], n)
    return g.to(dtype).contiguous()


class _GatherOnUse(torch.autograd.Function):
    @staticmethod
    def forward(ctx, loc, mesh, pl):
        ctx.args = (mesh, pl, loc.dtype)
        return _gather(loc, mesh, pl)

    @staticmethod
    def backward(ctx, g):
        mesh, pl, dtype = ctx.args
        return reduce_grad(g, mesh, pl, dtype), None, None


def _drop_dim0(pl: Sequence[Any]) -> list:
    out = []
    for p in pl:
        if isinstance(p, Shard):
            if p.dim == 0:
                raise ValueError("a stacked leaf's layers axis is sharded")
            p = Shard(p.dim - 1)
        out.append(p)
    return out


class LayerGather:
    """A placed stacked leaf ``[L, ...]`` whose ``[i]`` gathers layer i."""

    def __init__(self, loc: torch.Tensor, like: DTensor):
        self.loc, self.mesh = loc, like.device_mesh
        self.pl = _drop_dim0(like.placements)
        self.shape = like.shape

    def __getitem__(self, i: int) -> torch.Tensor:
        if not isinstance(i, int):
            raise TypeError("a placed stacked leaf is gathered one layer "
                            "(an int index) at a time")
        return _GatherOnUse.apply(self.loc[i], self.mesh, self.pl)


def stacked_leaves(schema: Any) -> Any:
    """A tree of bools: True where a schema leaf is stacked ``[L, ...]``
    over the ``layers`` axis."""
    return tree_map(lambda s: bool(s.axes) and s.axes[0] == "layers", schema)


def gathered(local_tree: Params, placed: Params, stacked: Any = None) -> Params:
    """The loss's view of a placed tree: ``local_tree`` holds the chunks
    (tracked for autograd), ``placed`` the DTensors they came from,
    ``stacked`` a tree of bools (:func:`stacked_leaves`; True: gathered
    per layer on ``[i]``). Every other placed leaf is gathered here."""
    def walk(loc, p, st):
        if isinstance(loc, dict):
            return {k: walk(loc[k], p[k],
                            st.get(k) if isinstance(st, dict) else None)
                    for k in loc}
        if not isinstance(p, DTensor):
            return loc
        if st is True:
            return LayerGather(loc, p)
        return _GatherOnUse.apply(loc, p.device_mesh, p.placements)
    return walk(local_tree, placed, stacked)


def sum_over_shards(values: List[torch.Tensor], leaves: List[Any]
                    ) -> List[torch.Tensor]:
    """Per-leaf scalars of local chunks (sums of squares, say) summed over
    the mesh dims each leaf is sharded on, and over no other: one
    all-reduce per mesh dim. Plain leaves' values come back as they are."""
    mesh = next((x.device_mesh for x in leaves if isinstance(x, DTensor)), None)
    if mesh is None:
        return values
    values = list(values)
    for i in range(mesh.ndim):
        idx = [j for j, x in enumerate(leaves) if isinstance(x, DTensor)
               and isinstance(x.placements[i], Shard)]
        if not idx or mesh.size(i) == 1:
            continue
        vec = torch.stack([values[j] for j in idx])
        dist.all_reduce(vec, group=mesh.get_group(i))
        for k, j in enumerate(idx):
            values[j] = vec[k]
    return values


# ---------------------------------------------------------------------------
# Rows of the global batch, resident bytes


def take_rows(tree: Any, batch: int, mesh: Any) -> Any:
    """This rank's rows of every tensor whose leading dim is the global
    batch ``batch`` (``batch_spec``: rows over the data axes). Raises when
    the rows do not divide over every data axis: a data axis over which
    the batch is replicated would sum equal gradients."""
    axes = shd.batch_spec(batch, mesh)[0] or ()
    dp = shd.dp_axes(mesh)
    if tuple(axes) != tuple(dp):
        raise ValueError(f"a global batch of {batch} rows does not divide "
                         f"over the data axes {dp} of sizes "
                         f"{[shd.axis_sizes(mesh)[a] for a in dp]}")
    names = shd.axis_names(mesh)
    coord = _coord(mesh)
    idx, n = 0, 1
    for a in dp:
        size = mesh.size(names.index(a))
        idx, n = idx * size + coord[names.index(a)], n * size
    rows = batch // n

    def one(x):
        if torch.is_tensor(x) and x.dim() > 0 and x.shape[0] == batch:
            return x[idx * rows:(idx + 1) * rows]
        return x
    if isinstance(tree, dict):
        return tree_map(one, tree)
    return one(tree)


def resident_bytes(tree: Params) -> int:
    """Bytes of the local chunks (of every leaf) this rank holds."""
    return sum(local(x).numel() * local(x).element_size()
               for x in tree_leaves(tree) if torch.is_tensor(x))


def shard_shape(shape: Sequence[int], spec: Tuple[Any, ...],
                sizes: dict) -> Tuple[int, ...]:
    """A leaf's chunk shape by the spec arithmetic."""
    out = []
    for dim, entry in zip(shape, spec):
        n = math.prod(sizes[a] for a in shd.entry_axes(entry))
        if dim % n:
            raise ValueError(f"dim {dim} does not divide over {entry}")
        out.append(dim // n)
    return tuple(out)
