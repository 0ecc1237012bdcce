"""Roofline terms of a planned step — the port of ``repro.launch.roofline``.

Sources (``launch/dryrun.py``):

* FLOPs and bytes a device come from tracing the step on ``meta``
  tensors at one device's shapes: ``FlopCounterMode`` for the FLOPs and
  a dispatch mode that sums each aten op's input and output bytes (the
  upper bound that XLA's "bytes accessed" also is).
* Collectives come from the plan's own arithmetic: the trace runs the
  port's sharded code paths (the per-layer gather of each placed leaf,
  the gradients' float32 reduce over the data axes, the losses'
  ``data_mean`` all-reduces, the LMs' ``sequence_parallel`` gathers) on a
  mesh shape, and :class:`CollectiveLedger` records each
  ``torch.distributed`` call they make with its operand and result
  bytes and its mesh axis. No collective runs.

Hardware model (:class:`Hardware`, default the H100 SXM): 989 TFLOP/s
bf16 dense, 3.35 TB/s HBM, 80 GB; NVLink at 450 GB/s a direction within
an 8-card node, and one 400 Gb/s NIC a card (50 GB/s a direction)
between nodes. A collective is priced at the slowest link its mesh axis
crosses: ranks are numbered row-major over the mesh and a node holds
eight consecutive ranks, so 'model' (innermost) at size 16 spans two
nodes, and every outer axis of a (16, 16) mesh leaves the node.
"""
from __future__ import annotations

import contextlib
import dataclasses
import inspect
import math
from typing import Any, Dict, Iterator, Optional

import torch
import torch.distributed as dist

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")


@dataclasses.dataclass(frozen=True)
class Hardware:
    """Per-card rates of the planner's hardware model."""
    name: str = "H100 SXM"
    peak_flops: float = 989e12          # bf16 dense tensor cores
    hbm_bw: float = 3.35e12
    hbm_bytes: float = 80e9
    node_link_bw: float = 450e9         # NVLink, a direction
    network_bw: float = 50e9            # one 400 Gb/s NIC a card
    cards_per_node: int = 8


H100_SXM = Hardware()


def h100() -> Hardware:
    """The H100 SXM model; its HBM size read from the card when one is
    present."""
    if torch.cuda.is_available():
        props = torch.cuda.get_device_properties(0)
        return dataclasses.replace(H100_SXM, hbm_bytes=float(props.total_memory))
    return H100_SXM


def axis_link_bw(mesh: Any, axis: str, hw: Hardware = H100_SXM) -> float:
    """The slowest link a collective over ``axis`` crosses: NVLink when
    the axis's ranks (stride: the product of the inner axes' sizes) stay
    within one node, else the network."""
    from repro_torch.runtime.sharding import axis_names, axis_sizes
    names, sizes = axis_names(mesh), axis_sizes(mesh)
    stride = math.prod(sizes[a] for a in names[names.index(axis) + 1:])
    span = stride * sizes[axis]
    return hw.node_link_bw if span <= hw.cards_per_node else hw.network_bw


# ---------------------------------------------------------------------------
# The collective ledger


def wire_bytes(kind: str, operand: float, result: float) -> float:
    """Modeled bytes on the wire a device (ring algorithms), the
    reference's rule."""
    if kind == "all-gather":
        return max(result - operand, operand)
    if kind == "all-reduce":
        return 2 * operand
    return operand


# The torch.distributed calls of the port's sharded code: each one's kind
# and the index of its operand among its arguments (its result is first).
_CALLS = {"all_gather_into_tensor": ("all-gather", 1),
          "reduce_scatter_tensor": ("reduce-scatter", 1),
          "all_reduce": ("all-reduce", 0),
          "all_to_all_single": ("all-to-all", 1)}


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class CollectiveLedger:
    """Per collective kind: op count, operand bytes, result bytes and
    modeled wire bytes a device; wire bytes per mesh axis.
    :meth:`record` swaps the ``torch.distributed`` collectives the port
    calls for recorders: a call is counted, and nothing is sent unless
    asked. Under a plan the group handed to a call is the mesh axis
    (``PlanMesh.get_group``)."""

    def __init__(self):
        self.kinds = {k: {"count": 0, "operand_bytes": 0.0,
                          "result_bytes": 0.0, "wire_bytes": 0.0}
                      for k in COLLECTIVES}
        self.axis_wire: Dict[str, float] = {}

    def add(self, kind: str, operand: float, result: float, axis: str) -> None:
        rec = self.kinds[kind]
        w = wire_bytes(kind, operand, result)
        rec["count"] += 1
        rec["operand_bytes"] += operand
        rec["result_bytes"] += result
        rec["wire_bytes"] += w
        self.axis_wire[axis] = self.axis_wire.get(axis, 0.0) + w

    @contextlib.contextmanager
    def record(self, send: bool = False) -> Iterator["CollectiveLedger"]:
        """Count the calls made inside; ``send`` also makes each call (the
        ranks of a real process group count what they send)."""
        sound = {name: getattr(dist, name) for name in _CALLS}

        def recorder(name):
            kind, src = _CALLS[name]
            sig = inspect.signature(sound[name])

            def call(*a, **kw):
                got = sig.bind(*a, **kw).arguments
                ts = list(got.values())
                self.add(kind, _nbytes(ts[src]), _nbytes(ts[0]),
                         got.get("group"))
                return sound[name](*a, **kw) if send else None
            return call
        for name in _CALLS:
            setattr(dist, name, recorder(name))
        try:
            yield self
        finally:
            for name, fn in sound.items():
                setattr(dist, name, fn)

    def as_dict(self) -> Dict[str, Dict[str, float]]:
        return {k: dict(v) for k, v in self.kinds.items()}


class PlanMesh:
    """A mesh shape that the port's sharded code paths accept in place of
    a ``DeviceMesh`` while a :class:`CollectiveLedger` records: this
    device sits at coordinate 0 on every axis (all devices do the same
    work), and an axis's group is its name."""

    def __init__(self, layout: Any):
        from repro_torch.runtime.sharding import axis_names, axis_sizes
        self.axis_names = axis_names(layout)
        self.shape = tuple(axis_sizes(layout)[a] for a in self.axis_names)
        self.ndim = len(self.shape)

    def _index(self, dim: Any) -> int:
        return self.axis_names.index(dim) if isinstance(dim, str) else dim

    def size(self, dim: Any) -> int:
        return self.shape[self._index(dim)]

    def get_group(self, dim: Any) -> str:
        return self.axis_names[self._index(dim)]

    def get_local_rank(self, dim: Any) -> int:
        return 0

    def get_coordinate(self):
        return [0] * self.ndim


# ---------------------------------------------------------------------------
# Terms


def roofline_terms(cost: Dict[str, float], collectives: Dict[str, Dict],
                   n_devices: int, model_flops_global: Optional[float] = None,
                   *, hw: Hardware = H100_SXM,
                   axis_wire: Optional[Dict[str, float]] = None,
                   mesh: Any = None) -> Dict[str, Any]:
    """The reference's terms and arithmetic on ``hw``. With ``axis_wire``
    (wire bytes by mesh axis) and ``mesh`` each axis's bytes go at its
    slowest link (:func:`axis_link_bw`); without, all at ``hw``'s
    network rate."""
    flops_dev = float(cost.get("flops", 0.0) or 0.0)
    bytes_dev = float(cost.get("bytes accessed", 0.0) or 0.0)
    coll_operand = sum(v["operand_bytes"] for v in collectives.values())
    coll_wire = sum(v["wire_bytes"] for v in collectives.values())
    t_compute = flops_dev / hw.peak_flops
    t_memory = bytes_dev / hw.hbm_bw
    if axis_wire is None:
        t_coll = coll_wire / hw.network_bw
    else:
        t_coll = sum(w / axis_link_bw(mesh, a, hw) for a, w in axis_wire.items())
    terms = {"compute_s": t_compute, "memory_s": t_memory,
             "collective_s": t_coll,
             "hlo_flops_per_device": flops_dev,
             "hlo_bytes_per_device": bytes_dev,
             "collective_operand_bytes": coll_operand,
             "collective_wire_bytes": coll_wire}
    dom = max(("compute_s", "memory_s", "collective_s"),
              key=lambda k: terms[k])
    terms["dominant"] = dom.replace("_s", "")
    bound = max(terms["compute_s"], terms["memory_s"], terms["collective_s"])
    terms["roofline_fraction"] = (terms["compute_s"] / bound) if bound > 0 else 0.0
    if model_flops_global:
        terms["model_flops_global"] = model_flops_global
        hlo_global = flops_dev * n_devices
        terms["useful_flops_ratio"] = (model_flops_global / hlo_global
                                       if hlo_global else 0.0)
    return terms


# ---------------------------------------------------------------------------
# Analytic MODEL_FLOPS (6·N·D train / 2·N·D inference; active params for MoE)


def model_flops(cfg, shape_kind: str, tokens: int) -> float:
    n = cfg.active_params()
    if shape_kind == "train":
        return 6.0 * n * tokens
    return 2.0 * n * tokens
