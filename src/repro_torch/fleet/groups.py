"""A sampling pipeline over a persistent rank group: the data plane of a
fleet's sequence-parallel replicas (``launch/serve.py --mesh DATAxSEQ
--replicas N``).

The reference builds N pipelines, each over its own SEQ-wide device
slice, and drives every mesh from one controller. In the port a mesh is
a process group, so a replica's mesh is a
:class:`~repro_torch.launch.mesh.RankGroup` of SEQ rank processes that
lives as long as the replica. Each rank holds a ``FlexiPipeline`` on a
``(1, SEQ)`` inference mesh over the same weights; :class:`RankGroupPipeline`
is what ``FixedSlotEngine`` and ``Replica`` read from a pipeline
(``cfg``, ``sched``, ``device``, ``sample``, ``cache_stats``).

``sample`` ships the plan, the labels, the prior, the DDPM noise and the
generator's state (not a seed: a generator that has already drawn gives
the same draws on every rank) to every rank as CPU tensors; every rank
samples, rank 0's x0 comes back and is placed on ``device``, and the
caller's generator moves on as the ranks' did. With ``device`` on CUDA
the parent draws what a single-device pipeline on that card draws, so a
fleet over groups can be held against a single-device fleet request for
request.

A rank that raises, or cannot start, fails the call loudly; a rank that
is gone (killed, or died outside Python) stops the whole group, :meth:`alive` turns False and the
fleet's replica stops beating (``fleet/fleet.py``). Nothing falls back to
one device.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Sequence, Union

import torch

from repro_torch.device import resolve_device
from repro_torch.launch.mesh import RankGroup, RankLost
from repro_torch.pipeline.pipeline import SampleResult

#: an int seed (``init_dit`` on each rank's device), a numpy tree in the
#: reference's layout (``convert.params_from_numpy``), or a module-level
#: ``weights(device) -> params``
Weights = Union[int, Dict[str, Any], Callable[[torch.device], Any]]


def _build_rank(rank: int, device: torch.device, state: dict, cfg, sched,
                weights: Weights) -> Dict[str, int]:
    """Rank side: this group's ``(1, SEQ)`` mesh and its pipeline."""
    import torch.distributed as dist

    from repro_torch import convert
    from repro_torch.launch.mesh import make_inference_mesh
    from repro_torch.models import dit as dit_mod
    from repro_torch.pipeline.pipeline import FlexiPipeline

    mesh = make_inference_mesh(1, dist.get_world_size(), device=device)
    if isinstance(weights, int):
        params = dit_mod.init_dit(
            cfg, torch.Generator(device=device).manual_seed(weights))
    elif isinstance(weights, dict):
        params = convert.params_from_numpy(weights, device=device)
    else:
        params = weights(device)
    state["pipe"] = FlexiPipeline(params, cfg, sched, device=device,
                                  mesh=mesh)
    return state["pipe"].cache_stats()


def _sample_rank(rank: int, device: torch.device, state: dict, plan, n: int,
                 gen_state: Optional[torch.Tensor], cond, x_T, noise
                 ) -> Optional[Dict[str, Any]]:
    """Rank side: one ``FlexiPipeline.sample``; rank 0 returns x0 on the
    CPU with the generator's state after the draws."""
    pipe = state["pipe"]
    gen = None
    if gen_state is not None:
        gen = torch.Generator(device=device)
        gen.set_state(gen_state)
    res = pipe.sample(plan, n, gen, cond=_to(cond, device),
                      x_T=_to(x_T, device), noise=_to(noise, device))
    if rank != 0:
        return None
    return {"x0": res.x0.cpu(), "flops": res.flops,
            "relative_compute": res.relative_compute, "trace": res.trace,
            "generator": None if gen is None else gen.get_state(),
            "stats": pipe.cache_stats()}


def _to(t: Any, device: Any) -> Any:
    return t.to(device) if isinstance(t, torch.Tensor) else t


class RankGroupPipeline:
    """A ``FlexiPipeline`` stand-in whose ``sample`` runs on ``seq`` rank
    processes of one group (Ulysses or the ring, by the plan's
    ``ParallelSpec``).

    >>> pipe = RankGroupPipeline(cfg, sched, 0, 2, device="cuda",
    ...                          backend="gloo")
    >>> res = pipe.sample(plan, 4, torch.Generator("cuda").manual_seed(1))
    >>> pipe.close()

    The group starts and builds its pipeline in the background;
    :meth:`wait_ready` (or the first call) waits for it. ``devices``,
    ``backend``, ``timeout_s`` and ``threads``: as
    :class:`~repro_torch.launch.mesh.RankGroup`'s.
    """

    def __init__(self, cfg, sched, weights: Weights, seq: int, *,
                 device: Any = None, backend: Optional[str] = None,
                 devices: Optional[Sequence[Any]] = None,
                 timeout_s: float = 600.0, threads: Optional[int] = None):
        self.cfg, self.sched, self.seq = cfg, sched, int(seq)
        self.device = resolve_device(device)
        self.group = RankGroup(self.seq, backend=backend,
                               device=self.device.type, devices=devices,
                               timeout_s=timeout_s, threads=threads)
        # rank 0's runner-cache counters as of its last call
        self._stats = dict.fromkeys(("runners", "hits", "misses",
                                     "compiled"), 0)
        self.group.submit(_build_rank, cfg, sched, weights)

    def wait_ready(self) -> None:
        """Wait for the ranks to join and build their pipelines."""
        if self.group.pending:
            self._stats = self.group.collect()[0]

    def alive(self) -> bool:
        """Every rank is up. A group that lost a rank is stopped here; one
        whose rank could not start raises that rank's traceback (the rank
        replies it, then exits)."""
        if self.group.alive():
            return True
        try:
            self.wait_ready()
        except RankLost:
            pass
        self.group.close()
        return False

    def close(self) -> None:
        self.group.close()

    def cache_stats(self) -> Dict[str, int]:
        """Rank 0's runner-cache counters as of its last call (the ranks
        build the same runners; a closed group keeps its last ones)."""
        self.wait_ready()
        return dict(self._stats)

    def sample(self, plan, n: int, generator: Optional[torch.Generator], *,
               cond: Any = None, x_T: Optional[torch.Tensor] = None,
               noise: Optional[torch.Tensor] = None) -> SampleResult:
        """``FlexiPipeline.sample`` on every rank of the group; rank 0's
        result, x0 on ``device``."""
        self.wait_ready()
        out = self.group.call(
            _sample_rank, plan, n,
            None if generator is None else generator.get_state(),
            *(_to(t, "cpu") for t in (cond, x_T, noise)))[0]
        self._stats = out["stats"]
        if generator is not None:
            generator.set_state(out["generator"])
        return SampleResult(x0=out["x0"].to(self.device), flops=out["flops"],
                            relative_compute=out["relative_compute"],
                            trace=out["trace"])
