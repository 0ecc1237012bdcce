"""Meshes and the rank launcher — the port of ``repro.launch.mesh``.

JAX runs a whole mesh from one controller; here every rank is a process
running the same program (SPMD). :func:`run_ranks` starts the ranks;
:func:`make_inference_mesh` builds the ``("data", "seq")`` serving mesh
and :func:`make_debug_mesh` the ``("data", "model")`` training mesh
inside each of them. :func:`make_production_mesh` is a mesh's shape
alone (axis names and sizes) for the planner (``launch/dryrun.py``),
which places nothing and needs no process group. The reference's
``ensure_host_devices`` has no counterpart: it forces fake XLA host
devices for the reference's planner, and this planner runs on no device.

The backend follows a rule, never a fallback:

* on the CPU the backend is ``gloo``;
* where there are no more ranks than visible cards, rank r uses
  ``cuda:r`` (``nccl`` or ``gloo``);
* where there are more ranks than cards, ranks share the cards round
  robin, which NCCL refuses: the caller must pass ``backend="gloo"``
  (Gloo stages each collective's CUDA tensors through the host).
"""
from __future__ import annotations

import datetime
import os
import pickle
import queue
import shutil
import tempfile
import time
import traceback
from typing import Any, Callable, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

BACKENDS = ("nccl", "gloo")


def parse_mesh_arg(arg: str) -> Tuple[int, int]:
    """'RxS' (e.g. '1x8') → (data, seq). Raises SystemExit on bad input:
    this parses a CLI flag."""
    try:
        data, seq = (int(p) for p in arg.lower().split("x"))
    except ValueError:
        raise SystemExit(f"--mesh expects 'DATAxSEQ' (e.g. 1x8), got {arg!r}")
    if data < 1 or seq < 1:
        raise SystemExit(f"--mesh sizes must be >= 1, got {arg!r}")
    return data, seq


def default_backend(world: int, device_type: str) -> str:
    """``gloo`` on the CPU, ``nccl`` where every rank has its own card;
    ranks that would share a card get no default (NCCL refuses them, and
    Gloo must be asked for)."""
    if device_type == "cpu":
        return "gloo"
    cards = torch.cuda.device_count()
    if world > cards:
        raise ValueError(f"{world} ranks on {cards} card(s) share a card, "
                         f"which NCCL refuses: pass backend='gloo' "
                         f"(--dist-backend gloo)")
    return "nccl"


def rank_device(rank: int, world: int, backend: str,
                device_type: str) -> torch.device:
    """The device of ``rank`` under the rule in the module docstring."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; known: {BACKENDS}")
    if device_type == "cpu":
        if backend != "gloo":
            raise ValueError(f"CPU ranks need backend 'gloo', got {backend!r}")
        return torch.device("cpu")
    if device_type != "cuda":
        raise ValueError(f"ranks run on 'cuda' or 'cpu', got {device_type!r}")
    cards = torch.cuda.device_count()
    if cards == 0:
        raise RuntimeError("CUDA is not available; pass device='cpu' to run "
                           "the ranks on the CPU")
    if world > cards and backend != "gloo":
        raise ValueError(f"{world} ranks on {cards} card(s) share a card, "
                         f"which NCCL refuses: pass backend='gloo'")
    return torch.device("cuda", rank % cards)


def make_production_mesh(*, multi_pod: bool = False):
    """16 x 16 = 256 cards, ``("data", "model")``; with ``multi_pod`` two
    such pods, ``("pod", "data", "model")`` = (2, 16, 16). A shape, not a
    process group: the sharding rules (``rules_for``, ``spec_tree``,
    ``placement.shard_shape``) read only its names and sizes."""
    from repro_torch.runtime.sharding import AxisLayout

    if multi_pod:
        return AxisLayout(("pod", "data", "model"), (2, 16, 16))
    return AxisLayout(("data", "model"), (16, 16))


def _world_mesh(shape: Tuple[int, int], names: Tuple[str, str], device: Any,
                backend: Optional[str], what: str):
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        raise RuntimeError(f"{what} runs inside a rank: start the ranks with "
                           f"run_ranks (or init the process group first)")
    world = dist.get_world_size()
    if shape[0] * shape[1] != world:
        raise ValueError(f"mesh {shape[0]}x{shape[1]} needs "
                         f"{shape[0] * shape[1]} ranks, the group has {world}")
    if backend is not None and dist.get_backend() != backend:
        raise ValueError(f"the process group runs {dist.get_backend()!r}, "
                         f"not the {backend!r} asked for")
    dev_type = torch.device("cuda" if device is None else device).type
    return init_device_mesh(dev_type, shape, mesh_dim_names=names)


def make_inference_mesh(data: int = 1, seq: int = 1, *,
                        device: Any = None, backend: Optional[str] = None):
    """The serving mesh of the sequence-parallel DiT engine, dims
    ``("data", "seq")`` over this process's default group (one rank per
    mesh entry, rank r at ``(r // seq, r % seq)``): requests batch over
    'data', long sequences scatter over 'seq'. ``backend``, when given,
    must be the group's own."""
    return _world_mesh((data, seq), ("data", "seq"), device, backend,
                       "make_inference_mesh")


def make_debug_mesh(data: int = 1, model: int = 1, *, device: Any = None,
                    backend: Optional[str] = None):
    """The training mesh, dims ``("data", "model")`` over this process's
    default group (rank r at ``(r // model, r % model)``): weights and
    batches shard by ``runtime/sharding``'s rules. ``backend`` as in
    :func:`make_inference_mesh`."""
    return _world_mesh((data, model), ("data", "model"), device, backend,
                       "make_debug_mesh")


def _rank_main(rank: int, world: int, backend: str, device_type: str,
               init_method: str, timeout_s: float, threads: Optional[int],
               work: str, results) -> None:
    try:
        with open(work, "rb") as f:          # written by run_ranks
            fn, args = pickle.load(f)
        if threads:
            torch.set_num_threads(threads)
        device = rank_device(rank, world, backend, device_type)
        if device.type == "cuda":
            torch.cuda.set_device(device)
        dist.init_process_group(
            backend, init_method=init_method, rank=rank, world_size=world,
            timeout=datetime.timedelta(seconds=timeout_s))
        results.put((rank, True, fn(rank, device, *args)))
    except Exception:           # the rank's boundary: report, then exit
        results.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def run_ranks(fn: Callable, world: int, *, backend: Optional[str] = None,
              device: Any = None, timeout_s: float = 600.0,
              threads: Optional[int] = None,
              args: Sequence[Any] = ()) -> list:
    """Run ``fn(rank, device, *args)`` in ``world`` fresh processes (the
    ``spawn`` start method) joined in one process group, and return each
    rank's result in rank order. ``fn`` must be importable by name (a
    module-level function) and its results picklable.

    The group rendezvous goes through a file in a new temporary directory,
    so concurrent launches never race for a port. A rank that raises makes
    this raise with that rank's traceback (the other ranks are stopped); a
    run past ``timeout_s`` is stopped and raises ``TimeoutError``.
    ``device``: ``"cpu"`` or CUDA (the default); ``backend``: see
    :func:`default_backend`. ``threads``: torch's intra-op threads a rank."""
    import multiprocessing as mp

    device_type = torch.device("cuda" if device is None else device).type
    backend = backend or default_backend(world, device_type)
    for r in range(world):                      # the rule, before any spawn
        rank_device(r, world, backend, device_type)
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    tmp = tempfile.mkdtemp(prefix="repro_torch_ranks_")
    init_method = "file://" + os.path.join(tmp, "rendezvous")
    # the work goes through a file: a large argument pickled into each
    # process's start would hold the parent's start() of the next rank
    # until this one had imported the function's modules
    work = os.path.join(tmp, "work.pkl")
    with open(work, "wb") as f:
        pickle.dump((fn, tuple(args)), f)
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(r, world, backend, device_type, init_method,
                               timeout_s, threads, work, results))
             for r in range(world)]
    deadline = time.monotonic() + timeout_s
    out = {}
    try:
        for p in procs:
            p.start()
        while len(out) < world:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(f"ranks {sorted(set(range(world)) - set(out))}"
                                   f" did not finish within {timeout_s:.0f}s")
            try:
                rank, ok, payload = results.get(timeout=min(left, 1.0))
            except queue.Empty:
                dead = [(r, p.exitcode) for r, p in enumerate(procs)
                        if r not in out and p.exitcode not in (None, 0)]
                if dead:
                    raise RuntimeError(f"rank {dead[0][0]} exited with code "
                                       f"{dead[0][1]} without a result")
                continue
            if not ok:
                raise RuntimeError(f"rank {rank} of {world} failed:\n{payload}")
            out[rank] = payload
        for p in procs:
            p.join(max(deadline - time.monotonic(), 0.1))
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(5)
            if p.is_alive():
                p.kill()
                p.join(5)
        results.close()
        shutil.rmtree(tmp, ignore_errors=True)
    return [out[r] for r in range(world)]
