"""Meshes and the rank launcher — the port of ``repro.launch.mesh``.

JAX runs a whole mesh from one controller; here every rank is a process
running the same program (SPMD). :func:`run_ranks` starts the ranks for
one function; a :class:`RankGroup` keeps them up across calls (each rank
keeping its own state), as a fleet's sequence-parallel replica needs;
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

import contextlib
import datetime
import os
import pickle
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


class RankLost(RuntimeError):
    """A rank of a :class:`RankGroup` exited without being asked (killed,
    or died outside Python): the group is stopped. A fleet reads it as a
    replica that stops beating, where a rank that raises is a failure."""


def _group_rank_main(rank: int, world: int, backend: str, device: str,
                     init_method: str, timeout_s: float,
                     threads: Optional[int], conn) -> None:
    """One rank of a :class:`RankGroup`: join the group, then run each call
    whose work file the parent names on ``conn``, with this rank's state
    kept between calls, until the parent sends None. Every reply is
    ``(ok, result or traceback)``, pickled here."""
    state: dict = {}
    try:
        if threads:
            torch.set_num_threads(threads)
        dev = torch.device(device)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        dist.init_process_group(
            backend, init_method=init_method, rank=rank, world_size=world,
            timeout=datetime.timedelta(seconds=timeout_s))
    except Exception:           # the rank's boundary: report, then exit
        conn.send_bytes(pickle.dumps((False, traceback.format_exc())))
        return
    try:
        while True:
            try:
                work = conn.recv()
            except EOFError:    # the parent is gone
                break
            if work is None:
                break
            try:
                with open(work, "rb") as f:      # written by RankGroup.submit
                    fn, args = pickle.load(f)
                reply = pickle.dumps((True, fn(rank, dev, state, *args)))
            except Exception:   # the rank's boundary: report, keep serving
                reply = pickle.dumps((False, traceback.format_exc()))
            conn.send_bytes(reply)
    finally:
        state.clear()
        if dist.is_initialized():
            dist.destroy_process_group()


class RankGroup:
    """``world`` spawned rank processes joined in one process group that
    live until :meth:`close`: each :meth:`call` runs a module-level
    ``fn(rank, device, state, *args)`` on every rank (``state``: the
    rank's own dict, kept between calls) and returns the results in rank
    order.

    The rendezvous goes through a file in a new temporary directory, so
    concurrent groups never race for a port; each call's function and
    arguments are pickled once into a work file there that every rank
    reads (a large argument sent to each rank in turn would serialize the
    ranks behind the parent). ``device``, ``backend`` and ``threads`` as
    in :func:`run_ranks`; ``devices`` pins rank r to ``devices[r]``
    (default: :func:`rank_device`'s rule over this group alone).

    A rank that raises makes the call raise ``RuntimeError`` with that
    rank's traceback; a rank that exits without a result makes it raise
    :class:`RankLost`; a call past ``timeout_s`` raises ``TimeoutError``.
    Each stops the whole group first (a surviving rank may be waiting in
    a collective for the one that is gone). ``timeout_s`` is also the
    group's collective timeout."""

    def __init__(self, world: int, *, backend: Optional[str] = None,
                 device: Any = None,
                 devices: Optional[Sequence[Any]] = None,
                 timeout_s: float = 600.0, threads: Optional[int] = None):
        import multiprocessing as mp

        device_type = torch.device("cuda" if device is None else device).type
        backend = backend or default_backend(world, device_type)
        if devices is None:                     # the rule, before any spawn
            devices = [rank_device(r, world, backend, device_type)
                       for r in range(world)]
        devices = [torch.device(d) for d in devices]
        if len(devices) != world or any(d.type != device_type
                                        for d in devices):
            raise ValueError(f"devices {devices}: need {world} of type "
                             f"{device_type!r}")
        self.world, self.devices = world, devices
        self.timeout_s = float(timeout_s)
        self._tmp = tempfile.mkdtemp(prefix="repro_torch_ranks_")
        init_method = "file://" + os.path.join(self._tmp, "rendezvous")
        ctx = mp.get_context("spawn")
        self._procs, self._conns = [], []
        self._pending: Optional[str] = None
        self._calls = 0
        self._closed = self._broken = False
        try:
            for r in range(world):
                parent, child = ctx.Pipe()
                p = ctx.Process(target=_group_rank_main, daemon=True,
                                args=(r, world, backend, str(devices[r]),
                                      init_method, self.timeout_s, threads,
                                      child))
                p.start()
                child.close()
                self._procs.append(p)
                self._conns.append(parent)
        except BaseException:
            self.close()
            raise

    @property
    def pids(self) -> list:
        return [p.pid for p in self._procs]

    def alive(self) -> bool:
        """Every rank is up and the group is not closed."""
        return not self._closed and all(p.is_alive() for p in self._procs)

    def submit(self, fn: Callable, *args: Any) -> None:
        """Start ``fn`` on every rank; :meth:`collect` returns the results.
        Lets the parent start several groups' calls before waiting."""
        if self._closed:
            raise RuntimeError("the rank group is closed")
        if self._pending is not None:
            raise RuntimeError("a call is already running on this group")
        self._calls += 1
        work = os.path.join(self._tmp, f"call{self._calls}.pkl")
        with open(work, "wb") as f:
            pickle.dump((fn, tuple(args)), f)
        for conn in self._conns:
            try:
                conn.send(work)
            except OSError:     # a rank that is gone: collect reports it
                pass
        self._pending = work

    @property
    def pending(self) -> bool:
        return self._pending is not None

    def collect(self) -> list:
        """The submitted call's results in rank order (see the class
        docstring for failures, each of which closes the group)."""
        if self._pending is None:
            raise RuntimeError("no call was submitted")
        work, self._pending = self._pending, None
        try:
            return self._collect()
        except BaseException:
            self._broken = True
            self.close()
            raise
        finally:
            with contextlib.suppress(OSError):
                os.remove(work)

    def call(self, fn: Callable, *args: Any) -> list:
        """Run ``fn(rank, device, state, *args)`` on every rank; the
        results in rank order."""
        self.submit(fn, *args)
        return self.collect()

    def _collect(self) -> list:
        from multiprocessing.connection import wait

        deadline = time.monotonic() + self.timeout_s
        waiting = {conn: r for r, conn in enumerate(self._conns)}
        out = {}
        while waiting:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(f"ranks {sorted(waiting.values())} of "
                                   f"{self.world} did not finish within "
                                   f"{self.timeout_s:.0f}s")
            for conn in wait(list(waiting), timeout=left):
                r = waiting.pop(conn)
                try:
                    ok, payload = pickle.loads(conn.recv_bytes())
                except (EOFError, OSError):
                    self._procs[r].join(5)
                    raise RankLost(f"rank {r} of {self.world} exited with "
                                   f"code {self._procs[r].exitcode} "
                                   f"without a result")
                if not ok:
                    lost = self._exited_rank()
                    if lost is not None:  # its peer's collective broke
                        raise RankLost(
                            f"rank {lost} of {self.world} exited with code "
                            f"{self._procs[lost].exitcode}; rank {r} then "
                            f"failed:\n{payload}")
                    raise RuntimeError(f"rank {r} of {self.world} failed:"
                                       f"\n{payload}")
                out[r] = payload
        return [out[r] for r in range(self.world)]

    def _exited_rank(self, grace_s: float = 0.5) -> Optional[int]:
        """A rank that exited without a reply, looking for up to
        ``grace_s``: a peer's collective can fail on a closed socket
        before the exit is seen. Only such a rank exits with a code other
        than 0 (a rank whose start failed replies its traceback, then
        exits with 0: a failure, not a loss)."""
        deadline = time.monotonic() + grace_s
        while True:
            for r, p in enumerate(self._procs):
                if p.exitcode not in (None, 0):
                    return r
            if time.monotonic() >= deadline:
                return None
            time.sleep(0.05)

    def close(self) -> None:
        """Stop and reap every rank (gracefully when the group is whole
        and idle, else at once) and remove the temporary directory.
        Idempotent."""
        if self._closed:
            return
        self._closed = True
        graceful = (not self._broken and self._pending is None
                    and all(p.is_alive() for p in self._procs))
        self._pending = None            # a running call's result is lost
        if graceful:
            for conn in self._conns:
                with contextlib.suppress(OSError):
                    conn.send(None)
            deadline = time.monotonic() + 30.0
            for p in self._procs:
                p.join(max(deadline - time.monotonic(), 0.1))
        for p in self._procs:
            if p.is_alive():
                p.terminate()
                p.join(5)
            if p.is_alive():
                p.kill()
                p.join(5)
        for conn in self._conns:
            conn.close()
        shutil.rmtree(self._tmp, ignore_errors=True)

    def __enter__(self) -> "RankGroup":
        return self

    def __exit__(self, *exc: Any) -> None:
        self.close()


def _stateless(rank: int, device: torch.device, state: dict, fn: Callable,
               *args: Any) -> Any:
    return fn(rank, device, *args)


def run_ranks(fn: Callable, world: int, *, backend: Optional[str] = None,
              device: Any = None, timeout_s: float = 600.0,
              threads: Optional[int] = None,
              args: Sequence[Any] = ()) -> list:
    """Run ``fn(rank, device, *args)`` in ``world`` fresh processes (the
    ``spawn`` start method) joined in one process group, and return each
    rank's result in rank order: a :class:`RankGroup` started, called once
    and closed. ``fn`` must be importable by name (a module-level
    function) and its results picklable.

    A rank that raises makes this raise with that rank's traceback (the
    other ranks are stopped); a run past ``timeout_s`` is stopped and
    raises ``TimeoutError``. ``device``: ``"cpu"`` or CUDA (the default);
    ``backend``: see :func:`default_backend`. ``threads``: torch's
    intra-op threads a rank."""
    with RankGroup(world, backend=backend, device=device,
                   timeout_s=timeout_s, threads=threads) as group:
        return group.call(_stateless, fn, *args)
