"""Compile-once runners: the port's counterpart of the reference's
``jax.jit`` on its phase runners and packed steps.

:func:`capture` wraps a runner body. On CUDA tensors the wrapper keeps
one CUDA graph per key and replays it:

* the key is the host branch (what the runner's ``host`` function
  decides on the host: the deep/shallow branch of each cached micro-step,
  say), the identity of every tensor of the parameter tree (the body's
  first argument) and the shape, dtype and device of every other tensor
  argument; other leaves (ints, None, strings) join the key by value.
  Host data (numpy, generators) is refused as a body argument: it goes
  through ``host``;
* a key's first call runs the body eagerly on the thread's capture
  stream (that call's result is returned; it fills every lazily built
  constant: schedule tables, pack plans, the kernels' libraries), then
  captures it with ``capture_error_mode="thread_local"`` into a private
  pool, so a warm-up thread may capture while the serving thread
  launches work. A failed capture raises; nothing falls back to eager;
* the wrapper owns static input buffers and copies the inputs into them
  before each replay, and returns clones of the outputs (callers keep
  latents, scatter deltas and hold tap tensors across later replays);
* ``donate`` names body arguments that are resident instead (the
  counterpart of ``jax.jit(fn, donate_argnums=...)``; the LM decode step
  donates its cache, a train step its parameter tree and its optimizer
  state, ``donate=(0, 1)``): they join the key by the identity of their
  tensors, as the parameter tree does, are read and written in place by
  the captured region (never copied in, never cloned out), come back as
  the caller's own objects when the body returns them whole, and are
  held by the graph. The capture itself runs no kernel, so a body that
  writes a donated tree is applied once by the key's first call (its
  eager run) and once by each replay, never twice a call. A caller that
  needs a donated tree's old values copies them first, as the
  reference's donated buffers are dead after the call;
* it holds a reference to every tensor the captured region reads that
  it did not make: the parameter tree, its static buffers, and the
  cached device constants the region reads, which the caches register
  through :func:`hold` (pack plans, positional embeddings, projection
  matrices, tile envelopes, schedule tables), so a replay never reads
  freed memory; a new parameter tree captures afresh (a train step,
  whose donated trees are dead after a call, first drops the graphs of
  the trees it held: :class:`Captured`'s ``one_tree``);
* kernel wrappers count their launches through :func:`count`: while this
  thread captures, a launch joins the capture's tally, and each replay
  adds that tally to the wrapper's counters, so launch counts read the
  same as eager.

A runner's graphs, and their pools, go when the runner does.

On CPU tensors the body runs eagerly (the caller asked for the CPU) and
the key is still computed and recorded (``keys_seen``), so the CPU tests
can hold the keying. :func:`disabled` is the counterpart of
``jax.disable_jit()``: under it (per thread) every runner runs eagerly.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

import torch
import torch.utils._pytree as pytree

_local = threading.local()


@contextlib.contextmanager
def disabled() -> Iterator[None]:
    """Run every captured runner eagerly on this thread (the eager
    reference of a captured run)."""
    depth = getattr(_local, "disabled", 0)
    _local.disabled = depth + 1
    try:
        yield
    finally:
        _local.disabled = depth


def is_disabled() -> bool:
    return getattr(_local, "disabled", 0) > 0


def hold(*tensors: torch.Tensor) -> None:
    """Keep ``tensors`` alive as long as the graph this thread is
    capturing: the port's caches of device constants (pack plans,
    positional embeddings, projection matrices, tile envelopes, schedule
    tables) call it where a region reads them, so an eviction cannot free
    memory a replay reads. A no-op outside a capture."""
    held = getattr(_local, "held", None)
    if held is not None:
        held.extend(tensors)


def count(fn: Callable[..., None], *key: Any) -> None:
    """Count one launch: ``fn(*key, 1)`` now, or, while this thread
    captures a runner, ``fn(*key, n)`` at each replay of that capture."""
    tally = getattr(_local, "tally", None)
    if tally is None:
        fn(*key, 1)
    else:
        tally[(fn, key)] = tally.get((fn, key), 0) + 1


def _signature(x: Any) -> Any:
    if isinstance(x, torch.Tensor):
        return ("tensor", tuple(x.shape), x.dtype, x.device)
    if x is None or isinstance(x, (bool, int, float, str)):
        return x
    raise TypeError(f"a captured runner takes tensors and Python scalars; "
                    f"got {type(x).__name__} (host data goes through the "
                    f"runner's host function)")


def _param_ids(params: Any) -> Tuple[int, ...]:
    return tuple(id(t) for t in pytree.tree_leaves(params)
                 if isinstance(t, torch.Tensor))


def _copied(args: Tuple[Any, ...], donate: Tuple[int, ...]) -> Tuple[Any, ...]:
    """The body arguments after the parameter tree that are copied into
    static buffers (every one but the donated)."""
    return tuple(a for i, a in enumerate(args) if i and i not in donate)


def make_key(static: Any, args: Tuple[Any, ...],
             donate: Tuple[int, ...] = ()) -> Tuple:
    """A body call's graph key (see the module docstring)."""
    leaves, spec = pytree.tree_flatten(_copied(args, donate))
    resident = tuple((str(pytree.tree_structure(args[i])), _param_ids(args[i]))
                     for i in donate)
    return (static, _param_ids(args[0]), resident, str(spec),
            tuple(_signature(x) for x in leaves))


def _device(args: Tuple[Any, ...]) -> Optional[torch.device]:
    for x in pytree.tree_leaves(args):
        if isinstance(x, torch.Tensor):
            return x.device
    return None


def _capture_stream(device: torch.device) -> torch.cuda.Stream:
    """This thread's side stream on ``device``: warm-up and capture run
    there (its cuBLAS workspace is set up by the first eager call)."""
    streams = getattr(_local, "streams", None)
    if streams is None:
        streams = _local.streams = {}
    if device not in streams:
        streams[device] = torch.cuda.Stream(device)
    return streams[device]


class _Resident:
    """Where a captured body's output is one of its donated arguments."""

    def __init__(self, index: int):
        self.index = index


def _out_tree(out: Any, args: Tuple[Any, ...], donate: Tuple[int, ...]) -> Any:
    """``out`` with each donated argument it returns whole (by identity)
    replaced by a :class:`_Resident` marker."""
    where = {id(args[i]): i for i in donate}
    return pytree.tree_map(
        lambda x: _Resident(where[id(x)]) if id(x) in where else x, out,
        is_leaf=lambda x: id(x) in where)


def _is_resident(x: Any) -> bool:
    return isinstance(x, _Resident)


class _Graph:
    """One captured key: the graph, its static buffers, the tensors it
    reads from outside, and its launch tally."""

    def __init__(self, device, graph, static_in, static_out, tally, held,
                 donate):
        self.device = device
        self.graph = graph
        self.pool_bytes: Optional[int] = None    # read once, by stats()
        self.static_in: List[torch.Tensor] = static_in
        self.static_out = static_out
        self.tally = tally
        self.held = held
        self.donate = donate
        self.done = torch.cuda.Event()
        self.replays = 0

    @property
    def in_bytes(self) -> int:
        """Bytes a replay copies into the static buffers."""
        return sum(b.numel() * b.element_size() for b in self.static_in)

    def replay(self, args: Tuple[Any, ...]) -> Any:
        stream = torch.cuda.current_stream(self.device)
        # the last replay's outputs were cloned (on whatever stream ran it)
        # before these buffers are written again
        stream.wait_event(self.done)
        flat = [x for x in pytree.tree_leaves(_copied(args, self.donate))
                if isinstance(x, torch.Tensor)]
        for buf, x in zip(self.static_in, flat):
            buf.copy_(x)
        self.graph.replay()

        def out(x):
            if isinstance(x, _Resident):     # the caller's own object
                return args[x.index]
            return x.clone() if isinstance(x, torch.Tensor) else x
        out = pytree.tree_map(out, self.static_out, is_leaf=_is_resident)
        self.done.record(stream)
        self.replays += 1
        for (fn, key), n in self.tally.items():
            fn(*key, n)
        return out


class Captured:
    """A runner body captured once per key and replayed (module
    docstring). ``fn(*args)``, or ``fn(static, *args)`` with ``host``:
    ``host(*call_args, **call_kw) -> (static, args)`` prepares host data
    outside the captured region. ``args[0]`` is the parameter tree
    (keyed by identity and held, donated or not); ``donate`` the indices
    of the body arguments that are resident. A subclass may override
    :meth:`split` and :meth:`_body` instead of handing in ``fn`` and
    ``host`` (a runner whose own methods are its body: stored bound
    methods would make a reference cycle that keeps the graphs' pools
    alive until the cyclic collector runs)."""

    # Set by a train step (``optim.adamw.TrainStep``), whose graphs are as
    # large as its activations: a call on another parameter tree or
    # donated tree drops the graphs of the old ones (donated trees are
    # dead after a call), so the runner holds one tree's graphs, one a
    # batch shape; and the cached blocks of the dropped graphs and of the
    # key's first call go back to the device before the capture (its
    # private pool would sit beside as much again). That synchronises the
    # device, so such a runner is never captured beside another thread's
    # capture.
    one_tree = False

    def __init__(self, fn: Optional[Callable], *,
                 host: Optional[Callable] = None,
                 name: Optional[str] = None, eager: bool = False,
                 donate: Tuple[int, ...] = ()):
        self.fn = fn
        self.host = host
        self.name = name or getattr(fn, "__qualname__", "runner")
        self.eager_only = eager
        self.donate = tuple(donate)
        self.keys_seen: set = set()
        self._graphs: Dict[Tuple, _Graph] = {}
        self._lock = threading.Lock()

    def split(self, *args: Any, **kw: Any) -> Tuple[Any, Tuple[Any, ...]]:
        """(host branch, body arguments) of a call."""
        if self.host is None:
            if kw:
                raise TypeError(f"{self.name} takes positional arguments")
            return (), args
        return self.host(*args, **kw)

    def _body(self, static: Any, args: Tuple[Any, ...]) -> Any:
        return self.fn(*args) if self.host is None else self.fn(static, *args)

    def key(self, *args: Any, **kw: Any) -> Tuple:
        static, body_args = self.split(*args, **kw)
        return make_key(static, body_args, self.donate)

    def eager(self, *args: Any, **kw: Any) -> Any:
        """The body run eagerly, whatever the device (a FLOP counter
        cannot see a replay)."""
        static, body_args = self.split(*args, **kw)
        return self._body(static, body_args)

    @property
    def captures(self) -> int:
        return len(self._graphs)

    def graphs(self) -> List["_Graph"]:
        return list(self._graphs.values())

    def __call__(self, *args: Any, **kw: Any) -> Any:
        static, body_args = self.split(*args, **kw)
        key = make_key(static, body_args, self.donate)
        with self._lock:
            self.keys_seen.add(key)
            device = _device(body_args[1:])
            if device is None or device.type != "cuda" or is_disabled() \
                    or self.eager_only:
                return self._body(static, body_args)
            graph = self._graphs.get(key)
            if graph is not None:
                return graph.replay(body_args)
            if self.one_tree:       # key[1:3]: the trees' identities
                self._graphs = {k: g for k, g in self._graphs.items()
                                if k[1:3] == key[1:3]}
            out, self._graphs[key] = self._capture(static, body_args, device)
            return out

    def _capture(self, static: Any, args: Tuple[Any, ...],
                 device: torch.device) -> Tuple[Any, _Graph]:
        params = args[0]
        leaves, spec = pytree.tree_flatten(_copied(args, self.donate))
        with torch.inference_mode(False):     # written in any mode
            static_in = [torch.empty_like(x) for x in leaves
                         if isinstance(x, torch.Tensor)]
        it = iter(static_in)
        static_leaves = [next(it) if isinstance(x, torch.Tensor) else x
                         for x in leaves]
        copied = iter(pytree.tree_unflatten(static_leaves, spec))
        # the donated arguments go in as the caller's own objects
        static_args = (params,) + tuple(
            a if i in self.donate else next(copied)
            for i, a in enumerate(args) if i)
        stream = torch.cuda.current_stream(device)
        side = _capture_stream(device)
        for buf, x in zip(static_in, (x for x in leaves
                                      if isinstance(x, torch.Tensor))):
            buf.copy_(x)
        side.wait_stream(stream)
        graph = torch.cuda.CUDAGraph()
        tally: Dict = {}
        held: List[torch.Tensor] = list(pytree.tree_leaves(params))
        for i in self.donate:
            held.extend(pytree.tree_leaves(args[i]))
        if self.one_tree:
            torch.cuda.empty_cache()
        with torch.cuda.stream(side):
            # the key's first call: eager, its result returned, its
            # launches counted as any eager launch
            out = self._body(static, static_args)
            if self.one_tree:
                torch.cuda.empty_cache()
            _local.tally, _local.held = tally, held
            try:
                graph.capture_begin(capture_error_mode="thread_local")
                try:
                    static_out = self._body(static, static_args)
                except BaseException:
                    try:
                        graph.capture_end()
                    except RuntimeError:
                        pass        # the capture is void; the body's error
                    raise           # is the one to see
                graph.capture_end()
            finally:
                _local.tally = _local.held = None
        stream.wait_stream(side)
        # the eager result must not alias a static buffer (a skip step
        # returns its delta input): the next replay would overwrite it
        buffers = {b.untyped_storage().data_ptr() for b in static_in}

        donated = {id(args[i]) for i in self.donate}

        def own(t):
            if not isinstance(t, torch.Tensor) or id(t) in donated:
                return t                # a donated argument: the caller's
            if t.untyped_storage().data_ptr() in buffers:
                t = t.clone()
            t.record_stream(stream)
            return t
        out = pytree.tree_map(own, out, is_leaf=lambda x: id(x) in donated)
        static_out = _out_tree(static_out, static_args, self.donate)
        return out, _Graph(device, graph, static_in, static_out, tally, held,
                           self.donate)


def capture(fn: Callable, *, host: Optional[Callable] = None,
            name: Optional[str] = None, eager: bool = False,
            donate: Tuple[int, ...] = ()) -> Captured:
    """Wrap a runner body (see :class:`Captured`). ``eager``: always run
    it eagerly (a runner over a mesh: Gloo collectives cannot be
    captured). ``donate``: the body arguments (by index) that are
    resident: read and written in place, returned as the caller's."""
    return Captured(fn, host=host, name=name, eager=eager, donate=donate)


class HostLoop:
    """A runner whose host loop calls captured pieces (the cached static
    runner: one captured NFE per phase, the refresh branch decided on the
    host each step). ``parts`` are its :class:`Captured` pieces."""

    def __init__(self, fn: Callable, parts: List[Captured]):
        self.fn = fn
        self.parts = parts

    def __call__(self, *args: Any, **kw: Any) -> Any:
        return self.fn(*args, **kw)


def pieces(runner: Any) -> List[Captured]:
    """The captured pieces of a runner (itself, or a host loop's)."""
    if isinstance(runner, Captured):
        return [runner]
    if isinstance(runner, HostLoop):
        return list(runner.parts)
    return []


def stats(runners: List[Any]) -> Dict[str, int]:
    """``captured`` graphs, ``replays`` and ``graph_pool_bytes`` over
    runners and their captured pieces. A captured pool holds what it was
    given, so each graph's bytes are read once, from one allocator
    snapshot for every graph not read yet."""
    parts = {id(p): p for r in runners for p in pieces(r)}   # shared once
    graphs = [g for p in parts.values() for g in p.graphs()]
    unread = {tuple(g.graph.pool()): g for g in graphs if g.pool_bytes is None}
    if unread:
        for g in unread.values():
            g.pool_bytes = 0
        for seg in torch.cuda.memory_snapshot():
            g = unread.get(tuple(seg["segment_pool_id"]))
            if g is not None:
                g.pool_bytes += seg["total_size"]
    return {"captured": len(graphs), "replays": sum(g.replays for g in graphs),
            "graph_pool_bytes": sum(g.pool_bytes for g in graphs)}
