"""Device time of a CUDA call, without the host's launch overhead."""
from __future__ import annotations

import statistics
from typing import Callable, Dict

import torch


def _capture(fn: Callable[[], object], calls: int) -> torch.cuda.CUDAGraph:
    """``calls`` calls of ``fn`` in one CUDA graph, after three warm-up
    calls outside it, replayed once."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    return graph


def _replay_ms(graph: torch.cuda.CUDAGraph, calls: int, replays: int) -> float:
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (calls * replays)


def graph_ms(fn: Callable[[], object], calls: int = 20, replays: int = 10) -> float:
    """Milliseconds per call of ``fn`` on the current CUDA device: ``calls``
    calls captured in one CUDA graph, replayed ``replays`` times between
    CUDA events, after three warm-up calls outside the graph."""
    return _replay_ms(_capture(fn, calls), calls, replays)


def interleaved_ms(fns: Dict[str, Callable[[], object]], rounds: int = 7,
                   calls: int = 20, replays: int = 10) -> Dict[str, dict]:
    """Time several calls in turns: each is captured once as in
    :func:`graph_ms`; then every round replays each graph in the order
    given (say new kernel, previous kernel, library call), so a drift of
    the card's clock or of its neighbours over the run falls on all of
    them alike. Returns, per name, the median milliseconds per call over
    the rounds, the fastest and slowest round, and the spread
    (slowest - fastest) / median."""
    graphs = {name: _capture(fn, calls) for name, fn in fns.items()}
    times = {name: [] for name in fns}
    for _ in range(rounds):
        for name, graph in graphs.items():
            times[name].append(_replay_ms(graph, calls, replays))
    out = {}
    for name, ts in times.items():
        med = statistics.median(ts)
        out[name] = {"ms": med, "min_ms": min(ts), "max_ms": max(ts),
                     "spread": (max(ts) - min(ts)) / med, "rounds": rounds}
    return out
