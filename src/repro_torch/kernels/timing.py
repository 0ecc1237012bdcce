"""Device time of a CUDA call, without the host's launch overhead."""
from __future__ import annotations

from typing import Callable

import torch


def graph_ms(fn: Callable[[], object], calls: int = 20, replays: int = 10) -> float:
    """Milliseconds per call of ``fn`` on the current CUDA device: ``calls``
    calls captured in one CUDA graph, replayed ``replays`` times between
    CUDA events, after three warm-up calls outside the graph."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (calls * replays)
