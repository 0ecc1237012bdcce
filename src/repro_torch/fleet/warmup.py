"""Background warm-set building, the port of ``repro.fleet.warmup``.

``precapture_warm_set`` walks the small-cohort bucket ladder — every
fine layout a mid-trace join might need — but doing it synchronously
holds the replica's startup for the whole ladder. The
:class:`BackgroundCompiler` moves that walk off the startup path: a
daemon thread per replica takes the engine's
:meth:`~repro_torch.serving.scheduler.ServingEngine.warm_set_ladder` work
list and warms one rung at a time — builds its packed runner and makes
one dummy dispatch on the device (``_dummy_dispatch(record=False)``: no
spans, the thread must not interleave writes into the serving thread's
recorder ring) — while the replica already serves.

Safety: the shared mutable state is ``FlexiPipeline``'s runner cache,
whose miss/insert path takes the pipeline's cache lock, and the engine's
and the flash kernel's launch counters, which take their own locks — if
the serving thread needs a rung first, it builds it, the warm thread sees
it warm and skips it, and the build counters stay exact (the warmer's
builds count as warm-up). Once :meth:`wait` returns, :meth:`assert_warm`
proves the ladder is fully built, and every later small-cohort dispatch
builds nothing. On CUDA the thread launches on a stream of its own, and
captures each rung's CUDA graphs there (``runtime.graphs`` captures in
thread-local mode) while the serving thread launches on its stream;
``torch.cuda.set_sync_debug_mode`` is process-wide, so count
synchronising calls only with no warmer alive.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Optional, Sequence

import torch


class BackgroundCompiler:
    """Walks one engine's cold warm-set ladder on a daemon thread.

    >>> warm = BackgroundCompiler(engine).start()
    >>> ... serve traffic ...
    >>> warm.wait(); warm.assert_warm()
    """

    def __init__(self, engine, *, max_per_mode: int = 2,
                 k_depths: Optional[Sequence[int]] = None,
                 name: Optional[str] = None):
        self.engine = engine
        self.max_per_mode = max_per_mode
        self.k_depths = list(k_depths) if k_depths is not None else None
        self.captured = 0            # rungs this thread built itself
        self._stop = threading.Event()
        self._err: Optional[BaseException] = None
        self._thread = threading.Thread(
            target=self._run, daemon=True,
            name=name or "fleet-warm")

    def start(self) -> "BackgroundCompiler":
        self._thread.start()
        return self

    def _run(self) -> None:
        device = self.engine.device
        try:
            with (torch.cuda.stream(torch.cuda.Stream(device))
                  if device.type == "cuda" else contextlib.nullcontext()):
                for layout, k in self.engine.warm_set_ladder(
                        self.max_per_mode, self.k_depths):
                    if self._stop.is_set():
                        return
                    if self.engine._is_warm(layout, k):
                        continue      # serving thread captured it first
                    self.engine._dummy_dispatch(layout, k, record=False)
                    self.captured += 1
        except Exception as e:        # surfaced on wait(), never lost
            self._err = e

    def stop(self) -> None:
        """Ask the walk to end after the current rung (drain/shutdown)."""
        self._stop.set()

    @property
    def done(self) -> bool:
        return not self._thread.is_alive()

    def wait(self, timeout: Optional[float] = None) -> bool:
        """Join the thread; re-raises anything it hit. Returns False on
        timeout (thread still walking)."""
        self._thread.join(timeout)
        if self._thread.is_alive():
            return False
        if self._err is not None:
            raise self._err
        return True

    def assert_warm(self) -> int:
        """Every ladder rung must now be warm: any residual cold rung
        would turn into a build stall (a runner built by the serving
        thread) mid-traffic. Returns the rung count proven warm."""
        residual = self.engine.warm_set_ladder(self.max_per_mode,
                                               self.k_depths)
        if residual:
            raise AssertionError(
                f"warm-set ladder not fully built: "
                f"{len(residual)} cold rung(s), first "
                f"{residual[0][0].groups} k={residual[0][1]}")
        n = 0
        for layout in self.engine.menu.layouts:
            if all(c <= self.max_per_mode for _m, c in layout.groups):
                n += 1
        return n
