"""One fleet replica: a serving engine + its own clock + its price tag; the
port of ``repro.fleet.replica``.

Two engine kinds sit behind the same pump/submit surface:

* ``packed`` — the continuous-batching :class:`ServingEngine` (the
  normal case; single-replica-equivalent sampling);
* ``fixed`` — :class:`FixedSlotEngine`, a per-level fixed-slot batcher
  driving ``FlexiPipeline.sample`` directly. It takes sequence-parallel
  plans (``plan.parallel``): every rank of the pipeline's mesh runs the
  same engine with the same submissions (``launch/serve.py --mesh``), or
  the pipeline is a rank group's (``fleet/groups.py``) and one engine
  feeds its ranks (``--mesh DATAxSEQ --replicas N``). A replica over a
  group that lost a rank is :attr:`Replica.lost`: the fleet stops pumping
  it, so it stops beating.

**Virtual time.** A single-process fleet shares one card, so replica
compute serializes and wall-clock can never show N-replica throughput.
Each replica therefore owns a :class:`ReplicaClock` that the pump
advances by the *modeled* dispatch cost — packed tokens x calibrated
seconds-per-token (x the replica's ``speed_factor``, the straggler dial).
Fleet makespan is the max replica clock; on a deployment where every
replica has its own card the virtual clock is replaced by
``time.monotonic`` (``virtual=False``) and seconds-per-token is measured.
Dispatch is asynchronous on CUDA, so a wall taken without a wait measures
the launch, not the work: a wall-clock replica measures only across the
engine's own waits (:attr:`ServingEngine.waits`), over the packed tokens
dispatched since the previous one. On one card that window also holds
the other replicas' queued work, so it over-prices.

**Pricing.** Every replica carries its own
:class:`~repro_torch.serving.controller.BudgetController` and feeds it
wall-per-analytic-FLOP calibration from its own observed/modeled
seconds-per-token, so ``controller.cost_seconds(level)`` is the
per-replica price the router scores placements with — a slow replica
literally costs more seconds.

**Randomness.** A fleet request's ``key`` is the keyword set of the
engine's ``submit`` that seeds it: ``{"seed": s}`` (the fleet derives
``s`` from its own request id), plus ``x_T`` / ``noise`` when the
submitter gave them. Every re-admission hands the same keywords to the
new engine.
"""
from __future__ import annotations

import math
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from repro_torch.core.scheduler import dit_nfe_flops
from repro_torch.launch.mesh import RankLost
from repro_torch.models import dit as dit_mod
from repro_torch.pipeline.pipeline import FlexiPipeline
from repro_torch.pipeline.plan import SamplingPlan
from repro_torch.serving.controller import BudgetController
from repro_torch.serving.metrics import RequestRecord, ServingMetrics
from repro_torch.serving.queue import Request, RequestQueue
from repro_torch.serving.scheduler import (ServedResult, ServingEngine,
                                           level_plans, request_seed)

ENGINE_KINDS = ("packed", "fixed")

#: pre-measurement seconds-per-token guess (only prices the very first
#: placements in wall mode; the EWMA takes over after one measurement)
DEFAULT_SECONDS_PER_TOKEN = 1e-4


class ReplicaClock:
    """Per-replica monotonic virtual clock (callable like
    ``time.monotonic``); the pump advances it by modeled dispatch cost."""

    def __init__(self, t: float = 0.0):
        self.t = float(t)

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> float:
        self.t += float(dt)
        return self.t

    def catch_up(self, t: float) -> None:
        """A replica can't run work that hasn't arrived yet: placement
        at fleet time ``t`` pulls an idle replica's clock forward."""
        if t > self.t:
            self.t = float(t)


class FixedSlotEngine:
    """Fixed-slot batcher with the packed engine's fleet surface
    (submit/step/extract_queued/stop_admissions/metrics).

    Each step serves one same-level batch of up to ``batch_size``
    requests through ``pipe.sample``. With the ``ddim`` solver the batch
    stacks each request's OWN prior (``x_T`` drawn from its seed, or
    given), so results match a standalone single-request ``sample``.
    (``ddpm`` ancestral noise is drawn for the batch from its first
    request's seed; per-request ddpm determinism under rebatching is what
    the packed engine is for.) Sequence-parallel plans run on the
    pipeline's mesh; every rank then returns the whole batch.
    """

    def __init__(self, pipe: FlexiPipeline,
                 plans: Dict[float, SamplingPlan], *,
                 batch_size: int = 4,
                 clock: Optional[Callable[[], float]] = None,
                 base_seed: int = 0x5e41):
        self.pipe = pipe
        self.cfg = pipe.cfg
        self.device = pipe.device
        self.clock = clock or time.monotonic
        self.batch_size = int(batch_size)
        ref = next(iter(plans.values()))
        self.guided = ref.guidance_active
        self.levels = level_plans(self.cfg, pipe.sched, plans)
        self.metrics = ServingMetrics()
        self.waits = 0
        self._queue = RequestQueue()
        self._admitting = True
        self._next_id = 0
        self._base_seed = int(base_seed)

    # -- request lifecycle (packed-engine surface) ---------------------

    def quantize(self, budget: float) -> float:
        for b in sorted(self.levels):
            if b >= budget - 1e-9:
                return b
        return max(self.levels)

    def submit(self, cond: int, budget: float,
               deadline: float = math.inf, *,
               x_T: Optional[torch.Tensor] = None,
               noise: Optional[torch.Tensor] = None,
               seed: Optional[int] = None) -> int:
        rid = self._next_id
        self._next_id += 1
        if seed is None:
            seed = request_seed(self._base_seed, rid)
        req = Request(id=rid, cond=int(cond), budget=float(budget),
                      deadline=deadline, seed=seed, x_T=x_T, noise=noise)
        self._queue.submit(req, self.clock())
        return rid

    def stop_admissions(self) -> None:
        self._admitting = False

    def resume_admissions(self) -> None:
        self._admitting = True

    def extract_queued(self) -> List[Request]:
        out = sorted(self._queue._pending, key=lambda r: r._seq)
        self._queue._pending.clear()
        return out

    @property
    def n_queued(self) -> int:
        return len(self._queue)

    @property
    def n_inflight(self) -> int:
        return 0                      # a fixed-slot step runs to finish

    @property
    def idle(self) -> bool:
        return not self._queue

    def cache_stats(self) -> Dict[str, int]:
        return self.pipe.cache_stats()

    # -- the iteration -------------------------------------------------

    def _generator(self, req: Request) -> torch.Generator:
        return torch.Generator(device=self.device).manual_seed(req.seed)

    @torch.inference_mode()
    def step(self) -> List[ServedResult]:
        """Serve one fixed-slot batch: the level with the oldest pending
        request, filled to ``batch_size`` in arrival order."""
        now = self.clock()
        if not self._queue:
            return []
        pending = sorted(self._queue._pending, key=lambda r: r._seq)
        level = self.quantize(pending[0].budget)
        batch = [r for r in pending
                 if self.quantize(r.budget) == level][:self.batch_size]
        for r in batch:
            self._queue._pending.remove(r)
        lp = self.levels[level]
        n = len(batch)
        shape = (1,) + tuple(self.cfg.dit.latent_shape)
        cond = torch.tensor([r.cond for r in batch], device=self.device)
        x_T = None
        if lp.plan.solver == "ddim":
            x_T = torch.cat([
                r.x_T.to(self.device, torch.float32).reshape(shape)
                if r.x_T is not None
                else torch.randn(shape, generator=self._generator(r),
                                 device=self.device)
                for r in batch])
        res = self.pipe.sample(lp.plan, n, self._generator(batch[0]),
                               cond=cond, x_T=x_T)
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()
        self.waits += 1
        finish = self.clock()
        mult = 2 if self.guided else 1
        tokens_each = int(mult * sum(
            dit_mod.tokens_for_mode(self.cfg, int(m)) for m in lp.modes))
        self.metrics.record_step(finish, tokens_each * n, tokens_each * n,
                                 n)
        out: List[ServedResult] = []
        for i, r in enumerate(batch):
            rec = RequestRecord(
                id=r.id, arrival=r.arrival, admit=now, finish=finish,
                deadline=r.deadline, budget_requested=r.budget,
                budget_served=level, tokens=tokens_each, flops=lp.flops)
            self.metrics.record_request(rec)
            out.append(ServedResult(request=r, x0=res.x0[i],
                                    budget_served=level, record=rec))
        return out

    def run(self, max_steps: int = 100_000) -> List[ServedResult]:
        out: List[ServedResult] = []
        steps = 0
        while self._queue and steps < max_steps:
            out.extend(self.step())
            steps += 1
        return out


class Replica:
    """Engine + clock + price model, pumped by the fleet's tick loop."""

    def __init__(self, rid: int, pipe: FlexiPipeline,
                 plans: Dict[float, SamplingPlan], *,
                 engine_kind: str = "packed",
                 virtual: bool = True,
                 seconds_per_token: float = DEFAULT_SECONDS_PER_TOKEN,
                 speed_factor: float = 1.0,
                 clock: Optional[Callable[[], float]] = None,
                 controller: Optional[BudgetController] = None,
                 base_seed: int = 0x5e41,
                 batch_size: int = 4,
                 faults: Optional[Any] = None,
                 engine_kwargs: Optional[Dict[str, Any]] = None):
        if engine_kind not in ENGINE_KINDS:
            raise ValueError(f"unknown engine kind {engine_kind!r}; "
                             f"known: {ENGINE_KINDS}")
        self.rid = rid
        self.virtual = virtual
        self.speed_factor = float(speed_factor)
        # per-replica fault facade (resilience/faults.ReplicaFaults);
        # None on every production path — the seams below are no-ops then
        self.faults = faults
        kw = dict(engine_kwargs or {})
        cache = kw.get("cache")
        if virtual:
            t0 = clock() if clock is not None else 0.0
            self.rclock: Callable[[], float] = ReplicaClock(t0)
        else:
            self.rclock = clock or time.monotonic
        self.controller = controller if controller is not None else \
            BudgetController(
                pipe.cfg, plans, cache=cache,
                num_train_steps=pipe.sched.num_steps,
                attn_backend=next(iter(plans.values())).attn_backend)
        if engine_kind == "packed":
            self.engine: Any = ServingEngine(
                pipe, plans, clock=self.rclock,
                controller=self.controller, base_seed=base_seed, **kw)
        else:
            self.engine = FixedSlotEngine(pipe, plans,
                                          batch_size=batch_size,
                                          clock=self.rclock,
                                          base_seed=base_seed)
        self._levels = self.engine.levels
        cfg = pipe.cfg
        mult = 2 if self.engine.guided else 1
        self._level_tokens = {
            b: int(mult * sum(dit_mod.tokens_for_mode(cfg, int(m))
                              for m in lp.modes))
            for b, lp in self._levels.items()}
        # wall-per-FLOP feeds: per patch mode, FLOPs carried by one of
        # its (guidance-multiplied) segment tokens — the bridge from the
        # seconds-per-token cost model into the controller's
        # seconds-space pricing
        backend = next(iter(plans.values())).attn_backend
        modes = sorted({int(m) for lp in self._levels.values()
                        for m in lp.modes})
        self._flops_per_token = {
            m: dit_nfe_flops(cfg, m, attn_backend=backend)
            / dit_mod.tokens_for_mode(cfg, m) for m in modes}
        self._spt = float(seconds_per_token)
        self._measured = virtual     # virtual spt is authoritative now
        # wall mode: the measurement window since the engine's last wait
        self._win_t0: Optional[float] = None
        self._win_tokens = 0
        if virtual:
            self._calibrate()

    # ------------------------------------------------------------------
    # Pricing

    def _calibrate(self) -> None:
        spt = self._spt * (self.speed_factor if self.virtual else 1.0)
        for m, fpt in self._flops_per_token.items():
            self.controller.observe_calibration(m, fpt, spt)

    @property
    def seconds_per_token(self) -> float:
        return self._spt * (self.speed_factor if self.virtual else 1.0)

    def price_seconds(self, level: float) -> float:
        """Calibrated seconds one request at ``level`` costs here."""
        c = self.controller.cost_seconds(level)
        if c is not None:
            return float(c)
        return self._level_tokens[level] * self.seconds_per_token

    def prices(self) -> Dict[float, float]:
        return {b: self.price_seconds(b) for b in self._levels}

    def backlog_seconds(self) -> float:
        """Priced not-yet-done work: queued requests at full price,
        in-flight ones at their remaining-step fraction."""
        total = 0.0
        for r in self.engine._queue._pending:
            total += self.price_seconds(self.engine.quantize(r.budget))
        for f in getattr(self.engine, "_inflight", ()):
            frac = 1.0 - f.step / max(len(f.lp.ts), 1)
            total += self.price_seconds(f.lp.level) * frac
        return total

    # ------------------------------------------------------------------
    # Fleet surface

    def submit(self, cond: int, budget: float, deadline: float,
               key: Dict[str, Any]) -> int:
        return self.engine.submit(cond, budget, deadline, **key)

    @property
    def has_work(self) -> bool:
        return not self.engine.idle

    def pump(self, now: float) -> Tuple[List[ServedResult], float]:
        """One engine iteration at fleet time ``now``; returns the
        finished results and the dispatch's modeled seconds (virtual), or
        the measured seconds of the window the engine just waited out (0
        when it did not wait). The replica clock never runs behind fleet
        time."""
        if self.virtual:
            self.rclock.catch_up(now)
        t0 = self.rclock()
        n0 = self.engine.metrics.total_steps
        w0 = self.engine.waits
        try:
            results = self.engine.step()
        except RankLost:
            return [], 0.0   # the group is stopped: see ``lost``
        dt = 0.0
        if self.engine.metrics.total_steps > n0:
            srec = self.engine.metrics.steps[-1]
            if self.virtual:
                dt = (srec.packed_tokens * self._spt * self.speed_factor)
                # fault seam: a scripted slowdown window stretches the
                # modeled dispatch cost (the straggler detector and the
                # router's backlog pricing both see it)
                if self.faults is not None:
                    dt *= self.faults.slowdown_factor(t0)
                self.rclock.advance(dt)
            else:
                if self._win_t0 is None:
                    self._win_t0 = t0
                self._win_tokens += srec.packed_tokens
                if self.engine.waits > w0:
                    dt = self.rclock() - self._win_t0
                    if self._win_tokens > 0 and dt > 0:
                        m = dt / self._win_tokens
                        self._spt = (m if not self._measured
                                     else 0.7 * self._spt + 0.3 * m)
                        self._measured = True
                        self._calibrate()
                    self._win_t0, self._win_tokens = None, 0
        return results, dt

    def estimated_finish(self, engine_id: int, now: float
                         ) -> Optional[float]:
        """Predicted completion time of an in-flight/queued request on
        this replica: remaining tokens x seconds-per-token, behind the
        current backlog. None when unknown here."""
        eng = self.engine
        spt = self.seconds_per_token
        for f in getattr(eng, "_inflight", ()):
            if f.req.id == engine_id:
                mult = 2 if eng.guided else 1
                rem = mult * sum(
                    dit_mod.tokens_for_mode(eng.cfg, int(m))
                    for m in f.lp.modes[f.step:])
                return max(now, self.rclock()) + rem * spt
        for r in eng._queue._pending:
            if r.id == engine_id:
                level = eng.quantize(r.budget)
                return (max(now, self.rclock()) + self.backlog_seconds()
                        + self._level_tokens[level] * spt)
        return None

    def cache_stats(self) -> Dict[str, int]:
        return self.engine.cache_stats()

    @property
    def lost(self) -> bool:
        """The pipeline is a rank group that is no longer whole: it lost
        a rank, or was stopped (never for a pipeline in this process)."""
        alive = getattr(self.engine.pipe, "alive", None)
        return alive is not None and not alive()

    def close(self) -> None:
        """Stop the pipeline's rank group, if it has one."""
        close = getattr(self.engine.pipe, "close", None)
        if close is not None:
            close()
