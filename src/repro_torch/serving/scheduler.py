"""Iteration-level continuous-batching engine, the port of
``repro.serving.scheduler``.

The engine keeps many in-flight requests at *different* denoise steps and
budgets and advances a packed subset of them every iteration:

* **join/leave mid-flight**: new requests enter between any two engine
  steps; finished latents leave without draining anyone else;
* **token packing**: each step's batch is composed token-wise from the
  bucket menu (``serving.batcher``): weak-phase requests contribute fewer
  tokens, packed into fixed-capacity rows with segment-id masking
  (``core.packing``), which the flash kernel turns into skipped tiles;
* **build-once**: all runners come from ``FlexiPipeline.packed_step``'s
  cache, keyed by the static layout only, and on CUDA each is captured as
  a CUDA graph at its first dispatch (a warm-up dispatch captures both
  branches of a cached runner), so steady-state serving builds and
  captures nothing and replays (``cache_stats()`` shows it);
* **SLA awareness**: ``policy='edf'`` orders admission and steps by
  deadline; ``policy='degrade'`` lets the
  :class:`~repro_torch.serving.controller.BudgetController` demote queued
  requests to the highest budget level the arrival rate sustains.

A request is served as a standalone ``FlexiPipeline.sample(plan, 1, ...)``
call given the same prior and noise would serve it: the engine draws
``x_T`` and (DDPM) one noise tensor per step from the request's
``torch.Generator`` in the pipeline's order, at admission, on the engine's
device. The host waits on the device at the reference's places only: once
per dummy warm-up dispatch, and once per dispatch in which some request
finishes (a result counts as served once it exists).

``telemetry=`` (``repro_torch.telemetry.Telemetry``) adds spans on the
engine's clock (admit, plan, pack, build, dispatch, materialize, one row
per request), routes dispatches through the tapped step family (the same
latents bit for bit, device tap outputs read only at aggregation), and,
with profiling on, measures each dispatch's wall time (CUDA events and one
wait per dispatch), attributes it to the requests in the pack with exact
conservation, and calibrates the ``BudgetController``; a watchdog checks
SLOs every step and dumps a post-mortem bundle on alerts or an uncaught
exception. Without it none of this runs.

Resilience seams (``repro_torch.resilience``): ``faults=`` takes a
per-replica fault facade (``FaultInjector(plan).for_replica(i)``) that can
fail cache-slot allocations transiently and poison one request's latent
row with NaN after a dispatch; ``quarantine=True`` (the default when
armed) drops a trajectory found non-finite and re-enqueues the request at
the most powerful level with the same randomness (``self_heal``, up to
``max_retries``), or parks it in ``quarantined`` for a fleet router to
escalate. Detection reads the finite tap (when telemetry taps are on) and
the finishing requests' latents in one device-to-host read that takes the
place of the completion wait: it adds no synchronisation. Every seam call
sits behind an ``is not None`` check, so with ``faults=None`` and
quarantine off the engine runs exactly the operations it runs without
this layer.

``precapture_warm_set`` / ``_dummy_dispatch`` may run on a second thread
(``fleet.warmup.BackgroundCompiler``) while this one serves: the runner
cache, each runner's graphs and the launch counters take locks, and the
warm-up thread captures on its own stream.
"""
from __future__ import annotations

import dataclasses
import math
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.cache import ledger as cache_ledger
from repro_torch.cache import policy as cache_policy
from repro_torch.cache.policy import CacheSpec
from repro_torch.cache.store import CacheStore, TransientAllocationError
from repro_torch.core.scheduler import dit_nfe_flops
from repro_torch.diffusion import schedule as sch
from repro_torch.models import dit as dit_mod
from repro_torch.pipeline.packed import PackLayout
from repro_torch.pipeline.pipeline import FlexiPipeline
from repro_torch.pipeline.plan import SamplingPlan
from repro_torch.serving.batcher import BucketMenu
from repro_torch.serving.controller import BudgetController
from repro_torch.serving.metrics import RequestRecord, ServingMetrics
from repro_torch.serving.queue import Request, RequestQueue
from repro_torch.telemetry import TapSample, Telemetry
from repro_torch.telemetry.profile import dummy_packed_args
from repro_torch.telemetry.profile import packed_key as profile_packed_key
from repro_torch.telemetry.trace import REQUEST_PID

ENGINE_POLICIES = ("fifo", "edf", "degrade")


@dataclasses.dataclass(frozen=True)
class LevelPlan:
    """One budget level of the menu, fully resolved for step-wise play."""
    level: float
    plan: SamplingPlan
    ts: np.ndarray               # descending timestep ladder [T]
    t_prev: np.ndarray           # ts shifted, -1 terminated [T]
    modes: np.ndarray            # per-step patch mode [T]
    run_len: np.ndarray          # same-mode steps remaining (incl. self) [T]
    flops: float                 # analytic per-request denoising FLOPs


@dataclasses.dataclass
class InFlight:
    req: Request
    lp: LevelPlan
    x_src: torch.Tensor          # [k, F, H, W, C] batch holding the latent
    x_row: int                   # ... at this row (kept unsliced so step
    #                              assembly can reuse whole output batches)
    noise: Optional[torch.Tensor]  # [T, 1, F, H, W, C] DDPM noise, else None
    admit: float
    seq: int
    step: int = 0
    # activation cache: this request's OWN staleness clock over its ladder,
    # and its slot in the engine's CacheStore (the slot follows the request
    # across bucket migrations; forced refreshes (join, phase switch,
    # eviction) flip the mask in place so the retire-time histogram is real)
    refresh_mask: Optional[np.ndarray] = None
    cache_slot: int = -1
    cache_mode: int = -1

    @property
    def x(self) -> torch.Tensor:
        return self.x_src[self.x_row]

    @property
    def mode(self) -> int:
        return int(self.lp.modes[self.step])

    @property
    def done(self) -> bool:
        return self.step >= len(self.lp.ts)


@dataclasses.dataclass
class ServedResult:
    request: Request
    x0: torch.Tensor
    budget_served: float
    record: RequestRecord
    # measured per-request served cost (telemetry.attribution.ServedCost)
    # when the engine runs with profiling telemetry; None otherwise
    cost: Optional[Any] = None


def level_plans(cfg, sched: sch.DiffusionSchedule,
                plans: Dict[float, SamplingPlan]) -> Dict[float, LevelPlan]:
    """Each menu level's resolved step ladder (the engine's own view, and
    the view a fleet replica prices with)."""
    out: Dict[float, LevelPlan] = {}
    for b in sorted(plans):
        plan = plans[b]
        fs = plan.resolve_schedule(cfg)
        ts = sch.respaced_timesteps(sched.num_steps, plan.T)
        step_modes = np.concatenate(
            [np.full(n, m, np.int64) for m, n in fs.phases if n])
        run_len = np.ones(len(step_modes), np.int64)
        for i in range(len(step_modes) - 2, -1, -1):
            if step_modes[i] == step_modes[i + 1]:
                run_len[i] = run_len[i + 1] + 1
        out[b] = LevelPlan(level=b, plan=plan, ts=ts,
                           t_prev=np.concatenate([ts[1:], [-1]]),
                           modes=step_modes, run_len=run_len,
                           flops=plan.flops(cfg))
    return out


def request_seed(base_seed: int, rid: int) -> int:
    """The generator seed of request ``rid`` under ``base_seed``."""
    a, b = np.random.SeedSequence((base_seed, rid)).generate_state(2)
    return (int(a) << 31) ^ int(b)


class ServingEngine:
    """Continuous-batching DiT serving on top of a FlexiPipeline.

    >>> engine = ServingEngine(pipe, plans, max_tokens_per_step=1024)
    >>> engine.submit(cond=3, budget=0.6)
    >>> results = engine.run()          # drain queue + in-flight
    """

    def __init__(self, pipe: FlexiPipeline,
                 plans: Dict[float, SamplingPlan], *,
                 max_tokens_per_step: Optional[int] = None,
                 policy: str = "fifo",
                 clock: Optional[Callable[[], float]] = None,
                 controller: Optional[BudgetController] = None,
                 max_inflight: Optional[int] = None,
                 base_seed: int = 0x5e41,
                 steps_per_dispatch: int = 8,
                 menu: Optional[BucketMenu] = None,
                 allow_cold: bool = True,
                 cache: Optional[CacheSpec] = None,
                 precapture_small: int = 0,
                 telemetry: Optional[Telemetry] = None,
                 faults: Optional[Any] = None,
                 quarantine: Optional[bool] = None,
                 self_heal: bool = True,
                 max_retries: int = 2,
                 expire_queued: bool = False,
                 cache_integrity: bool = False):
        if policy not in ENGINE_POLICIES:
            raise ValueError(f"unknown policy {policy!r}; known: "
                             f"{ENGINE_POLICIES}")
        # resilience: ``faults`` is a per-replica fault facade
        # (resilience.faults.ReplicaFaults), consulted only behind an
        # ``is not None`` check. Quarantine defaults to armed-only;
        # ``self_heal`` re-enqueues locally, a fleet turns it off and
        # escalates through its router instead
        self._faults = faults
        self._quarantine = (faults is not None) if quarantine is None \
            else quarantine
        self._self_heal = self_heal
        self._max_retries = max_retries
        self._retries: Dict[int, int] = {}
        self.quarantined: List[Request] = []
        self.expired: List[Request] = []
        self._expire_queued = expire_queued
        self.pipe = pipe
        self.cfg = pipe.cfg
        self.device = pipe.device
        self.clock = clock or time.monotonic
        # telemetry: spans stamp the engine's own clock; taps route every
        # dispatch through the tapped step family (extra data outputs)
        self.telemetry = telemetry
        self._taps = telemetry is not None and telemetry.taps_enabled
        self._rec = telemetry.recorder if telemetry is not None else None
        # profiling: cost registry + per-request attribution + watchdog;
        # profiling adds one wait per dispatch to measure its wall time
        self._profile = telemetry.profile if telemetry is not None else None
        self._attr = telemetry.attribution if telemetry is not None else None
        self._watchdog = telemetry.watchdog if telemetry is not None else None
        self._wd_ticks = 0
        if telemetry is not None:
            telemetry.bind_clock(self.clock)
        self.policy = policy
        self._validate_menu(plans)
        ref = next(iter(plans.values()))
        self.solver = ref.solver
        self.guidance_scale = ref.guidance_scale
        self.clip_x0 = ref.clip_x0
        self.guided = ref.guidance_active
        # one engine = one step family = one attention backend; 'auto'
        # resolves to the segment-aware flash kernel inside packed steps,
        # so the FLOPs ledger prices block-granular attention
        self.attn_backend = ref.attn_backend
        self.levels = level_plans(self.cfg, pipe.sched, plans)
        modes = {0}
        for lp in self.levels.values():
            modes.update(int(m) for m in lp.modes)
        mult = 2 if self.guided else 1
        self._seg_tokens = {m: dit_mod.tokens_for_mode(self.cfg, m)
                            for m in sorted(modes)}
        if max_tokens_per_step is None:
            max_tokens_per_step = 4 * mult * self._seg_tokens[0]
        if steps_per_dispatch < 1:
            raise ValueError(f"steps_per_dispatch must be >= 1, got "
                             f"{steps_per_dispatch}")
        self.steps_per_dispatch = steps_per_dispatch
        self.allow_cold = allow_cold
        self.menu = menu if menu is not None else BucketMenu(
            self.cfg, sorted(modes), max_tokens_per_step, guided=self.guided)
        if menu is not None and menu.guided != self.guided:
            raise ValueError("shared menu's guided flag mismatches the plan "
                             "menu's guidance")
        for m in sorted(modes):
            if not self.menu.greedy_fit([m])[0]:
                raise ValueError(
                    f"max_tokens_per_step={self.menu.max_tokens} cannot fit "
                    f"one mode-{m} request's {mult} segment(s); such "
                    f"requests would starve")
        self.max_inflight = max_inflight or 2 * self.menu.max_requests
        self.cache = cache
        self.cache_split = (cache.resolve_split(self.cfg.num_layers)
                            if cache is not None else None)
        self.store: Optional[CacheStore] = None
        self._level_masks: Dict[float, np.ndarray] = {}
        if cache is not None:
            self.store = CacheStore(self.cfg, sorted(modes),
                                    n_slots=self.max_inflight,
                                    guided=self.guided,
                                    integrity=cache_integrity,
                                    device=self.device)
            for b, lp in self.levels.items():
                fs = lp.plan.resolve_schedule(self.cfg)
                self._level_masks[b] = cache_policy.ladder_refresh_mask(
                    cache, fs.split_timesteps(lp.ts))
        self.controller = controller
        if policy == "degrade" and controller is None:
            self.controller = BudgetController(
                self.cfg, plans, cache=cache,
                num_train_steps=pipe.sched.num_steps,
                attn_backend=self.attn_backend)
        self.metrics = ServingMetrics()
        #: packed forwards dispatched (one per micro-step) and DiT block
        #: applications they ran (all layers, or the shallow ones on a
        #: micro-step where no cached request refreshes): what the flash
        #: kernel's launch count must equal under the flash backend
        self.packed_forwards = 0
        self.block_passes = 0
        #: dispatches the host waited on (those where a request finished):
        #: the only points where a wall clock sees the device's work
        self.waits = 0
        # a background warm-up thread dispatches beside the serving one
        self._count_lock = threading.Lock()
        self._layout_costs: Dict[Any, Any] = {}
        self._layout_blocks: Dict[Any, Any] = {}
        self._zero_blocks: Dict[Tuple, torch.Tensor] = {}
        self._queue = RequestQueue()
        self._inflight: List[InFlight] = []
        self._admitting = True
        self._next_id = 0
        self._seq = 0
        self._base_seed = int(base_seed)
        self._last_step_at: Optional[float] = None
        self._last_sync_at: Optional[float] = self.clock()
        self._flops_since_sync = 0.0
        self.started_at = self.clock()
        if precapture_small > 0:
            self.precapture_warm_set(max_per_mode=precapture_small)

    # ------------------------------------------------------------------
    # Validation / setup

    def _validate_menu(self, plans: Dict[float, SamplingPlan]) -> None:
        if not plans:
            raise ValueError("engine needs a non-empty plan menu")
        if self.cfg.dit is None or self.cfg.dit.conditioning != "class":
            raise ValueError("the serving engine currently serves "
                             "class-conditioned DiTs")
        if self.cfg.dit.lora_rank > 0:
            raise ValueError("mixed-mode packing needs mode-independent "
                             "blocks (shared-parameter recipe); per-mode "
                             "LoRA serving is not supported")
        ref = next(iter(plans.values()))
        for b, plan in plans.items():
            plan.validate(self.cfg)
            if plan.is_adaptive:
                raise ValueError("adaptive plans are per-sample host loops; "
                                 "the engine packs static schedules only")
            if plan.solver not in ("ddim", "ddpm"):
                raise ValueError(f"engine solvers: ddim|ddpm, got "
                                 f"{plan.solver!r} at level {b}")
            if plan.guidance_active and plan.guidance_kind != "uncond":
                raise ValueError("packed steps implement vanilla CFG; "
                                 "weak_cond guidance mixes modes inside "
                                 "one NFE pair")
            if (plan.solver, plan.guidance_scale, plan.clip_x0,
                    plan.attn_backend) != \
                    (ref.solver, ref.guidance_scale, ref.clip_x0,
                     ref.attn_backend):
                raise ValueError("all menu plans must share solver, "
                                 "guidance scale, clip_x0, and "
                                 "attn_backend (one engine = one "
                                 "step family)")

    # ------------------------------------------------------------------
    # Request lifecycle

    def quantize(self, budget: float) -> float:
        """Requested budget → menu level: cheapest level >= requested
        (the served sample is at least as powerful as asked)."""
        for b in sorted(self.levels):
            if b >= budget - 1e-9:
                return b
        return max(self.levels)

    def request_seed(self, rid: int) -> int:
        """The seed request ``rid`` is served with unless its submitter
        gave a generator, or ``x_T`` and ``noise``."""
        return request_seed(self._base_seed, rid)

    def submit(self, cond: int, budget: float,
               deadline: float = math.inf, *,
               generator: Optional[torch.Generator] = None,
               x_T: Optional[torch.Tensor] = None,
               noise: Optional[torch.Tensor] = None,
               seed: Optional[int] = None) -> int:
        """Enqueue one request; returns its id. Randomness as in
        ``FlexiPipeline.sample``: ``x_T`` ([1, *latent]) and, for DDPM,
        ``noise`` ([T, 1, *latent]) when given, else drawn at admission
        from ``generator`` (on the engine's device), else from a generator
        seeded with ``seed`` (a fleet passes the seed of its own request
        id), else with :meth:`request_seed` of the id."""
        rid = self._next_id
        self._next_id += 1
        if seed is None and generator is None:
            seed = self.request_seed(rid)
        now = self.clock()
        req = Request(id=rid, cond=int(cond), budget=float(budget),
                      deadline=deadline, seed=seed, generator=generator,
                      x_T=x_T, noise=noise)
        self._queue.submit(req, now)
        if self.controller is not None:
            self.controller.observe_arrival(now)
        return rid

    def _draw_inputs(self, req: Request, lp: LevelPlan
                     ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """The request's prior and (DDPM) per-step noise, drawn in the order
        ``FlexiPipeline.sample`` draws them for a batch of one."""
        shape = (1,) + tuple(self.cfg.dit.latent_shape)
        T = len(lp.ts)
        ddpm = self.solver == "ddpm"
        gen = req.generator
        if gen is None and (req.x_T is None or (ddpm and req.noise is None)):
            gen = torch.Generator(device=self.device).manual_seed(req.seed)
        if req.x_T is not None:
            x_T = req.x_T.to(self.device, torch.float32).reshape(shape)
        else:
            x_T = torch.randn(shape, generator=gen, device=self.device)
        noise = None
        if ddpm:
            if req.noise is not None:
                noise = req.noise.to(self.device).reshape((T,) + shape)
            else:
                noise = torch.stack([
                    torch.randn(shape, generator=gen, device=self.device)
                    for _ in range(T)])
        return x_T, noise

    def stop_admissions(self) -> None:
        """Drain mode: keep stepping the in-flight cohort to completion,
        but stop promoting queued requests (``submit`` still queues)."""
        self._admitting = False

    def resume_admissions(self) -> None:
        self._admitting = True

    def extract_queued(self) -> List[Request]:
        """Remove and return every not-yet-admitted request (submission
        order). Queued requests hold no device or cache state, so a
        draining engine hands them back loss-free; the in-flight cohort
        finishes here."""
        out = sorted(self._queue._pending, key=lambda r: r._seq)
        self._queue._pending.clear()
        return out

    def _admit(self, now: float) -> None:
        if self._expire_queued:
            # a queued request whose deadline has passed is a certain SLA
            # miss: reject it terminally instead of dispatching it (opt-in)
            for req in self._queue.take_expired(now):
                self.expired.append(req)
                self.metrics.total_expired += 1
                if self._rec is not None:
                    self._rec.instant("expired",
                                      args={"id": req.id,
                                            "deadline": req.deadline})
        if not self._admitting:
            return
        policy = "edf" if self.policy == "edf" else "fifo"
        while self._queue and len(self._inflight) < self.max_inflight:
            req = self._queue.pop(policy)
            level = self.quantize(req.budget)
            if self.controller is not None and self.policy == "degrade":
                level = self.controller.assign(level)
            lp = self.levels[level]
            x_T, noise = self._draw_inputs(req, lp)
            mask = (self._level_masks[level].copy()
                    if self.cache is not None else None)
            self._inflight.append(InFlight(
                req=req, lp=lp, x_src=x_T, x_row=0, noise=noise,
                admit=now, seq=self._seq, refresh_mask=mask))
            self._seq += 1

    def _priority(self, f: InFlight) -> Tuple:
        if self.policy == "edf":
            return (f.req.deadline, f.seq)
        return (f.seq,)

    def _runner_kw(self) -> Dict[str, Any]:
        return dict(solver=self.solver, guidance_scale=self.guidance_scale,
                    clip_x0=self.clip_x0, cache_split=self.cache_split,
                    attn_backend=self.attn_backend, taps=self._taps)

    def _is_warm(self, layout: PackLayout, k: int) -> bool:
        return self.pipe.packed_step_is_warm(layout, k_steps=k,
                                             **self._runner_kw())

    def _ensure_slot(self, f: InFlight, mode: int) -> bool:
        """Make sure ``f`` owns a live slot in ``mode``'s pool; returns
        True when the request must refresh on this dispatch's first step:
        the slot is fresh (joined / phase-switched / evicted), or the
        allocation failed transiently and the request runs slotless
        (``cache_slot == -1``: deep blocks recomputed, no cache reads or
        writes, re-allocation retried next dispatch)."""
        if f.cache_slot >= 0 and f.cache_mode == mode \
                and self.store.owner_of(mode, f.cache_slot) == f.req.id:
            return False
        if f.cache_slot >= 0 \
                and self.store.owner_of(f.cache_mode,
                                        f.cache_slot) == f.req.id:
            self.store.release(f.cache_mode, f.cache_slot)
        try:
            if self._faults is not None and self._faults.take_alloc_failure():
                raise TransientAllocationError("injected alloc failure")
            f.cache_slot = self.store.alloc(mode, f.req.id)
        except TransientAllocationError:
            f.cache_slot = -1
            self.metrics.total_alloc_failures += 1
        f.cache_mode = mode
        return True

    def _zeros(self, shape: Tuple[int, ...], dtype=torch.float32
               ) -> torch.Tensor:
        """A cached zeros block on the engine's device (dummy slots)."""
        key = (shape, dtype)
        z = self._zero_blocks.get(key)
        if z is None:
            z = self._zero_blocks[key] = torch.zeros(shape, dtype=dtype,
                                                     device=self.device)
        return z

    def _gather_latents(self, sel: List[InFlight], pad: int) -> torch.Tensor:
        """[cap, F, H, W, C] group input with as few device ops as
        possible: runs of requests holding consecutive rows of the same
        source batch (the steady state: last step's output) are reused
        whole; stragglers coalesce into one gather per source; dummy tail
        slots come from a cached zeros block."""
        parts: List[torch.Tensor] = []
        i = 0
        while i < len(sel):
            src = sel[i].x_src
            idx = [sel[i].x_row]
            i += 1
            while i < len(sel) and sel[i].x_src is src:
                idx.append(sel[i].x_row)
                i += 1
            if idx == list(range(src.shape[0])):
                parts.append(src)                    # whole batch, no op
            else:
                parts.append(src[idx])               # one gather
        if pad:
            parts.append(self._zeros((pad,) + tuple(self.cfg.dit.latent_shape)))
        return parts[0] if len(parts) == 1 else torch.cat(parts)

    def _gather_noise(self, sel: List[InFlight], pad: int, k: int
                      ) -> torch.Tensor:
        """[k, cap, F, H, W, C]: each request's next k noise draws."""
        parts = [f.noise[f.step:f.step + k] for f in sel]
        if pad:
            parts.append(self._zeros(
                (k, pad) + tuple(self.cfg.dit.latent_shape)))
        return parts[0] if len(parts) == 1 else torch.cat(parts, dim=1)

    def _wait(self) -> None:
        """Wait for the device to finish the work issued so far (the
        engine's only sync point)."""
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()

    # ------------------------------------------------------------------
    # Warm-set shaping

    def precapture_warm_set(self, max_per_mode: int = 2,
                            k_depths: Optional[Sequence[int]] = None) -> int:
        """Build (and run once, on dummy inputs) the SMALL-cohort bucket
        ladder: every menu layout with per-mode counts <= ``max_per_mode``
        at each micro-step depth in ``k_depths`` (default: powers of two up
        to ``steps_per_dispatch``), so a frozen planner's warm set fits
        mid-trace stragglers. Returns how many runners were cold."""
        n_cold = 0
        for layout, k in self.warm_set_ladder(max_per_mode, k_depths):
            n_cold += 1
            self._dummy_dispatch(layout, k)
        return n_cold

    def warm_set_ladder(self, max_per_mode: int = 2,
                        k_depths: Optional[Sequence[int]] = None
                        ) -> List[Tuple[PackLayout, int]]:
        """The still-COLD rungs of the small-cohort bucket ladder, in
        build order (``precapture_warm_set``'s work list)."""
        if k_depths is None:
            k_depths, kd = [], 1
            while kd <= self.steps_per_dispatch:
                k_depths.append(kd)
                kd *= 2
        out: List[Tuple[PackLayout, int]] = []
        for layout in self.menu.layouts:
            if any(c > max_per_mode for _m, c in layout.groups):
                continue
            for k in k_depths:
                if not self._is_warm(layout, k):
                    out.append((layout, k))
        return out

    @torch.inference_mode()
    def _dummy_dispatch(self, layout: PackLayout, k: int,
                        record: bool = True) -> None:
        """Run throwaway dispatches at ``layout`` so the runner is built
        and captured, and its kernels loaded, before a real step meets it:
        one, or on the cached family two (every micro-step refreshing,
        then none), so both deep/shallow graphs exist and no capture
        happens after warm-up. ``record=False`` skips the span (the
        background warm-up thread must not interleave writes into the
        serving thread's recorder)."""
        record = record and self._rec is not None
        t0 = self.clock() if record else 0.0
        key = profile_packed_key(layout, k_steps=k, **self._runner_kw())
        runner = self.pipe.packed_step(layout, k_steps=k, **self._runner_kw())
        L = self.cfg.num_layers
        for deep in ((True, False) if self.cache is not None else (True,)):
            runner(self.pipe.params, *dummy_packed_args(
                self.cfg, key, self.device, refresh=deep))
            with self._count_lock:
                self.block_passes += k * (L if deep else self.cache_split)
                self.packed_forwards += k
        self._wait()
        if record:
            self._rec.complete("compile", t0, self.clock(),
                               args={"groups": str(layout.groups), "k": k,
                                     "precapture": True})

    # ------------------------------------------------------------------
    # The engine iteration

    def _plan(self) -> Tuple[int, PackLayout, List[List[InFlight]]]:
        """Co-optimize the cohort, the bucket and the micro-step depth k:
        one dispatch advances the cohort k consecutive same-mode denoise
        steps (joins wait at most k steps), so the planner maximizes
        request-steps per dispatch (k x cohort size) over the power-of-two
        depths the highest-priority request can sustain. Cold dispatches
        pack an EXACT-fit layout (greedy over the priority order, no dummy
        slots); frozen serving (``allow_cold=False``) restricts to built
        layouts, falling back to a cold one only when nothing warm can
        serve at all."""
        prio = sorted(self._inflight, key=self._priority)
        top = prio[0]
        k_cap = 1
        top_run = min(self.steps_per_dispatch,
                      int(top.lp.run_len[top.step]))
        while k_cap * 2 <= top_run:
            k_cap *= 2
        best = None
        for cold_pass in ((True,) if self.allow_cold else (False, True)):
            if not cold_pass:
                # frozen pass: only buckets with room for the highest-
                # priority request's mode (keeps EDF live and k_cap valid)
                warm_layouts = {
                    kk: [l for l in ls if l.capacity_for(top.mode)]
                    for kk, ls in self.pipe.warm_packed_layouts(
                        **self._runner_kw()).items()}
            kc = k_cap
            while kc >= 1:
                eligible = [f for f in prio
                            if int(f.lp.run_len[f.step]) >= kc]
                if not eligible:
                    kc //= 2
                    continue
                if cold_pass:
                    idx, counts = self.menu.greedy_fit(
                        [f.mode for f in eligible])
                    if not idx:
                        kc //= 2
                        continue
                    cand = PackLayout.for_counts(
                        counts, guided=self.guided,
                        row_capacity=self.menu.row_capacity)
                    sel_by_mode: Optional[Dict[int, List[InFlight]]] = {}
                    for i in idx:
                        sel_by_mode.setdefault(eligible[i].mode,
                                               []).append(eligible[i])
                    served = len(idx)
                else:
                    demand: Dict[int, int] = {}
                    for f in eligible:
                        demand[f.mode] = demand.get(f.mode, 0) + 1
                    cand = self.menu.choose(
                        demand, among=warm_layouts.get(kc, ()))
                    if cand is None:
                        kc //= 2
                        continue
                    sel_by_mode = None
                    served = self.menu.served_by(cand, demand)
                score = (kc * served,
                         1 if self._is_warm(cand, kc) else 0,
                         -self.menu.packed_tokens(cand))
                if best is None or score > best[0]:
                    best = (score, kc, cand, sel_by_mode)
                kc //= 2
            if best is not None:
                break                 # frozen pass found a warm bucket
        _, k, layout, sel_by_mode = best
        if sel_by_mode is None:       # warm bucket: fill its capacities
            sel_by_mode = {}
            for f in prio:
                if int(f.lp.run_len[f.step]) >= k:
                    sel_by_mode.setdefault(f.mode, []).append(f)
        picked = [sel_by_mode.get(mode, [])[:cap]
                  for mode, cap in layout.groups]
        return k, layout, picked

    @torch.inference_mode()
    def step(self) -> List[ServedResult]:
        """One engine iteration: admit arrivals, plan (cohort, bucket,
        micro-step depth k), advance the packed cohort k denoise steps in
        one dispatch, and retire finished requests. Requests that don't
        fit the chosen bucket wait (no drain, no rebuild)."""
        now = self.clock()
        n_before = len(self._inflight)
        self._admit(now)
        if self._rec is not None and len(self._inflight) > n_before:
            self._rec.complete("admit", now, self.clock(),
                               args={"admitted":
                                     len(self._inflight) - n_before,
                                     "queued": len(self._queue)})
        if not self._inflight:
            self._last_step_at = now
            return []
        mult = 2 if self.guided else 1
        t_plan = self.clock() if self._rec is not None else 0.0
        k, layout, picked = self._plan()
        if self._rec is not None:
            self._rec.complete("plan", t_plan, self.clock(),
                               args={"k": k, "groups": str(layout.groups),
                                     "inflight": len(self._inflight)})
        t_pack = self.clock() if self._rec is not None else 0.0
        ddpm = self.solver == "ddpm"

        xs, metas, noises = [], [], []
        deltas, refreshes, slot_lists, rf_real = [], [], [], []
        real_tokens = 0
        n_refresh = n_cached_steps = 0
        for (mode, cap), sel in zip(layout.groups, picked):
            pad = cap - len(sel)
            xs.append(self._gather_latents(sel, pad))
            meta = np.zeros((k, 3, cap), np.int32)
            meta[:, 1, :] = -1                   # dummy slots: final step
            rf = np.zeros((k, cap), bool)        # dummies never refresh
            slots: List[int] = []
            for i, f in enumerate(sel):
                s = f.step
                meta[:, 0, i] = f.lp.ts[s:s + k]
                meta[:, 1, i] = f.lp.t_prev[s:s + k]
                meta[:, 2, i] = f.req.cond
                if self.cache is not None:
                    if self._ensure_slot(f, mode):
                        f.refresh_mask[s] = True     # fresh slot: no replay
                    elif self.store.integrity and not self.store.verify_slot(
                            mode, f.cache_slot):
                        # checksum mismatch: the resident delta was
                        # corrupted out of band; recompute the deep blocks
                        f.refresh_mask[s] = True
                        self.metrics.total_integrity_refreshes += 1
                    if f.cache_slot < 0:
                        # slotless: every micro-step refreshes, so the
                        # row gathered for it is never read
                        f.refresh_mask[s:s + k] = True
                    rf[:, i] = f.refresh_mask[s:s + k]
                    slots.append(f.cache_slot)
            metas.append(torch.from_numpy(meta).to(self.device))
            if ddpm:
                noises.append(self._gather_noise(sel, pad, k))
            real_tokens += mult * self._seg_tokens[mode] * len(sel) * k
            if self.cache is not None:
                refreshes.append(rf)
                slot_lists.append(slots)
                rf_real.append(rf[:, :len(sel)])
                gathered = (self.store.gather(mode, [max(sl, 0)
                                                     for sl in slots])
                            if slots else None)
                if pad:
                    z = self._zeros((pad, self.store.mult,
                                     self._seg_tokens[mode],
                                     self.cfg.d_model), self.store.dtype)
                    gathered = (z if gathered is None
                                else torch.cat([gathered, z]))
                deltas.append(gathered)

        L = self.cfg.num_layers
        step_flops = 0.0
        if self.cache is not None:
            # the deep blocks run for the whole pack on a micro-step where
            # any cohort member refreshes, so only all-skip micro-steps
            # realise the deep saving: FLOPs fed to the capacity EWMA charge
            # what the hardware ran; the per-request counts feed the
            # hit-rate ledger
            any_ref = np.zeros(k, bool)
            for rf in rf_real:
                if rf.size:
                    any_ref |= rf.any(axis=1)
            deep_skips = k - int(any_ref.sum())
            for (mode, _cap), sel, rf in zip(layout.groups, picked,
                                             rf_real):
                n_refresh += int(rf.sum())
                n_cached_steps += k * len(sel)
                full = dit_nfe_flops(self.cfg, mode,
                                     attn_backend=self.attn_backend)
                deep = cache_ledger.deep_block_flops(
                    self.cfg, mode, self.cache_split,
                    attn_backend=self.attn_backend)
                step_flops += mult * len(sel) * (k * full
                                                 - deep_skips * deep)
            passes = k * L - deep_skips * (L - self.cache_split)
        else:
            step_flops = k * sum(
                mult * len(sel)
                * dit_nfe_flops(self.cfg, mode,
                                attn_backend=self.attn_backend)
                for (mode, _cap), sel in zip(layout.groups, picked))
            passes = k * L
        with self._count_lock:
            self.block_passes += passes
            self.packed_forwards += k

        if self._rec is not None:
            self._rec.complete("pack", t_pack, self.clock(),
                               args={"real_tokens": real_tokens})
        was_warm = self._is_warm(layout, k) if self._rec is not None else True
        t_fetch = self.clock() if self._rec is not None else 0.0
        runner = self.pipe.packed_step(layout, k_steps=k, **self._runner_kw())
        if self._rec is not None and not was_warm:
            # cold dispatch: the runner was built now
            self._rec.complete("compile", t_fetch, self.clock(),
                               args={"groups": str(layout.groups), "k": k})
        timed = self._profile is not None
        t_disp = self.clock() if self._rec is not None or timed else 0.0
        events = None
        if timed and self.device.type == "cuda":
            events = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            events[0].record()
        zs = tuple(noises) if ddpm else None
        tap = None
        if self.cache is not None:
            out = runner(self.pipe.params, tuple(xs), tuple(metas), zs,
                         tuple(deltas), tuple(refreshes))
            outs, new_deltas, tap = out if self._taps else (*out, None)
            if self._faults is not None:
                self._apply_poison(outs, picked)
            for (mode, _cap), slots, nd in zip(layout.groups, slot_lists,
                                               new_deltas):
                # slotless rows are not written back: that would clobber
                # slot 0's owner
                keep = [j for j, sl in enumerate(slots) if sl >= 0]
                if len(keep) == len(slots) and slots:
                    self.store.scatter(mode, slots, nd[:len(slots)])
                elif keep:
                    self.store.scatter(mode, [slots[j] for j in keep],
                                       nd[keep])
            self.metrics.record_cache(n_refresh,
                                      n_cached_steps - n_refresh)
            self.metrics.set_cache_bytes(self.store.bytes_resident)
        else:
            out = runner(self.pipe.params, tuple(xs), tuple(metas), zs)
            outs, tap = out if self._taps else (out, None)
            if self._faults is not None:
                self._apply_poison(outs, picked)
        if timed:
            self._observe_dispatch(layout, k, picked, rf_real, step_flops,
                                   now, t_disp, events)
        if self._rec is not None:
            self._rec.complete(
                "dispatch", t_disp, self.clock(),
                args={"k": k, "groups": str(layout.groups),
                      "requests": sum(len(s) for s in picked),
                      "warm": was_warm})
        if tap is not None:
            # still device tensors: the aggregator reads them at export
            self.telemetry.taps.add(TapSample(
                time=now, k=k, groups=layout.groups,
                n_real=tuple(len(s) for s in picked),
                eps_norm=tap["eps_norm"], drift=tap.get("drift"),
                attn_blocks=tap.get("attn_blocks"),
                finite=tap.get("finite")))
        self._flops_since_sync += step_flops
        bad: set = set()
        if any(f.step + k >= len(f.lp.ts) for sel in picked for f in sel):
            # someone completes on this dispatch: a result counts as
            # served once it exists, so the finish stamp (and the latency
            # derived from it) waits for the device. This is also the only
            # honest capacity sample: between waits the clock sees only
            # host-side batch assembly
            t_mat = self.clock() if self._rec is not None else 0.0
            if self._quarantine:
                # the finite flags' read is the wait
                bad = self._scan_finite(tap, picked, outs, k)
            else:
                self._wait()
            self.waits += 1
            now = self.clock()
            if self._rec is not None:
                self._rec.complete("materialize", t_mat, now,
                                   args={"k": k})
            if self.controller is not None and self._last_sync_at is not None \
                    and now > self._last_sync_at:
                self.controller.observe_service(self._flops_since_sync,
                                                now - self._last_sync_at)
            self._flops_since_sync = 0.0
            self._last_sync_at = now

        finished: List[ServedResult] = []
        stepped = 0
        for g, sel in enumerate(picked):
            for i, f in enumerate(sel):
                f.x_src, f.x_row = outs[g], i
                f.step += k
                stepped += 1
                if f.req.id in bad:
                    self._inflight.remove(f)
                    self._quarantine_request(f, now)
                elif f.done:
                    self._inflight.remove(f)
                    finished.append(self._retire(f, now))
        cost = self._layout_costs.get(layout)
        if cost is None:
            cost = self._layout_costs[layout] = layout.cost(self.cfg)
        self.metrics.record_step(now, real_tokens, cost.packed_tokens * k,
                                 stepped)
        if self.attn_backend in ("auto", "pallas"):
            # cross-segment block skip ledger: the fraction of the pack's
            # score tiles the segment-aware kernel never issued
            blk = self._layout_blocks.get(layout)
            if blk is None:
                blk = self._layout_blocks[layout] = \
                    layout.attention_block_stats(self.cfg)
            self.metrics.record_attention_blocks(blk[0] * k, blk[1] * k)
        if self._rec is not None:
            self._rec.counter("engine", {"inflight": len(self._inflight),
                                         "queued": len(self._queue)})
        if self._watchdog is not None:
            self._watch(now)
        self._last_step_at = now
        return finished

    def _observe_dispatch(self, layout: PackLayout, k: int,
                          picked: List[List[InFlight]],
                          rf_real: List[np.ndarray], step_flops: float,
                          now: float, t_disp: float,
                          events: Optional[List[Any]]) -> None:
        """Profiling: wait for the dispatch (the one wait profiling adds),
        take its wall time (CUDA events on the card, the engine's clock on
        the CPU), and feed the cost registry, the attribution ledger and
        the controller's calibration."""
        if events is not None:
            events[1].record()
        self._wait()
        if events is not None:
            wall_s = events[0].elapsed_time(events[1]) / 1e3
        else:
            wall_s = self.clock() - t_disp
        pkey = profile_packed_key(layout, k_steps=k, **self._runner_kw())
        self._profile.observe_wall(pkey, wall_s)
        mult = 2 if self.guided else 1
        if self._attr is not None:
            rids: List[int] = []
            weights: List[float] = []
            for gi, ((mode, _cap), sel) in enumerate(zip(layout.groups,
                                                         picked)):
                full = dit_nfe_flops(self.cfg, mode,
                                     attn_backend=self.attn_backend)
                deep = (cache_ledger.deep_block_flops(
                    self.cfg, mode, self.cache_split,
                    attn_backend=self.attn_backend)
                    if self.cache is not None else 0.0)
                for i, f in enumerate(sel):
                    rids.append(f.req.id)
                    if self.cache is not None:
                        # refresh-aware ledger share: skip steps pay the
                        # shallow blocks only
                        w = mult * sum(full if r else full - deep
                                       for r in rf_real[gi][:, i])
                    else:
                        w = mult * k * full
                    weights.append(float(w))
            if rids:
                self._attr.attribute_dispatch(
                    time=now, label=f"k={k} groups={layout.groups}",
                    request_ids=rids, weights=weights,
                    wall_ns=int(wall_s * 1e9), flops=int(step_flops))
        if self.controller is not None:
            fams = {mode for (mode, _c), sel in zip(layout.groups, picked)
                    if sel}
            self.controller.observe_calibration(
                fams.pop() if len(fams) == 1 else None, step_flops, wall_s)

    def _watch(self, now: float) -> None:
        """One watchdog tick: the detectors over this step's observables;
        every ``taps_every`` ticks the tap window's drift (a host read of
        the taps, at that cadence only)."""
        self._wd_ticks += 1
        drift = None
        if self._taps and (self._wd_ticks
                           % self._watchdog.config.taps_every == 0):
            sub = self.telemetry.taps.aggregate().get("drift")
            if sub:
                drift = float(sub.get("max", 0.0))
        self._watchdog.observe_step(
            now=now, queued=len(self._queue), inflight=len(self._inflight),
            compiled=self.pipe.cache_stats()["compiled"],
            latencies=[r.latency for r in self.metrics.requests],
            drift_max=drift, nonfinite=self.metrics.total_quarantined)
        if self._watchdog.should_dump():
            self._watchdog.dump(
                reason="alert", engine_snapshot=self.snapshot_state(),
                attribution=self._attr, registry=self._profile)

    def _apply_poison(self, outs: Sequence[torch.Tensor],
                      picked: List[List[InFlight]]) -> None:
        """Fault seam (after the dispatch): overwrite the targeted
        requests' output rows with NaN in place, on the engine's stream —
        the failure a silently degraded weak step would have produced. No
        other row of the pack is touched."""
        for g, sel in enumerate(picked):
            for i, f in enumerate(sel):
                if self._faults is not None \
                        and self._faults.take_poison(f.req.id):
                    outs[g][i].fill_(math.nan)
                    self.metrics.total_poisoned += 1

    def _scan_finite(self, tap: Optional[Dict[str, Any]],
                     picked: List[List[InFlight]],
                     outs: Sequence[torch.Tensor], k: int) -> set:
        """Ids of the requests to quarantine on this completing dispatch:
        those whose rows the finite tap (taps on) flags on any micro-step,
        and those finishing now whose latents are not all finite. The
        flags are gathered on the device and read back in ONE copy, which
        waits for the dispatch as :meth:`_wait` would: the read takes the
        wait's place, so quarantine adds no synchronisation."""
        flags, owners = [], []
        fin = tap.get("finite") if tap is not None else None
        for g, sel in enumerate(picked):
            if not sel:
                continue
            if fin is not None:
                flags.append(fin[g][:, :len(sel)].all(dim=0))
                owners += [f.req.id for f in sel]
            # whole rows, no index tensor (an index list would be a copy
            # to the device); only the finishing requests' flags count
            flags.append(torch.isfinite(outs[g][:len(sel)]).flatten(1)
                         .all(dim=1))
            owners += [f.req.id if f.step + k >= len(f.lp.ts) else None
                       for f in sel]
        ok = torch.cat(flags).cpu().tolist()
        return {rid for rid, good in zip(owners, ok)
                if rid is not None and not good}

    def _quarantine_request(self, f: InFlight, now: float) -> None:
        """Non-finite latents detected: drop the trajectory, release its
        cache slot, and re-enqueue the request at the MOST POWERFUL menu
        level with the same randomness (seed, or ``x_T`` / ``noise``),
        restarting from step 0 — the recovered sample is exactly the clean
        powerful-path sample. With ``self_heal=False`` (fleet mode), or
        once the retry budget is spent, the request is parked in
        ``quarantined`` instead, for the caller to escalate (losing it
        silently is never an option)."""
        if self.store is not None and f.cache_slot >= 0 \
                and self.store.owner_of(f.cache_mode,
                                        f.cache_slot) == f.req.id:
            self.store.release(f.cache_mode, f.cache_slot)
        self.metrics.total_quarantined += 1
        if self._rec is not None:
            self._rec.instant("quarantine",
                              args={"id": f.req.id, "step": f.step,
                                    "level": f.lp.level})
        n = self._retries.get(f.req.id, 0)
        if not self._self_heal or n >= self._max_retries:
            self.quarantined.append(f.req)
            return
        self._retries[f.req.id] = n + 1
        self._queue.submit(dataclasses.replace(f.req,
                                               budget=max(self.levels)), now)

    def take_quarantined(self) -> List[Request]:
        """Drain quarantined requests awaiting external escalation (the
        fleet routes them through ``Router.escalate``)."""
        out, self.quarantined = self.quarantined, []
        return out

    def take_expired(self) -> List[Request]:
        """Drain terminally expired requests (deadline passed while
        queued) for the caller's bookkeeping."""
        out, self.expired = self.expired, []
        return out

    def _retire(self, f: InFlight, now: float) -> ServedResult:
        mult = 2 if self.guided else 1
        tokens = int(mult * sum(self._seg_tokens[int(m)] for m in f.lp.modes))
        if self.store is not None and f.cache_slot >= 0 \
                and self.store.owner_of(f.cache_mode,
                                        f.cache_slot) == f.req.id:
            self.store.release(f.cache_mode, f.cache_slot)
        if f.refresh_mask is not None:
            self.metrics.record_refresh_intervals(
                cache_policy.refresh_intervals(f.refresh_mask))
            self.metrics.set_cache_bytes(self.store.bytes_resident)
        rec = RequestRecord(
            id=f.req.id, arrival=f.req.arrival, admit=f.admit, finish=now,
            deadline=f.req.deadline, budget_requested=f.req.budget,
            budget_served=f.lp.level, tokens=tokens, flops=f.lp.flops)
        self.metrics.record_request(rec)
        cost = None
        if self._attr is not None:
            cost = self._attr.finalize(
                f.req.id, queue_wait_s=f.admit - f.req.arrival,
                budget=str(f.lp.level))
        if self._rec is not None:
            # one row per request under the "requests" track (tid = id)
            self._rec.complete(
                f"req{f.req.id}", f.admit, now,
                pid=REQUEST_PID, tid=f.req.id,
                args={"budget_requested": f.req.budget,
                      "budget_served": f.lp.level,
                      "steps": len(f.lp.ts), "flops": f.lp.flops,
                      "queue_wait": f.admit - f.req.arrival})
        return ServedResult(request=f.req, x0=f.x,
                            budget_served=f.lp.level, record=rec, cost=cost)

    # ------------------------------------------------------------------

    def run(self, max_steps: int = 100_000,
            on_step: Optional[Callable[[], None]] = None) -> List[ServedResult]:
        """Drain: step until queue and in-flight are empty, calling
        ``on_step()`` after each step (the CLI prints its periodic metrics
        line there). An uncaught exception, in a step or in ``on_step``,
        first dumps a post-mortem bundle (when a watchdog with a
        post-mortem directory is attached), then propagates unchanged."""
        out: List[ServedResult] = []
        steps = 0
        try:
            while (self._queue or self._inflight) and steps < max_steps:
                out.extend(self.step())
                steps += 1
                if on_step is not None:
                    on_step()
        except Exception:
            if self._watchdog is not None:
                self._watchdog.dump(
                    reason="engine-exception",
                    engine_snapshot=self.snapshot_state(),
                    attribution=self._attr, registry=self._profile)
            raise
        return out

    def snapshot_state(self) -> Dict[str, Any]:
        """Flight-recorder view of engine state: queue, in-flight request
        positions, runner-cache counters, cache residency. All host-side:
        safe to call from the crash path."""
        snap: Dict[str, Any] = {
            "queued": [{"id": r.id, "budget": r.budget,
                        "deadline": r.deadline, "arrival": r.arrival}
                       for r in self._queue._pending],
            "inflight": [{"id": f.req.id, "level": f.lp.level,
                          "step": f.step, "of": len(f.lp.ts),
                          "mode": f.mode, "admit": f.admit,
                          "cache_slot": f.cache_slot}
                         for f in self._inflight],
            "compile": self.pipe.cache_stats(),
            "policy": self.policy,
        }
        if self.store is not None:
            snap["cache_bytes"] = self.store.bytes_resident
        return snap

    @property
    def idle(self) -> bool:
        return not self._queue and not self._inflight

    @property
    def n_queued(self) -> int:
        return len(self._queue)

    @property
    def n_inflight(self) -> int:
        return len(self._inflight)

    def cache_stats(self) -> Dict[str, int]:
        """The pipeline's runner-cache counters (packed-step runners are
        cached there; no growth after warm-up = nothing rebuilt)."""
        return self.pipe.cache_stats()
