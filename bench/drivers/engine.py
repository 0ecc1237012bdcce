"""Driver of a class-conditioned DiT served through the port's
``ServingEngine`` (``submit`` / ``step``), the object ``launch/serve.py``
builds: DDIM under classifier-free guidance over a menu of budgets.

Set-up builds the pipeline and the engine (``allow_cold=False``: the
planner keeps to the layouts warmed here), warms every layout of the
engine's menu at every micro-step depth (the menu holds only the modes
the cell's budgets reach), and for a closed loop runs one turnover of the
clients before the window. The window then runs one of two loops:

- closed (``"arrivals": "closed"``): as many clients as the engine holds
  requests in flight, each sending its next request when its last one
  returns; the window opens on an idle device and closes at the first
  completion after ``seconds``, so it spans whole dispatches and ends
  with the device caught up; ``img_per_s`` counts the images finished
  inside it;
- open (``"arrivals": "poisson"``): the mix's requests at their due
  times; a request's latency runs from its due time to its image being
  ready; requests still in flight at ``seconds`` are drained, a minute at
  most, and any that never finish count as failed.

The output check draws a sample of the finished requests, ``per_budget``
of each budget (the longest among them), and recomputes them with the
plain reference from the same weights, labels and priors.
"""
from __future__ import annotations

import time
from typing import Any, Dict, List, Optional

import torch

from benchlib import ledger, port, traffic, weights
from benchlib.compare import rel_err
from benchlib.trace import Tracer

CLOSED = "closed"


def _engine(ctx, params):
    from repro_torch.pipeline import FlexiPipeline, SamplingPlan
    from repro_torch.serving import ServingEngine

    mix, cfg = ctx.mix, port.model_config(ctx.model)
    pipe = FlexiPipeline(params, cfg, port.schedule(ctx.config["diffusion"]),
                         device=ctx.device)
    p = mix["plan"]
    plans = {b: SamplingPlan(T=p["T"], budget=b, solver=p["solver"],
                             guidance_scale=p["guidance_scale"],
                             attn_backend=p["attn_backend"])
             for b in mix["budgets"]}
    e = mix["engine"]
    engine = ServingEngine(pipe, plans,
                           max_tokens_per_step=e["max_tokens_per_step"],
                           steps_per_dispatch=e["steps_per_dispatch"],
                           policy=e["policy"], allow_cold=False,
                           clock=ctx.clock)
    return pipe, engine


class Run:
    """One run of a cell: the window's observations, its completed
    requests and what the output check needs."""

    def __init__(self, ctx):
        self.ctx = ctx
        self.obs: Dict[str, Any] = {}
        self.done: Dict[int, Any] = {}      # request index -> result
        self.due: Dict[int, float] = {}     # request index -> due time
        self.attempted = 0
        self.failed = 0

    # -- set-up -------------------------------------------------------

    def setup(self) -> None:
        ctx, mix = self.ctx, self.ctx.mix
        m = ctx.model
        self.params = weights.make(m, ctx.seed, ctx.device,
                                   getattr(torch, m["param_dtype"]))
        self.pipe, self.engine = _engine(ctx, self.params)
        self.stream = traffic.Stream(mix, ctx.seed, ctx.seconds, ctx.rate)
        self.priors = traffic.DeviceDraws(
            ctx.seed, "priors", (1,) + tuple(m["dit"]["latent_shape"]),
            ctx.device)
        self.next_id = 0
        self.late = 0.0
        self.rid: Dict[int, int] = {}       # engine id -> request index
        t_warm = ctx.clock()
        self.obs["layouts_warmed"] = self._warm()
        self.obs["warm_s"] = ctx.clock() - t_warm
        t_prime = ctx.clock()
        if mix["arrivals"] == CLOSED:
            clients = self.engine.max_inflight
            self.obs["clients"] = clients
            for _ in range(clients):
                self._submit()
            primed = 0
            while primed < clients:
                for r in self.engine.step():
                    primed += 1
                    self._submit()
        self._sync()
        self.obs["prime_s"] = ctx.clock() - t_prime
        ctx.weights = self.params

    def _warm(self) -> int:
        """Capture every layout of the engine's menu (it holds only the
        modes the cell's budgets reach) once, at depth 1, then build its
        runners at the deeper micro-step depths, which replay the same
        captured micro-step: the planner (``allow_cold=False``) keeps to
        these."""
        engine = self.engine
        depths = [k for k in (2, 4, 8, 16, 32)
                  if k <= engine.steps_per_dispatch]
        deeper = engine.warm_set_ladder(max_per_mode=1 << 30,
                                        k_depths=depths)
        n = engine.precapture_warm_set(max_per_mode=1 << 30, k_depths=[1])
        kw = dict(solver=engine.solver, guidance_scale=engine.guidance_scale,
                  clip_x0=engine.clip_x0, cache_split=engine.cache_split,
                  attn_backend=engine.attn_backend, taps=False)
        for layout, k in deeper:
            self.pipe.packed_step(layout, k_steps=k, **kw)
        return n

    def _submit(self, due: Optional[float] = None) -> int:
        i = self.next_id
        self.next_id += 1
        eid = self.engine.submit(cond=self.stream.label(i),
                                 budget=self.stream.budget(i),
                                 x_T=self.priors[i])
        self.rid[eid] = i
        if due is not None:
            self.due[i] = due
            self.late = max(self.late, self.ctx.clock() - due)
        return i

    # -- the window ---------------------------------------------------

    def window(self, tracer: Tracer) -> None:
        ctx, engine = self.ctx, self.engine
        self.built0 = port.built(self.pipe)
        if ctx.device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(ctx.device)
        self.steps: List[Dict[str, Any]] = []
        tracer.start()
        t0 = ctx.clock()
        self.obs["t_open"] = t0
        tracer.open_window()
        trace_end = t0 + ctx.mix.get("trace_seconds", ctx.seconds)
        if ctx.mix["arrivals"] == CLOSED:
            self._closed(tracer, t0, trace_end)
        else:
            self._open(tracer, t0, trace_end)
        self._end_trace(tracer)
        self.obs["window_s"] = self.t_close - t0
        self.obs["steps"] = self.steps
        self.obs["built_in_window"] = port.built(self.pipe) - self.built0
        if ctx.device.type == "cuda":
            self.obs["peak_bytes_window"] = torch.cuda.max_memory_allocated(
                ctx.device)

    def _sync(self) -> None:
        if self.ctx.device.type == "cuda":
            torch.cuda.synchronize(self.ctx.device)

    def _step(self, tracer: Tracer) -> list:
        engine = self.engine
        pf = engine.packed_forwards
        with tracer.span("bench.step"):
            fin = engine.step()
        k = engine.packed_forwards - pf
        if k:
            rec = engine.metrics.steps[-1]
            self.steps.append({"k": k, "real": rec.real_tokens,
                               "packed": rec.packed_tokens,
                               "n": rec.n_requests,
                               "traced": tracer.active})
        return fin

    def _maybe_end_trace(self, tracer: Tracer, trace_end: float) -> None:
        if tracer.active and self.ctx.clock() >= trace_end:
            self._end_trace(tracer)

    def _end_trace(self, tracer: Tracer) -> None:
        """End the traced part on a caught-up device: every step it holds
        ran inside it."""
        if tracer.active:
            with tracer.span("bench.sync"):
                self._sync()
            tracer.stop()

    def _closed(self, tracer: Tracer, t0: float, trace_end: float) -> None:
        ctx = self.ctx
        end = t0 + ctx.seconds
        while True:
            fin = self._step(tracer)
            for r in fin:
                self.done[self.rid[r.request.id]] = r
                with tracer.span("bench.submit"):
                    self._submit()
            self._maybe_end_trace(tracer, trace_end)
            now = ctx.clock()
            if fin and now >= end:
                self.t_close = now
                break
        self.attempted = len(self.done)
        self.obs["completed"] = len(self.done)

    def _open(self, tracer: Tracer, t0: float, trace_end: float) -> None:
        ctx, engine, due = self.ctx, self.engine, self.stream.due
        n, i = len(due), 0
        end, limit = t0 + ctx.seconds, t0 + ctx.seconds + 60.0
        third = t0 + ctx.seconds / 3.0
        backlog = {}
        while True:
            now = ctx.clock()
            while i < n and t0 + due[i] <= now:
                with tracer.span("bench.submit"):
                    self._submit(due=t0 + float(due[i]))
                i += 1
            for mark, at in (("third", third), ("end", end)):
                if mark not in backlog and now >= at:
                    backlog[mark] = engine.n_queued + engine.n_inflight
            if engine.idle:
                if i >= n:
                    break
                with tracer.span("bench.sleep"):
                    time.sleep(max(0.0, min(t0 + due[i] - now, 0.002)))
                continue
            if now > limit:
                break
            for r in self._step(tracer):
                self.done[self.rid[r.request.id]] = r
            self._maybe_end_trace(tracer, trace_end)
        self.t_close = ctx.clock()
        self.attempted = n
        self.failed = n - len(self.done)
        self.obs["backlog"] = backlog
        lat = [(r.record.finish - self.due[j], r.record.admit - self.due[j])
               for j, r in self.done.items()]
        self.obs["latency_s"] = [a for a, _ in lat]
        self.obs["queue_wait_s"] = [b for _, b in lat]
        self.obs["late_s"] = self.late

    # -- after the window ---------------------------------------------

    def close(self) -> None:
        """Keep what the check needs, free the program's state."""
        self.outputs = {j: r.x0.detach().clone() for j, r in self.done.items()}
        self.done = {j: r.budget_served for j, r in self.done.items()}
        del self.engine, self.pipe
        port.free_device()

    def check_ids(self) -> List[int]:
        per = self.ctx.mix["check"]["per_budget"]
        groups: Dict[float, List[int]] = {}
        for j, b in self.done.items():
            groups.setdefault(b, []).append(j)
        return traffic.check_sample(self.ctx.seed, groups, per)


def run(ctx) -> Run:
    r = Run(ctx)
    r.setup()
    return r


def reference_outputs(ctx, ids: List[int], stream, priors,
                      precision: str = "float32") -> Dict[int, torch.Tensor]:
    """The plain reference's x0 of requests ``ids`` (float32, or the
    control's fp8), computed a budget at a time in blocks of requests."""
    ref = ctx.reference
    m, mix = ctx.model, ctx.mix
    p = mix["plan"]
    diff = ctx.config["diffusion"]
    acp = ref.linear_alphas_cumprod(diff["num_steps"], diff["beta_start"],
                                    diff["beta_end"])
    ts = ref.respaced(diff["num_steps"], p["T"])
    guided = p["guidance_scale"] != 0.0
    model = ref.DiT(m, ctx.weights, ctx.device, precision=precision)
    block = mix["check"].get("block", 8)
    out: Dict[int, torch.Tensor] = {}
    by_budget: Dict[float, List[int]] = {}
    for j in ids:
        by_budget.setdefault(stream.budget(j), []).append(j)
    for b, js in sorted(by_budget.items()):
        modes = ledger.step_modes(ledger.resolve_schedule(m, p["T"], b,
                                                          guided))
        for lo in range(0, len(js), block):
            part = js[lo:lo + block]
            x_T = torch.cat([priors[j] for j in part])
            y = torch.tensor([stream.label(j) for j in part],
                             device=ctx.device)
            x0 = ref.ddim_cfg(model, x_T, y, modes, ts,
                              p["guidance_scale"], acp)
            for j, x in zip(part, x0):
                out[j] = x[None]
    del model
    return out


def check(ctx, r: Run) -> Dict[str, Any]:
    """Readings of the output check: the widest relative error of a
    sampled request's x0 against the reference."""
    ids = r.check_ids()
    ref = reference_outputs(ctx, ids, r.stream, r.priors)
    errs = {j: rel_err(r.outputs[j], ref[j]) for j in ids}
    return {"x0_rel_err": max(errs.values()) if errs else float("inf"),
            "failed": float(r.failed), "checked": len(ids), "errors": errs}



def control_reading(ctx, precision: str) -> float:
    """The reference at ``precision`` put in the program's place: its
    widest x0 error against the float32 reference over the first
    ``per_budget`` requests of each budget of the stream."""
    stream = traffic.Stream(ctx.mix, ctx.seed, ctx.seconds, ctx.rate)
    priors = traffic.DeviceDraws(
        ctx.seed, "priors", (1,) + tuple(ctx.model["dit"]["latent_shape"]),
        ctx.device)
    ctx.weights = weights.make(ctx.model, ctx.seed, ctx.device,
                               getattr(torch, ctx.model["param_dtype"]))
    per = ctx.mix["check"]["per_budget"]
    ids, seen = [], {}
    i = 0
    while len(ids) < per * len(ctx.mix["budgets"]):
        b = stream.budget(i)
        if seen.get(b, 0) < per:
            ids.append(i)
            seen[b] = seen.get(b, 0) + 1
        i += 1
    low = reference_outputs(ctx, ids, stream, priors, precision)
    ref = reference_outputs(ctx, ids, stream, priors)
    return max(rel_err(low[j], ref[j]) for j in ids)
