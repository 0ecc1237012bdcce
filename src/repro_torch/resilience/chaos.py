"""Chaos harness: scripted fault schedules against a live fleet, the port
of ``repro.resilience.chaos``.

``run_chaos`` drives an N-replica fleet through a deterministic
:class:`~repro.resilience.faults.FaultPlan` — replica crash, transient
hang, heartbeat delay and partition, dispatch slowdown, NaN poisoning
of packed-step outputs, cache-slot corruption, transient allocation
failure — and returns the recovery ledger the chaos suite gates on:

* **zero requests lost** — every admitted request reaches a terminal
  state (served; expiry is disabled here by infinite deadlines);
* **all final latents finite** — every NaN/Inf trajectory was
  quarantined and re-executed, none leaked to a caller;
* **escalation correctness** — each quarantined request's final sample
  matches the clean powerful-path run of the same seed (the escalation
  restarts from step 0 at the most powerful level with the original
  randomness, so the recovered sample carries no trace of the fault);
* **build-once** — the whole chaos scenario replays after a rehearsal
  building zero new runners (faults change data and placement, never
  the step structure).

``run_replay`` is the router-crash scenario: a journaled fleet is
abandoned mid-drain, a fresh fleet replays the journal's unfinished
set exactly-once, and every replayed sample must match its
uninterrupted single-request reference (<=1e-4 in float32 on the CPU).

Errors are reported both as max |x0 - ref| and as ||x0 - ref|| / ||ref||
(the scale-free reading bf16 runs on the card are held to).

The harness drives ``Fleet.tick`` on an injectable clock advanced a
fixed ``tick_dt`` per round, so fault times, heartbeat timeouts, and
escalation backoffs all land deterministically — the same scenario
byte-replays under ``--seed``-style reruns and across the rehearsal /
measured pair.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.fleet import Fleet
from repro_torch.resilience.faults import (ALLOC_FAIL, CORRUPT_SLOT, CRASH,
                                           HANG, HEARTBEAT_DELAY, PARTITION,
                                           POISON, SLOWDOWN, UNHANG,
                                           FaultPlan)
from repro_torch.resilience.journal import RequestJournal


class ChaosClock:
    """Injectable fleet clock (callable like ``time.monotonic``)."""

    def __init__(self, t: float = 0.0):
        self.t = float(t)

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> float:
        self.t += float(dt)
        return self.t


def default_fault_plan(*, seed: int = 0,
                       poison_rids: Sequence[int] = (1, 7, 13)
                       ) -> FaultPlan:
    """The standard chaos schedule over a 4-replica fleet: every fault
    kind fires at least once, early enough that recovery happens while
    the drain is still under load. Times are fleet-clock seconds with
    the harness's default ``tick_dt=1e-3`` (so 0.006 = the 6th round);
    the heartbeat timeout is 0.005, which the transient hang and the
    delayed beats stay safely under while the partition blows through
    it (death by missed beats ~0.013)."""
    p = FaultPlan(seed=seed)
    for rid in poison_rids:
        p.add(0.001, POISON, rid=int(rid))
    p.add(0.003, CORRUPT_SLOT, replica=0)
    p.add(0.003, ALLOC_FAIL, replica=2, count=2)
    p.add(0.004, SLOWDOWN, replica=3, duration=0.01, factor=2.5)
    p.add(0.004, HEARTBEAT_DELAY, replica=2, duration=0.004, delay=0.001)
    p.add(0.006, CRASH, replica=1)
    p.add(0.007, HANG, replica=2)
    p.add(0.009, UNHANG, replica=2)      # transient stall < timeout
    p.add(0.008, PARTITION, replica=3, duration=1.0)  # >> timeout: death
    return p


def drive(fleet: Fleet, clk: ChaosClock, *, tick_dt: float = 1e-3,
          max_ticks: int = 20000) -> int:
    """Tick the fleet to drain, advancing the injectable clock a fixed
    ``tick_dt`` per round (unlike ``Fleet.run``, which leaves a caller
    clock alone, so scripted fault times / heartbeat timeouts would
    never come due)."""
    ticks = 0
    while fleet.router.unfinished() and ticks < max_ticks:
        fleet.tick()
        clk.advance(tick_dt)
        ticks += 1
    return ticks


def _errors(got: torch.Tensor, ref: torch.Tensor) -> Tuple[float, float]:
    """(max |got - ref|, ||got - ref|| / ||ref||) in float32."""
    d = got.float() - ref.float()
    return (float(d.abs().max()),
            float(d.norm() / ref.float().norm().clamp_min(1e-30)))


def _sample_alone(pipe, plan, key: Dict[str, Any], cond: int
                 ) -> torch.Tensor:
    """The request sampled alone by ``FlexiPipeline.sample`` with the
    randomness its fleet ``key`` names (seed, or given prior / noise)."""
    gen = torch.Generator(device=pipe.device).manual_seed(key["seed"])
    x_T, noise = key.get("x_T"), key.get("noise")
    return pipe.sample(plan, 1, gen,
                       cond=torch.tensor([cond], device=pipe.device),
                       x_T=None if x_T is None else x_T.reshape(
                           (1,) + tuple(pipe.cfg.dit.latent_shape)),
                       noise=noise).x0[0]


def _submit_workload(fleet: Fleet, n_requests: int, levels: Sequence[float],
                     num_classes: int, seed: int) -> List[int]:
    rng = np.random.default_rng(seed)
    rids = []
    for _ in range(n_requests):
        cond = int(rng.integers(0, num_classes))
        lvl = float(levels[int(rng.integers(0, len(levels)))])
        rids.append(fleet.submit(cond=cond, budget=lvl))
    return rids


def run_chaos(pipe, plans: Dict[float, Any], *,
              n_replicas: int = 4, n_requests: int = 32,
              fault_plan: Optional[FaultPlan] = None,
              journal: Optional[RequestJournal] = None,
              seconds_per_token: float = 1e-4,
              tick_dt: float = 1e-3,
              heartbeat_timeout_s: float = 0.005,
              backoff_base_s: float = 2e-3,
              max_retries: int = 3,
              seed: int = 0,
              engine_kwargs: Optional[Dict[str, Any]] = None,
              max_ticks: int = 20000) -> Dict[str, Any]:
    """One scripted chaos drain; returns the recovery ledger plus the
    fleet (under ``"fleet"``) for reference checks by the caller."""
    faults = fault_plan if fault_plan is not None else default_fault_plan(
        seed=seed)
    clk = ChaosClock()
    fleet = Fleet(pipe, plans, n_replicas, router="affinity", clock=clk,
                  seconds_per_token=seconds_per_token,
                  heartbeat_timeout_s=heartbeat_timeout_s,
                  faults=faults, journal=journal,
                  max_retries=max_retries, backoff_base_s=backoff_base_s,
                  engine_kwargs=engine_kwargs)
    rids = _submit_workload(fleet, n_requests, sorted(plans),
                            pipe.cfg.dit.num_classes, seed)
    ticks = drive(fleet, clk, tick_dt=tick_dt, max_ticks=max_ticks)
    lost = sorted(set(rids) - set(fleet.results))
    nonfinite = sum(0 if bool(torch.isfinite(r.x0).all()) else 1
                    for r in fleet.results.values())
    escalated = sorted(r.rid for r in fleet.router.requests.values()
                       if r.escalated)
    moved = sorted(r.rid for r in fleet.router.requests.values()
                   if r.readmits or r.handbacks)
    summ = fleet.summary()
    inj = fleet._injector
    return {
        "fleet": fleet,
        "rids": rids,
        "ticks": ticks,
        "requests": n_requests,
        "replicas": n_replicas,
        "requests_lost": len(lost),
        "nonfinite_outputs": nonfinite,
        "escalated_rids": escalated,
        "moved_rids": moved,
        "escalations": summ["router"]["escalations"],
        "expirations": summ["router"]["expirations"],
        "deaths": sum(1 for rid in fleet.replicas
                      if fleet.membership.state(rid) == "dead"),
        "faults": inj.summary() if inj is not None else {},
        "faults_exhausted": bool(inj.exhausted()) if inj is not None
        else True,
        "recovery": {
            "escalation_count": summ["escalation"]["count"],
            "escalation_mean_s": summ["escalation"]["mean_s"],
            "escalation_max_s": summ["escalation"]["max_s"],
            "readmit_count": summ["readmit"]["count"],
            "readmit_mean_s": summ["readmit"]["mean_s"],
            "readmit_max_s": summ["readmit"]["max_s"],
        },
        "integrity_refreshes": sum(
            rep.engine.metrics.total_integrity_refreshes
            for rep in fleet.replicas.values()),
        "alloc_failures": sum(
            rep.engine.metrics.total_alloc_failures
            for rep in fleet.replicas.values()),
        "quarantined": sum(
            rep.engine.metrics.total_quarantined
            for rep in fleet.replicas.values()),
    }


def powerful_reference(pipe, plans: Dict[float, Any], key: Dict[str, Any],
                       cond: int, *, seconds_per_token: float = 1e-4,
                       engine_kwargs: Optional[Dict[str, Any]] = None):
    """The clean powerful-path sample for one request: a fresh fault-free
    single-replica fleet serving only this request at the most powerful
    menu level with the original randomness (``key``: the fleet request's
    seed, or its given prior and noise). This is the exact computation an
    escalated quarantine re-runs, so recovered latents are compared
    against it bitwise (on the card, packed with other requests, the
    GEMMs run at other shapes: there the relative error is the reading)."""
    clk = ChaosClock()
    fleet = Fleet(pipe, plans, 1, clock=clk,
                  seconds_per_token=seconds_per_token,
                  engine_kwargs=engine_kwargs)
    rid = fleet.submit(cond, max(plans), **key)
    drive(fleet, clk)
    return fleet.results[rid].x0


def verify_escalations(pipe, plans: Dict[float, Any],
                       chaos: Dict[str, Any], *,
                       seconds_per_token: float = 1e-4,
                       engine_kwargs: Optional[Dict[str, Any]] = None
                       ) -> Dict[str, Any]:
    """Compare every escalated request's served latents against its
    clean powerful-path reference (bitwise + max abs and relative err)
    and every moved (re-admitted / handed-back) request against the
    uninterrupted per-request pipeline sample (<=1e-4 in float32, the
    packing bar)."""
    fleet = chaos["fleet"]
    esc_err, esc_rel, esc_bitwise = 0.0, 0.0, 1
    for rid in chaos["escalated_rids"]:
        req = fleet.router.requests[rid]
        got = fleet.results[rid].x0
        ref = powerful_reference(pipe, plans, req.key, req.cond,
                                 seconds_per_token=seconds_per_token,
                                 engine_kwargs=engine_kwargs)
        err, rel = _errors(got, ref)
        esc_err, esc_rel = max(esc_err, err), max(esc_rel, rel)
        if not torch.equal(got, ref):
            esc_bitwise = 0
    moved_err, moved_rel = 0.0, 0.0
    for rid in chaos["moved_rids"]:
        if rid in chaos["escalated_rids"]:
            continue                  # already held to the stronger bar
        req = fleet.router.requests[rid]
        res = fleet.results[rid]
        err, rel = _errors(res.x0, _sample_alone(
            pipe, plans[res.budget_served], req.key, req.cond))
        moved_err, moved_rel = max(moved_err, err), max(moved_rel, rel)
    return {"escalated": len(chaos["escalated_rids"]),
            "escalated_max_err": esc_err,
            "escalated_max_rel": esc_rel,
            "escalated_bitwise": esc_bitwise,
            "moved": len(chaos["moved_rids"]),
            "moved_max_err": moved_err,
            "moved_max_rel": moved_rel}


def run_replay(pipe, plans: Dict[float, Any], journal_path: str, *,
               n_replicas: int = 2, n_requests: int = 8,
               crash_after_finished: int = 2,
               seconds_per_token: float = 1e-4,
               tick_dt: float = 1e-3, seed: int = 1,
               engine_kwargs: Optional[Dict[str, Any]] = None,
               max_ticks: int = 20000) -> Dict[str, Any]:
    """Router-crash replay: fleet A journals to ``journal_path`` and is
    abandoned once ``crash_after_finished`` requests completed (in-flight
    and queued requests lost with it); fleet B — sharing only the
    journal file and the base key — replays the unfinished set
    exactly-once and its samples are compared against the uninterrupted
    per-request references (``FlexiPipeline.sample`` with the seed of
    the original fleet id). Returns the ledger, and both fleets under
    ``"fleets"`` for the caller's checks."""
    clk = ChaosClock()
    journal = RequestJournal(journal_path)
    fa = Fleet(pipe, plans, n_replicas, clock=clk,
               seconds_per_token=seconds_per_token, journal=journal,
               engine_kwargs=engine_kwargs)
    rids = _submit_workload(fa, n_requests, sorted(plans),
                            pipe.cfg.dit.num_classes, seed)
    ticks = 0
    while len(fa.results) < crash_after_finished and ticks < max_ticks:
        fa.tick()
        clk.advance(tick_dt)
        ticks += 1
    finished_before = sorted(fa.results)
    journal.close()                   # the crash: fleet A is abandoned

    loaded = RequestJournal.load(journal_path)
    unfinished = loaded.unfinished()
    clk2 = ChaosClock()
    fb = Fleet(pipe, plans, n_replicas, clock=clk2,
               seconds_per_token=seconds_per_token,
               engine_kwargs=engine_kwargs)
    new_ids = fb.resubmit_from_journal(loaded)
    drive(fb, clk2, tick_dt=tick_dt, max_ticks=max_ticks)

    # exactly-once: finished ∪ replayed covers every admit, no overlap
    replayed_orig = [int(r["rid"]) for r in unfinished]
    missing = sorted(set(rids) - set(finished_before) - set(replayed_orig))
    duplicates = sorted(set(finished_before) & set(replayed_orig))
    max_err, max_rel = 0.0, 0.0
    for rec, nid in zip(unfinished, new_ids):
        res = fb.results[nid]
        err, rel = _errors(res.x0, _sample_alone(
            pipe, plans[res.budget_served],
            {"seed": fb.request_seed(int(rec["rid"]))}, int(rec["cond"])))
        max_err, max_rel = max(max_err, err), max(max_rel, rel)
    return {"requests": n_requests,
            "finished_before_crash": len(finished_before),
            "replayed": len(replayed_orig),
            "missing": len(missing),
            "duplicates": len(duplicates),
            "max_readmit_err": max_err,
            "max_readmit_rel": max_rel,
            "journal": loaded.summary(),
            "fleets": (fa, fb)}
