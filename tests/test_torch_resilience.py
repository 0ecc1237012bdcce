"""The port's resilience layer (``repro_torch.resilience`` and the
engine's ``faults=`` / ``quarantine=`` seams) against the JAX package's.

Host-pure parts equal the reference exactly: the fault injector fed the
same event sequences (due order, defer, slowdown windows, beat delay and
partition, poison and allocation-failure countdowns, its seeded picks),
and the request journal, whose records and file bytes are the same, so a
journal written by either package loads in the other.

Engine seams, port against port, bit for bit: an engine with the
resilience machinery on but nothing armed serves what the stock engine
serves; a poisoned request self-heals to exactly the clean powerful-path
sample, and the poison write touches no other request's row; a transient
allocation failure changes nothing. The self-healed sample also holds
within 1e-4 of the reference engine's (the reference's draws handed
over). Parking after the retry budget, and detection through the finite
tap at another request's completion wait, before the poisoned request's
own last step.

The chaos harness at the reference's test sizes: the recovery ledger
(escalated, moved, deaths, fault counters) equals the reference's for the
same fault plan, every escalation equals its powerful-path reference bit
for bit, a rehearsal and a measured run agree bit for bit and the second
builds no runner; the journal replay is exactly-once within 1e-4. The
default chaos plan (4 replicas, 32 requests) runs on the port too.
"""
import dataclasses
import importlib
import math
import random

import jax
import numpy as np
import pytest
import torch
from torch_threads import one_torch_thread  # noqa: F401

import repro.resilience.faults as jfaults
import repro.resilience.journal as jjournal
from repro.cache.policy import CacheSpec as JCacheSpec
from repro.core.scheduler import FlexiSchedule as JSchedule
from repro.diffusion import schedule as jschedule
from repro.pipeline import FlexiPipeline as JPipeline
from repro.pipeline import SamplingPlan as JPlan
from repro.resilience import chaos as jchaos
from repro.serving import ServingEngine as JEngine
from repro_torch import convert
from repro_torch.core.scheduler import FlexiSchedule
from repro_torch.diffusion import schedule as tschedule
from repro_torch.pipeline import FlexiPipeline, SamplingPlan
from repro_torch.resilience import chaos as tchaos
from repro_torch.resilience import faults as tfaults
from repro_torch.resilience import journal as tjournal
from repro_torch.serving import CacheSpec, ServingEngine
from repro_torch.telemetry import Telemetry

jflex = importlib.import_module("repro.core.flexify")

T = 6
E2E_TOL = dict(atol=1e-4, rtol=1e-4)


def to_torch(tree):
    return convert.params_from_numpy(jax.tree.map(np.asarray, tree),
                                     device="cpu")


@pytest.fixture(scope="module")
def flexi(tiny_dit_cfg, trained_like_dit):
    return jflex.flexify(trained_like_dit, tiny_dit_cfg, [(1, 4, 4)])


@pytest.fixture(scope="module")
def pipes(flexi):
    fp, fcfg = flexi
    return (JPipeline(fp, fcfg, jschedule.linear_schedule(100)),
            FlexiPipeline(to_torch(fp), fcfg, tschedule.linear_schedule(100),
                          device="cpu"))


def make_plans(port=True):
    Plan, Sched = (SamplingPlan, FlexiSchedule) if port else (JPlan, JSchedule)
    return {0.6: Plan(T=T, budget=Sched.weak_first(T, 3), solver="ddim",
                      guidance_scale=1.5),
            1.0: Plan(T=T, budget=1.0, solver="ddim", guidance_scale=1.5)}


def fresh(pipe):
    """A pipeline sharing ``pipe``'s weights with an empty runner cache,
    so two engines compared bit for bit plan from the same warm set."""
    return FlexiPipeline(pipe.params, pipe.cfg, pipe.sched, device="cpu")


def make_engine(pipe, **kw):
    kw.setdefault("max_tokens_per_step", 256)
    kw.setdefault("steps_per_dispatch", 2)
    return ServingEngine(fresh(pipe), make_plans(), **kw)


def armed(plan=None):
    inj = tfaults.FaultInjector(plan if plan is not None
                                else tfaults.FaultPlan())
    return inj, inj.for_replica(0)


# ---------------------------------------------------------------------------
# Fault injector: the same event sequences, the same answers


def drive_injector(mod, seed: int) -> list:
    rng = random.Random(seed)
    plan = mod.FaultPlan(seed=seed)
    for _ in range(12):
        kind = rng.choice(mod.FAULT_KINDS)
        plan.add(round(rng.uniform(0, 1), 3), kind, replica=rng.randrange(3),
                 rid=rng.randrange(8), duration=rng.choice([0.1, 0.5]),
                 delay=rng.choice([0.05, 0.2]), factor=2.5,
                 count=rng.randrange(1, 3))
    inj = mod.FaultInjector(plan)
    out, now = [len(plan)], 0.0
    for _ in range(120):
        now += rng.uniform(0.0, 0.05)
        rep = rng.randrange(3)
        op = rng.choice(["due", "due", "window", "beat", "poison", "alloc",
                         "rng"])
        if op == "due":
            evs = inj.due(now)
            out.append([dataclasses.astuple(e) for e in evs])
            for e in evs:
                if rng.random() < 0.3:
                    inj.defer(e)
        elif op == "window":
            w = rng.choice(["slow", "delay", "part"])
            until = now + rng.uniform(0, 0.3)
            if w == "slow":
                inj.slow(rep, until, rng.choice([2.0, 3.0]))
            elif w == "delay":
                inj.delay_beats(rep, until, rng.uniform(0, 0.2))
            else:
                inj.partition(rep, until)
            out.append(inj.slowdown_factor(rep, now))
        elif op == "beat":
            out.append(inj.route_beat(rep, now))
            out.append(inj.due_beats(now))
        elif op == "poison":
            eid = rng.randrange(5)
            if rng.random() < 0.5:
                inj.add_poison(rep, eid)
            out.append((inj.take_poison(rep, eid),
                        inj.is_poison_target(rep, eid)))
        elif op == "alloc":
            if rng.random() < 0.4:
                inj.add_alloc_failures(rep, rng.randrange(1, 3))
            rf = inj.for_replica(rep)
            out.append((rf.rid, rf.take_alloc_failure(),
                        rf.slowdown_factor(now)))
            inj.note_corruption()
        else:
            out.append(inj.rng.randrange(1000))
        out.append((inj.exhausted(), inj.summary()))
    return out


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_fault_injector_matches_reference_on_event_sequences(seed):
    assert drive_injector(tfaults, seed) == drive_injector(jfaults, seed)
    assert tfaults.FAULT_KINDS == jfaults.FAULT_KINDS
    with pytest.raises(ValueError, match="unknown fault kind"):
        tfaults.FaultEvent(at=0.0, kind="meteor")


# ---------------------------------------------------------------------------
# Journal: same records, same bytes, readable across packages


def _journal_script(j):
    j.admit(0, cond=3, budget=1.0, deadline=math.inf, time=0.0)
    j.admit(1, cond=4, budget=0.6, deadline=math.inf, time=0.1)
    j.admit(2, cond=5, budget=0.6, deadline=1.0, time=0.2)
    j.dispatch(0, replica=0, time=0.3)
    j.dispatch(1, replica=1, time=0.3)
    j.escalate(1, time=0.35, retries=1)
    j.dispatch(1, replica=0, time=0.4)
    j.admit(1, cond=4, budget=0.6, deadline=math.inf, time=0.45)
    j.finish(0, replica=0, time=0.5)
    j.expire(2, time=1.2)
    j.admit(3, cond=9, budget=0.8, deadline=2.5, time=1.3)
    j.close()
    return j


@pytest.mark.parametrize("writer,reader", [(tjournal, jjournal),
                                           (jjournal, tjournal)])
def test_journal_bytes_and_records_cross_packages(tmp_path, writer, reader):
    ours = _journal_script(tjournal.RequestJournal(str(tmp_path / "t.jsonl")))
    ref = _journal_script(jjournal.RequestJournal(str(tmp_path / "j.jsonl")))
    assert (tmp_path / "t.jsonl").read_bytes() \
        == (tmp_path / "j.jsonl").read_bytes()
    assert ours.records == ref.records
    path = str(tmp_path / ("t.jsonl" if writer is tjournal else "j.jsonl"))
    back = reader.RequestJournal.load(path)
    want = jjournal.RequestJournal.load(str(tmp_path / "j.jsonl"))
    assert back.records == want.records
    assert [int(r["rid"]) for r in back.unfinished()] == [1, 3]
    assert back.unfinished() == want.unfinished()
    assert back.summary() == want.summary() == {
        "admit": 5, "dispatch": 3, "escalate": 1, "finish": 1, "expire": 1,
        "unfinished": 2}
    mem = _journal_script(tjournal.RequestJournal())
    assert mem.records == ref.records and mem.path is None


# ---------------------------------------------------------------------------
# Engine seams


@pytest.mark.parametrize("kw", [
    {"quarantine": True, "cache_integrity": True},
    {"faults": "armed"},
    {"faults": "armed", "telemetry": "taps"}])
def test_disarmed_or_idle_seams_serve_bit_for_bit(pipes, kw):
    """The resilience machinery on, or a fault facade armed with an empty
    plan: the latents equal the stock engine's bit for bit."""
    pipe = pipes[1]
    outs = []
    for extra in ({}, kw):
        extra = dict(extra)
        if extra.get("faults") == "armed":
            extra["faults"] = armed()[1]
        if extra.get("telemetry") == "taps":
            extra["telemetry"] = Telemetry(taps=True)
        eng = make_engine(pipe, cache=CacheSpec(policy="interval",
                                                interval=1, split=1), **extra)
        for i, b in enumerate((1.0, 0.6, 0.6)):
            eng.submit(3 + i, b, seed=11 + i)
        outs.append({r.request.id: r.x0 for r in eng.run()})
        assert eng.metrics.total_quarantined == 0
        assert eng.take_quarantined() == []
    assert sorted(outs[0]) == sorted(outs[1])
    assert all(torch.equal(outs[0][i], outs[1][i]) for i in outs[0])


def test_poison_writes_only_its_own_row(pipes):
    """The poison seam overwrites the target's row of the packed output
    and nothing else: after one dispatch every other request's latent
    equals the clean engine's bit for bit. (On the next forward the NaN
    row reaches requests sharing its packed rows through attention's
    0 x NaN, as in the reference; those are quarantined in turn.)"""
    pipe = pipes[1]
    lat = []
    for poison in (True, False):
        inj, rf = armed()
        if poison:
            inj.add_poison(0, 1)
        eng = make_engine(pipe, faults=rf)
        for i, b in enumerate((0.6, 0.6, 1.0, 0.6)):
            eng.submit(4 + i, b, seed=3 + i)
        eng.step()
        lat.append({f.req.id: f.x.clone() for f in eng._inflight})
        assert eng.metrics.total_poisoned == int(poison)
    assert sorted(lat[0]) == sorted(lat[1]) == [0, 1, 2, 3]
    assert torch.isnan(lat[0][1]).all()
    assert all(torch.equal(lat[0][i], lat[1][i]) for i in (0, 2, 3))


def test_self_heal_equals_the_powerful_path(pipes, flexi):
    """A poisoned request self-heals at the most powerful level to exactly
    the clean powerful-path sample (port against port), and within 1e-4
    of the reference engine's self-heal, its draws handed over."""
    pipe = pipes[1]
    inj, rf = armed()
    inj.add_poison(0, 0)                          # the first engine id
    eng = make_engine(pipe, faults=rf)
    eng.submit(4, 0.6, seed=3)
    (res,) = eng.run()
    assert eng.metrics.total_poisoned == 1
    assert eng.metrics.total_quarantined == 1
    assert res.budget_served == 1.0               # escalated weak→powerful
    assert torch.isfinite(res.x0).all()
    assert eng.metrics.summary()["quarantined"] == 1.0
    clean = make_engine(pipe)
    clean.submit(4, 1.0, seed=3)
    (ref,) = clean.run()
    assert torch.equal(res.x0, ref.x0)

    jpipe, fcfg = pipes[0], flexi[1]
    jinj = jfaults.FaultInjector(jfaults.FaultPlan())
    jinj.add_poison(0, 0)
    jeng = JEngine(jpipe, make_plans(port=False), max_tokens_per_step=256,
                   steps_per_dispatch=2, faults=jinj.for_replica(0))
    key = jax.random.PRNGKey(21)
    jeng.submit(4, 0.6, key=key)
    (jres,) = jeng.run()
    x_T = torch.from_numpy(np.array(jax.random.normal(
        key, (1,) + tuple(fcfg.dit.latent_shape))))
    inj, rf = armed()
    inj.add_poison(0, 0)
    teng = make_engine(pipe, faults=rf)
    teng.submit(4, 0.6, x_T=x_T)
    (tres,) = teng.run()
    assert tres.budget_served == jres.budget_served == 1.0
    torch.testing.assert_close(tres.x0, torch.from_numpy(np.array(jres.x0)),
                               **E2E_TOL)


def test_quarantine_parks_after_the_retry_budget(pipes):
    inj, rf = armed()
    eng = make_engine(pipes[1], faults=rf, max_retries=0)
    rid = eng.submit(2, 0.6)
    inj.add_poison(0, rid)
    assert eng.run() == []
    assert [r.id for r in eng.take_quarantined()] == [rid]
    assert eng.take_quarantined() == []
    # fleet mode: parked at once, whatever the budget
    inj, rf = armed()
    eng = make_engine(pipes[1], faults=rf, self_heal=False, max_retries=5)
    rid = eng.submit(2, 1.0)
    inj.add_poison(0, rid)
    assert eng.run() == [] and [r.id for r in eng.take_quarantined()] == [rid]


def test_finite_tap_detects_midflight(pipes):
    """With taps on, the finite tap flags the poisoned request at another
    request's completion wait, before its own last step; without taps the
    retire-time check catches it. Both recover to a finite sample."""
    for taps in (True, False):
        inj, rf = armed()
        tel = Telemetry(taps=True) if taps else None
        eng = make_engine(pipes[1], faults=rf, telemetry=tel,
                          steps_per_dispatch=1)
        eng.submit(5, 1.0)                        # finishes first
        for _ in range(3):
            eng.step()
        rid = eng.submit(1, 0.6)
        inj.add_poison(0, rid)
        results = eng.run()
        assert eng.metrics.total_quarantined == 1
        (res,) = [r for r in results if r.request.id == rid]
        assert torch.isfinite(res.x0).all() and res.budget_served == 1.0
        if taps:
            (q,) = tel.recorder.by_name("quarantine")
            assert q.args["step"] < T             # caught mid-flight


def test_transient_alloc_failure_changes_nothing(pipes):
    cache = CacheSpec(policy="interval", interval=1, split=1)
    inj, rf = armed()
    inj.add_alloc_failures(0, 2)
    eng = make_engine(pipes[1], faults=rf, cache=cache)
    eng.submit(2, 0.6, seed=7)
    eng.submit(3, 1.0, seed=8)
    got = {r.request.id: r.x0 for r in eng.run()}
    assert eng.metrics.total_alloc_failures == 2
    assert eng.store.n_active == 0
    clean = make_engine(pipes[1], cache=cache)
    clean.submit(2, 0.6, seed=7)
    clean.submit(3, 1.0, seed=8)
    ref = {r.request.id: r.x0 for r in clean.run()}
    assert all(torch.equal(got[i], ref[i]) for i in ref)


# ---------------------------------------------------------------------------
# Chaos harness and journal replay


def chaos_engine_kwargs(spec=CacheSpec):
    return {"max_tokens_per_step": 256, "steps_per_dispatch": 2,
            "cache": spec(policy="interval", interval=1, split=1)}


def small_plan(mod):
    plan = mod.FaultPlan()
    plan.add(0.001, mod.POISON, rid=1)
    plan.add(0.006, mod.CRASH, replica=1)
    plan.add(0.004, mod.SLOWDOWN, replica=0, duration=0.01, factor=2.0)
    return plan


LEDGER = ("ticks", "requests_lost", "nonfinite_outputs", "escalated_rids",
          "moved_rids", "escalations", "expirations", "deaths", "faults",
          "faults_exhausted", "recovery", "integrity_refreshes",
          "alloc_failures", "quarantined")


def test_chaos_small_fleet_matches_reference_and_replays(pipes):
    jpipe, pipe = pipes
    jres = jchaos.run_chaos(jpipe, make_plans(port=False), n_replicas=2,
                            n_requests=8, fault_plan=small_plan(jfaults),
                            engine_kwargs=chaos_engine_kwargs(JCacheSpec),
                            seed=0)
    tpipe = fresh(pipe)
    runs = []
    for _ in range(2):                            # rehearsal, measured
        built = tpipe.cache_stats()["compiled"]
        runs.append(tchaos.run_chaos(tpipe, make_plans(), n_replicas=2,
                                     n_requests=8,
                                     fault_plan=small_plan(tfaults),
                                     engine_kwargs=chaos_engine_kwargs(),
                                     seed=0))
        runs[-1]["built"] = tpipe.cache_stats()["compiled"] - built
    res = runs[1]
    for k in LEDGER:
        assert res[k] == jres[k], k
    assert res["requests_lost"] == 0 and res["nonfinite_outputs"] == 0
    assert res["faults_exhausted"] and res["deaths"] == 1
    assert len(res["escalated_rids"]) >= 1
    assert res["built"] == 0
    a, b = runs[0]["fleet"].results, res["fleet"].results
    assert sorted(a) == sorted(b)
    assert all(torch.equal(a[i].x0, b[i].x0) for i in a)
    v = tchaos.verify_escalations(tpipe, make_plans(), res,
                                  engine_kwargs=chaos_engine_kwargs())
    assert v["escalated_bitwise"] == 1 and v["escalated_max_err"] == 0.0
    assert v["moved_max_err"] <= 1e-4


def test_default_chaos_plan_on_the_port(pipes):
    """The chaos schedule the card runs (every fault kind, 4 replicas, 32
    requests): nothing lost, both scripted deaths, every escalation equal
    to its powerful-path reference bit for bit."""
    pipe = fresh(pipes[1])
    plan = tchaos.default_fault_plan()
    assert [dataclasses.astuple(e) for e in plan.events] \
        == [dataclasses.astuple(e)
            for e in jchaos.default_fault_plan().events]
    res = tchaos.run_chaos(pipe, make_plans(),
                           engine_kwargs=chaos_engine_kwargs())
    assert res["requests_lost"] == 0 and res["nonfinite_outputs"] == 0
    assert res["deaths"] == 2 and res["faults_exhausted"]
    assert res["escalated_rids"] and res["alloc_failures"] >= 1
    states = sorted(res["fleet"].membership.state(r) for r in range(4))
    assert states == ["active", "active", "dead", "dead"]
    v = tchaos.verify_escalations(pipe, make_plans(), res,
                                  engine_kwargs=chaos_engine_kwargs())
    assert v["escalated_bitwise"] == 1 and v["moved_max_err"] <= 1e-4


def test_journal_replay_exactly_once(pipes, tmp_path):
    rep = tchaos.run_replay(fresh(pipes[1]), make_plans(),
                            str(tmp_path / "j.jsonl"), n_replicas=2,
                            n_requests=6, crash_after_finished=1,
                            engine_kwargs=chaos_engine_kwargs())
    assert rep["missing"] == 0 and rep["duplicates"] == 0
    assert rep["replayed"] >= 1
    assert rep["max_readmit_err"] <= 1e-4 and rep["max_readmit_rel"] <= 1e-4
    # the port's journal file is one the reference reads back alike
    back = jjournal.RequestJournal.load(str(tmp_path / "j.jsonl"))
    assert back.summary() == rep["journal"]
