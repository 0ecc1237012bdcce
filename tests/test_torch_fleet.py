"""The port's fleet (``repro_torch.fleet``) against the JAX package's.

The control plane is host arithmetic: fed the same event sequences, the
port's router, membership, health and ``partition_devices`` give exactly
what the reference gives (random sequences from fixed seeds, every return
value and every refusal compared). The control modules import neither
torch nor numpy (an AST check, standing in for the reference's lint rule).

The data plane runs on the same injected clock in both packages, the
reference's draws handed to the port's requests (``x_T`` from the key the
reference fleet derives for each fleet id): the placement sequence and
the fleet's summary (virtual makespan, router, membership and straggler
ledgers) equal the reference's, every x0 holds within 1e-4 of the
reference's (the reference runs its dense attention, the port the flash
kernel's plain version), and each scenario — drain, kill mid-flight, hang
by heartbeat timeout, straggler down-weighting, hedging, join — also
passes the reference's own assertions on the port. Reference fleets are
built once per module.
"""
import ast
import dataclasses
import importlib
import math
import random
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from torch_threads import one_torch_thread  # noqa: F401

import repro.fleet as jfleet
import repro.fleet.health as jhealth
import repro.fleet.membership as jmembership
import repro.fleet.router as jrouter
from repro.core.scheduler import FlexiSchedule as JSchedule
from repro.diffusion import schedule as jschedule
from repro.pipeline import FlexiPipeline as JPipeline
from repro.pipeline import SamplingPlan as JPlan
from repro_torch import convert
from repro_torch import fleet as tfleet
from repro_torch.core.scheduler import FlexiSchedule
from repro_torch.diffusion import schedule as tschedule
from repro_torch.fleet import health as thealth
from repro_torch.fleet import membership as tmembership
from repro_torch.fleet import router as trouter
from repro_torch.launch import serve as tserve
from repro_torch.pipeline import FlexiPipeline, SamplingPlan

jflex = importlib.import_module("repro.core.flexify")

T = 6
E2E_TOL = dict(atol=1e-4, rtol=1e-4)
SRC = Path(__file__).resolve().parents[1] / "src" / "repro_torch"
HOST_PURE = ["fleet/router.py", "fleet/health.py", "fleet/membership.py",
             "resilience/faults.py", "resilience/journal.py"]


class FakeClock:
    def __init__(self, t: float = 0.0):
        self.t = t

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> float:
        self.t += dt
        return self.t


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


# ---------------------------------------------------------------------------
# Host-pure control plane: the same event sequences, the same answers


def test_control_modules_import_neither_torch_nor_numpy():
    for rel in HOST_PURE:
        tree = ast.parse((SRC / rel).read_text())
        roots = set()
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                roots |= {a.name.split(".")[0] for a in node.names}
            elif isinstance(node, ast.ImportFrom) and node.module:
                roots.add(node.module.split(".")[0])
        assert not roots & {"torch", "numpy", "jax", "repro"}, (rel, roots)


def _call(out, fn, *a, **kw):
    """Record ``fn``'s result, or the refusal it raised."""
    try:
        out.append(fn(*a, **kw))
    except (RuntimeError, ValueError) as e:
        out.append(("raised", type(e).__name__, str(e)))


def drive_router(mod, policy: str, seed: int) -> list:
    rng = random.Random(seed)
    r = mod.Router(policy)
    out, now = [], 0.0
    for _ in range(160):
        now += rng.uniform(0.0, 0.05)
        reqs = list(r.requests.values())
        op = rng.choice(["register", "register", "place", "place",
                         "handback", "done", "escalate", "expire", "hedge"])
        if op == "register" or not reqs:
            dl = math.inf if rng.random() < 0.5 else now + rng.uniform(0, 1)
            out.append(r.register(rng.randrange(10), rng.choice([0.6, 1.0]),
                                  dl, None, now).rid)
            continue
        req = rng.choice(reqs)
        if op == "place":
            pend = r.pending(now if rng.random() < 0.5 else None)
            if pend:
                req = rng.choice(pend)
            views = [mod.ReplicaView(
                rid=i, admitting=rng.random() < 0.8,
                backlog_seconds=rng.uniform(0, 2),
                prices={0.6: rng.uniform(0.1, 1), 1.0: rng.uniform(0.5, 2)},
                weight=rng.choice([1.0, 1.0, 1.7, 4.0])) for i in range(3)]
            _call(out, r.place, req, views, rng.choice([0.6, 1.0]))
            out.append([v.backlog_seconds for v in views])
        elif op == "handback":
            req.dispatched = rng.random() < 0.5
            _call(out, r.handback, req, lost_state=rng.random() < 0.5)
        elif op == "done":
            _call(out, r.mark_done, req, now, rng.randrange(3))
        elif op == "escalate":
            _call(out, r.escalate, req, now=now, level=1.0,
                  max_retries=rng.choice([0, 1, 2]),
                  backoff_base=rng.choice([0.0, 0.05, 10.0]))
        elif op == "expire":
            _call(out, r.mark_expired, req, now)
        else:
            _call(out, r.mark_hedged, req, rng.randrange(3), rng.randrange(9))
        out.append(sorted(x.rid for x in r.pending(now)))
    out.append(r.summary())
    out.append([r.affinity_hit_rate(n) for n in (0, 1, 7, 100)])
    out.append([dataclasses.astuple(x) for x in r.requests.values()])
    out.append(sorted(x.rid for x in r.unfinished()))
    return out


@pytest.mark.parametrize("policy", ["cheapest", "affinity", "rr"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_router_matches_reference_on_event_sequences(policy, seed):
    ours = drive_router(trouter, policy, seed)
    assert ours == drive_router(jrouter, policy, seed)
    assert trouter.ROUTER_POLICIES == jrouter.ROUTER_POLICIES
    with pytest.raises(ValueError, match="policy"):
        trouter.Router("sjf")


def drive_membership(mod, seed: int) -> list:
    rng = random.Random(seed)
    clk = FakeClock()
    sp = rng.choice([1, 2])
    n = rng.choice([2, 3])
    m = mod.FleetMembership(n, range(n * sp), seq_parallel=sp,
                            timeout_s=1.0, clock=clk)
    out = []
    for _ in range(150):
        clk.advance(rng.uniform(0.0, 0.6))
        rid = rng.choice(sorted(m.replicas))
        op = rng.choice(["beat", "beat", "beat_at", "check", "dead",
                         "drain", "finish", "rejoin", "join"])
        if op == "beat":
            m.beat(rid)
        elif op == "beat_at":
            m.beat(rid, at=clk() - rng.uniform(-0.5, 2.0))
        elif op == "check":
            out.append(m.check())
        elif op == "dead":
            m.mark_dead(rid)
        elif op == "drain":
            _call(out, m.start_drain, rid)
        elif op == "finish":
            _call(out, m.finish_drain, rid)
        elif op == "rejoin":
            _call(out, m.rejoin, rid)
        else:
            hi = max(max(i.device_ids) for i in m.replicas.values())
            _call(out, m.join, list(range(hi + 1, hi + 1 + rng.choice(
                [sp, sp, 3]))))
        out.append([(m.state(i), m.admitting(i), m.pumpable(i),
                     m.incarnation(i)) for i in sorted(m.replicas)])
        out.append(m.alive_count)
    out.append(m.summary())
    return out


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_membership_matches_reference_on_event_sequences(seed):
    assert drive_membership(tmembership, seed) \
        == drive_membership(jmembership, seed)
    assert tmembership.REPLICA_STATES == jmembership.REPLICA_STATES


@pytest.mark.parametrize("ids,n,sp", [(range(8), 4, 2), (range(7), 2, 2),
                                      (range(4), 3, 2), (range(6), 3, 1),
                                      (range(12), 3, 4), (range(2), 2, 1)])
def test_partition_devices_matches_reference(ids, n, sp):
    got, want = [], []
    _call(got, tmembership.partition_devices, ids, n, sp)
    _call(want, jmembership.partition_devices, ids, n, sp)
    assert got == want


def test_process_group_seam_matches_reference():
    for mod in (tmembership, jmembership):
        calls = []
        g = mod.init_process_group("tcp://localhost:29500", 4, 2,
                                   initialize_fn=lambda **kw:
                                   calls.append(kw))
        assert not g.simulated and g.num_processes == 4 and g.process_id == 2
        assert calls == [{"coordinator_address": "tcp://localhost:29500",
                          "num_processes": 4, "process_id": 2}]
        assert mod.init_process_group().simulated


def drive_health(mod, seed: int) -> list:
    rng = random.Random(seed)
    n = rng.choice([2, 3, 4])
    h = mod.FleetHealth(n, max_weight=4.0)
    out = []
    for _ in range(120):
        op = rng.choice(["rec", "rec", "rec", "weights", "grow", "ewma",
                         "report", "hedge"])
        if op == "rec":
            h.record_dispatch(rng.randrange(h.detector.n),
                              rng.choice([10.0, 12.0, 16.0, 40.0, 1e6]))
        elif op == "weights":
            out.append(h.weights())
        elif op == "grow":
            h.grow(h.detector.n + rng.choice([0, 1]))
        elif op == "ewma":
            out.append([h.ewma_ms(i) for i in range(h.detector.n + 1)])
        elif op == "report":
            rep = h.report()
            out.append((rep.step, list(rep.stragglers), rep.median_ms,
                        rep.worst_ms))
        else:
            k = rng.randrange(5)
            out.append(h.hedge_candidates(
                list(range(10, 10 + k)),
                [rng.uniform(-5.0, 5.0) for _ in range(k)]))
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_health_matches_reference_on_event_sequences(seed):
    assert drive_health(thealth, seed) == drive_health(jhealth, seed)


# ---------------------------------------------------------------------------
# The fleet, end to end, against the reference's (virtual time)


def ref_x_T(rid: int, shape) -> torch.Tensor:
    """The prior the reference fleet draws for fleet id ``rid``."""
    key = jax.random.fold_in(jax.random.PRNGKey(0xf1ee), rid)
    return torch.from_numpy(np.array(jax.random.normal(key, (1,) + shape)))


class Side:
    """One package's fleet, driven by the same scenario code: the port's
    requests get the reference's prior for their fleet id."""

    def __init__(self, port: bool, pipe, cfg):
        self.port, self.pipe, self.cfg = port, pipe, cfg
        self.mod = tfleet if port else jfleet
        self.plans = make_plans(port)

    def fleet(self, n, clk, **kw):
        f = self.mod.Fleet(self.pipe, self.plans, n, clock=clk,
                           seconds_per_token=1e-4, **kw)
        f.placement_log = []
        place = f.router.place

        def logged(req, views, level):
            r = place(req, views, level)
            f.placement_log.append((req.rid, r, level))
            return r

        f.router.place = logged
        return f

    def submit(self, f, cond, budget, deadline=math.inf):
        if not self.port:
            return f.submit(cond=cond, budget=budget, deadline=deadline)
        rid = f.router._next_id
        return f.submit(cond, budget, deadline,
                        x_T=ref_x_T(rid, tuple(self.cfg.dit.latent_shape)))

    def mixed(self, f, n, deadline=math.inf):
        return [self.submit(f, i % 10, [0.6, 1.0][i % 2], deadline)
                for i in range(n)]


def _scenario_spread(s, clk):
    """Mixed traffic over 3 replicas under each policy, then a solo fleet
    (the serial makespan)."""
    out = {}
    for policy in ("cheapest", "affinity", "rr"):
        f = s.fleet(3, FakeClock(), router=policy)
        rids = s.mixed(f, 9)
        f.run()
        assert sorted(f.results) == rids
        out[policy] = f
    solo = s.fleet(1, FakeClock())
    s.mixed(solo, 9)
    solo.run()
    out["solo"] = solo
    return out


def _scenario_drain(s, clk):
    f = s.fleet(2, clk, router="cheapest",
                engine_kwargs={"max_tokens_per_step": 128, "max_inflight": 2})
    rids = s.mixed(f, 8)
    f.tick()
    f.handed = f.drain_replica(0)
    f.state_after_drain = f.membership.state(0)
    f.run()
    assert sorted(f.results) == rids
    return {"drain": f}


def _scenario_kill(s, clk):
    f = s.fleet(2, clk, router="affinity")
    rids = s.mixed(f, 8)
    f.tick()
    f.killed_inflight = f.replicas[0].engine.n_inflight
    f.n_re = f.kill_replica(0)
    f.run()
    assert sorted(f.results) == rids
    return {"kill": f}


def _scenario_hang(s, clk):
    f = s.fleet(2, clk, router="rr", heartbeat_timeout_s=5.0)
    rids = s.mixed(f, 6)
    f.tick()
    f.inject_hang(0)
    clk.advance(6.0)
    f.tick()
    f.state_after_hang = f.membership.state(0)
    f.run()
    assert sorted(f.results) == rids
    f.served_before_rejoin = {r: x.replica for r, x in f.results.items()}
    f.incarnation = f.rejoin_replica(0)
    f.more = s.mixed(f, 2)
    f.run()
    return {"hang": f}


def _scenario_straggler(s, clk):
    f = s.fleet(2, clk, router="cheapest", speed_factors={0: 4.0})
    s.mixed(f, 10)
    f.run()
    return {"straggler": f}


def _scenario_hedge(s, clk):
    f = s.fleet(2, clk, router="rr", speed_factors={0: 4.0},
                engine_kwargs={"steps_per_dispatch": 1})
    s.mixed(f, 2)
    f.run()
    f.weights_primed = f.health.weights()
    f.hedged_rid = s.submit(f, 3, 1.0, deadline=f.now + 1e-3)
    f.tick()
    f.owner_after_tick = f.router.requests[f.hedged_rid].owner
    f.run()
    return {"hedge": f}


def _scenario_join(s, clk):
    f = s.fleet(1, clk, router="cheapest")
    s.mixed(f, 4)
    f.tick()
    f.joined = f.join_replica()
    f.admitting_joined = f.membership.admitting(f.joined)
    s.mixed(f, 4)
    f.run()
    return {"join": f}


SCENARIOS = {"spread": _scenario_spread, "drain": _scenario_drain,
             "kill": _scenario_kill, "hang": _scenario_hang,
             "straggler": _scenario_straggler, "hedge": _scenario_hedge,
             "join": _scenario_join}
SUMMARY_KEYS = ("replicas", "served", "tokens", "makespan_s", "tokens_per_s",
                "request_dispatches", "affinity_hit_rate", "router",
                "membership", "straggler", "readmit", "hedge_losses",
                "escalation")


@pytest.fixture(scope="module")
def reference_runs(pipes, flexi):
    """Each scenario run once on the reference fleet (lazily)."""
    side = Side(False, pipes[0], flexi[1])
    cache = {}

    def get(name):
        if name not in cache:
            cache[name] = SCENARIOS[name](side, FakeClock())
        return cache[name]

    return get


def _same_fleet(ours, ref):
    """Placements, per-request ledger and summary equal the reference's;
    every x0 within 1e-4 of the reference's."""
    assert ours.placement_log == ref.placement_log
    for rid, jr in ref.router.requests.items():
        tr = ours.router.requests[rid]
        for field in ("state", "owner", "home", "placements", "handbacks",
                      "readmits", "hedged", "hedge_owner", "served_by",
                      "done_at", "retries", "escalated"):
            assert getattr(tr, field) == getattr(jr, field), (rid, field)
    ts, js = ours.summary(), ref.summary()
    for k in SUMMARY_KEYS:
        assert ts[k] == js[k], k
    assert sorted(ours.results) == sorted(ref.results)
    for rid, jr in ref.results.items():
        tr = ours.results[rid]
        assert (tr.replica, tr.budget_served, tr.done_at, tr.arrival) \
            == (jr.replica, jr.budget_served, jr.done_at, jr.arrival)
        torch.testing.assert_close(tr.x0, torch.from_numpy(
            np.array(jr.x0)), **E2E_TOL)


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_fleet_matches_reference(pipes, flexi, reference_runs, name):
    ours = SCENARIOS[name](Side(True, pipes[1], flexi[1]), FakeClock())
    ref = reference_runs(name)
    assert sorted(ours) == sorted(ref)
    for key in ours:
        _same_fleet(ours[key], ref[key])
    _reference_assertions(name, ours)


def _reference_assertions(name, fleets):
    """The reference's own assertions (tests/test_fleet.py) on the port."""
    if name == "spread":
        f = fleets["cheapest"]
        s = f.summary()
        assert s["served"] == 9 and s["affinity_hit_rate"] == 1.0
        assert len({r.replica for r in f.results.values()}) == 3
        assert f.makespan() < fleets["solo"].makespan()
        a = fleets["affinity"]
        assert a.router.state_readmits == 0
        assert all(r.placements == 1 for r in a.router.requests.values())
        by_cond = {}
        for rid, res in a.results.items():
            by_cond.setdefault(a.router.requests[rid].cond,
                               set()).add(res.replica)
        assert all(len(v) == 1 for v in by_cond.values())
        assert f.cache_stats()["pipes"] == 1
    elif name == "drain":
        f = fleets["drain"]
        assert f.handed > 0 and f.state_after_drain == "draining"
        assert f.membership.state(0) == "drained"
        assert f.replicas[0].engine.metrics.total_served > 0
        assert f.router.handbacks >= f.handed
    elif name == "kill":
        f = fleets["kill"]
        assert f.n_re > 0 and f.membership.state(0) == "dead"
        assert all(r.replica == 1 for r in f.results.values())
        s = f.summary()
        assert s["readmit"]["count"] == f.n_re
        assert f.router.state_readmits == f.killed_inflight
        assert s["affinity_hit_rate"] == pytest.approx(
            1.0 - f.killed_inflight / s["request_dispatches"])
    elif name == "hang":
        f = fleets["hang"]
        assert f.state_after_hang == "dead"
        assert set(f.served_before_rejoin.values()) == {1}
        assert f.incarnation == 1
        assert set(f.more) <= set(f.results)
    elif name == "straggler":
        f = fleets["straggler"]
        w = f.health.weights()
        assert w[0] > 1.15 and w[1] == 1.0
        served = {rid: sum(1 for r in f.results.values()
                           if r.replica == rid) for rid in (0, 1)}
        assert served[1] > served[0]
    elif name == "hedge":
        f = fleets["hedge"]
        assert f.weights_primed[0] > 1.5 and f.owner_after_tick == 0
        assert f.router.requests[f.hedged_rid].hedged
        assert f.router.hedges == 1
        assert sorted(f.results) == [0, 1, f.hedged_rid]
        assert f.router.hedge_wins + f._hedge_losses <= 1
    elif name == "join":
        f = fleets["join"]
        assert f.joined == 1 and f.admitting_joined
        assert len(f.results) == 8
        assert any(r.replica == f.joined for r in f.results.values())


def test_fleet_results_match_per_request_sample(pipes, flexi):
    """Every port fleet result reproduces its standalone single-request
    ``FlexiPipeline.sample`` (its seed from ``fleet.request_seed``)."""
    pipe = pipes[1]
    f = tfleet.Fleet(pipe, make_plans(), 2, router="affinity",
                     clock=FakeClock(), seconds_per_token=1e-4)
    rids = [f.submit(cond=i % 10, budget=[0.6, 1.0][i % 2])
            for i in range(6)]
    f.tick()
    f.kill_replica(0)
    f.run()
    assert sorted(f.results) == rids
    for rid, r in f.results.items():
        req = f.router.requests[rid]
        gen = torch.Generator().manual_seed(f.request_seed(rid))
        ref = pipe.sample(make_plans()[r.budget_served], 1, gen,
                          cond=torch.tensor([req.cond])).x0[0]
        torch.testing.assert_close(r.x0, ref, **E2E_TOL)


def test_warm_traffic_and_background_warmer_build_nothing_new(pipes):
    """A fresh fleet over the shared pipeline replays a workload building
    no runner; a background warmer builds the ladder while the fleet
    serves, and a second walk has nothing left to build."""
    pipe = FlexiPipeline(pipes[1].params, pipes[1].cfg, pipes[1].sched,
                         device="cpu")
    fleet = tfleet.Fleet(pipe, make_plans(), 1, clock=FakeClock(),
                         seconds_per_token=1e-4)
    eng = fleet.replicas[0].engine
    warm = tfleet.BackgroundCompiler(eng, max_per_mode=1,
                                     k_depths=(1, 2)).start()
    for i in range(4):
        fleet.submit(cond=i, budget=[0.6, 1.0][i % 2])
    fleet.run()
    assert warm.wait(timeout=600.0) and warm.done
    assert warm.assert_warm() > 0
    again = tfleet.BackgroundCompiler(eng, max_per_mode=1, k_depths=(1, 2))
    c0 = eng.cache_stats()["compiled"]
    again.start()
    assert again.wait(timeout=60.0) and again.captured == 0
    assert eng.cache_stats()["compiled"] == c0
    warm_stats = fleet.cache_stats()
    replay = tfleet.Fleet(pipe, make_plans(), 1, clock=FakeClock(),
                          seconds_per_token=1e-4)
    for i in range(4):
        replay.submit(cond=i, budget=[0.6, 1.0][i % 2])
    replay.run()
    assert replay.cache_stats()["compiled"] == warm_stats["compiled"]
    assert replay.cache_stats()["pipes"] == 1


def test_runner_cache_and_counters_hold_under_threads(pipes):
    """A warm-up thread builds and dispatches beside the serving thread:
    with more threads than cores released together onto each new key and
    a short switch interval, each runner is built once (every thread gets
    the same one, the miss count equals the distinct keys) and no dispatch
    is lost from the engine's counts."""
    import os
    import sys
    import threading

    from repro_torch.pipeline import PackLayout
    pipe = FlexiPipeline(pipes[1].params, pipes[1].cfg, pipes[1].sched,
                         device="cpu")
    eng = tfleet.Replica(0, pipe, make_plans(), clock=FakeClock()).engine
    layouts = [PackLayout.for_counts(c, guided=True)
               for c in ({0: 1}, {1: 1}, {0: 1, 1: 1})]
    n_threads, rounds = 2 * (os.cpu_count() or 4) + 1, 24
    gate = threading.Barrier(n_threads, timeout=300.0)
    got = [[None] * rounds for _ in range(n_threads)]
    errors = []

    def work(i):
        try:
            for j in range(rounds):         # a new key each round
                gate.wait()
                got[i][j] = pipe.packed_step(layouts[j % 3],
                                             k_steps=1 + j // 3)
            eng._dummy_dispatch(layouts[i % 3], 1 + i % 2, record=False)
        except Exception as e:            # surfaced below
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(i,))
                   for i in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300.0)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads) and not errors
    assert pipe.cache_stats()["misses"] == rounds
    assert all(len({id(g[j]) for g in got}) == 1 for j in range(rounds))
    assert eng.packed_forwards == sum(1 + i % 2 for i in range(n_threads))
    assert eng.block_passes == pipe.cfg.num_layers * eng.packed_forwards


def test_wall_clock_replica_measures_only_across_waits(pipes):
    """``virtual=False``: a dispatch the host does not wait on measures
    only its launch, so the replica reports seconds (and recalibrates its
    price) only on pumps where the engine waited, over the packed tokens
    dispatched since the previous wait."""

    class Ticking:                       # a wall clock that moves per read
        def __init__(self):
            self.t = 0.0

        def __call__(self):
            self.t += 1e-3
            return self.t

    rep = tfleet.Replica(0, pipes[1], make_plans(), virtual=False,
                         clock=Ticking(), seconds_per_token=1.0,
                         engine_kwargs={"steps_per_dispatch": 1})
    for i in range(3):
        rep.submit(i, [0.6, 1.0][i % 2], math.inf, {"seed": i})
    price0, seen = rep.price_seconds(1.0), []
    while rep.has_work:
        w0, tokens0 = rep.engine.waits, rep._win_tokens
        _, dt = rep.pump(0.0)
        waited = rep.engine.waits > w0
        seen.append(waited)
        assert (dt > 0) == waited
        if not waited:
            assert rep._win_tokens > tokens0 and rep.seconds_per_token == 1.0
    assert any(seen) and not all(seen)
    assert rep._win_tokens == 0 and rep.seconds_per_token < 1.0
    assert rep.price_seconds(1.0) < price0


def test_fixed_slot_engine_and_fleet(pipes):
    """The fixed-slot engine kind: per-request priors stacked, so a ddim
    batch reproduces standalone samples; its fleet surface drains."""
    pipe = pipes[1]
    plans = make_plans()
    eng = tfleet.FixedSlotEngine(pipe, plans, batch_size=4,
                                 clock=FakeClock())
    for i in range(3):
        eng.submit(cond=i, budget=1.0, seed=70 + i)
    out = eng.run()
    assert len(out) == 3 and eng.idle and eng.waits == 1
    for r in out:
        ref = pipe.sample(plans[1.0], 1,
                          torch.Generator().manual_seed(70 + r.request.id),
                          cond=torch.tensor([r.request.cond])).x0[0]
        torch.testing.assert_close(r.x0, ref, **E2E_TOL)
    eng.submit(cond=5, budget=0.6)
    eng.submit(cond=6, budget=1.0)
    eng.stop_admissions()
    assert [r.cond for r in eng.extract_queued()] == [5, 6]
    # sequence-parallel plans are taken (served on a mesh in
    # tests/test_torch_distributed.py); without a mesh sampling refuses them
    from repro_torch.pipeline import ParallelSpec
    par = tfleet.FixedSlotEngine(pipe, {1.0: dataclasses.replace(
        plans[1.0], parallel=ParallelSpec())})
    par.submit(cond=1, budget=1.0)
    with pytest.raises(ValueError, match="mesh"):
        par.step()
    f = tfleet.Fleet(pipe, plans, 2, router="rr", clock=FakeClock(),
                     engine_kind="fixed", seconds_per_token=1e-4)
    rids = [f.submit(cond=i, budget=[0.6, 1.0][i % 2]) for i in range(4)]
    f.run()
    assert sorted(f.results) == rids
    for rid, r in f.results.items():
        gen = torch.Generator().manual_seed(f.request_seed(rid))
        ref = pipe.sample(plans[r.budget_served], 1, gen,
                          cond=torch.tensor([r.cond])).x0[0]
        torch.testing.assert_close(r.x0, ref, **E2E_TOL)


def test_fleet_constructor_validation(pipes):
    with pytest.raises(ValueError, match="at least one"):
        tfleet.Fleet(pipes[1], make_plans(), 0)
    with pytest.raises(ValueError, match="policy"):
        tfleet.Fleet(pipes[1], make_plans(), 1, router="fastest")
    with pytest.raises(ValueError, match="engine kind"):
        tfleet.Fleet(pipes[1], make_plans(), 1, engine_kind="bulk")


def test_public_names_match_reference():
    assert sorted(tfleet.__all__) == sorted(jfleet.__all__)
    import repro.resilience as jres
    import repro_torch.resilience as tres
    pub = lambda m: {n for n in dir(m) if not n.startswith("_")}  # noqa: E731
    assert pub(jres) - {"annotations"} <= pub(tres)


# ---------------------------------------------------------------------------
# launch/serve.py --replicas


@pytest.mark.parametrize("router", ["cheapest", "affinity"])
def test_serve_cli_fleet_on_cpu(capsys, router):
    m = tserve.main(["--arch", "dit-xl-2", "--smoke", "--requests", "4",
                     "--T", "4", "--device", "cpu", "--replicas", "2",
                     "--router", router])
    out = capsys.readouterr().out
    assert m["served"] == 4.0 and "[fleet] served 4 requests over 2" in out
    assert f"router={router}" in out and "pipes=1" in out


def test_serve_cli_mesh_still_raises():
    with pytest.raises(NotImplementedError, match="distributed"):
        tserve.main(["--arch", "dit-xl-2", "--smoke", "--device", "cpu",
                     "--replicas", "2", "--mesh", "2x1"])
