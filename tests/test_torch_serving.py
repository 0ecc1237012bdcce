"""The port's serving engine (``serving/``) and the DiT path of
``launch/serve.py``, against the JAX package and against the port's own
``FlexiPipeline.sample``.

Host arithmetic (bucket menus, count chains, the controller's pricing and
solved level) equals the reference exactly. Served latents hold at 1e-4
end to end: against the reference engine (the same requests, the prior
and DDPM noise drawn from the reference's keys and handed over; the
reference runs its dense attention path, the port the flash kernel's
plain version), and against the port's per-request ``FlexiPipeline.sample``
(packed rows with segment ids against unpacked batches). With a fake
clock, the EDF order and the degraded levels equal the reference's.
"""
import importlib
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_threads import one_torch_thread  # noqa: F401

from repro.core.scheduler import FlexiSchedule as JSchedule
from repro.diffusion import schedule as jschedule
from repro.launch import serve as jserve
from repro.pipeline import FlexiPipeline as JPipeline
from repro.pipeline import SamplingPlan as JPlan
from repro.serving import BucketMenu as JMenu
from repro.serving import BudgetController as JController
from repro.serving import ServingEngine as JEngine
from repro.serving import count_chain as j_count_chain
from repro.serving import request_cost_flops as j_cost
from repro.serving.controller import plan_mode_flops as j_mode_flops
from repro_torch import convert
from repro_torch.core.scheduler import FlexiSchedule
from repro_torch.diffusion import schedule as tschedule
from repro_torch.launch import serve as tserve
from repro_torch.pipeline import (AdaptiveBudget, FlexiPipeline, PackLayout,
                                  SamplingPlan)
from repro_torch.serving import (BucketMenu, BudgetController, Request,
                                 RequestQueue, ServingEngine, count_chain,
                                 request_cost_flops)
from repro_torch.serving.controller import plan_mode_flops

jflex = importlib.import_module("repro.core.flexify")

T = 6
E2E_TOL = dict(atol=1e-4, rtol=1e-4)


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
    fp, fcfg = jflex.flexify(trained_like_dit, tiny_dit_cfg, [(1, 4, 4)])
    return fp, fcfg


@pytest.fixture(scope="module")
def pipes(flexi):
    fp, fcfg = flexi
    return (JPipeline(fp, fcfg, jschedule.linear_schedule(100)),
            FlexiPipeline(to_torch(fp), fcfg, tschedule.linear_schedule(100),
                          device="cpu"))


def make_plans(solver="ddim", port=True, **kw):
    Plan, Sched = (SamplingPlan, FlexiSchedule) if port else (JPlan, JSchedule)
    return {0.6: Plan(T=T, budget=Sched.weak_first(T, 3), solver=solver,
                      guidance_scale=1.5, **kw),
            1.0: Plan(T=T, budget=1.0, solver=solver, guidance_scale=1.5,
                      **kw)}


def ref_inputs(key, jplan, cfg, num_steps=100):
    """The prior and the per-step DDPM noise the reference engine draws
    from ``key`` (its ``_solver_keys`` derivation)."""
    shape = tuple(cfg.dit.latent_shape)
    x_T = np.array(jax.random.normal(key, (1,) + shape))
    run_key = jax.random.fold_in(key, 1)
    ts = jschedule.respaced_timesteps(num_steps, jplan.T)
    noise, i = [], 0
    for _m, tsub in jplan.resolve_schedule(cfg).split_timesteps(ts):
        if not len(tsub):
            continue
        for k in jax.random.split(jax.random.fold_in(run_key, i), len(tsub)):
            noise.append(np.asarray(jax.random.normal(k, shape, jnp.float32)))
        i += 1
    return torch.from_numpy(x_T), torch.from_numpy(np.stack(noise)[:, None])


# ---------------------------------------------------------------------------
# Host-only: menus, chains, queue, controller (exact)


@pytest.mark.parametrize("n", [0, 1, 2, 6, 16, 31, 100])
def test_count_chain_matches_reference(n):
    assert count_chain(n) == j_count_chain(n)


@pytest.mark.parametrize("max_tokens,guided", [(128, True), (256, True),
                                               (512, False), (1024, True)])
def test_bucket_menu_matches_reference(flexi, max_tokens, guided):
    _, fcfg = flexi
    tm = BucketMenu(fcfg, (0, 1), max_tokens, guided=guided)
    jm = JMenu(fcfg, (0, 1), max_tokens, guided=guided)
    assert [l.groups for l in tm.layouts] == [l.groups for l in jm.layouts]
    assert tm.chains == jm.chains and tm.max_requests == jm.max_requests
    assert tm.describe() == jm.describe()
    for demand in [{0: 5}, {0: 1, 1: 2}, {1: 1}, {1: 9}, {0: 2, 1: 7}, {},
                   {0: 0, 1: 3}]:
        tl, jl = tm.choose(demand), jm.choose(demand)
        assert (tl.groups if tl else None) == (jl.groups if jl else None)
        if tl is not None:
            assert tm.packed_tokens(tl) == jm.packed_tokens(jl)
            assert tm.served_by(tl, demand) == jm.served_by(jl, demand)
    for order in [[0, 1, 1, 0, 1], [1] * 9, [0] * 5, [1, 0, 1, 0, 1, 1]]:
        assert tm.greedy_fit(order) == jm.greedy_fit(order)
    with pytest.raises(ValueError, match="not in the bucket menu"):
        tm.choose({3: 1})
    with pytest.raises(ValueError, match="below one row"):
        BucketMenu(fcfg, (0, 1), max_tokens_per_step=32, guided=True)


def test_request_queue_policies():
    q = RequestQueue()
    q.submit(Request(id=0, cond=0, budget=1.0, deadline=5.0), now=0.0)
    q.submit(Request(id=1, cond=0, budget=1.0, deadline=1.0), now=0.1)
    q.submit(Request(id=2, cond=0, budget=1.0, deadline=3.0), now=0.2)
    assert q.peek_deadlines() == [1.0, 3.0, 5.0]
    assert q.pop("fifo").id == 0
    assert q.pop("edf").id == 1
    assert [r.id for r in q.take_expired(4.0)] == [2]
    with pytest.raises(IndexError):
        q.pop("fifo")
    q.submit(Request(id=3, cond=0, budget=1.0), now=0.3)
    with pytest.raises(ValueError, match="policy"):
        q.pop("sjf")


@pytest.mark.parametrize("backend", ["auto", "dense"])
def test_pricing_matches_reference(flexi, backend):
    _, fcfg = flexi
    tp, jp = (make_plans(attn_backend=backend),
              make_plans(port=False, attn_backend=backend))
    for b in tp:
        for n_train in (100, 1000):
            assert request_cost_flops(fcfg, tp[b], num_train_steps=n_train) \
                == j_cost(fcfg, jp[b], num_train_steps=n_train)
            assert plan_mode_flops(fcfg, tp[b], num_train_steps=n_train) \
                == j_mode_flops(fcfg, jp[b], num_train_steps=n_train)
    # sequence-parallel pricing adds the partition's padding FLOPs
    for sp in (2, 3, 8):
        for b in tp:
            assert request_cost_flops(fcfg, tp[b], sp=sp) \
                == j_cost(fcfg, jp[b], sp=sp)


def test_controller_solved_levels_match_reference(flexi):
    """The same observations (service capacity, arrivals, calibration)
    fed to both controllers: the same level after each one."""
    _, fcfg = flexi
    ctls = (BudgetController(fcfg, make_plans(), target_util=0.9, alpha=0.5),
            JController(fcfg, make_plans(port=False), target_util=0.9,
                        alpha=0.5))
    f_hi = j_cost(fcfg, make_plans(port=False)[1.0])
    events = [("service", 2 * f_hi, 1.0), ("arrival", 0.0), ("arrival", 1.0),
              ("arrival", 1.25), ("arrival", 1.5), ("arrival", 1.75),
              ("service", 8 * f_hi, 1.0), ("arrival", 2.0),
              ("arrival", 60.0), ("calib", 0, f_hi, 0.2), ("arrival", 60.1),
              ("calib", None, f_hi, 0.05), ("arrival", 60.2)]
    for ev in events:
        for ctl in ctls:
            if ev[0] == "service":
                ctl.observe_service(flops=ev[1], dt=ev[2])
            elif ev[0] == "arrival":
                ctl.observe_arrival(ev[1])
            else:
                ctl.observe_calibration(ev[1], ev[2], ev[3])
        t, j = ctls
        assert (t.solve(), t.solve_analytic(), t.assign(1.0), t.assign(0.6)) \
            == (j.solve(), j.solve_analytic(), j.assign(1.0), j.assign(0.6))
        assert t.arrival_rate == j.arrival_rate
        assert t.calibration == j.calibration


# ---------------------------------------------------------------------------
# The engine against the port's pipeline and against the reference engine


def _reference(pipe, plans, level, label, seed):
    return pipe.sample(plans[level], 1, torch.Generator().manual_seed(seed),
                       cond=torch.tensor([label])).x0[0]


@pytest.mark.parametrize("solver", ["ddim", "ddpm"])
def test_engine_matches_per_request_sampling(pipes, solver):
    """A packed mixed-budget engine step (requests at different denoise
    steps, budgets and modes in ONE forward) reproduces each request's
    standalone FlexiPipeline.sample at 1e-4, with a late join and early
    leaves, and replaying the same workload builds nothing."""
    _, pipe = pipes
    plans = make_plans(solver)
    clk = FakeClock()
    eng = ServingEngine(pipe, plans, max_tokens_per_step=256, clock=clk)
    spec = [(0, 0.6, 3), (1, 1.0, 7), (2, 0.6, 5)]
    for rid, lvl, label in spec:
        eng.submit(cond=label, budget=lvl)
        clk.advance(0.01)
    results = []
    for _ in range(2):
        results += eng.step()
        clk.advance(0.01)
    late = eng.submit(cond=9, budget=1.0)
    spec.append((late, 1.0, 9))
    results += eng.run()
    order = [r.request.id for r in results]
    assert sorted(order) == [0, 1, 2, late]
    assert order.index(late) == len(order) - 1      # the others left first
    for r in results:
        _, lvl, label = next(s for s in spec if s[0] == r.request.id)
        ref = _reference(pipe, plans, lvl, label,
                         eng.request_seed(r.request.id))
        np.testing.assert_allclose(r.x0.numpy(), ref.numpy(), **E2E_TOL)
    warm = eng.cache_stats()
    for _rid, lvl, label in spec[:3]:
        eng.submit(cond=label, budget=lvl)
        clk.advance(0.01)
    for _ in range(2):
        eng.step()
        clk.advance(0.01)
    eng.submit(cond=9, budget=1.0)
    eng.run()
    after = eng.cache_stats()
    assert after["compiled"] == warm["compiled"]
    assert after["misses"] == warm["misses"]
    assert eng.metrics.summary()["served"] == 8.0
    assert math.isfinite(eng.metrics.latency_percentiles()["p99"])
    assert eng.block_passes == eng.packed_forwards * pipe.cfg.num_layers


@pytest.mark.parametrize("solver", ["ddim", "ddpm"])
def test_engine_matches_reference_engine(flexi, pipes, solver):
    """The same workload through both engines (late join, early leaves):
    x0 at 1e-4, the same finish order, and the same serving ledger."""
    _, fcfg = flexi
    jpipe, pipe = pipes
    jplans = make_plans(solver, port=False)
    clocks = FakeClock(), FakeClock()
    jeng = JEngine(jpipe, make_plans(solver, port=False, attn_backend="dense"),
                   max_tokens_per_step=256, clock=clocks[0])
    teng = ServingEngine(pipe, make_plans(solver), max_tokens_per_step=256,
                         clock=clocks[1])
    spec = [(3, 0.6, 40), (7, 1.0, 41), (5, 0.6, 42), (9, 1.0, 99)]

    def submit(label, lvl, s):
        key = jax.random.PRNGKey(s)
        jeng.submit(cond=label, budget=lvl, key=key)
        x_T, noise = ref_inputs(key, jplans[lvl], fcfg)
        teng.submit(cond=label, budget=lvl, x_T=x_T,
                    noise=noise if solver == "ddpm" else None)
        for c in clocks:
            c.advance(0.01)

    for s in spec[:3]:
        submit(*s)
    out = {"j": [], "t": []}
    for _ in range(2):
        out["j"] += jeng.step()
        out["t"] += teng.step()
        for c in clocks:
            c.advance(0.01)
    submit(*spec[3])
    out["j"] += jeng.run()
    out["t"] += teng.run()
    assert [r.request.id for r in out["t"]] == [r.request.id for r in out["j"]]
    for g, w in zip(out["t"], out["j"]):
        np.testing.assert_allclose(g.x0.numpy(), np.asarray(w.x0), **E2E_TOL)
        assert g.budget_served == w.budget_served
        assert g.record.latency == w.record.latency
    ts, js = teng.metrics.summary(), jeng.metrics.summary()
    for key in ("served", "steps", "tokens", "packing_efficiency", "flops",
                "p50", "p99"):
        assert ts[key] == js[key], key


def test_edf_order_matches_reference(pipes):
    """With room for one full request per step, EDF serves the later
    arrival with the earlier deadline first; FIFO does not: the same
    order as the reference's engine."""
    jpipe, pipe = pipes
    for policy in ("fifo", "edf"):
        orders = []
        for Engine, p, plans in [
                (JEngine, jpipe, {1.0: JPlan(T=T, budget=1.0,
                                             attn_backend="dense")}),
                (ServingEngine, pipe, {1.0: SamplingPlan(T=T, budget=1.0)})]:
            clk = FakeClock()
            eng = Engine(p, plans, max_tokens_per_step=128, policy=policy,
                         clock=clk)
            eng.submit(cond=1, budget=1.0, deadline=100.0)
            clk.advance(0.01)
            eng.submit(cond=2, budget=1.0, deadline=1.0)
            results = []
            while not eng.idle:
                results += eng.step()
                clk.advance(0.01)
            orders.append([r.request.id for r in results])
        assert orders[0] == orders[1]
        assert orders[1] == ([0, 1] if policy == "fifo" else [1, 0])


def test_degrade_levels_match_reference(flexi, pipes):
    """Under load the controller demotes queued requests, and recovers when
    the load drops: the same levels as the reference's engine."""
    _, fcfg = flexi
    jpipe, pipe = pipes
    levels = []
    for Engine, p, Ctl, plans in [
            (JEngine, jpipe, JController,
             make_plans(port=False, attn_backend="dense")),
            (ServingEngine, pipe, BudgetController, make_plans())]:
        ctl = Ctl(fcfg, plans, target_util=1.0, alpha=1.0)
        clk = FakeClock()
        eng = Engine(p, plans, max_tokens_per_step=256, policy="degrade",
                     clock=clk, controller=ctl)
        ctl.observe_service(flops=2 * j_cost(fcfg, make_plans(
            port=False)[1.0]), dt=1.0)
        for i in range(8):
            eng.submit(cond=i % 10, budget=1.0)
            clk.advance(0.125)
        served = [r.budget_served for r in eng.run()]
        clk.advance(50.0)
        eng.submit(cond=3, budget=1.0)
        served += [r.budget_served for r in eng.run()]
        levels.append((served, eng.metrics.summary()["degraded"]))
    assert levels[0] == levels[1]
    assert levels[1][0][:8] == [0.6] * 8 and levels[1][0][8] == 1.0


def test_engine_drain_and_frozen_mode(pipes):
    """stop/resume admissions, extract_queued, expiry, the warm-set
    ladder, and frozen serving (``allow_cold=False``) on built layouts."""
    _, pipe = pipes
    clk = FakeClock()
    eng = ServingEngine(pipe, make_plans(), max_tokens_per_step=256,
                        clock=clk, steps_per_dispatch=4, expire_queued=True)
    n = eng.precapture_warm_set(max_per_mode=1)
    assert n > 0 and eng.precapture_warm_set(max_per_mode=1) == 0
    for layout in eng.menu.layouts:
        if all(c <= 1 for _m, c in layout.groups):
            for k in (1, 2, 4):
                assert eng._is_warm(layout, k)
    eng.stop_admissions()
    eng.submit(cond=1, budget=1.0)
    eng.submit(cond=2, budget=0.6, deadline=0.5)
    assert eng.step() == [] and eng.n_queued == 2
    queued = eng.extract_queued()
    assert [r.cond for r in queued] == [1, 2] and eng.idle
    eng.resume_admissions()
    eng.submit(cond=3, budget=0.6, deadline=0.5)
    clk.advance(1.0)
    assert eng.step() == [] and [r.cond for r in eng.take_expired()] == [3]
    frozen = ServingEngine(pipe, make_plans(), max_tokens_per_step=256,
                           allow_cold=False, steps_per_dispatch=4,
                           precapture_small=1)
    built = frozen.cache_stats()["compiled"]
    for i in range(3):
        frozen.submit(cond=i, budget=(0.6, 1.0)[i % 2])
    assert len(frozen.run()) == 3
    assert frozen.cache_stats()["compiled"] == built
    snap = frozen.snapshot_state()
    assert snap["queued"] == [] and snap["inflight"] == []


def test_engine_validation_and_later_slice_seams(pipes):
    _, pipe = pipes
    with pytest.raises(ValueError, match="non-empty"):
        ServingEngine(pipe, {})
    with pytest.raises(ValueError, match="adaptive"):
        ServingEngine(pipe, {1.0: SamplingPlan(T=T, budget=AdaptiveBudget())})
    with pytest.raises(ValueError, match="share solver"):
        ServingEngine(pipe, {0.6: SamplingPlan(T=T, budget=0.6,
                                               solver="ddim"),
                             1.0: SamplingPlan(T=T, budget=1.0,
                                               solver="ddpm")})
    with pytest.raises(ValueError, match="weak_cond"):
        ServingEngine(pipe, {0.6: SamplingPlan(
            T=T, budget=0.6, guidance_kind="weak_cond")})
    with pytest.raises(ValueError, match="policy"):
        ServingEngine(pipe, make_plans(), policy="sjf")
    # telemetry= and taps=True are ported (tests/test_torch_telemetry.py),
    # faults= and quarantine= too (tests/test_torch_resilience.py):
    # quarantine is on when armed unless turned off
    from repro_torch.resilience import FaultInjector, FaultPlan
    faults = FaultInjector(FaultPlan()).for_replica(0)
    for kw, on in [(dict(faults=faults), True), (dict(quarantine=True), True),
                   (dict(faults=faults, quarantine=False), False), ({}, False)]:
        assert ServingEngine(pipe, make_plans(), **kw)._quarantine is on
    eng = ServingEngine(pipe, make_plans(), max_tokens_per_step=256)
    assert [eng.quantize(b) for b in (0.3, 0.6, 0.7, 1.0)] \
        == [0.6, 0.6, 1.0, 1.0]


def test_warm_packed_layouts_match_the_step_family(flexi):
    """Packed runners are keyed by one named tuple: the warm set of a step
    family lists its layouts by depth and nothing of another family."""
    fp, fcfg = flexi
    pipe = FlexiPipeline(to_torch(fp), fcfg, tschedule.linear_schedule(100),
                         device="cpu")
    a, b = PackLayout.for_counts({0: 1}), PackLayout.for_counts({0: 1, 1: 2})
    pipe.packed_step(a, k_steps=1)
    pipe.packed_step(b, k_steps=3)
    pipe.packed_step(a, k_steps=1, solver="ddpm")
    pipe.packed_step(b, k_steps=1, cache_split=1)
    assert pipe.cache_stats()["compiled"] == 4
    assert pipe.warm_packed_layouts() == {1: [a], 3: [b]}
    assert pipe.warm_packed_layouts(solver="ddpm") == {1: [a]}
    assert pipe.warm_packed_layouts(cache_split=1) == {1: [b]}
    assert pipe.warm_packed_layouts(guidance_scale=2.0) == {}
    assert pipe.packed_step_is_warm(b, k_steps=3)
    assert not pipe.packed_step_is_warm(b, k_steps=3, solver="ddpm")
    pipe.packed_step(a, k_steps=1)
    assert pipe.cache_stats()["compiled"] == 4


def test_packlayout_validation():
    with pytest.raises(ValueError, match="at least one"):
        PackLayout(groups=())
    with pytest.raises(ValueError, match="mode-sorted"):
        PackLayout(groups=((1, 2), (0, 1)))
    with pytest.raises(ValueError, match="counts"):
        PackLayout(groups=((0, 0),))
    layout = PackLayout.for_counts({1: 2, 0: 1})
    assert layout.groups == ((0, 1), (1, 2))
    assert layout.n_requests == 3
    assert layout.segment_modes() == (0, 0, 1, 1, 1, 1)


# ---------------------------------------------------------------------------
# launch/serve.py


@pytest.mark.parametrize("arg,base", [(None, 0.6), ("0.4,0.6,1.0", 0.5),
                                      ("1.0, 0.333,", 0.6), ("0.604,0.6", 0.6)])
def test_parse_budget_levels_matches_reference(arg, base):
    assert tserve.parse_budget_levels(arg, base) \
        == jserve.parse_budget_levels(arg, base)
    for bad in ("x", ",", "1.5"):
        with pytest.raises(SystemExit):
            tserve.parse_budget_levels(bad, base)


@pytest.mark.parametrize("extra", [[], ["--cache-policy", "interval",
                                        "--solver", "ddpm"]])
def test_serve_cli_smoke_on_cpu(capsys, extra):
    m = tserve.main(["--arch", "dit-xl-2", "--smoke", "--requests", "3",
                     "--T", "4", "--device", "cpu"] + extra)
    out = capsys.readouterr().out
    assert m["served"] == 6.0 and "served 6 requests" in out
    assert 0.0 < m["packing_efficiency"] <= 1.0
    if extra:
        assert "[act-cache]" in out and m["cache_hit_rate"] > 0.0


@pytest.mark.parametrize("flags,owner", [
    (["--replicas", "2", "--mesh", "2x1"], "distributed"),
    (["--mesh", "1x2", "--replicas", "3"], "distributed"),
    (["--arch", "mamba2-130m", "--replicas", "2"], "language-model")])
def test_serve_cli_later_slices_raise(flags, owner):
    with pytest.raises(NotImplementedError, match=owner):
        tserve.main(["--arch", "dit-xl-2", "--smoke", "--device", "cpu"]
                    + flags)


def test_serve_needs_cuda_unless_cpu_is_asked():
    if torch.cuda.is_available():
        pytest.skip("CUDA is present here; the check is for machines without it")
    with pytest.raises(RuntimeError, match="CUDA"):
        tserve.main(["--arch", "dit-xl-2", "--smoke", "--requests", "1"])
