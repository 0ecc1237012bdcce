"""The port's cross-step activation cache (``cache/``: policy, ledger,
store, apply) and the cached paths of ``FlexiPipeline`` and
``ServingEngine``, against the JAX package and against the port itself.

Refresh masks, drift and the FLOPs / bytes ledger are host arithmetic:
equal to the reference exactly. One cached step holds at float32 1e-5;
whole cached runs at 1e-4 (the reference's DDPM noise drawn from its keys
and handed over). The bitwise claims are the port's own: a cached plan at
``interval=1`` equals the uncached plan bit for bit, in the pipeline and
in the packed engine (the reference's engine-bitwise test is red, so it is
no oracle here).
"""
import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.cache import CacheSpec as JSpec
from repro.cache import CacheStore as JStore
from repro.cache import apply as japply
from repro.cache import ledger as jledger
from repro.cache import policy as jpolicy
from repro.core.guidance import GuidanceConfig as JGuidance
from repro.core.scheduler import FlexiSchedule as JSchedule
from repro.diffusion import schedule as jschedule
from repro.pipeline import FlexiPipeline as JPipeline
from repro.pipeline import SamplingPlan as JPlan
from repro.serving import BudgetController as JController
from repro.serving import ServingEngine as JEngine
from repro.serving import request_cost_flops as j_cost
from repro_torch import convert
from repro_torch.cache import (CacheSpec, CacheStore, TransientAllocationError,
                               apply as tapply, ledger as tledger,
                               policy as tpolicy)
from repro_torch.core.guidance import GuidanceConfig
from repro_torch.core.scheduler import FlexiSchedule
from repro_torch.diffusion import schedule as tschedule
from repro_torch.models import dit as tdit
from repro_torch.pipeline import AdaptiveBudget, FlexiPipeline, SamplingPlan
from repro_torch.serving import (BudgetController, ServingEngine,
                                 request_cost_flops)

jflex = importlib.import_module("repro.core.flexify")

T = 6
STEP_TOL = dict(atol=1e-5, rtol=1e-5)
E2E_TOL = dict(atol=1e-4, rtol=1e-4)
SPECS = [dict(policy="interval", interval=1), dict(policy="interval", interval=2),
         dict(policy="interval", interval=3, split=1),
         dict(policy="banded", bands=((50, 1),), interval=4),
         dict(policy="banded", bands=((700, 3), (200, 2)), interval=5),
         dict(policy="proxy", threshold=0.01), dict(policy="proxy"),
         dict(policy="proxy", threshold=0.3, split=1)]


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


def make_plans(solver="ddim", cache=None, port=True, **kw):
    Plan, Sched = (SamplingPlan, FlexiSchedule) if port else (JPlan, JSchedule)
    return {0.6: Plan(T=T, budget=Sched.weak_first(T, 3), solver=solver,
                      guidance_scale=1.5, cache=cache, **kw),
            1.0: Plan(T=T, budget=1.0, solver=solver, guidance_scale=1.5,
                      cache=cache, **kw)}


def ref_inputs(key, jplan, cfg, num_steps=100):
    """The prior and the per-step DDPM noise the reference engine (and its
    pipeline, for a batch of one) draws from ``key``."""
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
# Policies: exact


@pytest.mark.parametrize("spec", SPECS, ids=[f"s{i}" for i in range(len(SPECS))])
def test_refresh_masks_match_reference(spec):
    t_spec, j_spec = CacheSpec(**spec), JSpec(**spec)
    assert t_spec.exact == j_spec.exact
    for L in (2, 8, 28):
        assert t_spec.resolve_split(L) == j_spec.resolve_split(L)
    for n_train, n in [(100, 6), (1000, 10), (1000, 50), (1000, 1)]:
        ts = jschedule.respaced_timesteps(n_train, n)
        want = jpolicy.refresh_mask(j_spec, ts)
        got = tpolicy.refresh_mask(t_spec, ts)
        np.testing.assert_array_equal(got, want)
        assert tpolicy.refresh_intervals(got) == jpolicy.refresh_intervals(want)
        for t_weak in (0, n // 2, n):
            fs = JSchedule.weak_first(n, t_weak)
            np.testing.assert_array_equal(
                tpolicy.ladder_refresh_mask(t_spec, fs.split_timesteps(ts)),
                jpolicy.ladder_refresh_mask(j_spec, fs.split_timesteps(ts)))


def test_conditioning_drift_matches_reference():
    from repro.models.dit import T_EMB_DIM as J_T_EMB_DIM
    assert tdit.T_EMB_DIM == J_T_EMB_DIM
    ts = np.arange(0, 1000, 37)
    for low in (1.0, 0.5, 0.25):
        np.testing.assert_array_equal(tpolicy.timestep_embedding_np(ts, low),
                                      jpolicy.timestep_embedding_np(ts, low))
    np.testing.assert_array_equal(tpolicy.conditioning_drift(ts, ts[::-1]),
                                  jpolicy.conditioning_drift(ts, ts[::-1]))
    # the host embedding is the model's (low_frac 1) to float32 rounding
    from repro_torch.models.common import timestep_embedding
    np.testing.assert_allclose(
        tpolicy.timestep_embedding_np(ts),
        timestep_embedding(torch.from_numpy(ts), tdit.T_EMB_DIM).numpy(),
        atol=5e-4)


def test_cache_spec_validation_matches_reference():
    for bad in [dict(policy="lru"), dict(interval=0), dict(threshold=0.0),
                dict(split=-1), dict(policy="banded", bands=((5, 0),))]:
        with pytest.raises(ValueError) as want:
            JSpec(**bad)
        with pytest.raises(ValueError) as got:
            CacheSpec(**bad)
        assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="deep block"):
        CacheSpec(split=4).resolve_split(4)


def test_cache_plan_validation():
    with pytest.raises(ValueError, match="CacheSpec"):
        SamplingPlan(T=T, cache=object())
    with pytest.raises(ValueError, match="solvers"):
        SamplingPlan(T=T, budget=1.0, solver="dpm2", cache=CacheSpec())
    with pytest.raises(ValueError, match="vanilla"):
        SamplingPlan(T=T, budget=1.0, guidance_kind="weak_cond",
                     cache=CacheSpec())
    with pytest.raises(ValueError, match="static"):
        SamplingPlan(T=T, budget=AdaptiveBudget(), cache=CacheSpec())


# ---------------------------------------------------------------------------
# Ledger: exact


@pytest.mark.parametrize("spec", SPECS, ids=[f"s{i}" for i in range(len(SPECS))])
def test_cache_ledger_matches_reference(flexi, spec):
    _, fcfg = flexi
    from repro import configs as jcfgs
    xl = jcfgs.get_config("dit-xl-2")
    t_spec, j_spec = CacheSpec(**spec), JSpec(**spec)
    for cfg in (fcfg, xl):
        split = t_spec.resolve_split(cfg.num_layers)
        for mode in (0, 1):
            for backend in ("dense", "pallas"):
                assert tledger.deep_block_flops(cfg, mode, split, backend) \
                    == jledger.deep_block_flops(cfg, mode, split, backend)
                for rf in (True, False):
                    assert tledger.cached_nfe_flops(cfg, mode, split, rf,
                                                    backend) \
                        == jledger.cached_nfe_flops(cfg, mode, split, rf,
                                                    backend)
            for guided in (True, False):
                assert tledger.delta_bytes(cfg, mode, guided) \
                    == jledger.delta_bytes(cfg, mode, guided)
        assert tledger.store_bytes(cfg, {0: 3, 1: 5}) \
            == jledger.store_bytes(cfg, {0: 3, 1: 5})
        for n_train, n in [(100, T), (1000, 10)]:
            ts = jschedule.respaced_timesteps(n_train, n)
            for t_weak in (0, 3, n):
                fs = JSchedule.weak_first(n, t_weak)
                for cfg_on in (True, False):
                    assert tledger.schedule_cached_flops(
                        cfg, fs, ts, t_spec, cfg_scale_active=cfg_on,
                        attn_backend="pallas") \
                        == jledger.schedule_cached_flops(
                            cfg, fs, ts, j_spec, cfg_scale_active=cfg_on,
                            attn_backend="pallas")
                assert tledger.cache_savings(cfg, fs, ts, t_spec) \
                    == jledger.cache_savings(cfg, fs, ts, j_spec)


@pytest.mark.parametrize("spec", SPECS[:4], ids=[f"s{i}" for i in range(4)])
def test_cached_pricing_matches_reference(flexi, spec):
    """plan.cached_flops, request_cost_flops with the engine's cache, and
    the controller's solved level under it: equal exactly."""
    _, fcfg = flexi
    t_spec, j_spec = CacheSpec(**spec), JSpec(**spec)
    tp, jp = make_plans(cache=t_spec), make_plans(cache=j_spec, port=False)
    for b in tp:
        for n_train in (100, 1000):
            assert tp[b].cached_flops(fcfg, 2, n_train, "pallas") \
                == jp[b].cached_flops(fcfg, 2, n_train, "pallas")
    tp0, jp0 = make_plans(), make_plans(port=False)
    for b in tp0:
        assert request_cost_flops(fcfg, tp0[b], cache=t_spec,
                                  num_train_steps=100) \
            == j_cost(fcfg, jp0[b], cache=j_spec, num_train_steps=100)
    lam, cap = 4.0, 4.0 * j_cost(fcfg, jp0[0.6])
    solved = []
    for ctl in (BudgetController(fcfg, tp0, target_util=1.0, alpha=1.0,
                                 cache=t_spec),
                JController(fcfg, jp0, target_util=1.0, alpha=1.0,
                            cache=j_spec)):
        ctl.observe_service(flops=cap, dt=1.0)
        for i in range(5):
            ctl.observe_arrival(i / lam)
        solved.append((ctl.solve(), ctl.costs, ctl.mode_costs))
    assert solved[0] == solved[1]


# ---------------------------------------------------------------------------
# Store


def test_cache_store_slots_and_eviction_match_reference(flexi):
    _, fcfg = flexi
    ts_, js_ = (CacheStore(fcfg, (0, 1), n_slots=2, guided=True, device="cpu"),
                JStore(fcfg, (0, 1), n_slots=2, guided=True))
    seq = [("alloc", 0, 10), ("alloc", 0, 11), ("touch", 0, 1),
           ("alloc", 0, 12), ("release", 0, 1), ("alloc", 1, 13),
           ("alloc", 1, 14), ("alloc", 1, 15), ("alloc", 0, 16)]
    for op, mode, arg in seq:
        got = getattr(ts_, op)(mode, arg)
        want = getattr(js_, op)(mode, arg)
        assert got == want
        assert ts_.active_slots() == js_.active_slots()
        assert ts_.evictions == js_.evictions
        assert (ts_.n_active, ts_.bytes_resident, ts_.bytes_total) \
            == (js_.n_active, js_.bytes_resident, js_.bytes_total)
    # gather / scatter round trip, on the store's device
    slot = ts_.active_slots()[0][1]
    vals = torch.randn(1, 2, tdit.tokens_for_mode(fcfg, 0), fcfg.d_model)
    ts_.scatter(0, [slot], vals)
    assert torch.equal(ts_.gather(0, [slot]), vals)
    assert ts_.gather(0, [slot]).device.type == "cpu"
    # transient allocation failures
    ts_.fail_allocs(1)
    with pytest.raises(TransientAllocationError):
        ts_.alloc(0, 99)


def test_cache_store_integrity(flexi):
    _, fcfg = flexi
    store = CacheStore(fcfg, (0,), n_slots=2, integrity=True, device="cpu")
    s = store.alloc(0, owner=1)
    assert store.verify_slot(0, s)            # nothing recorded yet
    store.scatter(0, [s], torch.randn(1, 2, 64, fcfg.d_model))
    assert store.verify_slot(0, s)
    store.corrupt_slot(0, s)
    assert not store.verify_slot(0, s) and store.integrity_failures == 1
    bf = CacheStore(fcfg, (0,), n_slots=1, integrity=True, device="cpu",
                    dtype=torch.bfloat16)
    bf.scatter(0, [bf.alloc(0, 1)], torch.randn(1, 2, 64, fcfg.d_model))
    assert bf.verify_slot(0, 0)


# ---------------------------------------------------------------------------
# Cached eps and the cached pipeline


@pytest.mark.parametrize("refresh", [True, False])
@pytest.mark.parametrize("scale", [1.5, 0.0])
def test_cached_eps_fn_matches_reference(flexi, refresh, scale):
    fp, fcfg = flexi
    tp = to_torch(fp)
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2,) + fcfg.dit.latent_shape).astype(np.float32)
    t = np.array([80, 30], np.int32)
    y, null = np.array([3, 7], np.int32), np.array([10, 10], np.int32)
    B = 4 if scale else 2
    delta = (rng.standard_normal((B, 16, fcfg.d_model)) * 0.1).astype(np.float32)
    J, Tt = jnp.asarray, torch.from_numpy
    jf = japply.make_cached_eps_fn(fp, fcfg, J(y), J(null),
                                   JGuidance(scale=scale, mode_cond=1,
                                             mode_uncond=1), None, None, 1,
                                   attn_backend="dense")
    tf = tapply.make_cached_eps_fn(tp, fcfg, Tt(y), Tt(null),
                                   GuidanceConfig(scale=scale, mode_cond=1,
                                                  mode_uncond=1), None, None, 1)
    we, _, wd = jf(J(x), J(t), J(delta), jnp.asarray(refresh))
    ge, _, gd = tf(Tt(x), Tt(t), Tt(delta), refresh)
    np.testing.assert_allclose(ge.numpy(), np.asarray(we), **STEP_TOL)
    np.testing.assert_allclose(gd.numpy(), np.asarray(wd), **STEP_TOL)
    with pytest.raises(ValueError, match="vanilla"):
        tapply.make_cached_eps_fn(tp, fcfg, Tt(y), Tt(null),
                                  GuidanceConfig(scale=1.5, mode_cond=0,
                                                 mode_uncond=1,
                                                 kind="weak_cond"),
                                  None, None, 1)


@pytest.mark.parametrize("solver", ["ddim", "ddpm"])
def test_pipeline_interval1_bit_identical(pipes, solver):
    _, pipe = pipes
    plan = SamplingPlan(T=T, budget=FlexiSchedule.weak_first(T, 3),
                        solver=solver, guidance_scale=1.5)
    cached = dataclasses.replace(plan, cache=CacheSpec(policy="interval",
                                                       interval=1, split=1))
    cond = torch.tensor([3, 8])
    ref = pipe.sample(plan, 2, torch.Generator().manual_seed(7), cond=cond)
    got = pipe.sample(cached, 2, torch.Generator().manual_seed(7), cond=cond)
    assert torch.equal(got.x0, ref.x0)
    assert got.trace["cache_refreshes"] == got.trace["cache_steps"] == T


@pytest.mark.parametrize("solver", ["ddim", "ddpm"])
def test_pipeline_cached_matches_reference(flexi, pipes, solver):
    """A stale-cache plan (interval 2) against the reference's cached
    pipeline: same x_T, the reference's noise; FLOPs and the trace equal."""
    _, fcfg = flexi
    jpipe, pipe = pipes
    spec = dict(policy="interval", interval=2, split=1)
    jplan = JPlan(T=T, budget=JSchedule.weak_first(T, 2), solver=solver,
                  guidance_scale=1.5, cache=JSpec(**spec))
    plan = SamplingPlan(T=T, budget=FlexiSchedule.weak_first(T, 2),
                        solver=solver, guidance_scale=1.5,
                        cache=CacheSpec(**spec))
    key = jax.random.PRNGKey(13)
    cond = np.array([1, 4], np.int32)
    want = jpipe.sample(jplan, 2, key, cond=jnp.asarray(cond))
    x_T = torch.from_numpy(np.array(jax.random.normal(
        key, (2,) + fcfg.dit.latent_shape)))
    run_key = jax.random.fold_in(key, 1)
    noise, i = [], 0
    for _m, tsub in jplan.resolve_schedule(fcfg).split_timesteps(
            jschedule.respaced_timesteps(100, T)):
        for k in jax.random.split(jax.random.fold_in(run_key, i), len(tsub)):
            noise.append(np.asarray(jax.random.normal(
                k, (2,) + fcfg.dit.latent_shape, jnp.float32)))
        i += 1
    got = pipe.sample(plan, 2, None, cond=torch.from_numpy(cond), x_T=x_T,
                      noise=torch.from_numpy(np.stack(noise)))
    np.testing.assert_allclose(got.x0.numpy(), np.asarray(want.x0), **E2E_TOL)
    assert got.flops == want.flops
    assert (got.trace["cache_refreshes"], got.trace["cache_steps"]) \
        == (want.trace["cache_refreshes"], want.trace["cache_steps"])
    for g, w in zip(got.trace["refresh_masks"], want.trace["refresh_masks"]):
        np.testing.assert_array_equal(g, np.asarray(w))


def test_policy_switch_builds_nothing(pipes):
    _, pipe = pipes

    def run(spec):
        return pipe.sample(SamplingPlan(T=T, budget=1.0, solver="ddim",
                                        guidance_scale=1.5, cache=spec),
                           1, torch.Generator().manual_seed(3),
                           cond=torch.tensor([2])).x0
    run(CacheSpec(policy="interval", interval=2, split=1))
    warm = pipe.cache_stats()
    for spec in (CacheSpec(policy="interval", interval=3, split=1),
                 CacheSpec(policy="banded", bands=((50, 1),), interval=4,
                           split=1),
                 CacheSpec(policy="proxy", threshold=0.02, split=1),
                 CacheSpec(policy="proxy", threshold=0.3, split=1)):
        run(spec)
    after = pipe.cache_stats()
    assert after["compiled"] == warm["compiled"]
    assert after["misses"] == warm["misses"]
    with pytest.raises(ValueError, match="eps_transform"):
        pipe.sample(SamplingPlan(T=T, cache=CacheSpec()), 1, None,
                    eps_transform=lambda e, x, t: e)


# ---------------------------------------------------------------------------
# The cached engine


def _serve_wave(eng, spec, late):
    """Submit ``spec`` [(label, level, seed)], step twice, join ``late``,
    drain. Returns {request id: x0}."""
    for label, lvl, seed in spec:
        eng.submit(cond=label, budget=lvl,
                   generator=torch.Generator().manual_seed(seed))
    results = []
    for _ in range(2):
        results += eng.step()
    eng.submit(cond=late[0], budget=late[1],
               generator=torch.Generator().manual_seed(late[2]))
    results += eng.run()
    return {r.request.id: r.x0 for r in results}


@pytest.mark.parametrize("solver", ["ddim", "ddpm"])
def test_engine_interval1_bit_identical(pipes, solver):
    """Packed cached dispatches at interval=1 equal uncached packed
    serving bit for bit while requests join, leave and churn slots."""
    _, pipe = pipes
    spec = [(3, 0.6, 60), (7, 1.0, 61), (5, 0.6, 62)]
    late = (9, 1.0, 99)
    # one fresh runner cache each, so both plan their dispatches from the
    # same (empty) warm set
    plain, cached = (ServingEngine(
        FlexiPipeline(pipe.params, pipe.cfg, pipe.sched, device="cpu"),
        make_plans(solver), max_tokens_per_step=256, cache=c)
        for c in (None, CacheSpec(policy="interval", interval=1, split=1)))
    want, got = _serve_wave(plain, spec, late), _serve_wave(cached, spec, late)
    assert sorted(got) == sorted(want) == [0, 1, 2, 3]
    for rid in want:
        assert torch.equal(got[rid], want[rid])
    assert cached.store.n_active == 0
    assert cached.metrics.cache_hit_rate == 0.0
    assert cached.block_passes == plain.block_passes


@pytest.mark.parametrize("solver", ["ddim", "ddpm"])
def test_engine_cached_matches_reference_engine(flexi, pipes, solver):
    """interval=2 serving, port engine against the reference engine: the
    same requests, x_T and noise from the reference's keys; x0 at 1e-4 and
    the cache ledger equal."""
    _, fcfg = flexi
    jpipe, pipe = pipes
    spec = dict(policy="interval", interval=2, split=1)
    jeng = JEngine(jpipe, make_plans(solver, port=False, attn_backend="dense"),
                   max_tokens_per_step=256, cache=JSpec(**spec))
    teng = ServingEngine(pipe, make_plans(solver), max_tokens_per_step=256,
                         cache=CacheSpec(**spec))
    jplans = make_plans(solver, port=False)
    reqs = [(4, 1.0, 5), (2, 0.6, 6), (8, 1.0, 7)]
    for label, lvl, s in reqs:
        key = jax.random.PRNGKey(s)
        jeng.submit(cond=label, budget=lvl, key=key)
        x_T, noise = ref_inputs(key, jplans[lvl], fcfg)
        teng.submit(cond=label, budget=lvl, x_T=x_T,
                    noise=noise if solver == "ddpm" else None)
    want = {r.request.id: r for r in jeng.run()}
    got = {r.request.id: r for r in teng.run()}
    assert sorted(got) == sorted(want)
    for rid, w in want.items():
        np.testing.assert_allclose(got[rid].x0.numpy(), np.asarray(w.x0),
                                   **E2E_TOL)
    assert teng.metrics.cache_summary() == jeng.metrics.cache_summary()
    assert teng.store.n_active == jeng.store.n_active == 0


def test_engine_cache_drift_and_slot_reuse(pipes):
    _, pipe = pipes
    plans = make_plans("ddim")
    eng = ServingEngine(pipe, plans, max_tokens_per_step=256,
                        cache=CacheSpec(policy="interval", interval=2,
                                        split=1))
    eng.submit(cond=4, budget=1.0, generator=torch.Generator().manual_seed(5))
    (r1,) = eng.run()
    assert eng.store.n_active == 0               # released at retire
    ref = pipe.sample(plans[1.0], 1, torch.Generator().manual_seed(5),
                      cond=torch.tensor([4])).x0[0]
    rel = float(((r1.x0 - ref) ** 2).mean() / (ref ** 2).mean())
    assert 0.0 < rel < 0.25                      # stale but bounded
    # join/leave slot recycling: the next request claims the same slot
    eng.submit(cond=2, budget=1.0, generator=torch.Generator().manual_seed(6))
    eng.step()
    assert eng.store.active_slots() == [(0, 0)]
    eng.run()
    assert eng.store.n_active == 0
    cs = eng.metrics.cache_summary()
    assert cs["enabled"] and 0.0 < cs["hit_rate"] < 1.0
    assert cs["refresh_interval_hist"]
    assert eng.metrics.cache_bytes_resident == 0
    assert eng.metrics.summary()["cache_hit_rate"] == cs["hit_rate"]
    # all-skip micro-steps ran the shallow block only
    assert eng.block_passes < eng.packed_forwards * pipe.cfg.num_layers
