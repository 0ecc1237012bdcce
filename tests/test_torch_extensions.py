"""The port's sampling extensions against the JAX package: rectified-flow
sampling (``diffusion/flow.py``, the flow runner of ``FlexiPipeline``) and
the adaptive per-sample scheduler (``core/adaptive.py``, the pipeline's
per-mode NFE cache).

Inputs are numpy-seeded and handed to both packages. Tolerances: float32
1e-5 per flow phase; 1e-4 end to end (ten steps of two-layer forwards
compound float32 rounding that XLA and torch order differently). Adaptive
gaps 1e-5 relative. A switch step is a comparison of a measured gap with
the threshold, so switch steps are compared only where every probe gap
clears the threshold by more than that tolerance. τ ladders, their
splits, FLOPs and relative compute are host arithmetic: equal exactly.
DDPM noise cannot be replayed from threefry keys, so adaptive DDPM is held
port against port with the noise handed over.
"""
import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jcfgs
from repro.diffusion import flow as jflow
from repro.diffusion import schedule as jschedule
from repro.models import dit as jdit
from repro.pipeline import AdaptiveBudget as JAdaptive
from repro.pipeline import FlexiPipeline as JPipeline
from repro.pipeline import SamplingPlan as JPlan
from repro_torch import convert
from repro_torch.core import adaptive as tadaptive
from repro_torch.core.scheduler import FlexiSchedule
from repro_torch.diffusion import flow as tflow
from repro_torch.diffusion import schedule as tschedule
from repro_torch.pipeline import AdaptiveBudget, FlexiPipeline, SamplingPlan

jflex = importlib.import_module("repro.core.flexify")

PHASE_TOL = dict(atol=1e-5, rtol=1e-5)
E2E_TOL = dict(atol=1e-4, rtol=1e-4)
GAP_RTOL = 1e-5
T = 10


def to_torch(tree):
    return convert.params_from_numpy(jax.tree.map(np.asarray, tree),
                                     device="cpu")


def _rnd(key, i, shape, scale):
    return jax.random.normal(jax.random.fold_in(key, i), shape) * scale


@pytest.fixture(scope="module")
def text_lora(tiny_dit_cfg):
    """The tiny DiT made text-conditioned (8 tokens of 32), ε-only
    (``learn_sigma=False``, as flow needs), flexified to patch 4 with LoRA
    rank 4; every zero-initialized gate made non-zero."""
    cfg = dataclasses.replace(tiny_dit_cfg, dit=dataclasses.replace(
        tiny_dit_cfg.dit, conditioning="text", text_len=8, text_dim=32,
        learn_sigma=False))
    key = jax.random.PRNGKey(21)
    p = jdit.init_dit(cfg, key)
    p["deembed"]["w_flex"] = _rnd(key, 1, p["deembed"]["w_flex"].shape, 0.1)
    p["final"]["ada"]["w"] = _rnd(key, 2, p["final"]["ada"]["w"].shape, 0.05)
    p["blocks"]["ada"]["w"] = _rnd(key, 3, p["blocks"]["ada"]["w"].shape, 0.05)
    p["blocks"]["xattn"]["wo"] = _rnd(key, 4, p["blocks"]["xattn"]["wo"].shape,
                                      0.05)
    p, cfg = jflex.flexify(p, cfg, [(1, 4, 4)], lora_rank=4)
    p["ps_embed"] = _rnd(key, 5, p["ps_embed"].shape, 0.1)
    p["blocks"]["lora"] = jax.tree.map(
        lambda a: _rnd(key, a.size, a.shape, 0.05), p["blocks"]["lora"])
    text = np.random.default_rng(3).standard_normal((2, 8, 32)).astype(np.float32)
    return p, cfg, text


@pytest.fixture(scope="module")
def xl_small():
    """dit-xl-2 geometry cut to 2 layers and d=64 (patch 2, flexified to
    patch 4), class-conditioned with CFG, trained-like gates."""
    cfg = jcfgs.get_config("dit-xl-2").reduced()
    key = jax.random.PRNGKey(11)
    p = jdit.init_dit(cfg, key)
    p["deembed"]["w_flex"] = _rnd(key, 0, p["deembed"]["w_flex"].shape, 0.1)
    p["final"]["ada"]["w"] = _rnd(key, 1, p["final"]["ada"]["w"].shape, 0.05)
    p["blocks"]["ada"]["w"] = _rnd(key, 2, p["blocks"]["ada"]["w"].shape, 0.05)
    p["ps_embed"] = _rnd(key, 3, p["ps_embed"].shape, 0.05)
    return p, cfg


def prior(cfg, n, seed=2):
    return np.random.default_rng(seed).standard_normal(
        (n,) + cfg.dit.latent_shape).astype(np.float32)


# ---------------------------------------------------------------------------
# Flow


@pytest.mark.parametrize("n", [1, 4, 10, 25])
def test_tau_ladder_and_split_equal_reference(n):
    np.testing.assert_array_equal(tflow.tau_ladder(n), jflow.tau_ladder(n))
    taus = tflow.tau_ladder(n)
    for phases in [((1, n // 2), (0, n - n // 2)), ((0, n),), ((1, n), (0, 0))]:
        got = tflow.split_tau_ladder(taus, phases)
        want = jflow.split_tau_ladder(jflow.tau_ladder(n), phases)
        assert [m for m, _ in got] == [m for m, _ in want]
        for (_, a), (_, b) in zip(got, want):
            np.testing.assert_array_equal(a, b)


def test_flow_path_helpers_match_reference():
    rng = np.random.default_rng(4)
    x0, eps = (rng.standard_normal((3, 1, 4, 4, 2)).astype(np.float32)
               for _ in range(2))
    tau = rng.uniform(size=3).astype(np.float32)
    got = tflow.interpolate(torch.from_numpy(x0), torch.from_numpy(eps),
                            torch.from_numpy(tau))
    want = jflow.interpolate(jnp.asarray(x0), jnp.asarray(eps), jnp.asarray(tau))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **PHASE_TOL)
    v = rng.standard_normal(x0.shape).astype(np.float32)
    got = tflow.flow_matching_loss(torch.from_numpy(v), torch.from_numpy(x0),
                                   torch.from_numpy(eps))
    want = jflow.flow_matching_loss(jnp.asarray(v), jnp.asarray(x0),
                                    jnp.asarray(eps))
    np.testing.assert_allclose(float(got), float(want), **PHASE_TOL)


@pytest.mark.parametrize("solver", ["euler", "heun"])
@pytest.mark.parametrize("mode", [0, 1])
def test_flow_phase_matches_reference(text_lora, solver, mode):
    """One phase (three τ intervals) of the text + LoRA model at each mode,
    LoRA unmerged inside the forward."""
    jp, cfg, text = text_lora
    tp = to_torch(jp)
    taus = tflow.tau_ladder(6)[1:5]
    x = prior(cfg, 2)
    jfn = {"euler": jflow.euler_phase, "heun": jflow.heun_phase}[solver]
    tfn = {"euler": tflow.euler_phase, "heun": tflow.heun_phase}[solver]
    want = jfn(jflow.make_flow_v_fn(jp, cfg, jnp.asarray(text), mode=mode),
               jnp.asarray(x), taus)
    got = tfn(tflow.make_flow_v_fn(tp, cfg, torch.from_numpy(text), mode=mode),
              torch.from_numpy(x), taus)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **PHASE_TOL)


@pytest.mark.parametrize("solver", ["flow_euler", "flow_heun"])
@pytest.mark.parametrize("budget", [0.6, 1.0])
def test_flow_pipeline_sample_matches_reference(text_lora, solver, budget):
    """``FlexiPipeline.sample`` with a flow solver, unguided, weak-first at
    budget 0.6 (merged LoRA for the weak phase), end to end."""
    jp, cfg, text = text_lora
    plan_kw = dict(T=T, budget=budget, solver=solver, guidance_scale=0.0)
    x_T = prior(cfg, 2)
    jres = JPipeline(jp, cfg, jschedule.linear_schedule(100)).sample(
        JPlan(**plan_kw), 2, jax.random.PRNGKey(0), cond=jnp.asarray(text),
        x_T=jnp.asarray(x_T))
    pipe = FlexiPipeline(to_torch(jp), cfg, tschedule.linear_schedule(100),
                         device="cpu")
    plan = SamplingPlan(**plan_kw)
    if budget < 1.0:
        assert plan.resolve_schedule(cfg).phases[0][0] == 1   # weak first
    res = pipe.sample(plan, 2, None, cond=torch.from_numpy(text),
                      x_T=torch.from_numpy(x_T))
    np.testing.assert_allclose(res.x0.numpy(), np.asarray(jres.x0), **E2E_TOL)
    assert res.flops == jres.flops
    assert res.relative_compute == jres.relative_compute
    assert res.trace["schedule"].phases == jres.trace["schedule"].phases


def test_flow_runners_keyed_and_never_rebuilt(text_lora):
    jp, cfg, text = text_lora
    pipe = FlexiPipeline(to_torch(jp), cfg, tschedule.linear_schedule(100),
                         device="cpu")
    cond = torch.from_numpy(text)
    plans = [SamplingPlan(T=4, budget=b, solver=s, guidance_scale=0.0)
             for s in ("flow_euler", "flow_heun") for b in (0.6, 1.0)]
    for plan in plans:
        pipe.sample(plan, 2, torch.Generator().manual_seed(0), cond=cond)
    assert pipe.cache_stats()["compiled"] == 4
    assert all(k[0] == "flow" for k in pipe._runners)
    for plan in reversed(plans):
        res = pipe.sample(plan, 2, torch.Generator().manual_seed(1), cond=cond)
        assert torch.isfinite(res.x0).all()
    stats = pipe.cache_stats()
    assert stats["compiled"] == 4 and stats["hits"] == 4


def test_flow_and_adaptive_refuse_eps_transform(xl_small, text_lora):
    jp, cfg, text = text_lora
    pipe = FlexiPipeline(to_torch(jp), cfg, tschedule.linear_schedule(100),
                         device="cpu")
    with pytest.raises(ValueError, match="eps_transform"):
        pipe.sample(SamplingPlan(T=4, solver="flow_euler", guidance_scale=0.0),
                    2, None, cond=torch.from_numpy(text),
                    eps_transform=lambda e, x, t: e)
    with pytest.raises(ValueError, match="unguided"):
        SamplingPlan(T=4, solver="flow_heun")


def test_text_lora_weights_convert_leaf_for_leaf(text_lora):
    jp, _, _ = text_lora
    got = to_torch(jp)
    jl = jax.tree_util.tree_leaves_with_path(jp)
    assert {"text_proj", "lora"} <= set(got) | set(got["blocks"])
    for path, leaf in jl:
        node = got
        for k in path:
            node = node[k.key]
        assert tuple(node.shape) == leaf.shape
        np.testing.assert_array_equal(node.numpy(), np.asarray(leaf))


# ---------------------------------------------------------------------------
# Adaptive


def _adaptive_pair(xl_small, threshold, probe_every, solver="ddim"):
    jp, cfg = xl_small
    x_T = prior(cfg, 2, seed=7)
    y = np.array([3, 8], np.int32)
    budget = dict(threshold=threshold, probe_every=probe_every)
    jres = JPipeline(jp, cfg, jschedule.linear_schedule(100)).sample(
        JPlan(T=T, budget=JAdaptive(**budget), solver=solver), 2,
        jax.random.PRNGKey(1), cond=jnp.asarray(y), x_T=jnp.asarray(x_T))
    pipe = FlexiPipeline(to_torch(jp), cfg, tschedule.linear_schedule(100),
                         device="cpu")
    res = pipe.sample(SamplingPlan(T=T, budget=AdaptiveBudget(**budget),
                                   solver=solver), 2, None,
                      cond=torch.from_numpy(y), x_T=torch.from_numpy(x_T))
    return jres, res


@pytest.mark.parametrize("threshold,probe_every",
                         [(1e9, 1), (0.0, 2), (0.35, 2), (1e9, 3)])
def test_adaptive_ddim_matches_reference(xl_small, threshold, probe_every):
    """``FlexiPipeline.sample`` with an adaptive budget (CFG 1.5, DDIM):
    gaps at 1e-5 relative; the switch step wherever every probe clears
    the threshold by more than that; then x0 at 1e-4, FLOPs and relative
    compute exactly. (This model's largest gap is its first, so it
    switches at step 0 or never; ``test_adaptive_sample_switches_like_
    reference`` switches inside the ladder.)"""
    jres, res = _adaptive_pair(xl_small, threshold, probe_every)
    _hold_decisions(jres.trace["gaps"], res.trace["gaps"], threshold,
                    jres.trace["switch_step"], res.trace["switch_step"])
    np.testing.assert_allclose(res.x0.numpy(), np.asarray(jres.x0), **E2E_TOL)
    assert res.flops == jres.flops
    assert res.relative_compute == jres.relative_compute
    assert res.trace["flops_static_powerful"] \
        == jres.trace["flops_static_powerful"]


def _hold_decisions(jg, tg, threshold, j_switch, t_switch):
    """Gaps at GAP_RTOL; the switch step and the probe count only where no
    reference gap sits within that tolerance of the threshold."""
    n = min(len(jg), len(tg))
    assert n >= 1
    np.testing.assert_allclose(tg[:n], jg[:n], rtol=GAP_RTOL, atol=0)
    if any(abs(g - threshold) <= GAP_RTOL * abs(g) for g in jg):
        pytest.fail(f"a probe gap sits within {GAP_RTOL} of the threshold "
                    f"{threshold}: {jg}")
    assert len(tg) == len(jg) and t_switch == j_switch


def _ramp_eps_fns(lib, a: float = 1.0, scale_t: float = 100.0):
    """Synthetic guided-NFE pairs for both packages: ε_p = x/2 and ε_w =
    ε_p·(1 + a·(1 − t/scale_t)), so the relative gap a²(1 − t/scale_t)²
    grows along the ladder and the switch falls inside it."""
    def eps_p(x, t):
        return 0.5 * x, None

    def eps_w(x, t):
        f = 1.0 + a * (1.0 - t.astype(jnp.float32) / scale_t) if lib == "jax" \
            else 1.0 + a * (1.0 - t.float() / scale_t)
        return 0.5 * x * f.reshape((-1,) + (1,) * (x.ndim - 1)), None
    return [eps_p, eps_w]


@pytest.mark.parametrize("threshold,probe_every",
                         [(0.25, 1), (0.25, 2), (0.5, 3), (0.05, 1)])
def test_adaptive_sample_switches_like_reference(xl_small, threshold,
                                                 probe_every):
    """``core.adaptive.adaptive_sample`` (DDIM) against the reference's on
    NFEs whose gap rises along the ladder: the switch lands inside it."""
    jad = importlib.import_module("repro.core.adaptive")
    _, cfg = xl_small
    ts = tschedule.respaced_timesteps(100, T)
    x_T = prior(cfg, 2, seed=8)
    jres = jad.adaptive_sample(_ramp_eps_fns("jax"), jschedule.linear_schedule(100),
                               jnp.asarray(x_T), ts, jax.random.PRNGKey(0), cfg,
                               threshold=threshold, probe_every=probe_every)
    res = tadaptive.adaptive_sample(_ramp_eps_fns("torch"),
                                    tschedule.linear_schedule(100),
                                    torch.from_numpy(x_T), ts, cfg,
                                    threshold=threshold,
                                    probe_every=probe_every)
    _hold_decisions(jres.gaps, res.gaps, threshold, jres.switch_step,
                    res.switch_step)
    assert 0 < res.switch_step < T
    np.testing.assert_allclose(res.x0.numpy(), np.asarray(jres.x0), **E2E_TOL)
    assert (res.flops, res.flops_static_powerful) \
        == (jres.flops, jres.flops_static_powerful)


def test_relative_gap_matches_reference():
    rng = np.random.default_rng(9)
    e_w, e_p = (rng.standard_normal((4, 1, 8, 8, 4)).astype(np.float32)
                for _ in range(2))
    jad = importlib.import_module("repro.core.adaptive")
    want = float(jad._relative_gap(jnp.asarray(e_w), jnp.asarray(e_p)))
    got = float(tadaptive.relative_gap(torch.from_numpy(e_w),
                                       torch.from_numpy(e_p)))
    assert got == pytest.approx(want, rel=GAP_RTOL)
    # an all-zero powerful prediction: the denominator's floor
    assert float(tadaptive.relative_gap(torch.ones(3), torch.zeros(3))) \
        == pytest.approx(float(jad._relative_gap(jnp.ones(3), jnp.zeros(3))),
                         rel=GAP_RTOL)


@pytest.mark.parametrize("solver", ["ddim", "ddpm"])
@pytest.mark.parametrize("threshold", [0.0, 1e9])
def test_adaptive_equals_static_schedule_at_its_switch(xl_small, solver,
                                                       threshold):
    """Port against port: an adaptive run that switched at step s is the
    static weak-first run with s weak steps, given the same prior and (DDPM)
    the same noise handed over: equal bit for bit."""
    jp, cfg = xl_small
    pipe = FlexiPipeline(to_torch(jp), cfg, tschedule.linear_schedule(100),
                         device="cpu")
    x_T = torch.from_numpy(prior(cfg, 2, seed=7))
    y = torch.tensor([3, 8])
    noise = _noise(cfg, solver)
    res = pipe.sample(SamplingPlan(T=T, budget=AdaptiveBudget(threshold, 1),
                                   solver=solver), 2, None, cond=y, x_T=x_T,
                      noise=noise)
    s = res.trace["switch_step"]
    static = pipe.sample(SamplingPlan(T=T, budget=FlexiSchedule.weak_first(T, s),
                                      solver=solver), 2, None, cond=y, x_T=x_T,
                         noise=noise)
    assert torch.equal(res.x0, static.x0)
    # the FLOPs: weak NFEs to the switch, one powerful probe per step
    # probed, powerful NFEs from the switch on (CFG: 2 NFEs a call)
    from repro_torch.core.scheduler import dit_nfe_flops
    f_w, f_p = 2 * dit_nfe_flops(cfg, 1), 2 * dit_nfe_flops(cfg, 0)
    n_weak = min(s + 1, T)
    want = 2 * (n_weak * f_w + len(res.trace["gaps"]) * f_p + (T - s) * f_p)
    assert res.flops == pytest.approx(want, rel=1e-12)
    assert res.relative_compute == pytest.approx(want / (2 * T * f_p), rel=1e-12)


def _noise(cfg, solver):
    if solver != "ddpm":
        return None
    return torch.from_numpy(np.random.default_rng(5).standard_normal(
        (T, 2) + cfg.dit.latent_shape).astype(np.float32))


@pytest.mark.parametrize("solver", ["ddim", "ddpm"])
def test_adaptive_sample_mid_switch_equals_phased_sampler(xl_small, solver):
    """Port against port, switching inside the ladder: the adaptive loop
    equals ``sample_phased`` over (weak, first s steps) + (powerful, the
    rest) with the same DDPM noise handed over, bit for bit."""
    from repro_torch.diffusion import sampler as tsampler
    _, cfg = xl_small
    ts = tschedule.respaced_timesteps(100, T)
    sched = tschedule.linear_schedule(100)
    fns = _ramp_eps_fns("torch")
    x_T = torch.from_numpy(prior(cfg, 2, seed=8))
    noise = _noise(cfg, solver)
    res = tadaptive.adaptive_sample(fns, sched, x_T, ts, cfg, threshold=0.25,
                                    probe_every=1, solver=solver, noise=noise)
    s = res.switch_step
    assert 0 < s < T
    want = tsampler.sample_phased([(fns[1], ts[:s]), (fns[0], ts[s:])], sched,
                                  x_T, solver=solver, noise=noise)
    assert torch.equal(res.x0, want)


def test_adaptive_ddpm_generator_equals_noise_handed_over(xl_small):
    """Drawing the DDPM noise from the generator equals handing over the
    same draws in ladder order (after the prior)."""
    jp, cfg = xl_small
    pipe = FlexiPipeline(to_torch(jp), cfg, tschedule.linear_schedule(100),
                         device="cpu")
    plan = SamplingPlan(T=T, budget=AdaptiveBudget(1e9, 1), solver="ddpm")
    y = torch.tensor([1, 2])
    res = pipe.sample(plan, 2, torch.Generator().manual_seed(4), cond=y)
    g = torch.Generator().manual_seed(4)
    shape = (2,) + cfg.dit.latent_shape
    x_T = torch.randn(shape, generator=g)
    noise = torch.stack([torch.randn(shape, generator=g) for _ in range(T)])
    again = pipe.sample(plan, 2, None, cond=y, x_T=x_T, noise=noise)
    assert torch.equal(res.x0, again.x0)
    assert res.trace["switch_step"] == again.trace["switch_step"]


def test_adaptive_nfe_cache_builds_once_across_budgets(xl_small):
    """One guided NFE per (mode, scale, LoRA variant, backend); switching
    thresholds or probe cadence between calls builds nothing."""
    jp, cfg = xl_small
    pipe = FlexiPipeline(to_torch(jp), cfg, tschedule.linear_schedule(100),
                         device="cpu")
    g = torch.Generator().manual_seed(0)
    for thr, every in [(0.35, 2), (0.0, 1), (1e9, 3), (0.35, 2)]:
        res = pipe.sample(SamplingPlan(T=4, budget=AdaptiveBudget(thr, every)),
                          2, g)
        assert torch.isfinite(res.x0).all()
    stats = pipe.cache_stats()
    assert stats["nfe_fns"] == 2 and stats["compiled"] == 2
    assert sorted(pipe._nfes) == [("nfe", m, 1.5, "none", "auto")
                                  for m in (0, 1)]
    pipe.sample(SamplingPlan(T=4, budget=AdaptiveBudget(),
                             attn_backend="pallas"), 2, g)
    assert pipe.cache_stats()["compiled"] == 4
