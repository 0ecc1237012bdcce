"""The port's sampling math, FLOPs ledger, plans and FlexiPipeline against
the JAX package, plus the port's own invariants (no JAX import, no silent
CPU fallback, no rebuilt runners).

Inputs and the reference's DDPM noise are made once and handed to both
packages: torch cannot replay threefry keys, so the port takes noise as a
tensor. Tolerances: float32 1e-5 per step; 1e-4 end to end, where ten
steps of two 2-layer forwards compound float32 rounding that differs
between XLA and torch in the order of the sums. The FLOPs ledger is host
float64 arithmetic done term for term as in the reference: equal exactly.
"""
import ast
import dataclasses
import importlib
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jcfgs
from repro.core import guidance as jguid
from repro.core import scheduler as jsched
from repro.diffusion import sampler as jsampler
from repro.diffusion import schedule as jschedule
from repro.models import dit as jdit
from repro.pipeline import FlexiPipeline as JPipeline
from repro.pipeline import SamplingPlan as JPlan
from repro.pipeline import solve_t_weak as j_solve_t_weak
from repro_torch import configs as tcfgs
from repro_torch import convert
from repro_torch.core import guidance as tguid
from repro_torch.core import scheduler as tsched
from repro_torch.diffusion import sampler as tsampler
from repro_torch.diffusion import schedule as tschedule
from repro_torch.pipeline import AdaptiveBudget, FlexiPipeline, SamplingPlan
from repro_torch.pipeline import solve_t_weak

jflex = importlib.import_module("repro.core.flexify")

REPO = Path(__file__).resolve().parents[1]
STEP_TOL = dict(atol=1e-5, rtol=1e-5)
E2E_TOL = dict(atol=1e-4, rtol=1e-4)
T = 10


def to_torch(tree):
    return convert.params_from_numpy(jax.tree.map(np.asarray, tree), device="cpu")


@pytest.fixture(scope="module")
def xl_small():
    """dit-xl-2 geometry cut to 2 layers and d=64 (``reduced()``: patch 2,
    flexified to patch 4), with trained-like non-zero gates."""
    cfg = jcfgs.get_config("dit-xl-2").reduced()
    key = jax.random.PRNGKey(11)
    p = jdit.init_dit(cfg, key)
    for i, path in enumerate([("deembed", "w_flex"), ("final", "ada", "w"),
                              ("blocks", "ada", "w"), ("ps_embed",)]):
        node = p
        for k in path[:-1]:
            node = node[k]
        scale = 0.1 if i == 0 else 0.05
        node[path[-1]] = jax.random.normal(jax.random.fold_in(key, i),
                                           node[path[-1]].shape) * scale
    return p, cfg, jschedule.linear_schedule(100)


def reference_noise(key, phases, shape):
    """The standard normals the reference's DDPM phases draw, in step order
    (``sample_phased`` folds the phase index in, ``ddpm_phase`` splits)."""
    out = []
    for i, ts in enumerate([ts for ts in phases if len(ts)]):
        for k in jax.random.split(jax.random.fold_in(key, i), len(ts)):
            out.append(np.asarray(jax.random.normal(k, shape, jnp.float32)))
    return torch.from_numpy(np.stack(out))


# ---------------------------------------------------------------------------
# Solver steps


def test_solver_steps_match_reference():
    rng = np.random.default_rng(0)
    js, ts_ = jschedule.linear_schedule(1000), tschedule.linear_schedule(1000)
    x = rng.standard_normal((3, 1, 4, 4, 2)).astype(np.float32)
    eps = rng.standard_normal(x.shape).astype(np.float32)
    lv = np.tanh(rng.standard_normal(x.shape)).astype(np.float32)
    z = rng.standard_normal(x.shape).astype(np.float32)
    t = np.array([999, 500, 0], np.int32)
    tp = np.array([980, 480, -1], np.int32)
    J, Tt = jnp.asarray, torch.from_numpy
    np.testing.assert_allclose(
        tschedule.ddim_step(ts_, Tt(x), Tt(eps), Tt(t), Tt(tp)).numpy(),
        np.asarray(jschedule.ddim_step(js, J(x), J(eps), J(t), J(tp))), **STEP_TOL)
    # the reference draws its noise from the key; hand the same draw over
    key = jax.random.PRNGKey(3)
    zr = np.asarray(jax.random.normal(key, x.shape, jnp.float32))
    for frac, clip in [(None, 0.0), (lv, 1.0)]:
        want = jschedule.ddpm_step(js, J(x), J(eps), J(t), key,
                                   None if frac is None else J(frac), clip)
        got = tschedule.ddpm_step(ts_, Tt(x), Tt(eps), Tt(t), Tt(zr),
                                  None if frac is None else Tt(frac), clip)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **STEP_TOL)
    w = rng.standard_normal(x.shape).astype(np.float32)

    def j_eps(xx, tt):
        return xx * 0.3 + J(w) * (tt.astype(jnp.float32) / 1000).reshape(-1, 1, 1, 1, 1)

    def t_eps(xx, tt):
        return xx * 0.3 + Tt(w) * (tt.float() / 1000).reshape(-1, 1, 1, 1, 1)

    tp0 = np.maximum(tp, 0)
    np.testing.assert_allclose(
        tschedule.dpm_solver2_step(ts_, Tt(x), t_eps, Tt(t), Tt(tp0)).numpy(),
        np.asarray(jschedule.dpm_solver2_step(js, J(x), j_eps, J(t), J(tp0))),
        **STEP_TOL)
    np.testing.assert_array_equal(tschedule.respaced_timesteps(1000, 17),
                                  jschedule.respaced_timesteps(1000, 17))


@pytest.mark.parametrize("solver,kind", [("ddim", "uncond"), ("ddpm", "uncond"),
                                         ("dpm2", "uncond"), ("ddim", "weak_cond")])
def test_sample_phased_matches_reference(xl_small, solver, kind):
    """Weak-first phases with guidance, the t_final hand-off between them,
    and (DDPM) the reference's own noise."""
    jp, cfg, js = xl_small
    ts_ = tschedule.linear_schedule(100)
    rng = np.random.default_rng(1)
    x_T = rng.standard_normal((2,) + cfg.dit.latent_shape).astype(np.float32)
    y = np.array([3, 5], np.int32)
    null = np.full((2,), cfg.dit.num_classes, np.int32)
    ladder = jschedule.respaced_timesteps(100, 6)
    splits = [(1, ladder[:2]), (0, ladder[2:])]
    gcfgs = [jguid.GuidanceConfig(scale=1.5, mode_cond=m, mode_uncond=m)
             if (kind == "uncond" or m == 1) else
             jguid.GuidanceConfig(scale=1.5, mode_cond=0, mode_uncond=1,
                                  kind="weak_cond") for m, _ in splits]
    jphases = [(jguid.make_eps_fn(jp, cfg, jnp.asarray(y), jnp.asarray(null), g),
                ts) for g, (_, ts) in zip(gcfgs, splits)]
    key = jax.random.PRNGKey(9)
    want = jsampler.sample_phased(jphases, js, jnp.asarray(x_T), key,
                                  solver=solver)
    tp = to_torch(jp)
    tphases = [(tguid.make_eps_fn(tp, cfg, torch.from_numpy(y),
                                  torch.from_numpy(null),
                                  tguid.GuidanceConfig(**dataclasses.asdict(g))),
                ts) for g, (_, ts) in zip(gcfgs, splits)]
    noise = (reference_noise(key, [ts for _, ts in splits], x_T.shape)
             if solver == "ddpm" else None)
    got = tsampler.sample_phased(tphases, ts_, torch.from_numpy(x_T),
                                 solver=solver, noise=noise)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **E2E_TOL)


def test_guidance_scale_rule():
    for s in (1.0, 1.5, 4.0):
        for kind in ("uncond", "weak_cond"):
            assert tguid.GuidanceConfig(scale=s, kind=kind).effective_scale() \
                == jguid.GuidanceConfig(scale=s, kind=kind).effective_scale()


# ---------------------------------------------------------------------------
# FLOPs ledger and plans


def _ledger_cfgs():
    out = [(n, jcfgs.get_config(n), tcfgs.get_config(n)) for n in tcfgs.DIT_ARCHS]
    for n in tcfgs.DIT_ARCHS:
        out.append((n + "-reduced", jcfgs.get_config(n).reduced(),
                    tcfgs.get_config(n).reduced()))
    return out


def test_flops_ledger_equals_reference_exactly():
    for name, jc, tc in _ledger_cfgs():
        n_modes = 1 + len(jc.dit.flex_patch_sizes)
        for backend in ("dense", "pallas"):
            for mode in range(n_modes):
                assert tsched.dit_nfe_flops(tc, mode, attn_backend=backend) == \
                    jsched.dit_nfe_flops(jc, mode, attn_backend=backend), name
                assert tsched.lora_nfe_overhead(tc, mode) == \
                    jsched.lora_nfe_overhead(jc, mode), name
            assert tsched.dit_block_flops(tc, 300, 11, attn_backend=backend) == \
                jsched.dit_block_flops(jc, 300, 11, attn_backend=backend), name
        for t_weak in (0, 4, 10):
            ts_, js_ = (tsched.FlexiSchedule.weak_first(T, t_weak),
                        jsched.FlexiSchedule.weak_first(T, t_weak))
            assert ts_.phases == js_.phases
            for kw in ({}, {"cfg_scale_active": False},
                       {"guidance_modes": ((1, 1), (0, 1)), "lora_unmerged": True}):
                assert tsched.schedule_flops(tc, ts_, **kw) == \
                    jsched.schedule_flops(jc, js_, **kw), (name, kw)
            assert tsched.relative_compute(tc, ts_) == \
                jsched.relative_compute(jc, js_), name


def test_plans_resolve_and_price_like_reference():
    jc, tc = jcfgs.get_config("dit-xl-2"), tcfgs.get_config("dit-xl-2")
    for budget in (0.5, 0.6, 0.8, 1.0):
        for kw in ({}, {"guidance_kind": "weak_cond"}, {"guidance_scale": 0.0},
                   {"solver": "dpm2"}, {"weak_last": True}):
            jp, tp = JPlan(T=T, budget=budget, **kw), SamplingPlan(T=T, budget=budget, **kw)
            tp.validate(tc)
            assert tp.resolve_schedule(tc).phases == jp.resolve_schedule(jc).phases
            assert tp.flops(tc, batch=3) == jp.flops(jc, batch=3)
            assert tp.flops(tc, attn_backend="pallas") == \
                jp.flops(jc, attn_backend="pallas")
            assert tp.relative_compute(tc) == jp.relative_compute(jc)
        assert solve_t_weak(tc, T, budget) == j_solve_t_weak(jc, T, budget)
    adaptive = SamplingPlan(T=T, budget=AdaptiveBudget())
    from repro.pipeline import AdaptiveBudget as JAdaptive
    assert adaptive.flops(tc) == JPlan(T=T, budget=JAdaptive()).flops(jc)
    with pytest.raises(ValueError):
        SamplingPlan(T=T, budget=0.1).validate(tc)


# ---------------------------------------------------------------------------
# FlexiPipeline


@pytest.mark.parametrize("solver,kind", [("ddim", "uncond"), ("ddpm", "weak_cond")])
def test_pipeline_sample_matches_reference(xl_small, solver, kind):
    """Budget 0.6, weak-first, guided, at dit-xl-2 geometry (cut to 2
    layers): the port's x0 against the reference pipeline's."""
    jp, cfg, js = xl_small
    plan_kw = dict(T=T, budget=0.6, solver=solver, guidance_kind=kind)
    x_T = np.random.default_rng(2).standard_normal(
        (2,) + cfg.dit.latent_shape).astype(np.float32)
    y = np.array([4, 9], np.int32)
    key = jax.random.PRNGKey(5)
    want = JPipeline(jp, cfg, js).sample(JPlan(**plan_kw), 2, key,
                                         cond=jnp.asarray(y),
                                         x_T=jnp.asarray(x_T)).x0
    plan = SamplingPlan(**plan_kw)
    schedule = plan.resolve_schedule(cfg)
    assert schedule.phases[0][0] == 1 and schedule.phases[0][1] > 0   # weak first
    noise = None
    if solver == "ddpm":
        ladder = jschedule.respaced_timesteps(100, T)
        noise = reference_noise(jax.random.fold_in(key, 1),
                                [ts for _, ts in schedule.split_timesteps(ladder)],
                                x_T.shape)
    pipe = FlexiPipeline(to_torch(jp), cfg, tschedule.linear_schedule(100),
                         device="cpu")
    res = pipe.sample(plan, 2, None, cond=torch.from_numpy(y),
                      x_T=torch.from_numpy(x_T), noise=noise)
    assert res.relative_compute <= 0.6 + 1e-12
    np.testing.assert_allclose(res.x0.numpy(), np.asarray(want), **E2E_TOL)


def test_pipeline_builds_no_runner_on_repeats_or_budget_switches(xl_small):
    jp, cfg, _ = xl_small
    pipe = FlexiPipeline(to_torch(jp), cfg, tschedule.linear_schedule(100),
                         device="cpu")
    g = torch.Generator().manual_seed(0)
    plans = {b: SamplingPlan(T=4, budget=b) for b in (0.6, 0.8, 1.0)}
    for b in (0.6, 0.8, 1.0):
        pipe.sample(plans[b], 2, g)
    built = pipe.cache_stats()["compiled"]
    assert built == 3
    for b in (1.0, 0.6, 0.8, 0.6):
        res = pipe.sample(plans[b], 2, g, cond=[1, 2])
        assert torch.isfinite(res.x0).all()
    stats = pipe.cache_stats()
    assert stats["compiled"] == built and stats["hits"] == 4


def test_pipeline_needs_cuda_unless_cpu_is_asked(xl_small):
    if torch.cuda.is_available():
        pytest.skip("CUDA is present here; the check is for machines without it")
    jp, cfg, _ = xl_small
    with pytest.raises(RuntimeError, match="CUDA"):
        FlexiPipeline(to_torch(jp), cfg, tschedule.linear_schedule(100))


def test_unported_paths_raise(xl_small):
    jp, cfg, _ = xl_small
    pipe = FlexiPipeline(to_torch(jp), cfg, tschedule.linear_schedule(100),
                         device="cpu")
    # adaptive and flow plans are ported (tests/test_torch_extensions.py),
    # and sequence-parallel plans (tests/test_torch_distributed.py): a
    # parallel field that is no ParallelSpec is refused, as the reference
    # refuses it
    with pytest.raises(ValueError, match="ParallelSpec"):
        SamplingPlan(T=4, parallel=object())
    # the blocked attention backend is ported: it samples what dense does
    x = {be: pipe.sample(SamplingPlan(T=4, attn_backend=be), 1,
                         torch.Generator().manual_seed(0),
                         cond=torch.tensor([3])).x0
         for be in ("xla-blocked", "dense")}
    torch.testing.assert_close(x["xla-blocked"], x["dense"], **STEP_TOL)


def test_port_imports_neither_jax_nor_the_jax_package():
    files = sorted((REPO / "src" / "repro_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    assert len(files) > 20
    for path in files:
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            for n in names:
                assert not (n in ("jax", "repro") or n.startswith(("jax.", "repro."))), \
                    f"{path.relative_to(REPO)} imports {n}"
