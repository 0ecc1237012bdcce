"""``runtime.graphs``, the port's compile-once runners, on the CPU.

The keying is host-pure: a budget switch (other timesteps in the metas)
keeps the packed step's key; a cached step's refresh pattern keys only by
its deep/shallow branch (two keys, whatever the pattern); a new parameter
tree is a new key; host data is refused as a body argument. On CPU
tensors every runner runs eagerly (the caller asked for the CPU): nothing
is captured, and ``sample`` gives the same x0 as the eager path it always
ran, including the DDPM noise now drawn before the runner.
``graphs.disabled()`` nests and holds per thread. The card's side
(captured == eager bit for bit, launch counts through replays) is in
``tests/test_torch_gpu.py``.
"""
import threading

import numpy as np
import pytest
import torch
from torch_threads import one_torch_thread  # noqa: F401

from repro_torch.cache.policy import CacheSpec
from repro_torch.core.flexify import flexify
from repro_torch.core.guidance import GuidanceConfig, make_eps_fn
from repro_torch.diffusion import sampler
from repro_torch.diffusion import schedule as sch
from repro_torch.models import dit as dit_mod
from repro_torch.models.common import tree_map
from repro_torch.pipeline import FlexiPipeline, SamplingPlan
from repro_torch.pipeline.packed import PackLayout
from repro_torch.runtime import graphs
from repro_torch.telemetry.profile import dummy_packed_args, packed_key


@pytest.fixture(scope="module")
def pipe(tiny_dit_cfg):
    params = dit_mod.init_dit(tiny_dit_cfg, torch.Generator().manual_seed(3))
    fparams, fcfg = flexify(params, tiny_dit_cfg, [(1, 4, 4)])
    return FlexiPipeline(fparams, fcfg, sch.linear_schedule(100), device="cpu")


LAYOUT = PackLayout(groups=((0, 1), (1, 2)), guided=True)


def _args(pipe, k, ladder, split=None, refresh=None):
    key = packed_key(LAYOUT, k_steps=k, cache_split=split)
    xs, metas, noises, *rest = dummy_packed_args(pipe.cfg, key, "cpu")
    metas = tuple(m.clone() for m in metas)
    for m in metas:
        for j in range(k):
            m[j, 0] = ladder[j]
            m[j, 1] = ladder[j] - 10
    if split is not None:
        deltas, _ = rest
        rest = [deltas, refresh]
    return (pipe.params, xs, metas, noises, *rest)


def test_budget_switch_keeps_the_packed_key(pipe):
    """A budget switch is other timesteps in the metas: one key. The
    captured micro-step serves the layout at every depth k."""
    runner = pipe.packed_step(LAYOUT, k_steps=2)
    assert isinstance(runner, graphs.HostLoop)
    (micro,) = graphs.pieces(runner)
    runner(*_args(pipe, 2, (90, 80)))
    runner(*_args(pipe, 2, (30, 20)))
    assert len(micro.keys_seen) == 1 and micro.captures == 0
    assert graphs.pieces(pipe.packed_step(LAYOUT, k_steps=4)) == [micro]


def test_refresh_patterns_key_by_branch_only(pipe):
    runner = pipe.packed_step(LAYOUT, cache_split=1)
    assert isinstance(runner, graphs.HostLoop)
    (micro,) = graphs.pieces(runner)
    patterns = {"TFF": [[[True]], [[False, False]]],
                "FTF": [[[False]], [[True, False]]],
                "FFT": [[[False]], [[False, True]]]}
    for refresh in patterns.values():
        runner(*_args(pipe, 1, (90,), 1, [np.asarray(r) for r in refresh]))
    assert len(micro.keys_seen) == 1          # one deep-branch key
    runner(*_args(pipe, 1, (90,), 1, [np.zeros((1, 1), bool),
                                      np.zeros((1, 2), bool)]))
    assert len(micro.keys_seen) == 2          # the shallow branch
    assert {k[0] for k in micro.keys_seen} == {True, False}


def test_new_parameter_tree_is_a_new_key(pipe):
    run = graphs.capture(lambda p, x: x + p["w"])
    params, x = {"w": torch.ones(3)}, torch.zeros(3)
    other = tree_map(lambda a: a.clone(), params)
    assert run.key(params, x) == run.key(params, x + 1)
    assert run.key(params, x) != run.key(other, x)


def test_host_data_is_refused_as_a_body_argument():
    run = graphs.capture(lambda p, x: x)
    with pytest.raises(TypeError, match="host function"):
        run.key({}, np.zeros(3))
    with pytest.raises(TypeError, match="host data"):
        run({}, torch.Generator())


def test_disabled_nests_and_is_per_thread():
    assert not graphs.is_disabled()
    seen = []
    with graphs.disabled():
        with graphs.disabled():
            assert graphs.is_disabled()
        assert graphs.is_disabled()
        t = threading.Thread(target=lambda: seen.append(graphs.is_disabled()))
        t.start()
        t.join(timeout=30)
        assert not t.is_alive()
    assert not graphs.is_disabled() and seen == [False]


def test_count_outside_a_capture_counts_now():
    got = []
    graphs.count(lambda variant, n: got.append((variant, n)), "wgmma")
    assert got == [("wgmma", 1)]


@pytest.mark.parametrize("plan", [
    SamplingPlan(T=4, budget=0.6),
    SamplingPlan(T=4, budget=0.8, solver="ddpm"),
    SamplingPlan(T=4, cache=CacheSpec(policy="interval", interval=2, split=1)),
    SamplingPlan(T=4, solver="flow_euler", guidance_scale=0.0),
], ids=["ddim", "ddpm", "cached", "flow"])
def test_cpu_runners_run_eagerly_with_the_same_x0(pipe, plan):
    fresh = FlexiPipeline(pipe.params, pipe.cfg, pipe.sched, device="cpu")
    got = fresh.sample(plan, 2, torch.Generator().manual_seed(7)).x0
    with graphs.disabled():
        want = fresh.sample(plan, 2, torch.Generator().manual_seed(7)).x0
    assert torch.equal(got, want)
    stats = fresh.cache_stats()
    assert stats["compiled"] == 1
    assert (stats["captured"], stats["replays"],
            stats["graph_pool_bytes"]) == (0, 0, 0)


def test_ddpm_noise_drawn_before_the_runner_equals_the_old_draws(pipe):
    """The DDPM noise is drawn in ``sample`` now, step by step as the
    sampler drew it inside the runner: the same x0 bit for bit as the
    sampler handed the generator (schedule all powerful, CFG 1.5)."""
    plan = SamplingPlan(T=4, budget=1.0, solver="ddpm")
    n = 2
    got = pipe.sample(plan, n, torch.Generator().manual_seed(9),
                      cond=torch.tensor([1, 2])).x0
    gen = torch.Generator().manual_seed(9)
    x_T = torch.randn((n,) + tuple(pipe.cfg.dit.latent_shape), generator=gen)
    eps = make_eps_fn(pipe.params, pipe.cfg, torch.tensor([1, 2]),
                      torch.full((n,), pipe.cfg.dit.num_classes),
                      GuidanceConfig(scale=1.5))
    ts = sch.respaced_timesteps(pipe.sched.num_steps, plan.T)
    want = sampler.sample_phased([(eps, ts)], pipe.sched, x_T, solver="ddpm",
                                 generator=gen)
    assert torch.equal(got, want)


def test_mesh_runners_stay_eager(pipe):
    meshed = FlexiPipeline(pipe.params, pipe.cfg, pipe.sched, device="cpu",
                           mesh=object())
    for runner in (meshed.packed_step(LAYOUT),
                   meshed.packed_step(LAYOUT, cache_split=1)):
        assert all(p.eager_only for p in graphs.pieces(runner))
    assert not any(p.eager_only for p in graphs.pieces(
        pipe.packed_step(LAYOUT, cache_split=1)))
