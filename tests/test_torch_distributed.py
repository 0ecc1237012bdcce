"""The port's sequence-parallel sampling (``repro_torch.distributed``,
``launch/mesh.py``, ``FlexiPipeline(mesh=)``, ``launch/serve.py --mesh``)
against the JAX package, on CPU process groups over Gloo.

The reference's own fake-device suite does not run on this jax, so the
port is held against what does: the reference's single-device
``FlexiPipeline.sample`` fed the same draws (1e-4, as the other
end-to-end tests), its dense attention on the gathered inputs (1e-5), and
its host arithmetic (partition, sharding rules, pricing: equal exactly).

Three rank groups run, each once per module (``torch_dist_worker.run_group``
computes everything its mesh is asked for): (1 x 2) Ulysses, (2 x 2)
Ulysses with the batch split over 'data' (then a (1 x 4) mesh for the mesh
switch), and (1 x 3), where the tiny config's 4 heads make 'auto' resolve
to the ring and 64 / 16 tokens pad to 66 / 18. Ranks run one torch thread.
"""
import argparse
import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_threads import one_torch_thread  # noqa: F401

import torch_dist_worker as worker
from repro.configs import get_config as j_get_config
from repro.core.scheduler import FlexiSchedule as JSchedule
from repro.diffusion import schedule as jschedule
from repro.distributed import partition as jpart
from repro.models import attention as jattn
from repro.pipeline import FlexiPipeline as JPipeline
from repro.pipeline import SamplingPlan as JPlan
from repro.runtime import sharding as jshard
from repro.serving.controller import request_cost_flops as j_cost
from repro_torch import convert
from repro_torch.configs import base as tbase
from repro_torch.configs import get_config
from repro_torch.core.scheduler import FlexiSchedule
from repro_torch.diffusion import schedule as tschedule
from repro_torch.distributed import (ParallelSpec, SeqParallel,
                                     mesh_fingerprint, partition)
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import serve as tserve
from repro_torch.pipeline import FlexiPipeline, SamplingPlan
from repro_torch.runtime import sharding as tshard
from repro_torch.serving.controller import request_cost_flops

jflex = importlib.import_module("repro.core.flexify")

T = 6
N = 4
TRAIN_T = 100
E2E_TOL = dict(atol=1e-4, rtol=1e-4)
ATTN_TOL = dict(atol=1e-5, rtol=1e-5)
SOLVERS = [("ddim", 1.5), ("ddpm", 1.5), ("flow_euler", 0.0)]
MESHES = {"1x2": (1, 2), "2x2": (2, 2), "1x3": (1, 3)}
GROUP_TIMEOUT_S = 240.0


def port_cfg(jcfg):
    """The JAX package's ModelConfig as the port's (same fields)."""
    kw = {f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg)}
    kw["attn"] = tbase.AttnConfig(**dataclasses.asdict(jcfg.attn))
    kw["dit"] = tbase.DiTConfig(**dataclasses.asdict(jcfg.dit))
    return tbase.ModelConfig(**kw)


def reference_noise(key, phases, shape):
    """The reference's DDPM draws in step order (as test_torch_sampling)."""
    out = []
    for i, ts in enumerate([ts for ts in phases if len(ts)]):
        for k in jax.random.split(jax.random.fold_in(key, i), len(ts)):
            out.append(np.asarray(jax.random.normal(k, shape, jnp.float32)))
    return np.stack(out)


@pytest.fixture(scope="module")
def flexi(tiny_dit_cfg, trained_like_dit):
    # two weak modes: (1,4,4) → 16 tokens, (1,8,8) → 4, over 64 at mode 0
    fp, fcfg = jflex.flexify(trained_like_dit, tiny_dit_cfg,
                             [(1, 4, 4), (1, 8, 8)])
    return fp, fcfg, jax.tree.map(np.asarray, fp), port_cfg(fcfg)


@pytest.fixture(scope="module")
def draws(flexi):
    """One prior, labels and DDPM noise, shared by every mesh."""
    _, jcfg, _, _ = flexi
    rng = np.random.default_rng(3)
    x_T = rng.standard_normal((N,) + jcfg.dit.latent_shape).astype(np.float32)
    y = np.array([1, 5, 7, 2], np.int32)
    key = jax.random.PRNGKey(9)
    plan = JPlan(T=T, budget=0.6, solver="ddpm")
    ts = jschedule.respaced_timesteps(TRAIN_T, T)
    noise = reference_noise(
        jax.random.fold_in(key, 1),
        [tsub for _, tsub in plan.resolve_schedule(jcfg).split_timesteps(ts)],
        x_T.shape)
    return x_T, y, key, noise


@pytest.fixture(scope="module")
def references(flexi, draws):
    """The reference's single-device sample per solver."""
    jp, jcfg, _, _ = flexi
    x_T, y, key, _ = draws
    pipe = JPipeline(jp, jcfg, jschedule.linear_schedule(TRAIN_T))
    return {s: np.asarray(pipe.sample(
        JPlan(T=T, budget=0.6, solver=s, guidance_scale=g), N, key,
        cond=jnp.asarray(y), x_T=jnp.asarray(x_T)).x0) for s, g in SOLVERS}


def attn_inputs(seed, B, Nt, H, hd, n_pad):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((B, Nt, H, hd)).astype(np.float32)
               for _ in range(3))
    seg = np.zeros((B, Nt), np.int32)
    seg[0, Nt // 2:] = 1                      # two packed segments in row 0
    seg[:, Nt - n_pad:] = -1                  # padding tail
    return q, k, v, seg


def reference_attention(q, k, v, seg):
    """The reference's dense GQA attention on the gathered inputs."""
    from repro.configs.base import AttnConfig
    B, Nt, H, hd = q.shape
    cfg = AttnConfig(num_heads=H, num_kv_heads=H, head_dim=hd, use_rope=False)
    pos = jnp.broadcast_to(jnp.arange(Nt, dtype=jnp.int32), (B, Nt))
    bias = jattn.make_attention_bias(pos, pos, causal=False, window=0,
                                     q_segment=jnp.asarray(seg),
                                     k_segment=jnp.asarray(seg))
    return np.asarray(jattn.gqa_attend(jnp.asarray(q), jnp.asarray(k),
                                       jnp.asarray(v), bias, cfg))


ATTN_CASES = {
    # mesh: [(name, impl, (B, N, H, hd, padding))]
    "1x2": [("ulysses_sp2", "ulysses", (2, 12, 4, 8, 2)),
            ("ring_sp2", "ring", (2, 12, 4, 8, 2))],
    "1x3": [("ulysses_sp3", "ulysses", (2, 12, 6, 8, 3)),
            ("ring_sp3", "ring", (2, 12, 4, 8, 1))],
}


def serve_args(**kw):
    base = dict(budget=0.6, budget_levels="0.6,1.0", T=4, train_T=TRAIN_T,
                solver="ddim", cfg_scale=1.5, requests=3, batch_slots=2,
                attn_backend="auto", mesh="1x2", device="cpu")
    base.update(kw)
    return argparse.Namespace(**base)


def make_job(name, flexi, draws):
    _, _, np_params, tcfg = flexi
    x_T, y, _, noise = draws
    cases = []
    for solver, g in SOLVERS:
        plan = dict(T=T, budget=0.6, solver=solver, guidance_scale=g,
                    parallel="auto")
        cases.append(dict(name=solver, plan=plan, n=N, x_T=x_T, cond=y,
                          noise=noise if solver == "ddpm" else None))
    job = dict(mesh=MESHES[name], cfg=tcfg, params=np_params,
               train_T=TRAIN_T, cases=cases,
               attn=[(n, impl, *attn_inputs(i, *shape[:4], shape[4]))
                     for i, (n, impl, shape) in
                     enumerate(ATTN_CASES.get(name, ()))])
    if name == "1x2":
        job["switch"] = dict(T=4, budgets=(0.6, 1.0), n=2)
        job["fixed"] = dict(T=4, budgets=(0.6, 1.0),
                            requests=(0.6, 1.0, 0.6))
        scfg = get_config("dit-xl-2").reduced()
        args = serve_args()
        job["serve"] = (scfg, args, tserve.build_plan_menu(
            scfg, args, ParallelSpec()))
    if name == "2x2":
        # ring on the same mesh, and DDPM drawn from a generator: every
        # rank draws the whole batch's prior and noise, keeps its rows
        job["cases"].append(dict(
            name="ring", n=N, x_T=x_T, cond=y,
            plan=dict(T=T, budget=0.6, guidance_scale=1.5, parallel="ring")))
        job["cases"].append(dict(
            name="ddpm_gen", n=N, cond=y, seed=21,
            plan=dict(T=T, budget=0.6, solver="ddpm", guidance_scale=1.5,
                      parallel="ulysses")))
        job["mesh_switch"] = (1, 4)
    return job


_GROUPS = {}


@pytest.fixture(scope="module")
def group(flexi, draws):
    """Each mesh's rank group, launched once, on first use."""
    def get(name):
        if name not in _GROUPS:
            _GROUPS[name] = tmesh.run_ranks(
                worker.run_group, int(np.prod(MESHES[name])), backend="gloo",
                device="cpu", timeout_s=GROUP_TIMEOUT_S, threads=1,
                args=(make_job(name, flexi, draws),))
        return _GROUPS[name]
    return get


# ---------------------------------------------------------------------------
# Host arithmetic: partition, sharding rules, pricing


def _ledger_cfgs(flexi):
    _, jcfg, _, tcfg = flexi
    out = [(jcfg, tcfg)]
    for name in ("dit-xl-2", "t2i-transformer", "video-dit"):
        out.append((j_get_config(name), get_config(name)))
    return out


def _schedules(cfg):
    n_modes = 1 + len(cfg.dit.flex_patch_sizes)
    for mode in range(1, n_modes):
        for k in (0, 3, 6):
            yield ((mode, k), (0, T - k))          # weak first
            yield ((0, T - k), (mode, k))          # weak last
    yield ((0, T),)


@pytest.mark.parametrize("which", [0, 1, 2, 3])
def test_partition_equals_reference(flexi, which):
    """tiny (flexified to (1,4,4), (1,8,8)), dit-xl-2, t2i-transformer and
    video-dit at sp 1-8 under weak-first and weak-last schedules: every
    number of the partition equal to the reference's."""
    jcfg, tcfg = _ledger_cfgs(flexi)[which]
    for phases in _schedules(jcfg):
        js, ts = JSchedule(phases), FlexiSchedule(phases)
        for sp in range(1, 9):
            for attn in ("auto", "ring", "ulysses"):
                if attn == "ulysses" and jcfg.attn.num_heads % sp:
                    with pytest.raises(ValueError, match="divisible"):
                        partition.plan_partition(tcfg, ts, sp,
                                                 ParallelSpec(attn=attn))
                    continue
                jp = jpart.plan_partition(jcfg, js, sp,
                                          jpart.ParallelSpec(attn=attn))
                tp = partition.plan_partition(tcfg, ts, sp,
                                              ParallelSpec(attn=attn))
                assert tp.reshard_boundaries == jp.reshard_boundaries
                for active in (True, False):
                    assert tp.pad_flops(tcfg, cfg_scale_active=active) \
                        == jp.pad_flops(jcfg, cfg_scale_active=active)
                    assert tp.collective_bytes(tcfg, cfg_scale_active=active) \
                        == jp.collective_bytes(jcfg, cfg_scale_active=active)
                assert tp.parallel_efficiency(tcfg) \
                    == jp.parallel_efficiency(jcfg)
                for (a, n_a), (b, n_b) in zip(tp.phases, jp.phases):
                    assert n_a == n_b
                    assert (a.mode, a.sp, a.tokens, a.tokens_padded, a.impl,
                            a.pad, a.shard_tokens) == \
                        (b.mode, b.sp, b.tokens, b.tokens_padded, b.impl,
                         b.pad, b.shard_tokens)


def test_parallel_spec_and_plan_validation():
    with pytest.raises(ValueError, match="attn"):
        ParallelSpec(attn="pipefusion")
    with pytest.raises(ValueError, match="axis"):
        ParallelSpec(axis="")
    from repro_torch.pipeline import AdaptiveBudget
    from repro_torch.serving import CacheSpec
    with pytest.raises(ValueError, match="adaptive"):
        SamplingPlan(T=T, budget=AdaptiveBudget(), parallel=ParallelSpec())
    with pytest.raises(ValueError, match="ParallelSpec"):
        SamplingPlan(T=T, parallel="seq")
    with pytest.raises(ValueError, match="sequence-parallel"):
        SamplingPlan(T=T, parallel=ParallelSpec(), cache=CacheSpec())
    assert partition.padded_tokens(17, 8) == 24


def _spec(spec):
    """A partition spec as a tuple of entries, a one-axis tuple as its
    name (the reference's PartitionSpec folds ('data',) to 'data')."""
    return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e
                 for e in spec)


class _JMesh:
    """Axis names and sizes the reference's rules read (``devices.shape``)."""
    def __init__(self, names, shape):
        self.axis_names = names
        self.devices = np.empty(shape)


@pytest.mark.parametrize("names,shape", [
    (("data", "seq"), (2, 4)), (("data", "seq"), (1, 3)),
    (("data", "model"), (4, 2)), (("pod", "data", "model"), (2, 2, 2)),
    (("seq",), (8,))])
def test_sharding_rules_equal_reference(flexi, names, shape):
    jm, tm = _JMesh(names, shape), tshard.AxisLayout(names, shape)
    jcfg, tcfg = _ledger_cfgs(flexi)[1]
    assert tshard.axis_sizes(tm) == jshard.axis_sizes(jm)
    assert tshard.dp_axes(tm) == jshard.dp_axes(jm)
    for profile in jshard.PROFILES:
        assert tshard.resolve_profile(tcfg, profile) \
            == jshard.resolve_profile(jcfg, profile)
        assert tshard.base_profile(profile) == jshard.base_profile(profile)
        assert tshard.rules_for(tcfg, tm, profile) \
            == jshard.rules_for(jcfg, jm, profile)
    for batch in (1, 2, 3, 4, 6, 8, 16):
        assert _spec(tshard.batch_spec(batch, tm)) \
            == _spec(jshard.batch_spec(batch, jm))
        assert _spec(tshard.token_spec(batch, tm)) \
            == _spec(jshard.token_spec(batch, jm))
        if "model" in names:
            assert tshard.seq_axes_for_cache(batch, tm) \
                == jshard.seq_axes_for_cache(batch, jm)
    assert tshard.SEQ_AXIS == jshard.SEQ_AXIS


@pytest.mark.parametrize("sp", [2, 3, 4, 8])
def test_request_cost_with_sp_equals_reference(flexi, sp):
    _, jcfg, _, tcfg = flexi
    for b in (0.6, 1.0):
        for g in (1.5, 0.0):
            tp = SamplingPlan(T=T, budget=b, guidance_scale=g,
                              parallel=ParallelSpec())
            jp = JPlan(T=T, budget=b, guidance_scale=g,
                       parallel=jpart.ParallelSpec())
            assert request_cost_flops(tcfg, tp, sp) == j_cost(jcfg, jp, sp)


def test_engine_refuses_missing_mesh_and_axis(flexi):
    _, _, _, tcfg = flexi
    with pytest.raises(ValueError, match="mesh"):
        SeqParallel.create(None, ParallelSpec(), tcfg)
    with pytest.raises(ValueError, match="no 'ctx' axis"):
        SeqParallel.create(tshard.AxisLayout(("data", "seq"), (1, 2)),
                           ParallelSpec(axis="ctx"), tcfg)
    assert mesh_fingerprint(None) is None


def test_backend_rule_never_falls_back(monkeypatch):
    """NCCL asked for with more ranks than cards raises; CPU ranks take
    Gloo only; the launcher applies the rule before it starts a rank."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="NCCL refuses"):
        tmesh.rank_device(1, 4, "nccl", "cuda")
    with pytest.raises(ValueError, match="gloo"):
        tmesh.default_backend(4, "cuda")
    assert tmesh.default_backend(1, "cuda") == "nccl"
    assert tmesh.rank_device(3, 4, "gloo", "cuda") == torch.device("cuda", 0)
    with pytest.raises(ValueError, match="gloo"):
        tmesh.rank_device(0, 2, "nccl", "cpu")
    with pytest.raises(ValueError, match="NCCL refuses"):
        tmesh.run_ranks(worker.fail_on_rank_one, 2, backend="nccl",
                        device="cuda")
    assert tmesh.parse_mesh_arg("2x4") == (2, 4)
    with pytest.raises(SystemExit):
        tmesh.parse_mesh_arg("2by4")


def test_failing_rank_fails_the_run():
    with pytest.raises(RuntimeError, match="planted failure on rank 1"):
        tmesh.run_ranks(worker.fail_on_rank_one, 2, device="cpu",
                        timeout_s=60, threads=1)


# ---------------------------------------------------------------------------
# Rank groups


@pytest.mark.parametrize("mesh", ["1x2", "1x3"])
def test_attention_per_call_matches_reference(group, mesh):
    """Ulysses and the ring on each rank's shard, gathered, against the
    reference's dense attention on the gathered inputs (real query rows;
    padded ones are sliced off by the engine)."""
    ranks = group(mesh)
    for i, (name, impl, shape) in enumerate(ATTN_CASES[mesh]):
        q, k, v, seg = attn_inputs(i, *shape[:4], shape[4])
        got = np.concatenate([r[name] for r in ranks], axis=1)
        want = reference_attention(q, k, v, seg)
        real = seg >= 0
        np.testing.assert_allclose(got[real], want[real], **ATTN_TOL)


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("solver", [s for s, _ in SOLVERS])
def test_sharded_matches_single_device(group, flexi, references, mesh,
                                       solver):
    """Every rank's x0 against the reference's single-device sample fed
    the same draws; FLOPs and relative compute equal to the single-device
    port's; the counted q/k/v/o (ring: K/V) bytes, summed over ranks,
    equal to n x the partition ledger."""
    _, _, np_params, tcfg = flexi
    ranks = group(mesh)
    g = dict(SOLVERS)[solver]
    plan = SamplingPlan(T=T, budget=0.6, solver=solver, guidance_scale=g,
                        parallel=ParallelSpec())
    single = FlexiPipeline(convert.params_from_numpy(np_params, device="cpu"),
                           tcfg, tschedule.linear_schedule(TRAIN_T),
                           device="cpu")
    base = single.sample(dataclasses.replace(plan, parallel=None), N,
                         torch.Generator().manual_seed(0))
    sp = MESHES[mesh][1]
    part = partition.plan_partition(tcfg, plan.resolve_schedule(tcfg), sp,
                                    plan.parallel)
    impl = part.phases[0][0].impl
    assert impl == ("ring" if mesh == "1x3" else "ulysses")
    for r in ranks:
        res = r[solver]
        np.testing.assert_allclose(res["x0"], references[solver], **E2E_TOL)
        assert res["flops"] == base.flops
        assert res["relative_compute"] == base.relative_compute
    kind = "qkvo" if impl == "ulysses" else "kv"
    sent = sum(r[solver]["bytes"].get(kind, 0) for r in ranks)
    assert sent == N * part.collective_bytes(
        tcfg, cfg_scale_active=plan.guidance_active)
    assert all(r[solver]["bytes"].get("segment_ids", 0) > 0 for r in ranks)
    if mesh == "2x2":
        assert all(r[solver]["bytes"]["x0"] > 0 for r in ranks)


def test_ring_matches_ulysses_and_generator_draws(group, flexi, draws):
    """(2 x 2): the ring agrees with Ulysses; DDPM with draws from a
    generator equals the single-device port with the same generator."""
    _, _, np_params, tcfg = flexi
    _, y, _, _ = draws
    ranks = group("2x2")
    for r in ranks:
        np.testing.assert_allclose(r["ring"]["x0"], r["ddim"]["x0"],
                                   **E2E_TOL)
    single = FlexiPipeline(convert.params_from_numpy(np_params, device="cpu"),
                           tcfg, tschedule.linear_schedule(TRAIN_T),
                           device="cpu")
    want = single.sample(SamplingPlan(T=T, budget=0.6, solver="ddpm"), N,
                         torch.Generator().manual_seed(21),
                         cond=torch.from_numpy(y)).x0.numpy()
    for r in ranks:
        np.testing.assert_allclose(r["ddpm_gen"]["x0"], want, **E2E_TOL)
    assert sorted(r["coord"] for r in ranks) == [(0, 0), (0, 1), (1, 0),
                                                 (1, 1)]


def test_budget_switch_builds_nothing(group):
    """Two budgets on a fixed (1 x 2) mesh: each builds its runner once,
    switching back and forth builds nothing more."""
    for r in group("1x2"):
        before, after = r["switch"]
        assert after["compiled"] == before["compiled"] + 2
        assert after["misses"] == before["misses"] + 2
        assert after["hits"] == before["hits"] + 2


def test_mesh_switch_builds_separate_runners(group):
    """The same plan on a (2 x 2) then a (1 x 4) mesh over the same ranks:
    the fingerprint differs, so a new runner; back on the first mesh, a
    hit; and (1 x 4) Ulysses matches (2 x 2)."""
    for r in group("2x2"):
        runners, hits, x0 = r["mesh_switch"]
        assert runners == [1, 2, 2] and hits[2] == hits[1] + 1
        np.testing.assert_allclose(x0, r["ddim"]["x0"], **E2E_TOL)


def test_fixed_slot_engine_serves_parallel_plans(group):
    served = group("1x2")[0]["fixed"]
    assert sorted(s[0] for s in served) == [0, 1, 2]
    for _, _, x0, ref in served:
        np.testing.assert_allclose(x0, ref, **E2E_TOL)


def test_serve_mesh_rank_loop(group):
    """launch/serve.py's per-rank loop on the (1 x 2) group."""
    ranks = group("1x2")
    lines = ranks[0]["serve"]["lines"]
    assert ranks[1]["serve"]["lines"] == []
    assert any(line.startswith("[batch 1]") for line in lines)
    assert "served 3 requests in 2 batches" in "\n".join(lines)
    assert ranks[0]["serve"]["summary"]["runners"] <= 2


def test_serve_cli_mesh_on_cpu(capsys):
    m = tserve.main(["--arch", "dit-xl-2", "--smoke", "--mesh", "1x2",
                     "--device", "cpu", "--requests", "3", "--batch-slots",
                     "2", "--T", "3", "--budget-levels", "0.6,1.0"])
    out = capsys.readouterr().out
    assert "[mesh] data=1 seq=2 over 2 ranks (gloo, cpu)" in out
    assert "[shard]" in out and "impl=ulysses" in out
    assert "served 3 requests" in out and m["served"] == 3.0
    with pytest.raises(NotImplementedError, match="distributed"):
        tserve.main(["--arch", "dit-xl-2", "--smoke", "--device", "cpu",
                     "--mesh", "1x2", "--replicas", "2"])
