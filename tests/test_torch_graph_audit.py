"""The port's graph audit (``repro_torch/analysis/graph_audit.py``, the
counterpart of the JAX package's jaxpr audit) on the CPU.

Each audit unit passes on the port's own step functions, the language
models' prefill and decode bodies included (one tiny config a family);
fixture steps that bake a tensor constant or branch on a device value are
caught, and so are a decode body that reads its position on the host and
an LM step factory whose runner is not captured (or does not donate the
decode's cache); the train steps' captured body (DiT, the LoRA
distillation, the LM with remat over two microbatches) is one graph over
batch contents and draws, a body that reads its loss on the host is
flagged, and so is a train-step factory that runs eagerly or does not
donate the parameters and the optimizer state; the
cached packed step shows the refresh-mask fault that capture would have
turned into wrong answers (the flags baked as a constant differ between
two same-branch patterns; handed in as a tensor they do not) and exactly
two graphs over every pattern of a k=1 layout; and the packed step run
the way the pipeline captures it (its host function outside, the body or
its micro-step inside) still matches the JAX package's
``make_packed_step_fn`` at float32 1e-5 for the uncached, cached and
tapped families (the reference on its plain attention, as
``tests/test_torch_packing.py`` runs it).
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_threads import one_torch_thread  # noqa: F401

from repro.diffusion import schedule as jschedule
from repro.pipeline import packed as jpacked
from repro_torch import convert
from repro_torch.analysis import graph_audit as ga
from repro_torch.core import packing as tpack
from repro_torch.diffusion import schedule as tschedule
from repro_torch.models import dit as tdit
from repro_torch.pipeline import FlexiPipeline
from repro_torch.pipeline import packed as tpacked

jflex = importlib.import_module("repro.core.flexify")

TOL = dict(atol=1e-5, rtol=1e-5)

UNITS = [ga.audit_plain_step, ga.audit_packed_step, ga.audit_packed_cached_step,
         ga.audit_cached_runner, ga.audit_tapped_step,
         ga.audit_attention_segments, ga.audit_runners]


@pytest.mark.parametrize("unit", UNITS, ids=lambda u: u.__name__)
def test_audit_unit_passes_on_the_port(unit):
    rep = unit()
    assert [f.render() for f in rep.findings if f.severity == "error"] == []
    assert all(len(fp) == 32 for fp in rep.fingerprints.values())
    if unit is not ga.audit_runners:
        assert rep.fingerprints


@pytest.mark.parametrize("arch", ga.LM_AUDIT_ARCHS)
def test_lm_audit_unit_passes_on_the_port(arch):
    """The prefill at two token contents and the decode at two positions
    and token contents, on one slot: one graph each, no host read."""
    rep = ga.audit_lm_steps(arch)
    assert [f.render() for f in rep.findings] == []
    assert sorted(rep.fingerprints) == [f"lm_decode[{arch}]",
                                        f"lm_prefill[{arch}]"]
    assert all(len(fp) == 32 for fp in rep.fingerprints.values())


def test_lm_audit_catches_a_host_read_of_the_position():
    """A planted decode body reads ``pos`` on the host (``int(pos[0])``, a
    sync a capture refuses, or a position frozen into the graph): both
    decode cases are flagged, the prefill is not."""
    from repro_torch.models import lm as tlm
    cfg, _ = ga._tiny_lm("gemma2-9b")

    def planted(params, cache, token, pos):
        start = int(pos[0])
        return tlm.decode_step(params, cache, token,
                               torch.full_like(pos, start), cfg)

    rep = ga.audit_lm_steps("gemma2-9b", decode_body=planted)
    assert [(f.rule, f.symbol) for f in rep.findings] == \
        [("graph-host-sync", "lm_decode[gemma2-9b]")] * 2


def test_uncaptured_lm_step_factory_is_flagged():
    """``graph-uncaptured-runner`` over the LM step factories: the port's
    two pass; a factory returning a plain closure is flagged, and so is a
    decode runner that does not donate its cache."""
    from repro_torch.launch import steps as tsteps
    from repro_torch.runtime import graphs
    assert ga.lm_runner_findings() == []

    def closure_factory(cfg):
        def decode_step(params, cache, token, pos):
            return tsteps.lm.decode_step(params, cache, token, pos, cfg)
        return decode_step

    def undonated(cfg):
        return graphs.capture(tsteps.make_decode_step(cfg).fn)

    found = ga.lm_runner_findings({"closure": (closure_factory, (1,)),
                                   "undonated": (undonated, (1,)),
                                   "prefill": (tsteps.make_prefill_step, ())})
    assert [(f.rule, f.symbol) for f in found] == [
        ("graph-uncaptured-runner", "closure"),
        ("graph-uncaptured-runner", "undonated")]
    assert "runtime.graphs" in found[0].message
    assert "donates" in found[1].message


@pytest.mark.parametrize("kind", ga.TRAIN_AUDIT_KINDS)
def test_train_audit_unit_passes_on_the_port(kind):
    """The captured body of a train step (gradients, then AdamW in place)
    at two batch contents and draws: one graph, no host read."""
    with torch.inference_mode(False), torch.no_grad():     # as the CLI runs it
        rep = ga.audit_train_step(kind)
    assert [f.render() for f in rep.findings] == []
    assert list(rep.fingerprints) == [f"train_step[{kind}]"]
    assert len(rep.fingerprints[f"train_step[{kind}]"]) == 32


def test_train_audit_catches_a_host_read_of_the_loss():
    """A planted body logs its loss on the host inside the step (a sync a
    capture refuses): both cases are flagged."""
    from repro_torch.configs.base import TrainConfig
    from repro_torch.launch import steps as tsteps
    _, cfg, sched = ga._tiny()
    step = tsteps.make_dit_train_step(cfg, TrainConfig(), sched, mode=1)

    def planted(params, opt, batch, draws, mask):
        out = step.update(params, opt, batch, draws, mask)
        if float(out[2]["loss"]) > 1e9:
            raise FloatingPointError
        return out

    rep = ga.audit_train_step("dit", update=planted)
    assert [(f.rule, f.symbol) for f in rep.findings
            if f.severity == "error"] == [("graph-host-sync", "train_step[dit]")] * 2


def test_uncaptured_train_step_factory_is_flagged():
    """``graph-uncaptured-runner`` over the train-step factories: the
    port's four pass; a factory whose step runs eagerly, or does not
    donate the parameters and the optimizer state, is flagged."""
    from repro_torch.configs.base import TrainConfig
    from repro_torch.launch import steps as tsteps
    from repro_torch.runtime import graphs
    assert ga.train_runner_findings() == []
    assert sorted(ga._train_factories()) == [
        "make_distill_step", "make_dit_train_step", "make_mmd_finetune_step",
        "make_train_step"]
    _, cfg, sched = ga._tiny()
    step = tsteps.make_dit_train_step(cfg, TrainConfig(), sched)
    planted = {
        "eager": (lambda: graphs.capture(step.update, eager=True,
                                         donate=(0, 1)), ga.LM_STEPS_PATH),
        "closure": (lambda: step.update, ga.LM_STEPS_PATH),
        "state_copied": (lambda: graphs.capture(step.update, donate=(0,)),
                         ga.LM_STEPS_PATH),
        "sound": (lambda: tsteps.make_dit_train_step(cfg, TrainConfig(), sched),
                  ga.LM_STEPS_PATH)}
    found = ga.train_runner_findings(planted)
    assert [(f.rule, f.symbol) for f in found] == [
        ("graph-uncaptured-runner", "eager"),
        ("graph-uncaptured-runner", "closure"),
        ("graph-uncaptured-runner", "state_copied")]
    assert "runtime.graphs" in found[0].message
    assert "(0,)" in found[2].message and "AdamW state" in found[2].message


def test_audit_catches_a_baked_constant_and_a_host_branch():
    x = torch.zeros(4)

    def baked(t_host):
        def step(x, t):       # the timestep baked as a host-built tensor
            return x + torch.from_numpy(np.array([t_host], np.float32)) + t
        return step

    rep = ga._invariant("baked", {"t=1": (baked(1.0), (x, torch.ones(4))),
                                  "t=2": (baked(2.0), (x, torch.ones(4)))},
                        "timesteps")
    assert [f.rule for f in rep.findings] == ["graph-fingerprint-drift"]

    def branchy(x, t):        # a Python branch on a device value
        return x * 2 if bool((t > 50).all()) else x

    rep = ga._invariant("branchy", {"t=90": (branchy, (x, torch.full((4,), 90.))),
                                    "t=10": (branchy, (x, torch.full((4,), 10.)))},
                        "timesteps")
    # make_fx refuses the host read, as a capture would
    assert [f.rule for f in rep.findings] == ["graph-host-sync"] * 2
    # the same values as inputs: one graph
    rep = ga._invariant("clean", {"a": (lambda x, t: x + t, (x, x + 1)),
                                  "b": (lambda x, t: x + t, (x, x + 2))},
                        "values")
    assert rep.findings == []


def _cached_forward(route, refresh):
    """The cached packed forward at one refresh pattern: the flags as host
    numpy (baked into the graph: the fault capture would have frozen) or
    as a device tensor with the host's branch."""
    fparams, fcfg, _ = ga._tiny()
    groups = ((0, 1), (1, 2))
    seg = [(2 * n) for _m, n in groups]
    xs = [torch.zeros((2 * n,) + tuple(fcfg.dit.latent_shape))
          for _m, n in groups]
    ts = [torch.full((2 * n,), 90) for _m, n in groups]
    cs = [torch.zeros(2 * n, dtype=torch.int64) for _m, n in groups]
    deltas = [torch.zeros(s, tdit.tokens_for_mode(fcfg, m), fcfg.d_model)
              for (m, _), s in zip(groups, seg)]
    flags = [np.asarray(f, bool) for f in refresh]
    seg_groups = tuple((m, s) for (m, _), s in zip(groups, seg))
    if route == "host":
        def fwd(params, xs, ts, cs, deltas):
            return tpack.packed_mixed_forward(
                params, fcfg, seg_groups, xs, ts, cs, cache_deltas=deltas,
                cache_refresh=flags, cache_split=1)
        return fwd, (fparams, xs, ts, cs, deltas)

    def fwd(params, xs, ts, cs, deltas, dev_flags):
        return tpack.packed_mixed_forward(
            params, fcfg, seg_groups, xs, ts, cs, cache_deltas=deltas,
            cache_refresh=dev_flags, cache_split=1,
            cache_deep=any(f.any() for f in flags))
    return fwd, (fparams, xs, ts, cs, deltas,
                 [torch.from_numpy(f) for f in flags])


def test_cached_step_repaired_refresh_mask():
    """Two refresh patterns in the deep branch: the per-token mask built
    on the host is a constant of the graph and differs between them (what
    a capture would have replayed for every pattern); handed in as a
    device tensor, one graph serves both."""
    tt = [[True, True], [True, False, True, False]]
    tf = [[True, False], [False, True, True, True]]
    fp = {route: {tag: ga.fingerprint(ga.trace(*_flat(_cached_forward(route, p))))
                  for tag, p in (("TT", tt), ("TF", tf))}
          for route in ("host", "device")}
    assert fp["host"]["TT"] != fp["host"]["TF"]
    assert fp["device"]["TT"] == fp["device"]["TF"]
    # every pattern of a k=1 layout, the deep and the shallow graph only:
    # test_audit_unit_passes_on_the_port[audit_packed_cached_step]


def _flat(fn_args):
    fn, args = fn_args
    return (fn,) + tuple(args)


# ---------------------------------------------------------------------------
# The packed step as the pipeline captures it, against the JAX package


def to_torch(tree):
    return convert.params_from_numpy(jax.tree.map(np.asarray, tree),
                                     device="cpu")


@pytest.fixture(scope="module")
def flexi(tiny_dit_cfg, trained_like_dit):
    fp, fcfg = jflex.flexify(trained_like_dit, tiny_dit_cfg, [(1, 4, 4)])
    key = jax.random.PRNGKey(21)
    fp["ps_embed"] = jax.random.normal(key, fp["ps_embed"].shape) * 0.1
    return fp, fcfg, to_torch(fp)


@pytest.mark.parametrize("split,taps", [(None, False), (1, False),
                                        (None, True), (1, True)])
def test_pipeline_packed_step_matches_reference(flexi, split, taps):
    fp, fcfg, tp = flexi
    k = 2
    layout = jpacked.PackLayout.for_counts({0: 1, 1: 2})
    tlayout = tpacked.PackLayout.for_counts({0: 1, 1: 2})
    js, ts_ = jschedule.linear_schedule(100), tschedule.linear_schedule(100)
    pipe = FlexiPipeline(tp, fcfg, ts_, device="cpu")
    rng = np.random.default_rng(5)
    xs, metas = [], []
    for m, n in layout.groups:
        xs.append(rng.standard_normal((n,) + fcfg.dit.latent_shape)
                  .astype(np.float32))
        meta = np.zeros((k, 3, n), np.int32)
        start = rng.integers(k + 1, 99, n)
        for j in range(k):
            meta[j, 0] = start - 10 * j
            meta[j, 1] = start - 10 * (j + 1)
        meta[:, 2] = rng.integers(0, fcfg.dit.num_classes, n)
        metas.append(meta)
    kw = dict(guidance_scale=1.5, k_steps=k, cache_split=split)
    jstep = jax.jit(jpacked.make_packed_step_fn(
        fcfg, js, layout, attn_backend="dense", taps=taps, **kw))
    runner = pipe.packed_step(tlayout, taps=taps, **kw)
    J, T = jnp.asarray, torch.from_numpy
    keys = [jnp.zeros((k, n, 2), jnp.uint32) for _m, n in layout.groups]
    args_j = [[J(x) for x in xs], [J(m) for m in metas], keys]
    args_t = [[T(x) for x in xs], [T(m) for m in metas], None]
    if split is not None:
        deltas = [(rng.standard_normal((n, 2, tdit.tokens_for_mode(fcfg, m),
                                        fcfg.d_model)) * 0.1).astype(np.float32)
                  for m, n in layout.groups]
        refresh = [np.array([[True] * n, [False] * n]) for _m, n in
                   layout.groups]
        refresh[1][1, 0] = True       # a mixed pattern on the second step
        args_j += [[J(d) for d in deltas], [J(r) for r in refresh]]
        args_t += [[T(d) for d in deltas], refresh]
    want = jstep(fp, *args_j)
    got = runner(tp, *args_t)
    if not (split is not None or taps):
        want, got = (want,), (got,)
    for g_grp, w_grp in zip(got[:1 + (split is not None)],
                            want[:1 + (split is not None)]):
        for g, w in zip(g_grp, w_grp):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)
    if taps:
        g_tap, w_tap = got[-1], want[-1]
        assert tuple(g_tap["attn_blocks"]) == tuple(
            int(v) for v in w_tap["attn_blocks"])
        names = ("eps_norm", "finite") + (("drift",) if split else ())
        for name in names:
            for g, w in zip(g_tap[name], w_tap[name]):
                np.testing.assert_allclose(g.float().numpy(),
                                           np.asarray(w, np.float32), **TOL)
    assert pipe.cache_stats()["captured"] == 0        # the CPU runs eagerly
