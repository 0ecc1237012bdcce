"""The port's sharded training (``runtime/placement.py``, the placement
half of ``runtime/sharding.py``, ``models/common.spec_tree``,
``launch/mesh.make_debug_mesh``, ``optim/compression.py``,
``runtime/elastic.py``, ``Checkpointer.restore(shardings=)`` and the LMs'
``sequence_parallel``) against the JAX package, on one CPU process group
of 4 ranks over Gloo, a ("data", "model") mesh of (2 x 2).

The group runs once for the module (``torch_train_worker.train_group``,
one torch thread a rank), started on a thread while this process builds
the references:

* the DiT step at modes 0 and 1 (``tiny_dit_cfg`` flexified, profile
  ``fsdp2d`` forced), gemma2 with ``sequence_parallel`` (profile
  ``fsdp2d_sp``, remat "block") and deepseek-moe with its aux losses
  (``fsdp2d``), and gemma2 again through the microbatched step
  (``n_microbatches=2``, each data rank's 2 rows in 2 slices), all
  reduced and float32, fed the JAX package's draws: the
  loss (1e-5 relative), the aux losses (1e-5) and every gathered gradient
  leaf (1e-5 of its norm) against ``jax.value_and_grad`` of the
  reference's single-device loss; two whole steps against the port's
  single-device steps: the AdamW moments (each leaf within 1e-5 of its
  norm, where Adam's sign-like first update cannot hide a gradient off in
  scale) and the parameters where the gradient is not ~0 (1e-5 of their
  norm; ``GRAD_FLOOR`` says why there, and why not the update);
* four planted faults, each over its limit: ``global_norm`` over local
  chunks, the sequence-parallel gather's backward as a sum, a per-rank
  ``load_balance``, a data-axis gradient left unsummed;
* the LoRA distillation step (``tiny_dit_cfg`` flexified with rank-4
  LoRAs) and the MMD fine-tune step (the bootstrap's statistic over the
  global batch, its targets the global batch reversed), fed the port's
  own draws of the global batch: the loss (1e-5 relative) and every
  gathered gradient leaf (1e-5 of its norm) against the port's
  single-device step on the global batch, and a planted per-rank mean
  (per-rank MMD statistic and targets) over 1e-3;
* the collectives of the DiT step at mode 0 counted on every rank, by
  kind and operand bytes, against the planner's ledger
  (``launch/dryrun.plan_step`` on the (2 x 2) mesh shape);
* ``compressed_psum`` against the reference's under ``jax.vmap`` with an
  axis name (equal exactly), the elastic save on (2 x 2) and restore on
  the (1 x 2) sub-mesh of ranks 0-1 (every chunk equal exactly, a step
  there against the uninterrupted one at 1e-5), a checkpoint written by
  the JAX package placed on (2 x 2), and the resident bytes per rank
  against the spec arithmetic.

Host arithmetic (``spec_tree``, ``rules_for``, ``placements``,
``compress_decompress``) is held equal to the reference for every
config's schema x profile x mesh layout.
"""
import dataclasses
import math
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_threads import one_torch_thread  # noqa: F401

import torch_train_worker as worker
from repro import configs as jcfgs
from repro.checkpoint.checkpointer import Checkpointer as JCheckpointer
from repro.data import pipeline as jdp
from repro.diffusion import schedule as jsch
from repro.models import common as jcommon
from repro.models import dit as jdit
from repro.models import lm as jlm
from repro.optim import compression as jcomp
from repro.runtime import sharding as jshard
from repro_torch import configs as tcfgs
from repro_torch import convert
from repro_torch.configs import base as tbase
from repro_torch.configs.base import TrainConfig
from repro_torch.core import distill as tdistill
from repro_torch.core import mmd as tmmd
from repro_torch.diffusion import schedule as tsch
from repro_torch.launch import dryrun as tdryrun
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import steps as tsteps
from repro_torch.models import common as tcommon
from repro_torch.models import dit as tdit
from repro_torch.models import lm as tlm
from repro_torch.optim import adamw as tadamw
from repro_torch.optim import compression as tcomp
from repro_torch.runtime import placement as tplace
from repro_torch.runtime import sharding as tshard
from torch_train_refs import B, TC, ref_dit_draws, trained_like

TOL = 1e-5
# Parameters after a step, port against port, are compared where the
# first step's gradient is not ~0: |g| >= GRAD_FLOOR x the leaf's norm of
# the reference's gradient. Adam's update is lr · m̂ / (sqrt(v̂) + eps), a
# sign function of g where |g| >> eps; where |g| is ~0 (a dead unit's
# bias: 1e-11 against eps 1e-8) a difference of 1e-6 in g moves the
# update by 1e-3 of itself. The update itself is not compared: the
# parameter rounds to float32 after it, so two runs whose updates differ
# in the last bits give updates 1-3e-5 apart. The AdamW moments carry the
# gradients (m is 0.1 g after a step) with neither effect: they are held
# whole, each leaf within 1e-5 of its norm.
GRAD_FLOOR = 1e-3
LM_B, LM_S = 2, 40                # S past the reduced window (32)
PROFILES = ("fsdp2d", "fsdp2d_sp", "tp_only", "dp")
LAYOUTS = {"16x16": (("data", "model"), (16, 16)),
           "2x16x16": (("pod", "data", "model"), (2, 16, 16)),
           "2x2": (("data", "model"), (2, 2)),
           "3x1": (("data", "model"), (3, 1))}
GROUP_TIMEOUT_S = 240.0


def port_cfg(jcfg):
    """The JAX package's DiT ModelConfig as the port's (same fields)."""
    kw = {f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg)}
    kw["attn"] = tbase.AttnConfig(**dataclasses.asdict(jcfg.attn))
    kw["dit"] = tbase.DiTConfig(**dataclasses.asdict(jcfg.dit))
    return tbase.ModelConfig(**kw)


def fill_zero_leaves(tree, rng):
    """Every all-zero leaf gets small draws, so no path multiplies by 0."""
    def one(x):
        x = np.asarray(x)
        if not np.any(x):
            return (0.1 * rng.standard_normal(x.shape)).astype(x.dtype)
        return x
    return jax.tree.map(one, tree)


def rel(got, want):
    return float(np.linalg.norm(np.asarray(got, np.float64) - want)
                 / max(np.linalg.norm(np.asarray(want, np.float64)), 1e-30))


def flat(tree):
    """{path: numpy leaf} of a port or reference tree."""
    return dict(jax.tree_util.tree_leaves_with_path(
        jax.tree.map(np.asarray, tree)))


# ---------------------------------------------------------------------------
# Host arithmetic: spec trees, rules, placements, compression


class _JMesh:
    """Axis names and sizes the reference's rules read (``devices.shape``)."""
    def __init__(self, names, shape):
        self.axis_names = names
        self.devices = np.empty(shape)


def _schemas(name):
    jc, tc = jcfgs.get_config(name), tcfgs.get_config(name)
    if jc.family == "dit":
        return jc, tc, jdit.dit_schema(jc), tdit.dit_schema(tc)
    return jc, tc, jlm.lm_schema(jc), tlm.lm_schema(tc)


@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("name", sorted(jcfgs.REGISTRY))
def test_spec_tree_and_rules_equal_reference(name, layout):
    names, shape = LAYOUTS[layout]
    jm, tm = _JMesh(names, shape), tshard.AxisLayout(names, shape)
    jc, tc, js, ts = _schemas(name)
    for profile in PROFILES:
        jr, tr = jshard.rules_for(jc, jm, profile), tshard.rules_for(tc, tm, profile)
        assert tr == jr
        want = jax.tree.leaves(
            jcommon.spec_tree(js, jr, jshard.axis_sizes(jm)),
            is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
        got = tcommon.tree_leaves(tcommon.spec_tree(ts, tr, tshard.axis_sizes(tm)))
        assert [tuple(w) for w in want] == got, (name, profile)
        # each spec's placements name the dims it shards, one per mesh dim
        for spec in got:
            pl = tshard.placements(tm, spec)
            back = [[] for _ in spec]
            for i, p in enumerate(pl):
                if p.is_shard():
                    back[p.dim].append(names[i])
            assert [tuple(b) for b in back] == [tshard.entry_axes(e) for e in spec]


def test_named_shard_tree_constrain_without_mesh():
    layout = tshard.AxisLayout(("data", "model"), (2, 2))
    specs = {"a": (None, "model"), "b": {"c": (("data",), None)}}
    tree = tshard.shard_tree(layout, specs)
    assert tree["b"]["c"] == tshard.named(layout, (("data",), None))
    assert [str(p) for p in tree["a"].placements] == ["R", "S(1)"]
    x = torch.ones(2, 4)
    assert tshard.constrain(x, (("pod", "data"), "model")) is x
    assert tshard.gather_layout(x, (None, "model")) is x
    assert tshard.data_mean(x) is x and tshard.data_sum(x) is x
    with pytest.raises(ValueError, match="names axis"):
        tshard.placements(layout, ("seq",))
    with pytest.raises(ValueError, match="does not divide"):
        tplace.take_rows({"x": torch.zeros(3, 2)}, 3, layout)
    spec = tcommon.spec_tree(tlm.lm_schema(tcfgs.get_config("gemma2-9b")),
                             tshard.rules_for(tcfgs.get_config("gemma2-9b"),
                                              layout, "fsdp2d"),
                             tshard.axis_sizes(layout))
    meta = tcommon.abstract_tree(tlm.lm_schema(tcfgs.get_config("gemma2-9b")),
                                 torch.bfloat16)
    assert meta["embed"].device.type == "meta"
    assert tplace.shard_shape(meta["embed"].shape, spec["embed"],
                              tshard.axis_sizes(layout)) == (128000, 1792)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_compress_decompress_matches_reference(dtype):
    rng = np.random.default_rng(3)
    shapes = {"a": (33, 7), "b": {"c": (129,)}}
    grads = [jax.tree.map(lambda s: rng.standard_normal(s).astype(np.float32)
                          * 1e-2, shapes, is_leaf=lambda x: isinstance(x, tuple))
             for _ in range(3)]
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    j_ef = jcomp.init_error_feedback(jax.tree.map(
        lambda g: jnp.asarray(g, jdt), grads[0]))
    t_ef = tcomp.init_error_feedback(jax.tree.map(
        lambda g: torch.from_numpy(g).to(tdt), grads[0]))
    for g in grads:         # three rounds of error feedback
        j_deq, j_ef = jcomp.compress_decompress(
            jax.tree.map(lambda a: jnp.asarray(a, jdt), g), j_ef)
        t_deq, t_ef = tcomp.compress_decompress(
            jax.tree.map(lambda a: torch.from_numpy(a).to(tdt), g), t_ef)
        for want, got in ((j_deq, t_deq), (j_ef, t_ef)):
            w = flat(jax.tree.map(lambda a: np.asarray(a, np.float32), want))
            t = flat(jax.tree.map(lambda a: a.float().numpy(), got))
            assert w.keys() == t.keys()
            for k in w:
                np.testing.assert_array_equal(t[k], w[k])
        assert all(x.dtype == tdt for x in tcommon.tree_leaves(t_deq))


# ---------------------------------------------------------------------------
# The rank group and the references


def _dit_case(shared, batch, mode):
    jp, jcfg = shared
    draws = []
    for i in range(2):
        t, noise = ref_dit_draws(jax.random.PRNGKey(7 + mode + 10 * i),
                                 jnp.asarray(batch["x0"]), 1000)
        draws.append({"t": np.asarray(t), "noise": np.asarray(noise)})
    return dict(name=f"dit{mode}", cfg=port_cfg(jcfg), jcfg=jcfg, mode=mode,
                params=jax.tree.map(np.asarray, jp), batch=batch,
                draws=draws, tc=TC, profile="fsdp2d",
                faults=("norm_local", "unsummed") if mode == 0 else ())


def _numpy(tree):
    if isinstance(tree, dict):
        return {k: _numpy(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_numpy(v) for v in tree]
    return tree.numpy()


def _recipe_case(kind, model, batch, seed):
    """The distillation or MMD fine-tune step on the (2 x 2) mesh, fed the
    port's draws of the global batch: gradients only (no whole steps)."""
    jp, jcfg = model
    cfg = port_cfg(jcfg)
    make = {"distill": tdistill.make_distill_step,
            "mmd": tmmd.make_mmd_finetune_step}[kind]
    step = make(cfg, TrainConfig(**TC), tsch.linear_schedule(1000))
    tb = {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}
    draws = _numpy(step.draw(tb, torch.Generator().manual_seed(seed)))
    return dict(name=kind, kind=kind, cfg=cfg, jcfg=jcfg,
                params=jax.tree.map(np.asarray, jp), batch=batch,
                draws=[draws], tc=TC, profile="fsdp2d", faults=("per_rank",),
                steps=0)


def _recipe_reference(case):
    """The port's single-device ((loss, metrics), grads) on the global
    batch (the single-device recipes equal the JAX package's:
    ``tests/test_torch_train.py``, ``tests/test_torch_mmd.py``)."""
    import torch_train_worker as w
    params = convert.params_from_numpy(case["params"], device="cpu")
    (loss, m), g = w._step(case).grads(params, w._torch(case["batch"]),
                                       **w._draws(case["draws"][0]))
    return (float(loss), {k: float(v) for k, v in m.items()},
            flat(convert.tree_to_numpy(g)))


def _lm_case(arch, profile, faults, name=None, B=LM_B, n_microbatches=1,
             **over):
    jcfg = dataclasses.replace(jcfgs.get_config(arch).reduced(), **over)
    tcfg = dataclasses.replace(tcfgs.get_config(arch).reduced(), **over)
    rng = np.random.default_rng(len(arch))
    params = fill_zero_leaves(jax.tree.map(
        np.asarray, jlm.init_params(jcfg, jax.random.PRNGKey(3))), rng)
    rng = np.random.default_rng(5)
    batch = {k: rng.integers(0, jcfg.vocab_size, (B, LM_S), dtype=np.int32)
             for k in ("tokens", "targets")}
    return dict(name=name or arch, cfg=tcfg, jcfg=jcfg, params=params,
                batch=batch, draws=[None, None], tc=TC, profile=profile,
                faults=faults, n_microbatches=n_microbatches)


def _reference(case):
    """The JAX package's single-device ((loss, metrics), grads)."""
    jp = jax.tree.map(jnp.asarray, case["params"])
    b = {k: jnp.asarray(v) for k, v in case["batch"].items()}
    cfg = case["jcfg"]
    if cfg.family == "dit":
        sched = jsch.linear_schedule(1000)
        d = {k: jnp.asarray(v) for k, v in case["draws"][0].items()}

        def loss(p):        # the reference's loss_fn (launch/steps.py:93)
            x_t = jsch.q_sample(sched, b["x0"], d["t"], d["noise"])
            out = jdit.dit_forward(p, x_t, d["t"], b["cond"], cfg,
                                   mode=case["mode"])
            eps = jdit.eps_prediction(out, cfg)
            loss = jnp.mean(jnp.square(eps - d["noise"]))
            return loss, {"loss": loss}
    else:
        def loss(p):
            return jlm.lm_loss(p, b, cfg)
    (l, m), g = jax.jit(jax.value_and_grad(loss, has_aux=True))(jp)
    return float(l), {k: float(v) for k, v in m.items()}, flat(g)


def _single_device(case):
    """The port's two single-device steps: the parameters after each and
    the first step's metrics."""
    cfg, tc = case["cfg"], TrainConfig(**case["tc"])
    if cfg.family == "dit":
        params = convert.params_from_numpy(case["params"], device="cpu")
        step = tsteps.make_dit_train_step(cfg, tc, tsch.linear_schedule(1000),
                                          mode=case["mode"])
    else:
        params = convert.lm_params_from_numpy(case["params"], cfg, device="cpu")
        step = tsteps.make_train_step(
            cfg, tc, n_microbatches=case.get("n_microbatches", 1))
    opt = tadamw.init_opt_state(params)
    batch = {k: torch.from_numpy(np.array(v)) for k, v in case["batch"].items()}
    out = []
    for d in case["draws"]:
        draws = {k: torch.from_numpy(np.array(v)) for k, v in (d or {}).items()}
        params, opt, m = step.with_draws(params, opt, batch, **draws)
        out.append({"params": flat(convert.tree_to_numpy(params)),
                    "metrics": {k: float(v) for k, v in m.items()}})
    out[-1]["moments"] = flat(convert.tree_to_numpy({"m": opt["m"],
                                                     "v": opt["v"]}))
    return out


@pytest.fixture(scope="module")
def run(tiny_dit_cfg, tmp_path_factory):
    """The job, the group's results (one dict per rank) and the
    references, built while the ranks run."""
    shared = trained_like(tiny_dit_cfg, 0)
    make = jdp.make_dit_batch_fn(tiny_dit_cfg.dit.latent_shape,
                                 tiny_dit_cfg.dit.num_classes, B)
    batch = {k: np.asarray(v) for k, v in
             make(0, 0, 1, np.random.default_rng(0)).items()}
    cases = [dict(_dit_case(shared, batch, 0), count_collectives=True),
             _dit_case(shared, batch, 1),
             _lm_case("gemma2-9b", "fsdp2d_sp", ("sp_sum",),
                      sequence_parallel=True, remat="block"),
             _lm_case("deepseek-moe-16b", "fsdp2d", ("lb_per_rank",)),
             # the microbatched LM step (launch/steps._MicrobatchedStep):
             # 2 slices of each data rank's 2 rows
             _lm_case("gemma2-9b", "fsdp2d", (), name="gemma2-9b-mb2", B=4,
                      n_microbatches=2),
             _recipe_case("distill", trained_like(tiny_dit_cfg, 1, lora_rank=4),
                          batch, 21),
             _recipe_case("mmd", shared, batch, 22)]
    rng = np.random.default_rng(11)
    psum = {"float32": rng.standard_normal((4, 1000)).astype(np.float32),
            "bfloat16": rng.standard_normal((4, 1000)).astype(np.float32)}
    psum["bfloat16"] = np.asarray(jnp.asarray(psum["bfloat16"], jnp.bfloat16)
                                  .astype(jnp.float32))
    tmp = tmp_path_factory.mktemp("sharded")
    jax_ckpt = tmp / "jax"
    JCheckpointer(jax_ckpt, async_save=False).save(
        3, {"params": jax.tree.map(jnp.asarray, cases[0]["params"])})
    job = dict(cases=[{k: v for k, v in c.items() if k != "jcfg"}
                      for c in cases],
               psum=psum, elastic_case="dit0", ckpt_dir=str(tmp / "ckpt"),
               jax_ckpt_dir=str(jax_ckpt))
    box = {}

    def ranks():
        try:
            box["res"] = tmesh.run_ranks(worker.train_group, 4, backend="gloo",
                                         device="cpu", threads=1,
                                         timeout_s=GROUP_TIMEOUT_S, args=(job,))
        except BaseException as e:        # re-raised in the test process
            box["err"] = e
    th = threading.Thread(target=ranks)
    th.start()
    try:
        refs = {c["name"]: (_recipe_reference(c) if c.get("kind")
                            else _reference(c)) for c in cases}
        single = {c["name"]: _single_device(c) for c in cases
                  if c.get("steps", 2)}
    finally:
        th.join()
    if "err" in box:
        raise box["err"]
    return dict(cases={c["name"]: c for c in cases}, res=box["res"],
                refs=refs, single=single, psum=psum)


def _check_grads(got, want):
    assert got.keys() == want.keys()
    for path, w in want.items():
        err = np.abs(got[path] - w).max()
        assert err <= TOL * np.linalg.norm(w), (path, err)


# ---------------------------------------------------------------------------
# Sharded steps against the JAX package and against single-device


@pytest.mark.parametrize("name", ["dit0", "dit1", "gemma2-9b",
                                  "deepseek-moe-16b", "gemma2-9b-mb2"])
def test_sharded_loss_and_grads_match_reference(run, name):
    r0 = run["res"][0][name]
    jl, jm, jg = run["refs"][name]
    np.testing.assert_allclose(r0["loss"], jl, rtol=TOL, atol=0)
    assert sorted(r0["metrics"]) == sorted(jm)
    # a microbatched step reports its last slice's metrics (as the
    # reference's does), and a data rank's slice holds other rows than a
    # single device's: only the accumulated loss and gradients compare
    if run["cases"][name].get("n_microbatches", 1) == 1:
        for k, v in jm.items():          # the MoE aux losses among them
            np.testing.assert_allclose(r0["metrics"][k], v, rtol=TOL,
                                       atol=TOL)
    _check_grads(flat(r0["grads"]), jg)


@pytest.mark.parametrize("name", ["dit0", "dit1", "gemma2-9b",
                                  "deepseek-moe-16b", "gemma2-9b-mb2"])
def test_sharded_steps_equal_single_device(run, name):
    """Two whole steps against the port's single-device steps: the AdamW
    moments after them (each leaf within 1e-5 of its norm), the
    parameters after each where the gradient is not ~0 (``GRAD_FLOOR``;
    within 1e-5 of their norm) and the grad norms (1e-5)."""
    res, single = run["res"][0][name], run["single"][name]
    live = {k: np.abs(g) >= GRAD_FLOOR * np.linalg.norm(g)
            for k, g in run["refs"][name][2].items()}
    for got, want in zip(res["steps"], single):
        g = flat(got["params"])
        assert g.keys() == want["params"].keys()
        for k, w in want["params"].items():
            err = rel(g[k][live[k]], w[live[k]])
            assert err <= TOL, (name, k, err)
        np.testing.assert_allclose(got["metrics"]["grad_norm"],
                                   want["metrics"]["grad_norm"], rtol=TOL)
    got_m, want_m = flat(res["moments"]), single[-1]["moments"]
    assert got_m.keys() == want_m.keys()
    for k, w in want_m.items():
        assert rel(got_m[k], w) <= TOL, (name, k, rel(got_m[k], w))


@pytest.mark.parametrize("name", ["distill", "mmd"])
def test_sharded_recipe_matches_single_device(run, name):
    """Distillation and the MMD fine-tune on placed parameters: the loss
    and its parts (1e-5 relative) and every gathered gradient leaf (1e-5
    of its norm) equal the single-device step on the global batch."""
    r0 = run["res"][0][name]
    want_l, want_m, want_g = run["refs"][name]
    np.testing.assert_allclose(r0["loss"], want_l, rtol=TOL, atol=0)
    assert sorted(r0["metrics"]) == sorted(want_m)
    for k, v in want_m.items():
        np.testing.assert_allclose(r0["metrics"][k], v, rtol=TOL, atol=0)
    _check_grads(flat(r0["grads"]), want_g)


def test_collective_bytes_equal_planner(run):
    """The DiT step at mode 0 (gradients and AdamW) on (2 x 2): every rank
    calls the collectives the planner's ledger records on the mesh shape,
    kind by kind, with the same operand bytes."""
    case = run["cases"]["dit0"]
    layout = tshard.AxisLayout(("data", "model"), (2, 2))
    plan = tdryrun.plan_step(case["cfg"], "train_base", layout, "fsdp2d",
                             batch=B)
    want = {k: {"count": v["count"], "operand_bytes": v["operand_bytes"]}
            for k, v in plan["collectives"].items() if v["count"]}
    assert set(want) == {"all-gather", "reduce-scatter", "all-reduce"}
    for r in run["res"]:
        assert r["dit0"]["collectives"] == want


@pytest.mark.parametrize("fault,name", [
    ("norm_local", "dit0"), ("unsummed", "dit0"), ("sp_sum", "gemma2-9b"),
    ("lb_per_rank", "deepseek-moe-16b"), ("per_rank", "distill"),
    ("per_rank", "mmd")])
def test_planted_faults_read_over_the_limit(run, fault, name):
    got = run["res"][0][name][fault]
    jl, jm, jg = run["refs"][name]
    if fault == "norm_local":
        read = rel(got, run["single"][name][0]["metrics"]["grad_norm"])
    elif fault == "lb_per_rank":
        read = rel(got["metrics"]["load_balance"], jm["load_balance"])
    else:
        g = flat(got["grads"])
        read = max(rel(g[k], w) for k, w in jg.items())
    assert read > 100 * TOL, (fault, read)


def test_resident_bytes_equal_spec_arithmetic(run):
    """Parameters and AdamW moments: each rank's local bytes, summed over
    the ranks, equal the spec arithmetic over the (2 x 2) mesh."""
    layout = tshard.AxisLayout(("data", "model"), (2, 2))
    sizes = tshard.axis_sizes(layout)
    for name, case in run["cases"].items():
        cfg = case["cfg"]
        schema = tdit.dit_schema(cfg) if cfg.family == "dit" else tlm.lm_schema(cfg)
        specs = tcommon.spec_tree(schema, tshard.rules_for(cfg, layout,
                                                           case["profile"]), sizes)
        per_rank = sum(math.prod(tplace.shard_shape(s.shape, sp, sizes))
                       for s, sp in zip(tcommon.tree_leaves(schema),
                                        tcommon.tree_leaves(specs)))
        got = [r[name]["bytes"] for r in run["res"]]
        assert sum(p for p, _ in got) == 4 * per_rank * 4        # float32
        assert sum(m for _, m in got) == 4 * 2 * per_rank * 4    # m and v
        assert per_rank < tcommon.count_params(schema)           # sharded


# ---------------------------------------------------------------------------
# Collectives, elastic restore


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_compressed_psum_matches_reference(run, dtype):
    g = jnp.asarray(run["psum"][dtype], getattr(jnp, dtype))
    want = np.asarray(jax.vmap(lambda x: jcomp.compressed_psum(x, "i"),
                               axis_name="i")(g).astype(jnp.float32))
    for r in run["res"]:
        np.testing.assert_array_equal(r["psum"][dtype], want[0])


def _chunk(full, where):
    return full[tuple(slice(a, b) for a, b in where)]


def test_elastic_restore_onto_sub_mesh_is_exact(run):
    """Saved on (2 x 2) after a step, restored on (1 x 2) over ranks 0-1:
    every chunk equals its slice of the saved parameters, bit for bit;
    ranks 2-3 are refused."""
    saved = flat(run["res"][0]["dit0"]["steps"][0]["params"])
    for rank, r in enumerate(run["res"]):
        if rank >= 2:
            assert r["elastic"] is None
            continue
        assert r["elastic"]["sub"] == (1, 2)
        assert r["elastic"]["extra"] == {"mesh": "2x2"}
        for path, (loc, where) in flat_chunks(r["elastic"]["chunks"]).items():
            np.testing.assert_array_equal(loc, _chunk(saved[path], where))


def flat_chunks(tree):
    return dict(jax.tree_util.tree_leaves_with_path(
        tree, is_leaf=lambda x: isinstance(x, tuple)))


def test_elastic_step_equals_uninterrupted(run):
    """Step 2 taken on the (1 x 2) sub-mesh from the restored state, against
    the uninterrupted (2 x 2) step 2: the parameters where the gradient is
    not ~0 (``GRAD_FLOOR``), within 1e-5 of their norm."""
    want = flat(run["res"][0]["dit0"]["steps"][1]["params"])
    got = flat(run["res"][0]["elastic"]["step2"])
    assert got.keys() == want.keys()
    for k, g in run["refs"]["dit0"][2].items():
        live = np.abs(g) >= GRAD_FLOOR * np.linalg.norm(g)
        assert rel(got[k][live], want[k][live]) <= TOL, k


def test_jax_checkpoint_restores_placed(run):
    """A checkpoint the JAX package wrote, restored with ``shardings=`` on
    (2 x 2): every rank's chunks equal the reference's leaves' slices."""
    want = flat(run["cases"]["dit0"]["params"])
    for r in run["res"]:
        chunks = flat_chunks(r["from_jax"])
        assert chunks.keys() == want.keys()
        for path, (loc, where) in chunks.items():
            np.testing.assert_array_equal(loc, _chunk(want[path], where))
