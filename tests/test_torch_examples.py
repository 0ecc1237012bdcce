"""The port's examples on the CPU, held against the JAX package.

``examples/torch_quickstart.py``, ``torch_flexify_lora_t2i.py`` and
``torch_cached_sampling.py`` each run once a module (short steps), and
what they fix once their weights and ``x_T`` are given is run again
through the JAX package: the plans, the FLOPs ledger, merged and unmerged
forwards, sampled x0. The training runs themselves draw from
``torch.Generator`` (the reference folds threefry keys), so they are not
compared. ``torch_serve_llm.py`` and ``torch_distributed_sampling.py``
run as their command lines do.

Tolerances (ROADMAP): float32 1e-5 per module (a forward, a merge), 1e-4
end to end (a whole sampled x0); relative compute, FLOPs, the cache
ledger, solved schedules and runner counts are host arithmetic or
counters: equal exactly. The FID proxy's copy in the quickstart is the
same numpy code as ``benchmarks/common.py``'s: equal exactly.
"""
import ast
import contextlib
import dataclasses
import importlib
import io
import os
import re
import runpy
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from torch_threads import one_torch_thread  # noqa: F401

from repro.cache import CacheSpec as JCacheSpec
from repro.cache import cache_savings as j_cache_savings
from repro.configs import base as jbase
from repro.core.scheduler import FlexiSchedule as JSchedule
from repro.core.scheduler import dit_nfe_flops as j_nfe_flops
from repro.core.scheduler import lora_nfe_overhead as j_lora_overhead
from repro.diffusion import schedule as jschedule
from repro.models import dit as jdit
from repro.pipeline import FlexiPipeline as JPipeline
from repro.pipeline import SamplingPlan as JPlan
from repro_torch import convert
from repro_torch.core import merge_lora

jflex = importlib.import_module("repro.core.flexify")

ROOT = Path(__file__).resolve().parents[1]
EXAMPLES = ROOT / "examples"
MODULE_TOL = dict(atol=1e-5, rtol=1e-5)
E2E_TOL = dict(atol=1e-4, rtol=1e-4)


def jax_cfg(cfg):
    """The port's config (the same frozen dataclasses, field for field) as
    the JAX package's."""
    if dataclasses.is_dataclass(cfg):
        cls = getattr(jbase, type(cfg).__name__)
        return cls(**{f.name: jax_cfg(getattr(cfg, f.name))
                      for f in dataclasses.fields(cfg)})
    return cfg


def jax_tree(tree):
    return jax.tree.map(jnp.asarray, tree)


def jax_budget(budget):
    return JSchedule(budget.phases) if hasattr(budget, "phases") else budget


def run_example(name: str, argv: list):
    """``main(argv)`` of an example, with what it printed."""
    mod = runpy.run_path(str(EXAMPLES / name))
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        res = mod["main"](argv)
    return res, out.getvalue()


# ---------------------------------------------------------------------------
# torch_quickstart.py


@pytest.fixture(scope="module")
def quickstart():
    res, text = run_example("torch_quickstart.py",
                            ["--steps", "40", "--sample-T", "8",
                             "--device", "cpu"])
    jcfg = jax_cfg(res["cfg"])
    pipe = JPipeline(jax_tree(res["params"]), jcfg,
                     jschedule.linear_schedule(100))
    x_T = jnp.asarray(res["x_T"])
    ref = [pipe.sample(JPlan(T=res["T"], budget=jax_budget(r["budget"]),
                             guidance_scale=1.5),
                       len(x_T), jax.random.PRNGKey(42), x_T=x_T)
           for r in res["rows"]]
    return res, text, jcfg, ref, pipe.cache_stats()


def test_quickstart_plans_match_reference(quickstart):
    """Each plan's relative compute, FLOPs and schedule (the budget-0.6
    one solved by the plan) equal the JAX package's exactly, and the
    printed table carries them."""
    res, text, jcfg, ref, _ = quickstart
    T = res["T"]
    assert [r["T_weak"] for r in res["rows"][:3]] == [0, T // 2, 3 * T // 4]
    for row, want in zip(res["rows"], ref):
        assert row["phases"] == want.trace["schedule"].phases
        assert row["relative_compute"] == want.relative_compute
        assert row["flops"] == want.flops
        assert f"compute={row['relative_compute'] * 100:5.1f}%" in text
    solved = JPlan(T=T, budget=0.6, guidance_scale=1.5).resolve_schedule(jcfg)
    assert res["rows"][3]["phases"] == solved.phases
    assert f"budget=0.60 → T_weak={solved.phases[0][1]}/{T}" in text


def test_quickstart_x0_matches_reference(quickstart):
    """With the example's final weights carried across, the JAX pipeline
    on the same ``x_T`` gives each plan's x0 within 1e-4 of the port's,
    after building as many runners."""
    res, _, _, ref, jstats = quickstart
    for row, want in zip(res["rows"], ref):
        np.testing.assert_allclose(row["x0"], np.asarray(want.x0), **E2E_TOL)
    assert res["stats"]["compiled"] == jstats["compiled"]


def test_quickstart_fid_copy_equals_benchmarks(quickstart):
    """The example's numpy copy of the FID proxy and its reference set
    equal ``benchmarks/common.py``'s exactly on the same arrays."""
    sys.path.insert(0, str(ROOT))
    try:
        common = importlib.import_module("benchmarks.common")
    finally:
        sys.path.remove(str(ROOT))
    mod = runpy.run_path(str(EXAMPLES / "torch_quickstart.py"))
    res = quickstart[0]
    ref, labels = mod["reference_set"](128)
    want_ref, want_labels = common.reference_set(128, latent=mod["LATENT"])
    assert np.array_equal(ref, want_ref) and np.array_equal(labels, want_labels)
    assert np.array_equal(res["reference"], want_ref)
    assert mod["N_CLASSES"] == common.N_CLASSES
    for row in res["rows"]:
        assert np.array_equal(mod["features"](row["x0"]),
                              common.features(row["x0"]))
        assert row["fid"] == common.fid_proxy(row["x0"], want_ref)
        assert np.isfinite(row["fid"])


# ---------------------------------------------------------------------------
# torch_flexify_lora_t2i.py


@pytest.fixture(scope="module")
def lora():
    res, text = run_example("torch_flexify_lora_t2i.py",
                            ["--pretrain-steps", "20", "--distill-steps", "10",
                             "--device", "cpu"])
    return res, text, jax_cfg(res["cfg"])


def test_lora_mode0_exact_and_frozen_leaves_unchanged(lora):
    """Mode 0 of the flexified tree equals the pre-trained forward bit for
    bit, and distillation writes no leaf outside the LoRA mask."""
    res, text, _ = lora
    assert res["mode0_delta"] == 0.0
    assert "mode-0 bit-exactness: max|Δ| = 0.00e+00" in text
    flat = lambda tree: jax.tree_util.tree_flatten_with_path(tree)[0]  # noqa: E731
    mask = dict(flat(res["mask"]))
    start, end = dict(flat(res["start"])), dict(flat(res["params"]))
    assert mask.keys() == start.keys() == end.keys()
    frozen = [p for p, on in mask.items() if not on]
    moved = [p for p, on in mask.items()
             if on and not np.array_equal(start[p], end[p])]
    assert frozen and moved
    for p in frozen:
        assert np.array_equal(start[p], end[p]), jax.tree_util.keystr(p)
    assert all(np.isfinite(l) for l in res["losses"])


def test_lora_merge_and_forwards_match_reference(lora):
    """The JAX ``merge_lora`` and ``dit_forward(mode=1)``, merged and
    unmerged, on the port's distilled weights match the port's within
    1e-5."""
    res, _, jcfg = lora
    jp = jax_tree(res["params"])
    jmerged = jflex.merge_lora(jp, jcfg, 1)
    tmerged = convert.tree_to_numpy(merge_lora(
        convert.params_from_numpy(res["params"], device="cpu"), res["cfg"], 1))
    got = dict(jax.tree_util.tree_flatten_with_path(tmerged)[0])
    for path, want in jax.tree_util.tree_flatten_with_path(jmerged)[0]:
        np.testing.assert_allclose(got[path], np.asarray(want), **MODULE_TOL)
    fw = res["forward"]
    args = [jnp.asarray(fw[k]) for k in ("x", "t", "cond")]
    for tree, key in ((jp, "unmerged"), (jmerged, "merged")):
        want = jdit.dit_forward(tree, *args, jcfg, mode=1)
        np.testing.assert_allclose(fw[key], np.asarray(want), **MODULE_TOL)


def test_lora_flops_and_samples_match_reference(lora):
    """The overhead percentage and both samples' FLOPs equal the JAX
    package's exactly; the unmerged sample costs the merged one plus the
    weak NFEs' LoRA overhead; each sampled x0 is within 1e-4 of the JAX
    pipeline's on the same ``x_T`` and text."""
    res, text, jcfg = lora
    want_pct = 100 * j_lora_overhead(jcfg, 1) / j_nfe_flops(jcfg, 1)
    assert res["overhead_pct"] == want_pct
    assert f"overhead per NFE: {want_pct:.2f}%" in text
    pipe = JPipeline(jax_tree(res["params"]), jcfg,
                     jschedule.linear_schedule(100))
    T, n = res["T"], len(res["x_T"])
    for variant in ("unmerged", "merged"):
        plan = JPlan(T=T, budget=JSchedule.weak_first(T, res["T_weak"]),
                     guidance_scale=1.5, lora=variant)
        want = pipe.sample(plan, n, jax.random.PRNGKey(17),
                           cond=jnp.asarray(res["cond"]),
                           x_T=jnp.asarray(res["x_T"]))
        assert res[variant]["flops"] == want.flops
        np.testing.assert_allclose(res[variant]["x0"], np.asarray(want.x0),
                                   **E2E_TOL)
    weak_nfes = 2 * res["T_weak"] * n            # CFG: two NFEs a step
    assert res["unmerged"]["flops"] == (res["merged"]["flops"] + weak_nfes
                                        * j_lora_overhead(jcfg, 1))


# ---------------------------------------------------------------------------
# torch_cached_sampling.py


@pytest.fixture(scope="module")
def cached():
    res, text = run_example("torch_cached_sampling.py",
                            ["--T", "8", "--device", "cpu"])
    jcfg = jax_cfg(res["cfg"])
    pipe = JPipeline(jax_tree(res["params"]), jcfg,
                     jschedule.linear_schedule(res["train_T"]))
    budget = jax_budget(res["budget"])
    kw = dict(cond=jnp.asarray(res["cond"]), x_T=jnp.asarray(res["x_T"]))
    ref = []
    for row in res["rows"]:
        spec = row["spec"] and JCacheSpec(**dataclasses.asdict(row["spec"]))
        plan = JPlan(T=res["T"], budget=budget, guidance_scale=1.5, cache=spec)
        ref.append((spec, pipe.sample(plan, 1, jax.random.PRNGKey(42), **kw)))
    return res, text, jcfg, ref, pipe.cache_stats()


def test_cached_ledger_matches_reference(cached):
    """Each policy's relative FLOPs and refresh rate equal the JAX
    ``cache_savings`` exactly, and interval 1 drifts by exactly 0."""
    res, text, jcfg, ref, _ = cached
    assert [r["name"] for r in res["rows"]] == [
        "no cache", "interval k=1", "interval k=2", "interval k=3",
        "interval k=4", "proxy (default)"]
    ts = jschedule.respaced_timesteps(res["train_T"], res["T"])
    budget = jax_budget(res["budget"])
    for row, (spec, want) in zip(res["rows"], ref):
        assert row["flops"] == want.flops
        if spec is None:
            assert (row["rel_flops"], row["refresh_rate"]) == (1.0, 1.0)
            continue
        led = j_cache_savings(jcfg, budget, ts, spec)
        assert row["rel_flops"] == 1.0 - led["flops_saved_frac"]
        assert row["refresh_rate"] == led["refresh_rate"]
    k1 = res["rows"][1]
    assert k1["drift"] == 0.0 and np.array_equal(k1["x0"], res["ref_x0"])
    assert "interval k=1      1.000     1.00     0.00e+00  (bit-identical)" in text
    assert any(r["drift"] > 0.0 for r in res["rows"][2:5])


def test_cached_x0_and_runners_match_reference(cached):
    """Each policy's x0 is within 1e-4 of the JAX pipeline's on the same
    ``x_T``, and the sweep builds as many runners as the JAX pipeline's
    (one uncached, one cached: the policy is data)."""
    res, text, _, ref, jstats = cached
    for row, (_spec, want) in zip(res["rows"], ref):
        np.testing.assert_allclose(row["x0"], np.asarray(want.x0), **E2E_TOL)
    assert res["stats"]["compiled"] == jstats["compiled"] == 2
    assert [r["stats"]["compiled"] for r in res["rows"]] == [1, 2, 2, 2, 2, 2]
    assert "compiled runners: 2" in text


# ---------------------------------------------------------------------------
# every port example: CUDA unless asked for the CPU; the other two examples


@pytest.mark.parametrize("name", ["torch_quickstart.py",
                                  "torch_flexify_lora_t2i.py",
                                  "torch_cached_sampling.py"])
def test_example_needs_cuda_unless_cpu_is_asked(name):
    """Without ``--device cpu`` an example runs on CUDA, and on a machine
    without a card it raises before any work; none imports the JAX
    package, JAX or the reference benchmarks."""
    for node in ast.walk(ast.parse((EXAMPLES / name).read_text())):
        names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                 else [node.module or ""] if isinstance(node, ast.ImportFrom)
                 else [])
        assert not any(n.split(".")[0] in ("repro", "jax", "benchmarks")
                       for n in names), names
    mod = runpy.run_path(str(EXAMPLES / name))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        mod["main"]([])


def test_serve_llm_example_serves_its_requests(monkeypatch, capsys):
    """``torch_serve_llm.py --arch gemma2-9b --device cpu`` serves its 8
    requests on the reduced config."""
    monkeypatch.setattr(sys, "argv", ["torch_serve_llm.py", "--arch",
                                      "gemma2-9b", "--device", "cpu"])
    runpy.run_path(str(EXAMPLES / "torch_serve_llm.py"), run_name="__main__")
    out = capsys.readouterr().out
    assert re.search(r"^served 8 requests, \d+ tokens", out, re.M), out
    assert out.count("[batch done] 4 reqs") == 2


def test_distributed_sampling_example_within_tolerance():
    """``torch_distributed_sampling.py --device cpu``: (2 x 2) Gloo ranks,
    every printed ``max|sp - single|`` within the example's TOL, one
    runner compiled a budget."""
    tol = runpy.run_path(str(EXAMPLES / "torch_distributed_sampling.py"))["TOL"]
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    got = subprocess.run([sys.executable,
                          str(EXAMPLES / "torch_distributed_sampling.py"),
                          "--device", "cpu"], capture_output=True, text=True,
                         env=env, timeout=300)
    assert got.returncode == 0, got.stderr[-3000:]
    diffs = [float(d) for d in re.findall(r"max\|sp - single\|=(\S+)",
                                          got.stdout)]
    assert len(diffs) == 2 and all(d <= tol for d in diffs), got.stdout
    assert "cache: runners=2 compiled=2 (one per budget)" in got.stdout
