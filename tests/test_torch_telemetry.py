"""The port's telemetry layer (``telemetry/``, the tapped packed-step
family, the engine's telemetry seam, the telemetry flags of
``launch/serve.py``) against the JAX package and against the port's own
untapped path.

Host arithmetic is held exactly against the reference fed the same
events: span traces, exporter text, attribution shares, the watchdog's
alerts on a scripted trace, ``packed_analytic``. Tap values hold at
float32 1e-5 against the reference's tapped step (its dense attention
path against the flash kernel's plain version, as in
``test_torch_packing.py``). Port against port, the tapped step and a
telemetry-on engine serve the untapped latents bit for bit.
"""
import dataclasses
import importlib
import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_threads import one_torch_thread  # noqa: F401

from repro.diffusion import schedule as jschedule
from repro.pipeline import packed as jpacked
from repro.telemetry import attribution as jattr
from repro.telemetry import export as jexport
from repro.telemetry import profile as jprofile
from repro.telemetry import taps as jtaps
from repro.telemetry import trace as jtrace
from repro.telemetry import watchdog as jwatch
from repro_torch import convert
from repro_torch.core.scheduler import FlexiSchedule
from repro_torch.diffusion import schedule as tschedule
from repro_torch.launch import serve as tserve
from repro_torch.models import dit as tdit
from repro_torch.pipeline import FlexiPipeline, PackLayout, SamplingPlan
from repro_torch.pipeline import packed as tpacked
from repro_torch.serving import CacheSpec, ServingEngine
from repro_torch.telemetry import Telemetry
from repro_torch.telemetry import attribution as tattr
from repro_torch.telemetry import export as texport
from repro_torch.telemetry import profile as tprofile
from repro_torch.telemetry import taps as ttaps
from repro_torch.telemetry import trace as ttrace
from repro_torch.telemetry import watchdog as twatch

jflex = importlib.import_module("repro.core.flexify")

TOL = dict(atol=1e-5, rtol=1e-5)
T = 6


def to_torch(tree):
    return convert.params_from_numpy(jax.tree.map(np.asarray, tree),
                                     device="cpu")


class FakeClock:
    def __init__(self, t: float = 0.0):
        self.t = t

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> float:
        self.t += dt
        return self.t


class TickingClock(FakeClock):
    """A fake clock that moves 1 ms each time it is read, so profiled
    dispatches (timed by the engine's clock on the CPU) take time."""

    def __call__(self) -> float:
        self.t += 1e-3
        return self.t


@pytest.fixture(scope="module")
def flexi(tiny_dit_cfg, trained_like_dit):
    """The tiny DiT flexified to patch 4 (mode 0: 64 tokens, mode 1: 16),
    the per-mode embedding made non-zero."""
    fp, fcfg = jflex.flexify(trained_like_dit, tiny_dit_cfg, [(1, 4, 4)])
    key = jax.random.PRNGKey(21)
    fp["ps_embed"] = jax.random.normal(key, fp["ps_embed"].shape) * 0.1
    return fp, fcfg, to_torch(fp)


def make_plans(solver="ddim"):
    return {0.6: SamplingPlan(T=T, budget=FlexiSchedule.weak_first(T, 3),
                              solver=solver, guidance_scale=1.5),
            1.0: SamplingPlan(T=T, budget=1.0, solver=solver,
                              guidance_scale=1.5)}


# ---------------------------------------------------------------------------
# Host-pure modules, fed the same events as the reference: exact


def _script(rec_mod, clk):
    """The same span/instant/counter script through a recorder of
    ``rec_mod``, on a fake clock, with a ring small enough to drop."""
    rec = rec_mod.SpanRecorder(clock=clk, max_events=12)
    for i in range(6):
        with rec.span("dispatch", args={"k": i % 3, "groups": "((0, 1),)"}):
            clk.advance(0.25)
        rec.instant("alert.p99", tid=i, args={"value": 1.5 * i})
        rec.counter("engine", {"inflight": i, "queued": 6 - i},
                    ts=clk() - 0.1)
        rec.complete(f"req{i}", 0.5 * i, clk(), pid=rec_mod.REQUEST_PID,
                     tid=i, args={"budget_served": 0.6})
        clk.advance(0.125)
    return rec


def test_span_recorder_matches_reference():
    j = _script(jtrace, FakeClock(1.0))
    t = _script(ttrace, FakeClock(1.0))
    assert t.to_chrome_trace() == j.to_chrome_trace()
    assert t.counters() == j.counters()
    assert (t.events_recorded, t.events_dropped, t.occupancy) \
        == (j.events_recorded, j.events_dropped, j.occupancy) == (24, 12, 1.0)
    assert [dataclasses.asdict(e) for e in t.by_name("req5")] \
        == [dataclasses.asdict(e) for e in j.by_name("req5")]
    assert ttrace.REQUEST_PID == jtrace.REQUEST_PID


SNAPSHOT = dict(
    summary={"served": 12.0, "p50": 0.75, "p99": 1.3125,
             "deadline_hit_rate": 1.0, "tokens_per_s": 12345.678,
             "packing_efficiency": 0.989, "nan_rate": float("nan"),
             "ok": True, "name": "ignored", "steps": 7},
    cache={"hit_rate": 0.4667, "refresh_interval_hist": {"1": 3, "2": 9}},
    compile_stats={"runners": 5, "hits": 40, "misses": 5, "compiled": 5},
    taps={"eps_norm": {"mean": 1.25, "max": 2.5},
          "drift": {"mean": 0.01, "max": 0.03, "p99": 0.029},
          "attn_blocks": {"active": 90, "total": 96, "skip_rate": 0.0625}},
    spans={"events_recorded": 100.0, "events_dropped": 3.0,
           "occupancy": 0.5, "capacity": 200.0})


def test_exporters_match_reference():
    s = SNAPSHOT
    assert texport.flatten_metrics(s) == jexport.flatten_metrics(s)
    assert texport.build_snapshot(**s) == jexport.build_snapshot(**s)
    assert texport.json_snapshot(**s) == jexport.json_snapshot(**s)
    assert texport.prometheus_text(**s) == jexport.prometheus_text(**s)
    assert texport.prometheus_text() == jexport.prometheus_text() == ""
    kw = dict(taps=s["taps"], compile_stats=s["compile_stats"],
              spans=s["spans"])
    assert texport.metrics_line(s["summary"], **kw) \
        == jexport.metrics_line(s["summary"], **kw)
    assert texport.metrics_line({}, tag="x") == jexport.metrics_line({}, tag="x")


@pytest.mark.parametrize("total,weights", [
    (10, [1, 1, 1]), (1_000_003, [0.3, 0.1, 2.5, 7.0]), (7, [0, 0, 0]),
    (5, [1e-9, 1.0]), (0, [1, 2]), (99, [3]), (13, [-1.0, 2.0, 2.0]),
    (123456789, [1 / 3] * 9)])
def test_exact_shares_match_reference(total, weights):
    got = tattr.exact_shares(total, weights)
    assert got == jattr.exact_shares(total, weights)
    assert sum(got) == total if weights else got == []


def _ledger_script(mod):
    led = mod.AttributionLedger(max_dispatch_records=4)
    rng = np.random.default_rng(3)
    for d in range(7):
        ids = [int(i) for i in rng.choice(6, size=1 + d % 4, replace=False)]
        w = [float(x) for x in rng.uniform(0.1, 5.0, len(ids))]
        led.attribute_dispatch(time=0.5 * d, label=f"k={d}", request_ids=ids,
                               weights=w, wall_ns=int(rng.integers(1e5, 1e8)),
                               flops=int(rng.integers(1e9, 1e12)),
                               bytes_=int(rng.integers(0, 1e6)))
        if d in (3, 5):
            led.finalize(ids[0], queue_wait_s=0.1 * d, budget="0.6")
    led.finalize(99)
    return led


def test_attribution_ledger_matches_reference():
    j, t = _ledger_script(jattr), _ledger_script(tattr)
    assert t.snapshot() == j.snapshot()
    assert t.conservation() == j.conservation() \
        == {"wall_ns_delta": 0, "flops_delta": 0, "bytes_delta": 0}
    assert {k: dataclasses.asdict(v) for k, v in t.finalized.items()} \
        == {k: dataclasses.asdict(v) for k, v in j.finalized.items()}
    assert all(d.conserved for d in t.dispatches) and len(t.dispatches) == 4


def _watch_script(mod, tmp):
    """A scripted engine trace: warm-up builds, a runner built after
    warm-up, a queue spike, a p99 breach that persists past the cooldown,
    a drift spike and one quarantine."""
    cfg = mod.WatchdogConfig(p99_slo_s=1.0, queue_limit=5, drift_limit=0.1,
                             warmup_steps=3, cooldown_steps=4,
                             min_latencies=4, window=8, max_dumps=2)
    rec = (jtrace if mod is jwatch else ttrace).SpanRecorder(
        clock=FakeClock(0.0))
    wd = mod.Watchdog(cfg, recorder=rec, postmortem_dir=str(tmp))
    lat = []
    fired = []
    for step in range(20):
        lat.append(0.2 + (1.5 if 8 <= step <= 15 else 0.0))
        out = wd.observe_step(
            now=float(step), queued=9 if step == 5 else 1, inflight=2,
            compiled=3 + step if step < 3 else (7 if step >= 10 else 6),
            latencies=lat, drift_max=0.5 if step == 12 else 0.01,
            nonfinite=1 if step >= 17 else 0)
        fired.append([a.kind for a in out])
        if wd.should_dump():
            wd.dump(reason="alert", engine_snapshot={"step": step})
    return wd, fired, rec


def test_watchdog_alerts_match_reference(tmp_path):
    jw, jf, jr = _watch_script(jwatch, tmp_path / "j")
    tw, tf, tr = _watch_script(twatch, tmp_path / "t")
    assert tf == jf

    def same_words(a):
        # the port names its counter "runners built", the reference "jit
        # compile counter"; every other field and detail is the same
        d = a.as_dict()
        d["detail"] = d["detail"].replace("jit compile counter",
                                          "runners built")
        return d
    assert [same_words(a) for a in tw.alerts] \
        == [same_words(a) for a in jw.alerts]
    kinds = {a.kind for a in tw.alerts}
    assert kinds == {"recompile", "queue", "p99", "drift", "nonfinite"}
    assert [e.name for e in tr.events] == [e.name for e in jr.events]
    assert len(tw.dumps_written) == len(jw.dumps_written) == 2
    for tp_, jp_ in zip(tw.dumps_written, jw.dumps_written):
        t_b, j_b = json.load(open(tp_)), json.load(open(jp_))
        assert json.dumps(t_b, sort_keys=True) == json.dumps(
            j_b, sort_keys=True).replace("jit compile counter",
                                         "runners built")


def _samples(n_samples=5, seed=0):
    """Tap samples as numpy arrays (the same values for both packages)."""
    rng = np.random.default_rng(seed)
    out = []
    for s in range(n_samples):
        groups, n_real = ((0, 3), (1, 4)), (2, 4 - s % 2)
        k = 1 + s % 3
        eps = tuple(rng.uniform(0.5, 2.0, (k, c)).astype(np.float32)
                    for _, c in groups)
        drift = tuple(rng.uniform(0.0, 0.1, (k, c)).astype(np.float32)
                      for _, c in groups) if s % 2 else None
        fin = tuple(rng.random((k, c)) > 0.1 for _, c in groups)
        out.append(dict(time=0.5 * s, k=k, groups=groups, n_real=n_real,
                        eps_norm=eps, drift=drift,
                        attn_blocks=(40 + s, 48), finite=fin))
    return out


def test_tap_aggregator_matches_reference():
    j, t = jtaps.TapAggregator(max_samples=4), ttaps.TapAggregator(4)
    for s in _samples():
        j.add(jtaps.TapSample(**dict(s, attn_blocks=np.asarray(s["attn_blocks"]))))
        t.add(ttaps.TapSample(**dict(
            s, eps_norm=tuple(torch.from_numpy(e) for e in s["eps_norm"]),
            drift=(None if s["drift"] is None else
                   tuple(torch.from_numpy(d) for d in s["drift"])),
            finite=tuple(torch.from_numpy(f) for f in s["finite"]))))
    assert t.aggregate() == j.aggregate()
    assert t.counter_series() == j.counter_series()
    assert len(t) == 4 and t.samples_recorded == 5
    assert ttaps.TAP_NAMES == jtaps.TAP_NAMES


def test_tap_helpers_match_reference():
    rng = np.random.default_rng(1)
    eps = rng.standard_normal((3, 1, 8, 8, 4)).astype(np.float32)
    x = eps.copy()
    x[1, 0, 2, 3, 1] = np.nan
    d_new, d_old = (rng.standard_normal((3, 2, 16, 8)).astype(np.float32)
                    for _ in range(2))
    np.testing.assert_allclose(ttaps.eps_norm_tap(torch.from_numpy(eps)),
                               jtaps.eps_norm_tap(jnp.asarray(eps)), **TOL)
    np.testing.assert_array_equal(ttaps.finite_tap(torch.from_numpy(x)),
                                  jtaps.finite_tap(jnp.asarray(x)))
    np.testing.assert_allclose(
        ttaps.drift_tap(torch.from_numpy(d_new), torch.from_numpy(d_old)),
        jtaps.drift_tap(jnp.asarray(d_new), jnp.asarray(d_old)), **TOL)


# ---------------------------------------------------------------------------
# The tapped step family


def _step_inputs(cfg, layout, k, seed):
    """Latents, metas [k, 3, n] (each request at its own step, request 0
    reaching its final x0 step), the reference's keys and their noise."""
    rng = np.random.default_rng(seed)
    xs, metas, keys, noise = [], [], [], []
    base = jax.random.PRNGKey(seed)
    for gi, (m, n) in enumerate(layout.groups):
        xs.append(rng.standard_normal((n,) + cfg.dit.latent_shape)
                  .astype(np.float32))
        meta = np.zeros((k, 3, n), np.int32)
        start = rng.integers(k + 1, 99, n)
        for j in range(k):
            meta[j, 0] = start - 10 * j
            meta[j, 1] = start - 10 * (j + 1)
        meta[k - 1, 1, 0] = -1
        meta[:, 2] = rng.integers(0, cfg.dit.num_classes, n)
        metas.append(meta)
        kk = jax.random.split(jax.random.fold_in(base, gi), k * n)
        keys.append(np.asarray(kk).reshape(k, n, 2))
        noise.append(np.stack([np.stack([
            np.asarray(jax.random.normal(kk[j * n + i], cfg.dit.latent_shape,
                                         jnp.float32))
            for i in range(n)]) for j in range(k)]))
    return xs, metas, keys, noise


def _cache_inputs(cfg, layout, k):
    rng = np.random.default_rng(k)
    deltas = [(rng.standard_normal((n, 2, tdit.tokens_for_mode(cfg, m),
                                    cfg.d_model)) * 0.1).astype(np.float32)
              for m, n in layout.groups]
    refresh = [rng.random((k, n)) < 0.5 for _m, n in layout.groups]
    refresh[0][0] = True
    refresh[-1][-1] = False
    return deltas, refresh


STEP_CASES = [("ddim", 1, None), ("ddim", 3, None), ("ddpm", 3, None),
              ("ddim", 3, 1), ("ddpm", 1, 1)]


@pytest.mark.parametrize("solver,k,split", STEP_CASES)
def test_tapped_step_taps_match_reference(flexi, solver, k, split):
    """eps_norm, finite and (cached) drift at 1e-5 against the reference's
    tapped step, attn_blocks exactly; the latents as in the untapped
    comparison."""
    fp, fcfg, tp = flexi
    groups = {0: 1, 1: 2}
    layout = jpacked.PackLayout.for_counts(groups)
    tlayout = tpacked.PackLayout.for_counts(groups)
    xs, metas, keys, noise = _step_inputs(fcfg, layout, k, 31 + k)
    kw = dict(solver=solver, guidance_scale=1.5, k_steps=k, cache_split=split,
              taps=True)
    jstep = jax.jit(jpacked.make_packed_step_fn(
        fcfg, jschedule.linear_schedule(100), layout, attn_backend="dense",
        **kw))
    tstep = tpacked.make_packed_step_fn(fcfg, tschedule.linear_schedule(100),
                                        tlayout, **kw)
    J, Tt = jnp.asarray, torch.from_numpy
    args_j = ([J(x) for x in xs], [J(m) for m in metas], [J(q) for q in keys])
    args_t = ([Tt(x) for x in xs], [Tt(m) for m in metas],
              [Tt(z) for z in noise])
    if split is not None:
        deltas, refresh = _cache_inputs(fcfg, layout, k)
        args_j += ([J(d) for d in deltas], [J(r) for r in refresh])
        args_t += ([Tt(d) for d in deltas], refresh)
    want, got = jstep(fp, *args_j), tstep(tp, *args_t)
    wtap, gtap = want[-1], got[-1]
    for g, w in zip(got[0], want[0]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)
    names = ("eps_norm", "finite") + (("drift",) if split is not None else ())
    assert set(gtap) == set(names) | {"attn_blocks"} == set(wtap)
    for name in names:
        for g, w in zip(gtap[name], wtap[name]):
            assert tuple(g.shape) == np.asarray(w).shape
            np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)
    assert tuple(gtap["attn_blocks"]) == tuple(np.asarray(wtap["attn_blocks"]))
    if split is not None:
        # skip steps replay the cached residual: their drift is exactly 0
        last = gtap["drift"][-1][:, -1]
        assert float(last[~torch.from_numpy(refresh[-1][:, -1])].abs().sum()) == 0.0


@pytest.mark.parametrize("solver,k,split", STEP_CASES)
def test_tapped_step_latents_equal_untapped(flexi, solver, k, split):
    """Port against port: the tapped family's latents (and deltas) equal
    the untapped family's bit for bit."""
    _, fcfg, tp = flexi
    layout = tpacked.PackLayout.for_counts({0: 2, 1: 1})
    xs, metas, _keys, noise = _step_inputs(fcfg, layout, k, 41 + k)
    args = ([torch.from_numpy(x) for x in xs],
            [torch.from_numpy(m) for m in metas],
            [torch.from_numpy(z) for z in noise])
    if split is not None:
        deltas, refresh = _cache_inputs(fcfg, layout, k)
        args += ([torch.from_numpy(d) for d in deltas], refresh)
    outs = {}
    for taps in (False, True):
        step = tpacked.make_packed_step_fn(
            fcfg, tschedule.linear_schedule(100), layout, solver=solver,
            k_steps=k, cache_split=split, taps=taps)
        outs[taps] = step(tp, *args)
    plain, tapped = outs[False], outs[True][:-1]
    if split is None:
        plain = (plain,)
    for p_, t_ in zip(plain, tapped):
        assert all(torch.equal(a, b) for a, b in zip(p_, t_))


def test_tapped_runner_key_differs_only_in_taps(flexi):
    """``packed_step(taps=True)`` (it raised before this slice) builds its
    own runner, keyed like the untapped one but for ``taps``."""
    _, fcfg, tp = flexi
    pipe = FlexiPipeline(tp, fcfg, tschedule.linear_schedule(100),
                         device="cpu")
    layout = PackLayout.for_counts({0: 1})
    plain = pipe.packed_step(layout, k_steps=2)
    tapped = pipe.packed_step(layout, k_steps=2, taps=True)
    assert plain is not tapped and pipe.cache_stats()["compiled"] == 2
    keys = list(pipe._runners)
    assert keys[0]._replace(taps=True) == keys[1]
    assert tprofile.packed_key(layout, k_steps=2, taps=True) == keys[1]
    assert pipe.warm_packed_layouts(taps=True) == {2: [layout]}


PROFILE_KEYS = [dict(groups={0: 2, 1: 3}), dict(groups={1: 9}, k=4),
                dict(groups={0: 1, 1: 1}, k=2, split=1),
                dict(groups={0: 3}, backend="dense"),
                dict(groups={0: 1, 1: 6}, guided=False, split=1, k=8),
                dict(groups={1: 4}, backend="pallas", cap=128)]


@pytest.mark.parametrize("case", PROFILE_KEYS)
def test_packed_analytic_matches_reference(flexi, case):
    _, fcfg, _ = flexi
    k, split = case.get("k", 1), case.get("split")
    backend, guided = case.get("backend", "auto"), case.get("guided", True)
    cap = case.get("cap", 0)
    jl = jpacked.PackLayout.for_counts(case["groups"], guided=guided,
                                       row_capacity=cap)
    tl = tpacked.PackLayout.for_counts(case["groups"], guided=guided,
                                       row_capacity=cap)
    want = jprofile.packed_analytic(fcfg, jprofile.packed_key(
        jl, k_steps=k, cache_split=split, attn_backend=backend))
    got = tprofile.packed_analytic(fcfg, tprofile.packed_key(
        tl, k_steps=k, cache_split=split, attn_backend=backend))
    assert got == want


# ---------------------------------------------------------------------------
# The engine's telemetry seam


def _wave(eng, clk, spec, late):
    out = []
    for label, lvl in spec:
        eng.submit(cond=label, budget=lvl)
        clk.advance(0.01)
    for _ in range(2):
        out += eng.step()
        clk.advance(0.01)
    for label, lvl in late:
        eng.submit(cond=label, budget=lvl)
    out += eng.run()
    return {r.request.id: r for r in out}


SPEC = [(3, 0.6), (7, 1.0), (5, 0.6), (1, 0.6)]
LATE = [(9, 1.0), (2, 0.6)]


@pytest.mark.parametrize("solver,cache", [("ddim", None), ("ddpm", None),
                                          ("ddim", 2)])
def test_engine_with_telemetry_serves_the_same_latents(flexi, solver, cache):
    """Spans, taps, profiling and a watchdog on: every x0 equals the
    telemetry-off engine's bit for bit; the spans cover the lifecycle;
    attribution conserves exactly; no runner is built by the replay."""
    _, fcfg, tp = flexi
    plans = make_plans(solver)
    spec = CacheSpec(policy="interval", interval=cache) if cache else None
    results = {}
    for on in (False, True):
        clk = TickingClock()
        tel = (Telemetry(taps=True, profile=True,
                         watchdog=twatch.Watchdog(twatch.WatchdogConfig(
                             p99_slo_s=1e-6, min_latencies=2, taps_every=1)))
               if on else None)
        pipe = FlexiPipeline(tp, fcfg, tschedule.linear_schedule(100),
                             device="cpu")
        eng = ServingEngine(pipe, plans, max_tokens_per_step=256, clock=clk,
                            cache=spec, telemetry=tel)
        results[on] = _wave(eng, clk, SPEC, LATE)
        if on:
            built = eng.cache_stats()["compiled"]
            results["replay"] = _wave(eng, clk, SPEC, LATE)
            assert eng.cache_stats()["compiled"] == built
            on_eng, on_tel = eng, tel
    assert sorted(results[False]) == sorted(results[True])
    for rid, r in results[False].items():
        assert torch.equal(r.x0, results[True][rid].x0)
        assert r.cost is None and results[True][rid].cost is not None
    rec = on_tel.recorder
    n_disp = on_eng.metrics.total_steps
    assert len(rec.by_name("dispatch")) == len(rec.by_name("plan")) \
        == len(rec.by_name("pack")) == n_disp
    served = {e.tid for e in rec.events if e.name.startswith("req")}
    assert served == set(range(2 * (len(SPEC) + len(LATE))))
    assert all(e.pid == ttrace.REQUEST_PID for e in rec.events
               if e.name.startswith("req"))
    assert rec.by_name("admit") and rec.by_name("materialize")
    assert rec.by_name("compile")          # the first wave built runners
    assert on_tel.attribution.conservation() \
        == {"wall_ns_delta": 0, "flops_delta": 0, "bytes_delta": 0}
    assert len(on_tel.attribution.finalized) == len(served)
    agg = on_tel.taps.aggregate()
    assert agg["samples"] == n_disp and agg["request_steps"] == T * len(served)
    assert math.isfinite(agg["eps_norm"]["mean"]) and agg["eps_norm"]["mean"] > 0
    assert agg.get("nonfinite_request_steps") == 0
    if cache:
        assert "drift" in agg and agg["drift"]["max"] > 0.0
    alerts = {a.kind for a in on_tel.watchdog.alerts}
    assert "p99" in alerts
    walls = on_tel.profile.walls
    assert sum(w.n for w in walls.values()) == n_disp
    assert all(k.taps for k in walls)


def test_engine_profiling_calibrates_the_controller(flexi):
    """The degrade policy's controller is calibrated from the profiled
    dispatch walls (per family where a pack is single-mode); the cost
    report counts each packed runner once and builds nothing."""
    _, fcfg, tp = flexi
    clk = TickingClock()
    tel = Telemetry(taps=True, profile=True)
    pipe = FlexiPipeline(tp, fcfg, tschedule.linear_schedule(100),
                         device="cpu")
    eng = ServingEngine(pipe, make_plans(), max_tokens_per_step=256,
                        clock=clk, policy="degrade", telemetry=tel)
    _wave(eng, clk, SPEC, LATE)
    calib = eng.controller.calibration
    assert calib is not None and calib["global"] > 0
    before = pipe.cache_stats()["compiled"]
    hv = tel.profile.harvest(pipe)
    assert pipe.cache_stats()["compiled"] == before
    assert hv["harvested"] == len(pipe._runners) and hv["skipped"] == 0
    rep = tel.profile.reconcile()
    assert rep["n_flagged"] == 0
    assert 0.9 < rep["min_counted_over_analytic"] \
        <= rep["max_counted_over_analytic"] < 1.2
    rows = [r for r in rep["rows"] if "wall_ms_ewma" in r]
    assert rows and all(r["achieved_gflops_per_s"] > 0 for r in rows)
    assert tel.profile.report_lines()[0].startswith("[profile]")
    snap = tel.snapshot()
    assert snap["attribution"]["conservation"]["flops_delta"] == 0


def test_engine_dumps_a_postmortem_on_an_exception(flexi, tmp_path):
    _, fcfg, tp = flexi
    tel = Telemetry(taps=True, postmortem_dir=str(tmp_path))
    pipe = FlexiPipeline(tp, fcfg, tschedule.linear_schedule(100),
                         device="cpu")
    eng = ServingEngine(pipe, make_plans(), max_tokens_per_step=256,
                        telemetry=tel)
    eng.submit(cond=1, budget=0.6)

    def boom(*a, **k):
        raise RuntimeError("device lost")

    eng.pipe.packed_step = boom
    with pytest.raises(RuntimeError, match="device lost"):
        eng.run()
    (path,) = tel.watchdog.dumps_written
    bundle = json.load(open(path))
    assert bundle["reason"] == "engine-exception"
    assert bundle["engine"]["inflight"][0]["id"] == 0


@pytest.mark.parametrize("flags,expect", [
    (["--trace", "TRACE"], "[trace]"),
    (["--metrics-interval", "2"], "[metrics] served="),
    (["--profile"], "[attrib] conservation deltas"),
    (["--postmortem-dir", "PM"], "[telemetry] spans+taps on, post-mortems"),
    (["--slo-p99", "1e-6"], "[alert] p99")])
def test_serve_cli_telemetry_flags(capsys, tmp_path, flags, expect):
    flags = [str(tmp_path / "t.json") if f == "TRACE" else
             str(tmp_path / "pm") if f == "PM" else f for f in flags]
    # one budget level (mode 0 only) keeps the warm-set ladder small
    m = tserve.main(["--arch", "dit-xl-2", "--smoke", "--device", "cpu",
                     "--requests", "4", "--T", "4", "--budget-levels", "1.0"]
                    + flags)
    out = capsys.readouterr().out
    assert m["served"] == 8.0 and expect in out
    if flags[0] == "--trace":
        # spans alone: the untapped steps, no tap counter
        assert "[telemetry] spans on" in out and "[taps]" not in out
        trace = json.load(open(tmp_path / "t.json"))
        names = {e["name"] for e in trace["traceEvents"]}
        assert {"dispatch", "plan", "pack", "retire", "req0"} <= names
        assert "taps" not in names
    else:
        assert "[telemetry] spans+taps on" in out and "[taps]" in out
    if "--profile" in flags:
        assert "[profile] harvest" in out and "(all must be 0)" in out


def test_serve_cli_postmortem_on_engine_exception(tmp_path, monkeypatch):
    """--postmortem-dir: the CLI drains through ``engine.run()``, so an
    exception in a served step dumps an 'engine-exception' bundle and then
    propagates."""
    calls = [0]
    step = ServingEngine.step

    def failing_step(self):
        calls[0] += 1
        if calls[0] == 2:
            raise RuntimeError("planted step failure")
        return step(self)

    monkeypatch.setattr(ServingEngine, "step", failing_step)
    with pytest.raises(RuntimeError, match="planted step failure"):
        tserve.main(["--arch", "dit-xl-2", "--smoke", "--device", "cpu",
                     "--requests", "2", "--T", "4", "--budget-levels", "1.0",
                     "--postmortem-dir", str(tmp_path / "pm")])
    reasons = [json.load(open(p))["reason"]
               for p in sorted((tmp_path / "pm").glob("postmortem_*.json"))]
    assert reasons[-1:] == ["engine-exception"]
