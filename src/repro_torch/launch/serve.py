"""Serving entry point of the port: the DiT path of ``repro.launch.serve``.

Requests carry a class label, a relative-compute budget quantized onto
the ``--budget-levels`` plan menu, and a deadline; the continuous-batching
engine (``repro_torch.serving``) keeps many requests in flight at
different denoise steps and packs each iteration token-wise (weak-phase
requests contribute fewer tokens) into build-once bucket layouts under
``--max-tokens-per-step``, every block's attention on the segment-aware
flash kernel. ``--policy`` picks admission/step ordering: ``fifo``,
``edf`` (earliest deadline first), or ``degrade`` (queued requests are
demoted to the highest budget level the measured arrival rate sustains).
Weights are random (``init_dit`` from a seed): a smoke run, not a model.

Telemetry (``repro_torch.telemetry``): ``--trace OUT.json`` (spans and
tap counters as a Chrome trace), ``--metrics-interval N`` (a ``[metrics]``
line every N engine steps), ``--profile`` (per-dispatch wall time, the
packed runners' cost report, per-request attribution ``[attrib]`` and the
controller's calibration ``[calib]``), ``--postmortem-dir DIR`` and
``--slo-p99 SEC`` (the SLO watchdog and its flight recorder). Any one of
them turns on spans and taps.

Runs on CUDA unless ``--device cpu``. Later slices own the options that
raise here: ``--replicas`` (fleet), ``--mesh`` (distributed), and a
language-model ``--arch``.

  python -m repro_torch.launch.serve --arch dit-xl-2 --smoke --requests 6
  python -m repro_torch.launch.serve --arch dit-xl-2 --smoke --policy degrade
  python -m repro_torch.launch.serve --arch dit-xl-2 --smoke \
      --cache-policy interval --cache-interval 2
  python -m repro_torch.launch.serve --arch dit-xl-2 --smoke --profile \
      --trace trace.json --metrics-interval 4
"""
from __future__ import annotations

import argparse
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.configs import get_config


def parse_budget_levels(arg: Optional[str], base: float) -> List[float]:
    """``--budget-levels`` 'a,b,c' → sorted, deduped, validated floats in
    (0, 1]; default menu derived from ``--budget`` when unset. Validation
    runs on the ROUNDED values (and on the default menu too) so nothing
    outside (0, 1] ever reaches ``SamplingPlan``."""
    if not arg:
        raw = [base, (base + 1.0) / 2, 1.0]
    else:
        raw = []
        for part in arg.split(","):
            part = part.strip()
            if not part:
                continue
            try:
                raw.append(float(part))
            except ValueError:
                raise SystemExit(f"--budget-levels: {part!r} is not a number")
        if not raw:
            raise SystemExit("--budget-levels: no levels given")
    levels = set()
    for b in raw:
        b = round(b, 2)
        if not 0.0 < b <= 1.0:
            raise SystemExit(f"--budget-levels/--budget: level {b} "
                             f"outside (0, 1]")
        levels.add(b)
    return sorted(levels)


def build_plan_menu(cfg, args, parallel=None) -> Dict[float, "object"]:
    """``--budget-levels`` → validated ``{level: SamplingPlan}``, printing
    one ``[plan]`` line per level."""
    from repro_torch.pipeline import SamplingPlan

    levels = parse_budget_levels(getattr(args, "budget_levels", None),
                                 args.budget)
    plans: Dict[float, SamplingPlan] = {}
    for b in levels:
        plan = SamplingPlan(T=args.T, budget=float(b), solver=args.solver,
                            guidance_scale=args.cfg_scale, parallel=parallel,
                            attn_backend=getattr(args, "attn_backend",
                                                 "auto") or "auto")
        plan.validate(cfg)
        plans[b] = plan
        fs = plan.resolve_schedule(cfg)
        print(f"[plan] budget<={b:.2f}: T_weak={fs.phases[0][1]}/{args.T} "
              f"relative_compute={plan.relative_compute(cfg):.3f}")
    return plans


def _later_slice_options(args) -> None:
    """Options whose code comes with a later slice of the port raise."""
    owners = [("replicas", lambda v: v > 1, "fleet"),
              ("mesh", bool, "distributed")]
    for name, is_set, owner in owners:
        value = getattr(args, name, None)
        if value is not None and is_set(value):
            raise NotImplementedError(
                f"--{name.replace('_', '-')} comes with the {owner} slice "
                f"of the port")


def serve_dit(cfg, args) -> Dict[str, float]:
    """Serve DiT sampling requests through the continuous-batching engine
    on ``args.device`` (CUDA unless 'cpu'). Returns the engine's metrics
    summary."""
    from repro_torch.device import resolve_device
    from repro_torch.diffusion import schedule as sch
    from repro_torch.models import dit as dit_mod
    from repro_torch.pipeline import FlexiPipeline

    _later_slice_options(args)
    device = resolve_device(getattr(args, "device", None))
    gen = torch.Generator(device=device).manual_seed(0)
    params = dit_mod.init_dit(cfg, gen)          # smoke: untrained weights
    pipe = FlexiPipeline(params, cfg, sch.linear_schedule(args.train_T),
                         device=device)
    plans = build_plan_menu(cfg, args)
    return _serve_dit_engine(cfg, args, pipe, plans)


def _serve_dit_engine(cfg, args, pipe, plans) -> Dict[str, float]:
    """The continuous-batching path: a warm-up wave builds the bucket
    layouts the workload visits, then the same wave is served again and
    (under fifo) must build nothing."""
    from repro_torch.serving import CacheSpec, ServingEngine
    from repro_torch.telemetry import Telemetry
    from repro_torch.telemetry import export as tel_export

    policy = getattr(args, "policy", None) or "fifo"
    max_tokens = getattr(args, "max_tokens_per_step", None)
    cache = None
    cache_policy = getattr(args, "cache_policy", None) or "off"
    if cache_policy != "off":
        cache = CacheSpec(policy=cache_policy,
                          interval=getattr(args, "cache_interval", 2),
                          threshold=getattr(args, "cache_threshold", 0.05))
        print(f"[cache] activation cache on: policy={cache.policy} "
              f"interval={cache.interval} threshold={cache.threshold} "
              f"split={cache.resolve_split(cfg.num_layers)}/"
              f"{cfg.num_layers} blocks")
    trace_path = getattr(args, "trace", None)
    metrics_interval = getattr(args, "metrics_interval", 0) or 0
    profile = bool(getattr(args, "profile", False))
    pm_dir = getattr(args, "postmortem_dir", None)
    slo_p99 = getattr(args, "slo_p99", None)
    telemetry = None
    if trace_path or metrics_interval or profile or pm_dir or slo_p99:
        # tracing implies taps: the tapped step family serves the same
        # latents bit for bit
        watchdog = None
        if pm_dir or slo_p99:
            from repro_torch.telemetry.watchdog import Watchdog, WatchdogConfig
            watchdog = Watchdog(WatchdogConfig(p99_slo_s=slo_p99))
        telemetry = Telemetry(taps=True, profile=profile,
                              watchdog=watchdog, postmortem_dir=pm_dir)
        print("[telemetry] spans+taps on"
              + (", cost profiling on" if profile else "")
              + (f", post-mortems -> {pm_dir}" if pm_dir else "")
              + (f", trace -> {trace_path}" if trace_path else ""))
    engine = ServingEngine(pipe, plans, policy=policy,
                           max_tokens_per_step=max_tokens, cache=cache,
                           telemetry=telemetry)
    # warm-set shaping: build the small-cohort bucket ladder off the hot
    # path so mid-trace arrivals never meet a coarse layout
    n_pre = engine.precapture_warm_set(max_per_mode=2)
    print(f"[warm-set] precaptured {n_pre} small-cohort runners")
    print(engine.menu.describe())

    levels = sorted(plans)
    rng = np.random.default_rng(0)

    def submit_wave(n: int) -> None:
        now = engine.clock()
        for i in range(n):
            deadline = now + float(rng.uniform(0.5, 5.0))
            engine.submit(cond=int(rng.integers(0, cfg.dit.num_classes)),
                          budget=levels[i % len(levels)], deadline=deadline)

    t0 = time.time()

    def metrics_tick() -> None:
        """The periodic metrics line, every ``metrics_interval`` steps."""
        if metrics_interval and \
                engine.metrics.total_steps % metrics_interval == 0:
            print(tel_export.metrics_line(
                engine.metrics.summary(wall=time.time() - t0),
                taps=telemetry.taps.aggregate(),
                compile_stats=engine.cache_stats(),
                spans=telemetry.recorder.counters()))

    # the warm-up wave builds the bucket layouts this workload visits ...
    submit_wave(args.requests)
    results = engine.run(on_step=metrics_tick)
    warm = engine.cache_stats()
    # ... after which serving the same workload shape builds nothing
    submit_wave(args.requests)
    results += engine.run(on_step=metrics_tick)
    dt = time.time() - t0

    done = len(results)
    stats = engine.cache_stats()
    m = engine.metrics.summary(wall=dt)
    for r in results[:4]:
        print(f"[served] req={r.request.id} budget={r.budget_served:.2f} "
              f"latency={r.record.latency:.2f}s "
              f"x0_std={float(r.x0.float().std()):.3f}", flush=True)
    print(f"served {done} requests in {int(m['steps'])} engine steps, "
          f"{dt:.1f}s ({done / max(dt, 1e-9):.2f} img/s), "
          f"{m.get('flops', 0.0) / 1e9:.2f} GFLOPs total")
    print(f"[metrics] policy={policy} p50={m.get('p50', 0.0):.2f}s "
          f"p99={m.get('p99', 0.0):.2f}s "
          f"packing_eff={m['packing_efficiency']:.3f} "
          f"deadline_hit={m.get('deadline_hit_rate', 1.0):.2f} "
          f"degraded={int(m['degraded'])}")
    if "attn_block_skip_rate" in m:
        print(f"[attn] backend={engine.attn_backend} "
              f"block_skip_rate={m['attn_block_skip_rate']:.3f} "
              f"(cross-segment score tiles never issued)")
    print(f"[cache] runners={stats['runners']} compiled={stats['compiled']} "
          f"hits={stats['hits']} misses={stats['misses']}")
    if cache is not None:
        cs = engine.metrics.cache_summary()
        print(f"[act-cache] hit_rate={cs['hit_rate']:.3f} "
              f"refreshes={cs['refreshes']} skips={cs['skips']} "
              f"interval_hist={cs['refresh_interval_hist']} "
              f"store_bytes_total={engine.store.bytes_total}")
    if telemetry is not None:
        _report_telemetry(telemetry, engine, pipe, results, m, stats,
                          trace_path, tel_export)
    # only the fifo drain replays deterministically (edf priorities move
    # with the wall clock, degradation shifts the level mix)
    if policy == "fifo" and stats["compiled"] != warm["compiled"]:
        raise AssertionError("steady-state serving must not build runners "
                             "after bucket warm-up")
    m["img_per_s"] = done / max(dt, 1e-9)
    return m


def _report_telemetry(telemetry, engine, pipe, results, m, stats,
                      trace_path, tel_export) -> None:
    """The telemetry report after the drain: taps, the final metrics
    line, the cost report with attribution and calibration (--profile),
    alerts and post-mortems, and the trace file."""
    agg = telemetry.taps.aggregate()
    if "drift" in agg:
        print(f"[taps] drift_mean={agg['drift']['mean']:.4g} "
              f"drift_max={agg['drift']['max']:.4g} "
              f"eps_norm_mean={agg['eps_norm']['mean']:.4g} over "
              f"{agg['request_steps']} request-steps")
    elif "eps_norm" in agg:
        print(f"[taps] eps_norm_mean={agg['eps_norm']['mean']:.4g} "
              f"over {agg['request_steps']} request-steps")
    print(tel_export.metrics_line(m, taps=agg, compile_stats=stats,
                                  spans=telemetry.recorder.counters(),
                                  tag="metrics-final"))
    if telemetry.profiling:
        # count each packed runner once, off the dispatch path: the
        # analytic ledger vs counted FLOPs vs measured wall
        hv = telemetry.profile.harvest(pipe)
        if engine.cache_stats()["compiled"] != stats["compiled"]:
            raise AssertionError("the cost harvest must build no runner")
        print(f"[profile] harvest: {hv}")
        for line in telemetry.profile.report_lines():
            print(line)
        cons = telemetry.attribution.conservation()
        print(f"[attrib] conservation deltas {cons} over "
              f"{len(telemetry.attribution.finalized)} finalized "
              f"requests (all must be 0)")
        for r in results[:4]:
            c = r.cost
            print(f"[attrib] req={c.request_id} flops={c.flops / 1e9:.2f}G "
                  f"wall={c.wall_ms:.1f}ms dispatches={c.dispatches} "
                  f"queue_wait={c.queue_wait_s:.3f}s")
        calib = (engine.controller.calibration
                 if engine.controller is not None else None)
        if calib:
            fams = {k: f"{v:.3e}" for k, v in calib["per_family"].items()}
            print(f"[calib] wall_per_analytic_flop "
                  f"global={calib['global']:.3e} per_family={fams}")
    wd = telemetry.watchdog
    if wd is not None:
        for a in wd.alerts:
            print(f"[alert] {a.kind} step={a.step} value={a.value:.4g} "
                  f"limit={a.limit:.4g} {a.detail}")
        if wd.dumps_written:
            print(f"[postmortem] {len(wd.dumps_written)} bundle(s) -> "
                  f"{wd.dumps_written}")
    if trace_path:
        # drift/eps counter tracks: the timeline shows WHEN replay error
        # spiked, aligned with the dispatch spans
        for when, vals in telemetry.taps.counter_series():
            telemetry.recorder.counter("taps", vals, ts=when)
        telemetry.recorder.dump(trace_path)
        print(f"[trace] {telemetry.recorder.events_recorded} events "
              f"({telemetry.recorder.events_dropped} dropped) -> "
              f"{trace_path} (open in ui.perfetto.dev)")


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, float]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="dit-xl-2")
    ap.add_argument("--smoke", action="store_true",
                    help="serve the arch's reduced (tiny) config")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' runs the "
                         "kernels' plain versions)")
    ap.add_argument("--budget", type=float, default=0.6,
                    help="base relative-compute budget for DiT requests")
    ap.add_argument("--budget-levels", default=None,
                    help="comma-separated relative-compute menu, e.g. "
                         "'0.4,0.6,1.0' (default: derived from --budget)")
    ap.add_argument("--policy", default="fifo",
                    choices=["fifo", "edf", "degrade"],
                    help="serving-engine admission/step policy: arrival "
                         "order, earliest deadline first, or SLA-aware "
                         "budget degradation under load")
    ap.add_argument("--max-tokens-per-step", type=int, default=None,
                    help="token-packing budget of one engine step "
                         "(default: four full-grid CFG requests)")
    ap.add_argument("--cache-policy", default="off",
                    choices=["off", "interval", "banded", "proxy"],
                    help="cross-step activation cache refresh policy; off "
                         "disables caching")
    ap.add_argument("--cache-interval", type=int, default=2,
                    help="refresh every k steps (interval policy / band "
                         "fallback); 1 equals no cache bit for bit")
    ap.add_argument("--cache-threshold", type=float, default=0.05,
                    help="proxy policy: analytic conditioning-drift "
                         "threshold triggering a refresh")
    ap.add_argument("--attn-backend", default="auto",
                    choices=["auto", "pallas", "xla-blocked", "dense"],
                    help="attention backend: auto runs the segment-aware "
                         "flash kernel ('pallas', the Hopper kernel) on "
                         "packed token streams, dense otherwise")
    ap.add_argument("--T", type=int, default=20,
                    help="DiT denoising steps per request")
    ap.add_argument("--train-T", type=int, default=1000,
                    help="diffusion schedule length the DiT was trained at")
    ap.add_argument("--solver", default="ddim", choices=["ddim", "ddpm"])
    ap.add_argument("--cfg-scale", type=float, default=1.5)
    ap.add_argument("--trace", default=None, metavar="OUT.json",
                    help="record span tracing + device taps and dump a "
                         "Chrome-trace JSON loadable in ui.perfetto.dev")
    ap.add_argument("--metrics-interval", type=int, default=0, metavar="N",
                    help="print one structured [metrics] line every N "
                         "engine steps (0 = off); also enables taps")
    ap.add_argument("--profile", action="store_true",
                    help="cost profiling: measure each dispatch's wall "
                         "time, count each packed runner's FLOPs, "
                         "attribute served cost per request, calibrate "
                         "the budget controller, and print the report")
    ap.add_argument("--postmortem-dir", default=None, metavar="DIR",
                    help="enable the SLO watchdog + flight recorder: "
                         "alerts and uncaught engine exceptions dump a "
                         "post-mortem bundle here")
    ap.add_argument("--slo-p99", type=float, default=None, metavar="SEC",
                    help="p99 latency SLO for the watchdog's rolling "
                         "breach detector (default: off)")
    # options of later slices: accepted by the parser, refused by serve_dit
    ap.add_argument("--replicas", type=int, default=1)
    ap.add_argument("--mesh", default=None)
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.smoke:
        cfg = cfg.reduced()
    if cfg.family != "dit":
        raise NotImplementedError(f"serving {args.arch!r} (a language "
                                  f"model) comes with the language-model "
                                  f"slice of the port")
    return serve_dit(cfg, args)


if __name__ == "__main__":
    main()
