"""Serving entry point of the port: ``repro.launch.serve``'s DiT path and
its language-model path (:func:`serve_lm`: batches of prompts prefilled,
then greedy KV-cache decode, for every language-model family, both steps
captured once as CUDA graphs on the card).

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

The fleet path: ``--replicas N`` runs N packed engines behind the
router (``repro_torch.fleet``; ``--router cheapest|rr|affinity``), all on
the one card and sharing one pipeline, while a background thread warms
the small-cohort bucket ladder.

The mesh path: ``--mesh DATAxSEQ`` serves DiT requests sequence-parallel
(``repro_torch.distributed``) from fixed batch slots of ``--batch-slots``
requests, in DATA x SEQ rank processes started here
(``launch.mesh.run_ranks``), every rank running the same loop; rank 0's
``[batch n]`` and ``served`` lines are printed. ``--mesh DATAxSEQ
--replicas N`` (N == DATA) composes the two: with SEQ > 1, N fixed-slot
replicas behind the router, each over its own persistent group of SEQ
rank processes (``fleet/groups.RankGroupPipeline``) on one contiguous
slice of the N x SEQ devices, with ``ParallelSpec()`` plans; with SEQ ==
1, N packed replicas with a pipeline each. The groups take turns on one
card, so the fleet's img/s prices routing over sequence-parallel
replicas, not scale. The backend follows the rule of ``launch/mesh.py``
over all the ranks: ``gloo`` on the CPU, ``nccl`` when every rank has
its own card, and ranks that share a card need ``--dist-backend gloo``;
nothing falls back to one device. The language-model path reads neither
flag: it serves on one device, as the reference's does.

Runs on CUDA unless ``--device cpu``.

  python -m repro_torch.launch.serve --arch dit-xl-2 --smoke --requests 6
  python -m repro_torch.launch.serve --arch dit-xl-2 --smoke --policy degrade
  python -m repro_torch.launch.serve --arch dit-xl-2 --smoke \
      --cache-policy interval --cache-interval 2
  python -m repro_torch.launch.serve --arch dit-xl-2 --smoke --profile \
      --trace trace.json --metrics-interval 4
  python -m repro_torch.launch.serve --arch dit-xl-2 --replicas 3 \
      --router affinity --requests 12 --T 10
  python -m repro_torch.launch.serve --arch gemma2-9b --requests 4 \
      --batch-slots 2 --prompt-len 512 --max-new 16
  python -m repro_torch.launch.serve --arch dit-xl-2 --mesh 1x2 \
      --dist-backend gloo --requests 4 --batch-slots 2 --T 10
  python -m repro_torch.launch.serve --arch dit-xl-2 --mesh 2x2 \
      --replicas 2 --dist-backend gloo --requests 8 --T 10
"""
from __future__ import annotations

import argparse
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.configs import get_config

# ``--mesh``: seconds before the rank processes are stopped and the run fails
MESH_TIMEOUT_S = 900.0


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


def serve_dit(cfg, args) -> Dict[str, float]:
    """Serve DiT sampling requests through the continuous-batching engine
    (or, with ``--replicas`` > 1, a fleet of them; with ``--mesh``, the
    sequence-parallel fixed-slot path; with both, a fleet of
    sequence-parallel replicas) on ``args.device`` (CUDA unless 'cpu').
    Returns the metrics summary."""
    from repro_torch.device import resolve_device
    from repro_torch.diffusion import schedule as sch
    from repro_torch.fleet import Fleet
    from repro_torch.models import dit as dit_mod
    from repro_torch.pipeline import FlexiPipeline

    replicas = getattr(args, "replicas", 1)
    if getattr(args, "mesh", None):
        if replicas > 1:
            return _serve_dit_mesh_fleet(cfg, args)
        return _serve_dit_mesh(cfg, args)
    device = resolve_device(getattr(args, "device", None))
    gen = torch.Generator(device=device).manual_seed(0)
    params = dit_mod.init_dit(cfg, gen)          # smoke: untrained weights
    pipe = FlexiPipeline(params, cfg, sch.linear_schedule(args.train_T),
                         device=device)
    plans = build_plan_menu(cfg, args)
    if replicas > 1:
        return _serve_dit_fleet(cfg, args, Fleet(
            pipe, plans, replicas, router=args.router,
            engine_kwargs=_packed_engine_kwargs(args)))
    return _serve_dit_engine(cfg, args, pipe, plans)


def _packed_engine_kwargs(args) -> Dict[str, object]:
    return {"policy": getattr(args, "policy", None) or "fifo",
            "max_tokens_per_step": getattr(args, "max_tokens_per_step", None)}


def lm_prefill(prefill, params, inputs: Dict[str, torch.Tensor],
               slot: Dict[str, torch.Tensor]) -> torch.Tensor:
    """One batch's prefill through the ``prefill`` runner, its cache
    written into ``slot`` (``runtime.padding.write_kv_slot``: K/V at the
    prompt's positions, zeros after). Returns the last-position logits
    [B, V] float32."""
    from repro_torch.runtime.padding import write_kv_slot

    logits, cache = prefill(params, inputs)
    write_kv_slot(slot, cache, inputs["tokens"].shape[1])
    return logits


def lm_decode(decode, params, slot: Dict[str, torch.Tensor],
              tok: torch.Tensor, start: int, n: int
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``n`` greedy decode steps through the ``decode`` runner from token
    ``tok`` [B, 1] at position ``start``, written into ``slot`` in place.
    Returns (the tokens each step chose [B, n] int32, their logits [B, n,
    V] float32)."""
    toks, logits_all = [], []
    for i in range(n):
        pos = torch.full((tok.shape[0],), start + i, dtype=torch.int32,
                         device=tok.device)
        logits, _ = decode(params, slot, tok, pos)
        tok = logits.argmax(-1).to(torch.int32)[:, None]
        toks.append(tok)
        logits_all.append(logits)
    if not toks:            # --max-new 1: the prefill's token only
        return tok[:, :0], torch.empty((tok.shape[0], 0, 0), device=tok.device)
    return torch.cat(toks, dim=1), torch.stack(logits_all, dim=1)


def serve_lm(cfg, args) -> Dict[str, float]:
    """Serve language-model requests as the reference does: random prompts
    of ``--prompt-len`` tokens (numpy, seed 0) in batches of
    ``--batch-slots``, each batch prefilled on the default backend (the
    vision model's image states and whisper's audio frames zeros, as the
    reference feeds them), then ``--max-new`` - 1 greedy decode steps.
    Weights are random (``lm.init_params`` from seed 0 on
    ``args.device``).

    The prefill and decode steps are built once (``launch/steps``: the
    reference's two ``jax.jit``), captured as CUDA graphs on the card.
    Each batch size has one cache slot of ``--prompt-len`` +
    ``--max-new`` positions (``lm.serve_slot``), made at its first batch;
    each prefill's cache is copied into it, and the decode replays on it
    in place. After the first batch of a size, a batch captures nothing.
    ``--mesh`` and ``--replicas`` are read by the DiT path only: the LM
    path serves on one device, as the reference's does. Returns the counts,
    the wall times (prefill and decode, each ending in a device
    synchronisation) and the graphs' counts."""
    from repro_torch.device import resolve_device
    from repro_torch.launch import steps as st
    from repro_torch.models import lm
    from repro_torch.runtime import graphs

    if getattr(args, "mesh", None) or getattr(args, "replicas", 1) > 1:
        print("[lm] the language-model path reads neither --mesh nor "
              "--replicas: serving on one device, as the reference does")
    device = resolve_device(getattr(args, "device", None))
    params = lm.init_params(cfg, torch.Generator(device=device).manual_seed(0))
    B = args.batch_slots
    prefill = st.make_prefill_step(cfg)
    decode = st.make_decode_step(cfg)
    slots: Dict[int, Dict[str, torch.Tensor]] = {}

    def sync() -> float:
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        return time.perf_counter()

    rng = np.random.default_rng(0)
    pending: List[np.ndarray] = [
        rng.integers(0, cfg.vocab_size, size=(args.prompt_len,), dtype=np.int32)
        for _ in range(args.requests)]
    done = tokens_out = n_steps = late = 0
    prefill_s = decode_s = 0.0
    t0 = sync()
    with torch.inference_mode():
        while pending:
            batch = [pending.pop(0) for _ in range(min(B, len(pending)))]
            n = len(batch)
            warm = n in slots
            if not warm:
                slots[n] = lm.serve_slot(cfg, n, args.prompt_len + args.max_new,
                                         device)
            before = prefill.captures + decode.captures
            t1 = sync()
            inputs = {"tokens": torch.from_numpy(np.stack(batch)).to(device)}
            if cfg.family == "vlm":      # the stub front ends: zero states
                inputs["vision"] = torch.zeros(
                    (n, cfg.vision_tokens, cfg.d_model), device=device)
            if cfg.family == "audio":
                inputs["frames"] = torch.zeros(
                    (n, cfg.audio_frames, cfg.d_model), device=device)
            logits = lm_prefill(prefill, params, inputs, slots[n])
            tok = logits.argmax(-1).to(torch.int32)[:, None]
            t2 = sync()
            toks, _ = lm_decode(decode, params, slots[n], tok, args.prompt_len,
                                args.max_new - 1)
            t3 = sync()
            if warm:
                late += prefill.captures + decode.captures - before
            tokens_out += n * toks.shape[1]
            n_steps += toks.shape[1]
            prefill_s += t2 - t1
            decode_s += t3 - t2
            done += n
            gen = torch.cat([tok, toks], dim=1)
            print(f"[batch done] {n} reqs, first gen: "
                  f"{gen[0].cpu().numpy()[:8].tolist()}", flush=True)
    dt = sync() - t0
    g = graphs.stats([prefill, decode])
    print(f"served {done} requests, {tokens_out} tokens in {dt:.1f}s "
          f"({tokens_out / max(dt, 1e-9):.1f} tok/s)")
    print(f"[lm] {cfg.name} on {device}: prefill {prefill_s * 1e3:.1f} ms in "
          f"all, decode {decode_s * 1e3 / max(1, n_steps):.2f} ms a step "
          f"({n_steps} steps)")
    print(f"[graphs] prefill and decode: {g['captured']} graphs captured "
          f"({late} after the first batch of a size), {g['replays']} "
          f"replays, pools {g['graph_pool_bytes'] / 2**20:.1f} MiB")
    return {"served": float(done), "tokens": float(tokens_out),
            "seconds": dt, "prefill_s": prefill_s, "decode_s": decode_s,
            "decode_steps": float(n_steps),
            "graphs_captured": float(g["captured"]),
            "graph_replays": float(g["replays"]),
            "graph_pool_bytes": float(g["graph_pool_bytes"]),
            "captured_after_warmup": float(late)}


def _serve_dit_mesh(cfg, args) -> Dict[str, float]:
    """``--mesh DATAxSEQ``: the plan menu and its shard lines here, then
    DATA x SEQ ranks serving fixed batch slots (:func:`_serve_mesh_rank`).
    Returns rank 0's summary."""
    from repro_torch.distributed import ParallelSpec, plan_partition
    from repro_torch.launch.mesh import default_backend, parse_mesh_arg, run_ranks

    d_sz, s_sz = parse_mesh_arg(args.mesh)
    world = d_sz * s_sz
    device = torch.device("cuda" if getattr(args, "device", None) is None
                          else args.device)
    backend = (getattr(args, "dist_backend", None)
               or default_backend(world, device.type))
    print(f"[mesh] data={d_sz} seq={s_sz} over {world} ranks ({backend}, "
          f"{device.type})")
    parallel = ParallelSpec() if s_sz > 1 else None
    plans = build_plan_menu(cfg, args, parallel)
    if parallel is not None:
        for b in sorted(plans):
            part = plan_partition(cfg, plans[b].resolve_schedule(cfg), s_sz,
                                  parallel)
            per_phase = " ".join(f"m{p.mode}:{p.tokens}+{p.pad}pad/{p.sp}"
                                 for p, nn in part.phases if nn)
            coll = part.collective_bytes(
                cfg, cfg_scale_active=args.cfg_scale != 0)
            print(f"[shard]   {per_phase} impl={part.phases[0][0].impl} "
                  f"collective={coll / 1e6:.1f}MB/sample "
                  f"eff={part.parallel_efficiency(cfg):.3f}")
    # CPU ranks share the host's cores: one intra-op thread each
    out = run_ranks(_serve_mesh_rank, world, backend=backend,
                    device=device.type, timeout_s=MESH_TIMEOUT_S,
                    threads=1 if device.type == "cpu" else None,
                    args=(cfg, args, plans, (d_sz, s_sz)))
    for line in out[0]["lines"]:
        print(line)
    return out[0]["summary"]


def _serve_mesh_rank(rank: int, device: torch.device, cfg, args, plans,
                     mesh_shape) -> Dict[str, object]:
    """One rank of ``--mesh``: the reference's fixed-batch-slot driver.
    Every rank builds the same weights and queue and samples every batch
    (padded to exactly ``--batch-slots`` requests, so each batch replays
    its level's runner); rank 0 returns the progress lines."""
    from repro_torch.diffusion import schedule as sch
    from repro_torch.launch.mesh import make_inference_mesh
    from repro_torch.models import dit as dit_mod
    from repro_torch.pipeline import FlexiPipeline

    mesh = make_inference_mesh(*mesh_shape, device=device)
    params = dit_mod.init_dit(cfg, torch.Generator(device=device).manual_seed(0))
    pipe = FlexiPipeline(params, cfg, sch.linear_schedule(args.train_T),
                         device=device, mesh=mesh)
    B = args.batch_slots
    levels = sorted(plans)
    rng = np.random.default_rng(0)
    queue: Dict[float, List[int]] = {b: [] for b in levels}
    for i in range(args.requests):
        queue[levels[i % len(levels)]].append(
            int(rng.integers(0, cfg.dit.num_classes)))
    lines: List[str] = []
    done = batches = 0
    total_flops = 0.0
    t0 = time.time()
    while any(queue.values()):
        # fill the slots from the fullest level
        b = max(queue, key=lambda k: len(queue[k]))
        labels = [queue[b].pop(0) for _ in range(min(B, len(queue[b])))]
        n_real = len(labels)
        labels += [labels[-1]] * (B - n_real)
        gen = torch.Generator(device=device).manual_seed(100 + batches)
        res = pipe.sample(plans[b], B, gen,
                          cond=torch.tensor(labels, device=device))
        x0_std = float(res.x0[:n_real].float().std())
        done += n_real
        batches += 1
        total_flops += res.flops * n_real / B
        lines.append(f"[batch {batches}] budget={b:.2f} served={n_real} "
                     f"(pad={B - n_real}) rel_compute="
                     f"{res.relative_compute:.3f} x0_std={x0_std:.3f}")
    dt = time.time() - t0
    stats = pipe.cache_stats()
    lines.append(f"served {done} requests in {batches} batches, {dt:.1f}s "
                 f"({done / max(dt, 1e-9):.2f} img/s), "
                 f"{total_flops / 1e9:.2f} GFLOPs total")
    lines.append(f"[cache] runners={stats['runners']} "
                 f"compiled={stats['compiled']} hits={stats['hits']} "
                 f"misses={stats['misses']}")
    if stats["compiled"] > len(levels):
        raise AssertionError("budget switches must not build beyond one "
                             "runner per plan")
    return {"lines": lines if rank == 0 else [],
            "summary": {"served": float(done), "batches": float(batches),
                        "seconds": dt, "img_per_s": done / max(dt, 1e-9),
                        "runners": float(stats["compiled"])}}


def _serve_dit_mesh_fleet(cfg, args) -> Dict[str, float]:
    """``--mesh DATAxSEQ --replicas N``, the reference's fleet over
    device slices: N == DATA replicas, each on a contiguous SEQ-wide slice
    of the N x SEQ devices. SEQ > 1: fixed-slot replicas with
    ``ParallelSpec()`` plans, each over a persistent rank group
    (``fleet/groups.RankGroupPipeline``; weights from seed 0 on every
    rank, as the single-device path's), a joined or rejoined replica on a
    fresh group; SEQ == 1: packed replicas, one pipeline each (no ranks).
    Every group is stopped when the fleet is done."""
    from repro_torch.device import resolve_device
    from repro_torch.diffusion import schedule as sch
    from repro_torch.distributed import ParallelSpec
    from repro_torch.fleet import Fleet, partition_devices
    from repro_torch.launch.mesh import (default_backend, parse_mesh_arg,
                                         rank_device)
    from repro_torch.models import dit as dit_mod
    from repro_torch.pipeline import FlexiPipeline

    n = args.replicas
    d_sz, s_sz = parse_mesh_arg(args.mesh)
    if d_sz != n:
        raise SystemExit(f"--mesh {args.mesh}: DATA={d_sz} must equal "
                         f"--replicas {n} on the fleet path (one "
                         f"replica per data-parallel slice)")
    device = resolve_device(getattr(args, "device", None))
    sched = sch.linear_schedule(args.train_T)
    slices = partition_devices(range(n * s_sz), n, s_sz)
    print(f"[mesh] {n} replica(s) x seq={s_sz}: slices "
          f"{[list(sl) for sl in slices]}")
    if s_sz == 1:
        params = dit_mod.init_dit(
            cfg, torch.Generator(device=device).manual_seed(0))
        pipes = [FlexiPipeline(params, cfg, sched, device=device)
                 for _ in slices]
        plans = build_plan_menu(cfg, args)
        return _serve_dit_fleet(cfg, args, Fleet(
            pipes[0], plans, n, router=args.router, pipes=pipes,
            seq_parallel=s_sz, batch_size=args.batch_slots,
            engine_kwargs=_packed_engine_kwargs(args)))
    from repro_torch.fleet.groups import RankGroupPipeline

    world = n * s_sz
    backend = (getattr(args, "dist_backend", None)
               or default_backend(world, device.type))
    print(f"[mesh] {world} ranks in {n} groups ({backend}, {device.type})")

    def group(rid: int, device_ids) -> RankGroupPipeline:
        return RankGroupPipeline(
            cfg, sched, 0, s_sz, device=device, backend=backend,
            devices=[rank_device(i, world, backend, device.type)
                     for i in device_ids],
            timeout_s=MESH_TIMEOUT_S,
            # CPU ranks share the host's cores: one intra-op thread each
            threads=1 if device.type == "cpu" else None)

    plans = build_plan_menu(cfg, args, ParallelSpec())
    pipes: List = []
    try:
        pipes.extend(group(i, sl) for i, sl in enumerate(slices))
        for p in pipes:            # the groups start side by side
            p.wait_ready()
        fleet = Fleet(pipes[0], plans, n, router=args.router, pipes=pipes,
                      engine_kind="fixed", seq_parallel=s_sz,
                      batch_size=args.batch_slots, pipe_factory=group)
        with fleet:
            return _serve_dit_fleet(
                cfg, args, fleet, packed=False,
                note="; the groups take turns on the card(s): routing's "
                     "price, not scale")
    finally:
        for p in pipes:
            p.close()


def _serve_dit_fleet(cfg, args, fleet, *, packed: bool = True,
                     note: str = "") -> Dict[str, float]:
    """Serve ``--requests`` through ``fleet`` on the wall clock. A
    ``packed`` fleet warms the small-cohort ladder on one background
    thread (replica 0's pipeline; shared pipelines make it the others'
    too) while it already serves, and after the drain every rung must be
    warm; a fixed-slot fleet has no ladder."""
    from repro_torch.fleet import BackgroundCompiler

    if packed:
        fleet.warmers[0] = BackgroundCompiler(fleet.replicas[0].engine,
                                              name="serve-warm").start()
    levels = sorted(fleet.plans)
    rng = np.random.default_rng(0)
    t0 = time.time()
    for i in range(args.requests):
        deadline = fleet.now + float(rng.uniform(0.5, 5.0))
        fleet.submit(cond=int(rng.integers(0, cfg.dit.num_classes)),
                     budget=levels[i % len(levels)], deadline=deadline)
    results = fleet.run()
    if packed:
        fleet.wait_warm(timeout=600.0)
    dt = time.time() - t0
    s = fleet.summary()
    for r in results[:4]:
        print(f"[served] req={r.rid} replica={r.replica} "
              f"budget={r.budget_served:.2f} latency={r.latency:.2f}s "
              f"x0_std={float(r.x0.float().std()):.3f}", flush=True)
    print(f"[fleet] served {s['served']} requests over {s['replicas']} "
          f"replicas in {dt:.1f}s ({len(results) / max(dt, 1e-9):.2f} "
          f"img/s{note}) router={args.router}")
    rs = s["router"]
    print(f"[fleet] affinity_hit_rate={s['affinity_hit_rate']:.3f} "
          f"placements={int(rs['placements'])} "
          f"handbacks={int(rs['handbacks'])} hedges={int(rs['hedges'])}")
    c = s["cache"]
    print(f"[cache] pipes={c['pipes']} runners={c['runners']} "
          f"compiled={c['compiled']} hits={c['hits']} misses={c['misses']}")
    return {"served": float(s["served"]),
            "img_per_s": len(results) / max(dt, 1e-9),
            "affinity_hit_rate": s["affinity_hit_rate"],
            "placements": rs["placements"], "handbacks": rs["handbacks"],
            "hedges": rs["hedges"], "runners": float(c["runners"])}


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
    # LM path
    ap.add_argument("--batch-slots", type=int, default=4,
                    help="prompts prefilled and decoded together (with "
                         "--mesh: DiT requests sampled together)")
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=16)
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
    ap.add_argument("--replicas", type=int, default=1,
                    help="serve DiT requests through a fleet of N packed "
                         "engines behind a router (all on the one card); "
                         "with --mesh DATAxSEQ (DATA == N) each replica "
                         "owns a SEQ-wide slice; the LM path serves on one "
                         "device")
    ap.add_argument("--router", default="cheapest",
                    choices=["cheapest", "rr", "affinity"],
                    help="fleet placement policy (--replicas > 1)")
    ap.add_argument("--mesh", default=None, metavar="DATAxSEQ",
                    help="serve DiT requests sequence-parallel over DATA x "
                         "SEQ rank processes started here, e.g. 1x2; with "
                         "--replicas N, N groups of SEQ ranks behind the "
                         "router (the LM path serves on one device)")
    ap.add_argument("--dist-backend", default=None, choices=["nccl", "gloo"],
                    help="--mesh: the torch.distributed backend (default: "
                         "gloo on the CPU, nccl when every rank has its own "
                         "card; ranks sharing a card need gloo)")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.smoke:
        cfg = cfg.reduced()
    if cfg.family != "dit":
        return serve_lm(cfg, args)
    return serve_dit(cfg, args)


if __name__ == "__main__":
    main()
