"""Level 2 — graph audit of the port, the counterpart of the reference's
jaxpr auditor (``src/repro/analysis/jaxpr_audit.py``; DESIGN.md
§analysis).

The port's runners are captured once per key as CUDA graphs
(``runtime.graphs``): a budget, cache-policy or pack-content switch must
replay a graph, never capture one. What a capture records is what the
body's Python dispatches, so this module traces the REAL step functions
with ``torch.fx.experimental.proxy_tensor.make_fx`` on the CPU over a
tiny (fully flexified) DiT and fingerprints each graph: its canonical
code (ops, their non-tensor arguments, the graph's wiring), its
placeholders' shapes and dtypes, and a digest of the value of every
tensor constant. Inputs become placeholders, so any input value that
survives into the fingerprint was baked as a constant or decided by a
Python branch on the host: in a CUDA graph, a frozen value that the next
replay would reuse for other data. Each function runs once before it is
traced, as a capture's first call does (lazily built tables and pack
plans exist by then, as constants of every trace alike).

Invariances asserted (``graph-fingerprint-drift`` on violation):

* the plain eps + DDIM step at two timesteps;
* the packed step at two timestep-ladder metas (a budget switch);
* the cached packed step (the body the pipeline captures, its host flags
  prepared outside) at two refresh patterns in the same branch; over
  every pattern of a k=1 layout exactly two graphs exist (deep and
  shallow);
* two independently built cached runners whose ``CacheSpec`` differ in
  every data-only knob (policy / interval / threshold) at one split: each
  captured NFE, per branch;
* dense attention and the flash kernel's plain version at two segment-id
  contents at fixed geometry (a pack-layout occupancy change);
* the tapped packed step: dropping its tap outputs and eliminating dead
  code gives the untapped graph exactly (``graph-tap-structure``), and it
  is ladder-invariant too;
* the language models' serving steps (``launch/steps.make_prefill_step``
  / ``make_decode_step``), one tiny config a family (dense with window,
  softcap and scaled embeddings; MoE; hybrid; vision; audio): the
  prefill at two token contents, and the decode on one cache slot at two
  positions and two token contents.

Each graph is walked for host reads (``graph-host-sync``:
``aten._local_scalar_dense`` and kin, a sync that fails a capture) and
silent widenings (``graph-dtype-promotion``, a warning, as in the
reference). ``graph-uncaptured-runner`` (the counterpart of the
reference's ``jaxpr-nondonated-hotbuf`` check on its hot ``jax.jit``
entry points) builds every kind of runner ``FlexiPipeline._lookup``
caches and both LM step factories, and fails on one that does not go
through ``runtime.graphs`` (or a decode step that does not donate its
cache).

What the fingerprint does NOT prove, as in the reference: equality of
phase runners across budgets (a budget switch changes the phase split of
a whole-sample runner, so those are other keys; zero captures there is
replay of a cached key, held by the cache-key rule and the capture
counters of ``FlexiPipeline.cache_stats()``).
"""
from __future__ import annotations

import dataclasses
import functools
import hashlib
import re
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch
import torch.utils._pytree as pytree
from torch.fx.experimental.proxy_tensor import make_fx

from repro_torch.analysis.engine import Finding

PIPELINE_PATH = "src/repro_torch/pipeline/pipeline.py"
LM_STEPS_PATH = "src/repro_torch/launch/steps.py"

#: aten ops that read a device value to the host (a sync: a capture fails)
HOST_SYNC_OPS = {"_local_scalar_dense", "is_nonzero", "equal", "item"}

#: silent widenings worth flagging (operand, result)
WIDENINGS = {(torch.float32, torch.float64), (torch.bfloat16, torch.float32),
             (torch.float16, torch.float32)}

_ADDR_RE = re.compile(r"0x[0-9a-fA-F]+")


# ---------------------------------------------------------------------------
# Fingerprinting


def _digest_value(t: torch.Tensor) -> str:
    t = t.detach().cpu().contiguous().reshape(-1)
    h = hashlib.sha256()
    h.update(str(t.dtype).encode())
    h.update(str(tuple(t.shape)).encode())
    h.update(t.view(torch.uint8).numpy().tobytes())
    return h.hexdigest()[:16]


def trace(fn: Callable, *args: Any) -> torch.fx.GraphModule:
    """``fn`` run once, then traced by ``make_fx`` on these inputs."""
    fn(*args)
    return make_fx(fn, tracing_mode="real")(*args)


def _val(node: torch.fx.Node) -> Any:
    return node.meta.get("val", node.meta.get("tensor_meta"))


def canonical(gm: torch.fx.GraphModule) -> str:
    """The graph's structure with every node by position (names and
    memory addresses drop out), its placeholders by shape and dtype, and
    its constants by value digest."""
    index: Dict[torch.fx.Node, int] = {}
    lines = []
    for i, node in enumerate(gm.graph.nodes):
        index[node] = i
        if node.op == "placeholder":
            v = _val(node)
            desc = (f"{getattr(v, 'dtype', type(v).__name__)}"
                    f"{tuple(getattr(v, 'shape', ()))}")
        elif node.op == "get_attr":
            const = getattr(gm, node.target)
            desc = (f"const#{_digest_value(const)}"
                    if isinstance(const, torch.Tensor)
                    else _ADDR_RE.sub("0x", repr(const)))
        else:
            args = torch.fx.node.map_arg((node.args, node.kwargs),
                                         lambda n: f"%{index[n]}")
            desc = f"{node.target}{_ADDR_RE.sub('0x', repr(args))}"
        lines.append(f"{i}:{node.op}:{desc}")
    return "\n".join(lines)


def fingerprint(gm: torch.fx.GraphModule) -> str:
    """Stable structural digest of a traced graph, constants included
    (baked data is a per-capture hazard)."""
    return hashlib.sha256(canonical(gm).encode()).hexdigest()[:32]


def keep_outputs(gm: torch.fx.GraphModule, n: int) -> torch.fx.GraphModule:
    """A copy of ``gm`` returning only its first ``n`` flat outputs, dead
    code eliminated (the tapped step's taps dropped)."""
    gm = torch.fx.GraphModule(gm, gm.graph.__deepcopy__())
    out = next(node for node in gm.graph.nodes if node.op == "output")
    flat = pytree.tree_leaves(out.args[0])
    out.args = (tuple(flat[:n]),)
    gm.graph._codegen = torch.fx.graph.CodeGen()
    gm.graph.eliminate_dead_code()
    gm.recompile()
    return gm


def n_outputs(gm: torch.fx.GraphModule) -> int:
    out = next(node for node in gm.graph.nodes if node.op == "output")
    return len(pytree.tree_leaves(out.args[0]))


# ---------------------------------------------------------------------------
# Per-graph walks


def check_graph(gm: torch.fx.GraphModule, unit: str,
                path: str = PIPELINE_PATH) -> List[Finding]:
    findings: List[Finding] = []
    for node in gm.graph.nodes:
        if node.op != "call_function":
            continue
        name = getattr(node.target, "__name__", str(node.target))
        packet = name.split(".")[0]
        if packet in HOST_SYNC_OPS:
            findings.append(Finding(
                "graph-host-sync", "error", path, 0,
                f"`{name}` in the {unit} graph: a host read, which fails a "
                f"capture (or freezes the value into it)", unit))
        elif packet == "_to_copy":
            src = _val(node.args[0]) if node.args and isinstance(
                node.args[0], torch.fx.Node) else None
            new = node.kwargs.get("dtype")
            old = getattr(src, "dtype", None)
            if (old, new) in WIDENINGS:
                findings.append(Finding(
                    "graph-dtype-promotion", "warning", path, 0,
                    f"silent {old}->{new} widening in the {unit} graph",
                    unit))
    return findings


# ---------------------------------------------------------------------------
# Tiny audited model (mirrors tests/conftest.py, self-contained so
# `python -m repro_torch.analysis` works outside pytest)


@functools.lru_cache(maxsize=1)
def _tiny():
    from repro_torch.configs.base import AttnConfig, DiTConfig, ModelConfig
    from repro_torch.core.flexify import flexify
    from repro_torch.diffusion import schedule as sch
    from repro_torch.models import dit as dit_mod
    cfg = ModelConfig(
        name="audit-dit", family="dit", num_layers=2, d_model=64, d_ff=256,
        vocab_size=0, attn=AttnConfig(4, 4, 16, use_rope=False),
        dit=DiTConfig(latent_shape=(1, 16, 16, 4), patch_size=(1, 2, 2),
                      flex_patch_sizes=(), underlying_patch_size=(1, 2, 2),
                      conditioning="class", num_classes=10),
        mlp_activation="gelu", norm_type="layernorm",
        param_dtype="float32", compute_dtype="float32", remat="none",
        max_seq_len=256)
    with torch.random.fork_rng():
        params = dit_mod.init_dit(cfg, torch.Generator().manual_seed(0))
        fparams, fcfg = flexify(params, cfg, [(1, 4, 4)])
    return fparams, fcfg, sch.linear_schedule(100)


@dataclasses.dataclass
class AuditReport:
    findings: List[Finding]
    fingerprints: Dict[str, str]


def _drift(unit: str, fps: Dict[str, str], what: str,
           path: str = PIPELINE_PATH) -> List[Finding]:
    """One finding if the fingerprints in ``fps`` are not all equal."""
    if len(set(fps.values())) <= 1:
        return []
    detail = ", ".join(f"{k}={v[:10]}" for k, v in fps.items())
    return [Finding(
        "graph-fingerprint-drift", "error", path, 0,
        f"{unit}: graph fingerprint differs across {what} — a data-only "
        f"switch would capture again ({detail})", unit)]


def _trace(unit: str, fn: Callable, *args, path: str = PIPELINE_PATH
           ) -> Tuple[Optional[torch.fx.GraphModule], List[Finding]]:
    try:
        return trace(fn, *args), []
    except Exception as e:      # a host read of a traced value, a shape leak
        # make_fx refuses to read a traced value on the host: a sync that
        # a capture would refuse too
        rule = ("graph-host-sync" if "_local_scalar_dense" in str(e)
                else "graph-trace-failure")
        return None, [Finding(
            rule, "error", path, 0,
            f"{unit} no longer traces: {type(e).__name__}: "
            f"{str(e)[:200]}", unit)]


def _invariant(unit: str, cases: Dict[str, Tuple[Callable, Tuple]],
               what: str, path: str = PIPELINE_PATH) -> AuditReport:
    """Trace ``fn(*args)`` per case; drift if the fingerprints differ,
    plus the walks of the last graph."""
    findings: List[Finding] = []
    fps: Dict[str, str] = {}
    last = None
    for tag, (fn, args) in cases.items():
        gm, errs = _trace(unit, fn, *args, path=path)
        findings.extend(errs)
        if gm is None:
            continue
        fps[tag] = fingerprint(gm)
        last = gm
    findings.extend(_drift(unit, fps, what, path))
    if last is not None:
        findings.extend(check_graph(last, unit, path))
    return AuditReport(findings, {unit: next(iter(fps.values()), "")})


# ---------------------------------------------------------------------------
# Audited units


def audit_plain_step() -> AuditReport:
    """Guided eps + DDIM update, traced at two timesteps."""
    from repro_torch.core.guidance import GuidanceConfig, make_eps_fn
    from repro_torch.diffusion import schedule as sch
    fparams, fcfg, sched = _tiny()
    B = 2
    g = GuidanceConfig(scale=1.5, mode_cond=0, mode_uncond=0)

    def step(params, x, t, t_next, cond, null):
        e, _lv = make_eps_fn(params, fcfg, cond, null, g)(x, t)
        return sch.ddim_step(sched, x, e, t, t_next)

    x = torch.zeros((B,) + tuple(fcfg.dit.latent_shape))
    cond = torch.zeros(B, dtype=torch.int64)
    null = torch.full((B,), fcfg.dit.num_classes, dtype=torch.int64)
    cases = {tag: (step, (fparams, x, torch.full((B,), t),
                          torch.full((B,), tn), cond, null))
             for tag, (t, tn) in {"t=90": (90, 80), "t=10": (10, 0)}.items()}
    return _invariant("plain_step", cases, "timesteps")


LAYOUT_GROUPS = ((0, 1), (1, 2))


def packed_args(layout, k_steps: int, ts: Iterable[int],
                cache_split: Optional[int] = None,
                refresh: Optional[np.ndarray] = None) -> Tuple:
    """The packed step's call arguments (params first) at a ladder
    ``ts`` and, cached, refresh flags [k, n] per group (all True by
    default)."""
    from repro_torch.cache import apply as cache_apply
    fparams, fcfg, _sched = _tiny()
    ts = list(ts)
    xs, metas, noises, deltas, refreshes = [], [], [], [], []
    for g, (mode, n) in enumerate(layout.groups):
        xs.append(torch.zeros((n,) + tuple(fcfg.dit.latent_shape)))
        rows = []
        for s in range(k_steps):
            t = ts[s % len(ts)]
            rows.append([[t] * n, [max(t - 10, -1)] * n, [0] * n])
        metas.append(torch.tensor(rows, dtype=torch.int32))
        noises.append(torch.zeros((k_steps, n) + tuple(fcfg.dit.latent_shape)))
        if cache_split is not None:
            _eb, N, d = cache_apply.delta_shape(fcfg, mode, n, layout.guided)
            mult = 2 if layout.guided else 1
            deltas.append(torch.zeros((n, mult, N, d)))
            refreshes.append(np.ones((k_steps, n), bool) if refresh is None
                             else refresh[g])
    args = (fparams, tuple(xs), tuple(metas), tuple(noises))
    if cache_split is not None:
        args += (tuple(deltas), tuple(refreshes))
    return args


def _flat(fn_args: Tuple[Callable, Tuple]) -> Tuple:
    return (fn_args[0],) + tuple(fn_args[1])


def captured_body(step: Callable, *args) -> Tuple[Callable, Tuple]:
    """What the pipeline captures of a packed step: its host function run
    outside (flags to a device tensor and the branch pattern), the body
    traced over the host's outputs."""
    branches, body_args = step.host(*args)
    return functools.partial(step.body, branches), body_args


def audit_packed_step() -> AuditReport:
    """Packed step: a budget switch is a metas-value change only."""
    from repro_torch.pipeline.packed import PackLayout, make_packed_step_fn
    _fparams, fcfg, sched = _tiny()
    layout = PackLayout(groups=LAYOUT_GROUPS, guided=True)
    step = make_packed_step_fn(fcfg, sched, layout, k_steps=2)
    cases = {tag: captured_body(step, *packed_args(layout, 2, ladder))
             for tag, ladder in {"ladder-hi": (90, 80),
                                 "ladder-lo": (30, 20)}.items()}
    return _invariant("packed_step", cases, "budget ladders")


def cached_patterns(layout) -> Dict[str, List[np.ndarray]]:
    """Every refresh pattern of a k=1 layout, by name ('TFT' ...)."""
    n_all = sum(n for _m, n in layout.groups)
    out = {}
    for bits in range(2 ** n_all):
        flat = np.array([(bits >> i) & 1 for i in range(n_all)], bool)
        parts, off = [], 0
        for _m, n in layout.groups:
            parts.append(flat[off:off + n][None])
            off += n
        out["".join("T" if b else "F" for b in flat)] = parts
    return out


def audit_packed_cached_step() -> AuditReport:
    """Cached packed step: a policy switch is a refresh-flag change only.
    Two same-branch patterns give one graph; over every pattern of a k=1
    layout exactly two graphs exist (the deep and the shallow branch)."""
    from repro_torch.pipeline.packed import PackLayout, make_packed_step_fn
    _fparams, fcfg, sched = _tiny()
    layout = PackLayout(groups=LAYOUT_GROUPS, guided=True)
    step = make_packed_step_fn(fcfg, sched, layout, k_steps=1, cache_split=1)
    patterns = cached_patterns(layout)
    unit = "packed_cached_step"
    findings: List[Finding] = []
    by_pattern: Dict[str, str] = {}
    last = None
    for tag, refresh in patterns.items():
        fn, args = captured_body(step, *packed_args(
            layout, 1, (90,), cache_split=1, refresh=refresh))
        gm, errs = _trace(unit, fn, *args)
        findings.extend(errs)
        if gm is None:
            continue
        by_pattern[tag] = fingerprint(gm)
        last = gm
    deep = {t: f for t, f in by_pattern.items() if "T" in t}
    findings.extend(_drift(unit, deep, "refresh policies (deep branch)"))
    if len(set(by_pattern.values())) != 2:
        findings.append(Finding(
            "graph-fingerprint-drift", "error", PIPELINE_PATH, 0,
            f"{unit}: {len(set(by_pattern.values()))} graphs over the "
            f"{len(by_pattern)} refresh patterns of a k=1 layout, expected "
            f"2 (deep and shallow)", unit))
    if last is not None:
        findings.extend(check_graph(last, unit))
    return AuditReport(findings, {unit: deep.get("T" * len(
        next(iter(patterns))), "")})


def audit_cached_runner() -> AuditReport:
    """Two independently built cached runners whose CacheSpec differ in
    every data-only knob (same split): each captured NFE traces alike,
    per branch."""
    from repro_torch.cache import apply as cache_apply
    from repro_torch.cache.policy import CacheSpec
    from repro_torch.diffusion import schedule as sch
    from repro_torch.pipeline import FlexiPipeline, SamplingPlan
    from repro_torch.runtime import graphs
    fparams, fcfg, sched = _tiny()
    pipe = FlexiPipeline(fparams, fcfg, sched, device="cpu")
    B = 2
    cond = torch.zeros(B, dtype=torch.int64)
    null = torch.full((B,), fcfg.dit.num_classes, dtype=torch.int64)
    x = torch.zeros((B,) + tuple(fcfg.dit.latent_shape))
    findings: List[Finding] = []
    fps: Dict[Tuple[int, bool], Dict[str, str]] = {}
    for tag, spec in {
        "interval": CacheSpec(policy="interval", interval=2, split=1),
        "proxy": CacheSpec(policy="proxy", threshold=0.1, split=1),
    }.items():
        plan = SamplingPlan(T=6, cache=spec)
        ts = sch.respaced_timesteps(sched.num_steps, plan.T)
        schedule = plan.resolve_schedule(fcfg)
        runner = pipe._static_runner(plan, schedule, ts, None, 1)
        for i, (part, (mode, tsub)) in enumerate(zip(
                graphs.pieces(runner), schedule.split_timesteps(ts))):
            if not len(tsub):
                continue
            delta = torch.zeros(cache_apply.delta_shape(fcfg, mode, B, True))
            for refresh in (True, False):
                fn = functools.partial(part.fn, refresh)
                args = ((fparams, None), x, torch.full((B,), int(tsub[0])),
                        delta, cond, null, None, None)
                gm, errs = _trace("cached_runner", fn, *args)
                findings.extend(errs)
                if gm is None:
                    continue
                fps.setdefault((i, refresh), {})[tag] = fingerprint(gm)
                findings.extend(check_graph(gm, "cached_runner"))
    for (i, refresh), by_spec in fps.items():
        findings.extend(_drift(f"cached_runner[phase {i}, refresh={refresh}]",
                               by_spec, "cache policies (same split)"))
    first = fps[min(fps)] if fps else {}
    return AuditReport(findings, {"cached_runner": first.get("interval", "")})


def audit_tapped_step() -> AuditReport:
    """Telemetry taps are data, not structure (DESIGN.md §telemetry): for
    the plain and cached packed families, dropping the tap outputs of the
    tapped graph and eliminating dead code gives the untapped graph
    exactly, and the tapped graph is ladder-invariant."""
    from repro_torch.pipeline.packed import PackLayout, make_packed_step_fn
    _fparams, fcfg, sched = _tiny()
    layout = PackLayout(groups=LAYOUT_GROUPS, guided=True)
    findings: List[Finding] = []
    fingerprints: Dict[str, str] = {}
    for split, unit in ((None, "packed_step_tapped"),
                        (1, "packed_cached_step_tapped")):
        off = make_packed_step_fn(fcfg, sched, layout, cache_split=split)
        on = make_packed_step_fn(fcfg, sched, layout, cache_split=split,
                                 taps=True)
        fps: Dict[str, str] = {}
        last = None
        for tag, ladder in {"ladder-hi": (90,), "ladder-lo": (30,)}.items():
            args = packed_args(layout, 1, ladder, cache_split=split)
            gt, errs = _trace(unit, *_flat(captured_body(on, *args)))
            findings.extend(errs)
            if gt is None:
                continue
            fps[tag] = fingerprint(gt)
            last = gt
            if tag != "ladder-hi":
                continue
            go, errs = _trace(unit, *_flat(captured_body(off, *args)))
            findings.extend(errs)
            if go is None:
                continue
            n = n_outputs(go)
            dce_t = fingerprint(keep_outputs(gt, n))
            dce_o = fingerprint(keep_outputs(go, n))
            if dce_t != dce_o:
                findings.append(Finding(
                    "graph-tap-structure", "error", PIPELINE_PATH, 0,
                    f"{unit} ({tag}): dropping the tap outputs does not "
                    f"recover the untapped graph ({dce_t[:10]} != "
                    f"{dce_o[:10]}) — taps changed the step's structure, "
                    f"not just its outputs", unit))
        findings.extend(_drift(unit, fps, "budget ladders (taps on)"))
        if last is not None:
            findings.extend(check_graph(last, unit))
            fingerprints[unit] = fps.get("ladder-hi", "")
    return AuditReport(findings, fingerprints)


def audit_attention_segments() -> AuditReport:
    """Dense attention and the flash kernel's plain version at fixed
    geometry, two segment-id contents (a pack-layout occupancy change)."""
    from repro_torch.kernels.attention import ops as attn_ops
    from repro_torch.models import attention as attn_mod
    _fparams, fcfg, _sched = _tiny()
    a = fcfg.attn
    d = fcfg.d_model
    params = {
        "wq": torch.zeros((d, a.num_heads, a.head_dim)),
        "wk": torch.zeros((d, a.num_kv_heads, a.head_dim)),
        "wv": torch.zeros((d, a.num_kv_heads, a.head_dim)),
        "wo": torch.zeros((a.num_heads, a.head_dim, d)),
    }
    S = 32
    seg_a = torch.cat([torch.zeros((1, S // 2), dtype=torch.int32),
                       torch.ones((1, S // 2), dtype=torch.int32)], dim=1)
    seg_b = torch.zeros((1, S), dtype=torch.int32)

    def dense(params, x, seg):
        return attn_mod.attention(params, x, a, causal=False,
                                  segment_ids=seg, backend="dense")

    def flash(q, k, v, seg):
        return attn_ops.flash_attention(q, k, v, causal=False,
                                        segment_ids=seg, block_q=16,
                                        block_k=16)

    x = torch.zeros((1, S, d))
    q = torch.zeros((1, S, a.num_heads, a.head_dim))
    out = AuditReport([], {})
    for unit, fn, head in (("attention_segments", dense, (params, x)),
                           ("flash_plain_segments", flash, (q, q, q))):
        rep = _invariant(unit, {"two-seg": (fn, head + (seg_a,)),
                                "one-seg": (fn, head + (seg_b,))},
                         "segment-id contents")
        out.findings.extend(rep.findings)
        out.fingerprints.update(rep.fingerprints)
    return out


def audit_runners() -> AuditReport:
    """Every runner kind ``FlexiPipeline._lookup`` caches (static DDIM
    and DDPM, cached, flow, adaptive NFEs, uncached and cached packed
    steps) goes through ``runtime.graphs`` and is captured on CUDA (not
    held eager)."""
    from repro_torch.cache.policy import CacheSpec
    from repro_torch.pipeline import AdaptiveBudget, FlexiPipeline, SamplingPlan
    from repro_torch.pipeline.packed import PackLayout
    from repro_torch.runtime import graphs
    fparams, fcfg, sched = _tiny()
    pipe = FlexiPipeline(fparams, fcfg, sched, device="cpu")
    gen = torch.Generator().manual_seed(0)
    for plan in (SamplingPlan(T=2), SamplingPlan(T=2, solver="ddpm"),
                 SamplingPlan(T=2, cache=CacheSpec(policy="interval",
                                                   interval=2, split=1)),
                 SamplingPlan(T=2, solver="flow_euler", guidance_scale=0.0),
                 SamplingPlan(T=2, budget=AdaptiveBudget())):
        pipe.sample(plan, 1, gen)
    layout = PackLayout(groups=((0, 1),), guided=True)
    pipe.packed_step(layout)
    pipe.packed_step(layout, cache_split=1)
    findings = []
    for key, runner in list(pipe._runners.items()) + list(pipe._nfes.items()):
        parts = graphs.pieces(runner)
        if not parts or any(p.eager_only for p in parts):
            sym = str(key[0] if isinstance(key, tuple) else key)[:40]
            findings.append(Finding(
                "graph-uncaptured-runner", "error", PIPELINE_PATH, 0,
                f"the {sym} runner FlexiPipeline._lookup built does not go "
                f"through runtime.graphs: it would run eagerly on the card",
                "FlexiPipeline._lookup"))
    findings.extend(lm_runner_findings())
    return AuditReport(findings, {})


# ---------------------------------------------------------------------------
# The language models' serving steps

#: one tiny config a family: dense with window, softcap and scaled
#: embeddings (gemma2), MoE, hybrid (attention beside an SSM), vision, audio
LM_AUDIT_ARCHS = ("gemma2-9b", "deepseek-moe-16b", "hymba-1.5b",
                  "llama-3.2-vision-90b", "whisper-small")
LM_B, LM_S, LM_NEW = 2, 8, 4


@functools.lru_cache(maxsize=None)
def _tiny_lm(arch: str):
    """The arch's reduced config (float32) and its parameters from seed 0,
    on the CPU."""
    from repro_torch.configs import get_config
    from repro_torch.models import lm
    cfg = get_config(arch).reduced()
    return cfg, lm.init_params(cfg, torch.Generator().manual_seed(0))


def _lm_inputs(cfg, seed: int) -> Dict[str, torch.Tensor]:
    """A prompt batch (and the vision / audio states) drawn from ``seed``."""
    g = torch.Generator().manual_seed(seed)
    inputs = {"tokens": torch.randint(0, cfg.vocab_size, (LM_B, LM_S),
                                      generator=g, dtype=torch.int32)}
    if cfg.family == "vlm":
        inputs["vision"] = torch.randn((LM_B, cfg.vision_tokens, cfg.d_model),
                                       generator=g)
    if cfg.family == "audio":
        inputs["frames"] = torch.randn((LM_B, cfg.audio_frames, cfg.d_model),
                                       generator=g)
    return inputs


def audit_lm_steps(arch: str, decode_body: Optional[Callable] = None
                   ) -> AuditReport:
    """The bodies ``launch/steps`` captures for ``arch``'s tiny config: the
    prefill at two token contents gives one graph, the decode on one cache
    slot (``lm.serve_slot``) at two positions and two token contents gives
    one graph; each walked for host reads. ``decode_body`` stands in for
    the decode step's body (a planted fault)."""
    from repro_torch.launch import steps
    from repro_torch.models import lm
    cfg, params = _tiny_lm(arch)
    prefill = steps.make_prefill_step(cfg).fn
    decode = decode_body or steps.make_decode_step(cfg).fn
    out = _invariant(f"lm_prefill[{arch}]", {
        f"tokens-{seed}": (prefill, (params, _lm_inputs(cfg, seed)))
        for seed in (0, 1)}, "token contents", LM_STEPS_PATH)
    slot = lm.serve_slot(cfg, LM_B, LM_S + LM_NEW, "cpu")
    cases = {}
    for i in range(2):
        tok = _lm_inputs(cfg, 2 + i)["tokens"][:, :1]
        pos = torch.full((LM_B,), LM_S + i, dtype=torch.int32)
        cases[f"pos-{LM_S + i}"] = (decode, (params, slot, tok, pos))
    rep = _invariant(f"lm_decode[{arch}]", cases,
                     "positions and token contents", LM_STEPS_PATH)
    out.findings.extend(rep.findings)
    out.fingerprints.update(rep.fingerprints)
    return out


def audit_lm_serving() -> AuditReport:
    """:func:`audit_lm_steps` for every family of ``LM_AUDIT_ARCHS``."""
    out = AuditReport([], {})
    for arch in LM_AUDIT_ARCHS:
        rep = audit_lm_steps(arch)
        out.findings.extend(rep.findings)
        out.fingerprints.update(rep.fingerprints)
    return out


def lm_runner_findings(factories: Optional[Dict[str, Tuple[Callable, Tuple[
        int, ...]]]] = None) -> List[Finding]:
    """``graph-uncaptured-runner`` over the LM step factories (name →
    (factory, the arguments its runner must donate); default
    ``launch/steps``' two, the decode donating its cache as the
    reference's ``donate_argnums=(1,)``): each must return a
    ``runtime.graphs`` runner captured on CUDA."""
    from repro_torch.launch import steps
    from repro_torch.runtime import graphs
    if factories is None:
        factories = {"make_prefill_step": (steps.make_prefill_step, ()),
                     "make_decode_step": (steps.make_decode_step, (1,))}
    cfg, _ = _tiny_lm(LM_AUDIT_ARCHS[0])
    findings = []
    for name, (factory, donate) in factories.items():
        runner = factory(cfg)
        if not isinstance(runner, graphs.Captured) or runner.eager_only:
            why = ("does not go through runtime.graphs: it would run eagerly "
                   "on the card")
        elif runner.donate != donate:
            why = (f"donates arguments {runner.donate}, not {donate}: on the "
                   f"card the cache would be copied in and cloned out a step")
        else:
            continue
        findings.append(Finding(
            "graph-uncaptured-runner", "error", LM_STEPS_PATH, 0,
            f"the runner of launch/steps.{name} {why}", name))
    return findings


# ---------------------------------------------------------------------------
# Entry point


def audit_step_functions() -> AuditReport:
    """Run every audit unit; units that cannot even build surface as
    ``graph-trace-failure`` findings rather than crashing the CLI."""
    findings: List[Finding] = []
    fingerprints: Dict[str, str] = {}
    units = [audit_plain_step, audit_packed_step, audit_packed_cached_step,
             audit_cached_runner, audit_tapped_step,
             audit_attention_segments, audit_runners, audit_lm_serving]
    for unit in units:
        try:
            with torch.inference_mode(False), torch.no_grad():
                rep = unit()
        except Exception as e:
            findings.append(Finding(
                "graph-trace-failure", "error", PIPELINE_PATH, 0,
                f"audit unit {unit.__name__} failed to build: "
                f"{type(e).__name__}: {e}", unit.__name__))
            continue
        findings.extend(rep.findings)
        fingerprints.update(rep.fingerprints)
    return AuditReport(findings, fingerprints)
