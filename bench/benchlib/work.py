"""The useful work a traced part of a window held, from the harness's own
records of what it ran: for the serving engine each step's depth k, real
tokens and requests (the engine's step record), turned into each packed
forward's segments; for the pipeline the traced batches' forwards. Priced
by the frozen ledger (``benchlib.ledger``): FLOPs without padding or
dummy segments, the flash kernel's pairs inside segments only."""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from benchlib import ledger

Segments = List[Tuple[int, int]]      # (tokens, count)


def engine_modes(ctx) -> List[int]:
    m, p = ctx.model, ctx.mix["plan"]
    guided = p["guidance_scale"] != 0.0
    modes = set()
    for b in ctx.mix["budgets"]:
        modes.update(mode for mode, n in
                     ledger.resolve_schedule(m, p["T"], b, guided) if n)
    return sorted(modes)


def mode_counts(m: Dict, modes: List[int], tokens: int, n: int
                ) -> Optional[Dict[int, int]]:
    """Requests per mode of a packed forward holding ``n`` requests of
    ``tokens`` real tokens (one segment each); None when the records
    cannot tell (more than two modes)."""
    if len(modes) == 1:
        return {modes[0]: n}
    if len(modes) != 2:
        return None
    a, b = sorted(modes, key=lambda mo: -ledger.tokens_for_mode(m, mo))
    na, nb = ledger.tokens_for_mode(m, a), ledger.tokens_for_mode(m, b)
    c_a, rem = divmod(tokens - nb * n, na - nb)
    if rem or not 0 <= c_a <= n:
        return None
    return {a: c_a, b: n - c_a}


def engine_forwards(ctx, steps: List[Dict]) -> Optional[List[Dict[int, int]]]:
    """Requests per mode of each packed forward of ``steps`` (a step of
    depth k runs k forwards of one composition)."""
    m = ctx.model
    mult = 2 if ctx.mix["plan"]["guidance_scale"] != 0.0 else 1
    modes = engine_modes(ctx)
    out = []
    for s in steps:
        per_fwd, rem = divmod(s["real"], mult * s["k"])
        counts = None if rem else mode_counts(m, modes, per_fwd, s["n"])
        if counts is None:
            return None
        out += [counts] * s["k"]
    return out


def pipeline_forwards(ctx, batches: int) -> List[int]:
    """The mode of each forward of ``batches`` batches."""
    m, p = ctx.model, ctx.mix["plan"]
    phases = ledger.resolve_schedule(m, p["T"], p["budget"],
                                     p["guidance_scale"] != 0.0)
    return ledger.step_modes(phases) * batches


def traced_forwards(obs: Dict, ctx) -> Optional[List[Segments]]:
    """The segments of every forward the traced part ran, a forward's
    CFG pair counted as two segments."""
    m = ctx.model
    if "steps" in obs:
        mult = 2 if ctx.mix["plan"]["guidance_scale"] != 0.0 else 1
        fwd = engine_forwards(ctx, [s for s in obs["steps"] if s["traced"]])
        if fwd is None:
            return None
        return [[(ledger.tokens_for_mode(m, mo), mult * c)
                 for mo, c in counts.items() if c] for counts in fwd]
    B = obs["batch"]
    return [[(ledger.tokens_for_mode(m, mo), B)]
            for mo in pipeline_forwards(ctx, obs["traced_batches"])]


def segment_flops(m: Dict, segments: Segments) -> float:
    by_tokens = {ledger.tokens_for_mode(m, mo): mo
                 for mo in range(len(ledger.patch_sizes(m)))}
    return sum(c * ledger.nfe_flops(m, by_tokens[n]) for n, c in segments)
