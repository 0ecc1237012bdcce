"""The whole model step's share of the chip's bf16 peak over the traced
part of the window: the useful FLOPs of every forward it ran (the frozen
ledger's, dense attention inside segments, no padding or dummy
segments) over its seconds and 989 TFLOP/s, in percent."""
from benchlib import ledger, work


def read(obs, ctx):
    tr = obs.get("trace")
    fwd = work.traced_forwards(obs, ctx) if tr else None
    if not fwd or not tr["window_s"]:
        return None
    flops = sum(work.segment_flops(ctx.model, segs) for segs in fwd)
    return 100.0 * flops / (tr["window_s"] * ledger.PEAK_BF16_FLOPS)
