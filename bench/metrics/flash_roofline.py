"""The flash kernel's share of its roofline over the traced part of the
window: the least time its launches needed (each the larger of its
operations at 989 TFLOP/s and its bytes at 3.35 TB/s, pairs inside
segments only, q, k, v and o once) over the kernel's device time in the
profiler's trace, in percent. One launch a layer a forward; a trace whose
launch count disagrees reads nothing."""
import sys

from benchlib import ledger, work


def read(obs, ctx):
    tr = obs.get("trace")
    fwd = work.traced_forwards(obs, ctx) if tr else None
    if not fwd or not tr["flash_s"]:
        return None
    m = ctx.model
    d_attn = m["attn"]["num_heads"] * m["attn"]["head_dim"]
    L = m["num_layers"]
    if len(tr["flash_s"]) != L * len(fwd):
        print(f"flash_roofline: {len(tr['flash_s'])} launches traced, "
              f"{L * len(fwd)} expected", file=sys.stderr)
        return None
    least = L * sum(ledger.least_seconds(*ledger.flash_work(segs, d_attn))
                    for segs in fwd)
    return 100.0 * least / sum(tr["flash_s"])
