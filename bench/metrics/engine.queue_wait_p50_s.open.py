"""Median wait from a request's due time to the engine admitting it into
its in-flight set (the engine's admit stamp, host clock)."""
import numpy as np


def read(obs, ctx):
    w = obs.get("queue_wait_s")
    return float(np.percentile(w, 50)) if w else None
