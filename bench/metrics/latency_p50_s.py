"""Median latency of the requests due in the window, from each request's
due time to its image being ready (host clock)."""
import numpy as np


def read(obs, ctx):
    lat = obs.get("latency_s")
    return float(np.percentile(lat, 50)) if lat else None
