"""Runners built plus CUDA graphs captured while the window ran (the
pipeline's cache counters before and after): 0 when set-up warmed every
shape the traffic reaches."""


def read(obs, ctx):
    return None if "built_in_window" not in obs else \
        float(obs["built_in_window"])
