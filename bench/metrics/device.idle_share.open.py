"""Share of the traced part of the window in which no kernel, copy or
fill ran on the device (the union of the profiler's device intervals),
in percent."""


def read(obs, ctx):
    tr = obs.get("trace")
    if not tr or not tr["window_s"]:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
