"""Seconds from the process's start to the window's opening (host
clock): imports, weights, the program's set-up and warm-up (compilation
in a checkout's first run), and a closed loop's first turnover."""


def read(obs, ctx):
    return obs.get("setup_s")
