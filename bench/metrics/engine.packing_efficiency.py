"""Real segment tokens over the tokens the packed forwards computed (rows
x capacity, dummy segments and row padding included), over the window's
engine steps: the engine's own step records, exact host counts."""


def read(obs, ctx):
    steps = obs.get("steps")
    if not steps:
        return None
    packed = sum(s["packed"] for s in steps)
    return sum(s["real"] for s in steps) / packed if packed else None
