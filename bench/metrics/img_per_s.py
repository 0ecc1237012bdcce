"""Images finished inside the window over the window's seconds (host
clock): a closed loop's window spans whole dispatches, a batch loop's
whole batches."""


def read(obs, ctx):
    if "completed" not in obs or not obs.get("window_s"):
        return None
    return obs["completed"] / obs["window_s"]
