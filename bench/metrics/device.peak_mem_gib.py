"""The most device memory allocated at once during the window
(``torch.cuda.max_memory_allocated`` after a reset at its opening), GiB."""


def read(obs, ctx):
    b = obs.get("peak_bytes_window")
    return None if b is None else b / 2 ** 30
