"""``torch.cuda.max_memory_allocated`` over the window, reset at its start,
in GiB: the largest library one card builds or traverses."""


def read(ctx):
    peak = ctx["window_peak_bytes"]
    return None if peak is None else peak / 2 ** 30
