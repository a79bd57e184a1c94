"""Share of the traced slice of the window (the first probed build) in
which no operation ran on the device: 100 (1 - busy / slice), busy the
union of the profiler's kernel, copy and set intervals."""


def read(ctx):
    if "partition_s" not in ctx["counters"] or ctx["trace"] is None:
        return None
    return ctx["trace"]["idle_pct"]
