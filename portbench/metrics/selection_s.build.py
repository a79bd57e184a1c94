"""Mean seconds of the selection stage over the window's builds
(``HNSWIndex.build(stage_times=)``)."""


def read(ctx):
    times = ctx["counters"].get("selection_s")
    return sum(times) / len(times) if times else None
