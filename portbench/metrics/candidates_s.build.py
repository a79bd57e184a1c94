"""Mean seconds of the candidates stage over the window's builds
(``HNSWIndex.build(stage_times=)``, synchronised at stage boundaries)."""


def read(ctx):
    times = ctx["counters"].get("candidates_s")
    return sum(times) / len(times) if times else None
