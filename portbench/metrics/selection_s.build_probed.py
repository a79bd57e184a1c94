"""Mean seconds of the selection stage over the window's traced probed
builds (``HNSWIndex.build(stage_times=)``'s ``"selection"``: on the probed
layer each group of q-blocks between two device synchronisations)."""


def read(ctx):
    times = ctx["counters"].get("selection_s")
    return sum(times) / len(times) if times else None
