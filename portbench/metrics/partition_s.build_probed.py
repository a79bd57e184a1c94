"""Mean seconds of the probed layers' partition and probe lists over the
window's traced builds (``HNSWIndex.build(stage_times=)``'s
``"bisection"`` and ``"probe_tables"``: host seconds, each level of the
bisection ending in a read-back and a host sort)."""


def read(ctx):
    times = ctx["counters"].get("partition_s")
    return sum(times) / len(times) if times else None
