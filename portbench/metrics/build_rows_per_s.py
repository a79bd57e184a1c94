"""Rows of every whole build in the window over those builds' host-clock
seconds (``HNSWIndex.add`` and ``build``)."""


def read(ctx):
    c = ctx["counters"]
    if "build_rows" not in c:
        return None
    return c["build_rows"] / c["build_s"]
