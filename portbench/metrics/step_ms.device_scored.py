"""Host-clock milliseconds of the window's ``fused_run`` / ``run`` calls
over the steps their states counted."""


def read(ctx):
    c = ctx["counters"]
    if "device_scored" not in c or not c["steps"]:
        return None
    return 1e3 * c["run_s"] / c["steps"]
