"""Device seconds inside the traced build's probed scans: the union of
kernel, copy and set intervals within each q-block group's scan, placed
by the ``stage_times`` writes around it."""


def read(ctx):
    return ctx["counters"].get("probe_scan_device_s") or None
