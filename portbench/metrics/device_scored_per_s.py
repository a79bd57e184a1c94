"""Molecules scored by the device-scored campaigns of the window over the
window's host-clock seconds, each campaign's set-up and read-back
included."""


def read(ctx):
    c = ctx["counters"]
    if "device_scored" not in c:
        return None
    return c["device_scored"] / c["wall_s"]
