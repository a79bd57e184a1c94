"""Seconds from the process's start to the first timed operation: loading,
making the inputs, building and warming up (host clock)."""


def read(ctx):
    return ctx["setup_s"]
