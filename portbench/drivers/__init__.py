"""One module per kind of driven entry, named by a traffic file's
``driver``. Each has ``make(config, traffic, seed, device)`` returning an
object with:

- ``setup()``: make the inputs from the seed, build what the cell needs,
  warm up the cell's own shapes;
- ``window(seconds, tracer, control=False) -> counters``: the closed loop
  of units (campaigns or builds) for ``seconds``; ``control=True`` puts
  the reference, in the precision below the configuration's, in the
  program's place;
- ``release()``: free the program's state;
- ``check() -> [{"name", "value", "limit"}]``: the comparison of what the
  window produced with the reference, and ``failed``, the units that
  failed it.
"""

from __future__ import annotations

import time

import torch


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Parts:
    """Seconds of each part of a set-up, each ended by a device
    synchronisation (reported on standard error)."""

    def __init__(self, device):
        self.device = device
        self.parts = {}
        self._t = time.perf_counter()

    def done(self, name: str) -> None:
        sync(self.device)
        now = time.perf_counter()
        self.parts[name] = round(now - self._t, 3)
        self._t = now


def closed_loop(seconds: float, device, tracer, unit, next_fits=None):
    """Runs ``unit(i)`` back to back until ``seconds`` have passed (the
    last unit started in time runs to its end); ``next_fits(elapsed,
    last_unit_s)`` may refuse to start a unit. Returns ``(units, wall
    seconds, each unit's seconds)``."""
    sync(device)
    t0 = time.perf_counter()
    i = 0
    last = None
    unit_s = []
    while True:
        elapsed = time.perf_counter() - t0
        if i > 0 and elapsed >= seconds:
            break
        if i > 0 and next_fits is not None and not next_fits(elapsed, last):
            break
        t_unit = time.perf_counter()
        with tracer.unit(i, device):
            unit(i)
        sync(device)
        last = time.perf_counter() - t_unit
        unit_s.append(last)
        i += 1
    wall = time.perf_counter() - t0
    tracer.close(device)
    return i, wall, unit_s


def mismatches(a, b) -> int:
    """Positions at which two 1-D arrays differ, plus their length gap."""
    import numpy as np

    a, b = np.asarray(a), np.asarray(b)
    n = min(len(a), len(b))
    if a.dtype.kind == "f" or b.dtype.kind == "f":
        # bit for bit
        a = a.astype(np.float32).view(np.int32)
        b = b.astype(np.float32).view(np.int32)
    return int((a[:n] != b[:n]).sum()) + abs(len(a) - len(b))
