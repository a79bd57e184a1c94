"""Profiling helpers: a ``torch.profiler`` trace of any region, the
device-kernel time per kernel name in such a trace, and a named timer.

The counterparts of :mod:`rad_tpu.utils.profiling`. Not to be confused
with :mod:`rad_tpu_torch.profiling`, the entry point that profiles the 1M
build and traversal step.

    with profile_trace("trace/"):
        run()
    per_kernel_ns, n_events = aggregate_device_ops("trace/")
"""

from __future__ import annotations

import contextlib
import glob
import json
import os
import time
from typing import Dict, Iterator, Tuple

__all__ = ["profile_trace", "Timer", "aggregate_device_ops"]

# the Chrome-trace categories of device work in a torch.profiler dump
_DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")


@contextlib.contextmanager
def profile_trace(logdir: str) -> Iterator[None]:
    """Trace the enclosed region with ``torch.profiler`` (the CPU, and the
    CUDA device when one is visible) and write it into ``logdir`` as a
    Chrome trace (``*.pt.trace.json``, for TensorBoard or Perfetto)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(
        logdir, f"trace_{os.getpid()}_{time.time_ns()}.pt.trace.json"))


def aggregate_device_ops(logdir: str) -> Tuple[Dict[str, int], int]:
    """Sum device time (ns) per kernel name over every trace that
    :func:`profile_trace` wrote under ``logdir``: kernels, copies and
    sets. Returns ``({name: total_ns}, n_events)``; a CPU-only trace gives
    ``({}, 0)``. The counterpart of ``rad_tpu``'s ``aggregate_xla_ops``."""
    files = glob.glob(os.path.join(logdir, "**", "*.pt.trace.json"),
                      recursive=True)
    if not files:
        raise RuntimeError(f"no *.pt.trace.json under {logdir}")
    agg: Dict[str, int] = {}
    n_events = 0
    for f in files:
        with open(f) as fh:
            events = json.load(fh).get("traceEvents", [])
        for ev in events:
            if ev.get("ph") != "X" or ev.get("cat") not in _DEVICE_CATEGORIES:
                continue
            # Chrome traces give durations in microseconds
            ns = int(round(float(ev.get("dur", 0)) * 1000))
            agg[ev["name"]] = agg.get(ev["name"], 0) + ns
            n_events += 1
    return agg, n_events


class Timer:
    """Accumulating named wall-clock timer for stats dicts."""

    def __init__(self) -> None:
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}

    @contextlib.contextmanager
    def section(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def stats(self) -> Dict[str, dict]:
        return {
            name: {
                "total_seconds": self.totals[name],
                "count": self.counts[name],
                "avg_ms": 1000.0 * self.totals[name]
                / max(self.counts[name], 1),
            }
            for name in self.totals
        }
