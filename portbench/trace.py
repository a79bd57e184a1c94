"""Spans around the calls into the program, and the device trace of a
slice of the window.

Every driver wraps its calls into a layer in :meth:`Tracer.span` (a
``torch.profiler.record_function`` named ``pb.<layer>`` when tracing, a
no-op otherwise) and each unit of work (a campaign, a build) in
:meth:`Tracer.unit`. In a ``--trace 1`` run the profiler records the units
``[start, start + count)`` that the traffic's ``trace_units`` names, and
:func:`summarize` reduces what it recorded: the seconds in which any
operation ran on the device (the union of kernel, copy and set intervals),
the slice's length, device time by operation, and the idle gaps by the
innermost span the host was in when each began.
"""

from __future__ import annotations

import bisect
import collections
import contextlib
import time

import torch

DEVICE_ACTIVITIES = {"kernel", "gpu_memcpy", "gpu_memset",
                     "concurrent kernel"}


class Tracer:
    def __init__(self, enabled: bool, units=(1, 1)):
        self.enabled = enabled
        self.start, self.count = (int(units[0]), int(units[1]))
        self.summary = None
        self._prof = None
        self._t0 = None

    def mark(self, name: str) -> float:
        """A zero-length span ``pb.mark.<name>`` in the trace; returns the
        host clock (``perf_counter``) at that moment, which ties the two
        clocks together."""
        with torch.profiler.record_function(f"pb.mark.{name}"):
            return time.perf_counter()

    def span(self, name: str):
        if not self.enabled:
            return contextlib.nullcontext()
        return torch.profiler.record_function(f"pb.{name}")

    @contextlib.contextmanager
    def unit(self, index: int, device):
        """Wraps unit ``index`` of the window; the traced slice starts
        before the first unit it covers and stops after the last."""
        first = self.enabled and index == self.start
        last = self.enabled and index == self.start + self.count - 1
        if first:
            _sync(device)
            self._prof = _Profiler(device)
            self._t0 = time.perf_counter()
        yield
        if last:
            self.close(device)

    def close(self, device) -> None:
        """Stops the slice (also one that the window's end cut short) and
        keeps its summary."""
        if self._prof is not None:
            _sync(device)
            window_s = time.perf_counter() - self._t0
            self.summary = summarize(self._prof.stop(), window_s)
            self._prof = None


class _Profiler:
    """The profiler's own start and stop: the raw events go straight to
    :func:`summarize`, with no Python event objects built on the way."""

    def __init__(self, device):
        from torch.autograd import (ProfilerActivity, ProfilerConfig,
                                    ProfilerState, _enable_profiler,
                                    _prepare_profiler)
        from torch._C._profiler import _ExperimentalConfig

        acts = {ProfilerActivity.CPU}
        if device.type == "cuda":
            acts.add(ProfilerActivity.CUDA)
        config = ProfilerConfig(ProfilerState.KINETO, False, False, False,
                                False, False, _ExperimentalConfig())
        _prepare_profiler(config, acts)
        _enable_profiler(config, acts)

    def stop(self):
        from torch.autograd import _disable_profiler

        return _disable_profiler().events()


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _on_device(e) -> bool:
    """A kernel, copy or set on the device (``activity_type`` where this
    torch has it, else the event's device)."""
    kind = getattr(e, "activity_type", None)
    if kind is not None:
        return kind() in DEVICE_ACTIVITIES
    return e.device_type() != torch.autograd.DeviceType.CPU


def summarize(events, window_s: float, top: int = 10) -> dict:
    """``busy_s`` (union of device intervals), ``window_s``, ``idle_pct``,
    ``device_ops`` and ``idle_gaps`` (``[[name, seconds], ...]``, the
    ``top`` largest) from profiler events."""
    dev, spans, marks, merged = [], [], {}, []
    by_op = collections.Counter()
    for e in events:
        name = e.name()
        if _on_device(e):
            if e.is_user_annotation() or name.startswith("pb."):
                continue    # a span's shadow on the device's timeline
            s, d = e.start_ns(), e.duration_ns()
            dev.append((s, s + d))
            by_op[name[:120]] += d / 1e9
        elif e.is_user_annotation() and name.startswith("pb.mark."):
            marks[name] = e.start_ns()
        elif e.is_user_annotation() and name.startswith("pb."):
            s = e.start_ns()
            spans.append((s, s + e.duration_ns(), name))
    if not dev:
        return {"busy_s": 0.0, "window_s": window_s, "idle_pct": None,
                "device_ops": [], "idle_gaps": [], "intervals": [],
                "marks": marks}
    dev.sort()
    busy, gaps = 0, []
    cur_s, cur_e = dev[0]
    for s, e in dev[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            merged.append((cur_s, cur_e))
            gaps.append((cur_e, s))
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    merged.append((cur_s, cur_e))
    busy_s = busy / 1e9
    # each gap goes to the innermost benchmark span open at its start
    spans.sort()
    starts = [s for s, _, _ in spans]
    idle = collections.Counter()
    for g0, g1 in gaps:
        name = "outside spans"
        width = None
        for s, e, n in spans[: bisect.bisect_right(starts, g0)]:
            if s <= g0 < e and (width is None or e - s < width):
                name, width = n, e - s
        idle[name] += (g1 - g0) / 1e9
    return {
        "busy_s": busy_s,
        "window_s": window_s,
        "idle_pct": 100.0 * max(0.0, 1.0 - busy_s / window_s),
        "device_ops": [[k, v] for k, v in by_op.most_common(top)],
        "idle_gaps": [[k, v] for k, v in idle.most_common(top)],
        "intervals": merged,
        "marks": marks,
    }


def busy_within(summary: dict, a_ns: float, b_ns: float) -> float:
    """Seconds in ``[a_ns, b_ns]`` (profiler clock) in which an operation
    ran on the device."""
    total = 0
    for s, e in summary["intervals"]:
        lo, hi = max(s, a_ns), min(e, b_ns)
        if hi > lo:
            total += hi - lo
    return total / 1e9
