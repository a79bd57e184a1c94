"""Profiling helpers: a ``torch.profiler`` trace of any region, the
device-kernel time per kernel name in such a trace, a named timer, and the
program's own spans and counters.

The first three are the counterparts of :mod:`rad_tpu.utils.profiling`.
Not to be confused with :mod:`rad_tpu_torch.profiling`, the entry point
that profiles the 1M build and traversal step.

    with profile_trace("trace/"):
        run()
    per_kernel_ns, n_events = aggregate_device_ops("trace/")

Spans and counters are off unless a :func:`recording` block is open:

    with recording() as rec, torch.profiler.profile(...) as prof:
        fused_run(...)
    rec.counters    # {"step": 35, "sync.loop": 36, ...}

Inside the block, :func:`span` opens a ``torch.profiler.record_function``
named ``rad.<name>``, so under a profiler it lies on the same clock as the
kernels it launches and nests in the span around it; :func:`count` adds to
``rec.counters``. Outside it both return at once. The program records:

- the traversal step (:mod:`rad_tpu_torch.traverse.device`): span
  ``step``, each pass of the device-scored loop, from its loop read to
  the end of its integrate; ``step.expand``, ``step.score`` and
  ``step.integrate`` inside it; ``step.refill`` (the two-level head's
  rebuild) and ``step.merge`` (the buffer's merge into the head), the
  frontier's sorts; counter ``step``, once per ``expand``, from every
  engine that calls it (the device loop, ``DeviceTraverser``, the pod);
- every host read-back of device state on the step path, as span and
  counter ``sync.<site>`` (the span holds the read and the few
  operations that compute what it reads): ``loop`` (the device loop's condition),
  ``refill_check`` and ``merge_check`` (the two-level refill and the
  buffer's overflow), ``narrow`` (``narrow_width``'s test) and
  ``download`` (each of the pipelined driver's two copies of a step's
  ids to the host). Each stalls the host until the device has run
  everything launched before it;
- the exact build (:mod:`rad_tpu_torch.build.exact`): spans
  ``build.candidates``, ``build.selection`` and ``build.symmetrization``
  (the last with the host's read of the rows) around the stages that
  ``stage_times`` times, once a stage for each scanned layer; on a probed
  layer selection streams into the scan, so ``build.selection`` nests
  inside ``build.candidates``, once for each group of query blocks;
  counters ``build.bucket_topk`` and ``build.bucket_loop``, once per
  bucket scan (a big layer's, or a shard's span of it in the mesh build)
  by the path it took: the bucket top-k, or the column-block loop
  (buckets under 8 columns; on the card, k or the row width past the
  kernel's instances); on a probed layer (:mod:`rad_tpu_torch.build.
  probe`), spans ``build.bisection`` and ``build.probe_tables`` around
  the partition and the probe lists, and ``build.probe_scan`` around each
  q-block's loop over its probed clusters, with counters
  ``build.probe_qblocks`` (once a q-block) and ``build.probe_bucket`` /
  ``build.probe_matrix`` (once a cluster scanned, by the path it took:
  the bucket kernel or the distance matrix).
"""

from __future__ import annotations

import contextlib
import contextvars
import glob
import json
import os
import time
from typing import Dict, Iterator, Tuple

__all__ = ["profile_trace", "Timer", "aggregate_device_ops", "recording",
           "span", "count"]

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


class Recording:
    """What one :func:`recording` block counted: ``counters``, a plain
    ``{name: int}``."""

    def __init__(self) -> None:
        self.counters: Dict[str, int] = {}


# the span while recording is off: one object, entered and left again
_NULL_SPAN = contextlib.nullcontext()
# the open recording of this thread (or task), None while recording is off
_RECORDING: contextvars.ContextVar = contextvars.ContextVar(
    "rad_tpu_torch_recording", default=None)


@contextlib.contextmanager
def recording() -> Iterator[Recording]:
    """Turn the program's spans and counters on for the block (in this
    thread) and yield the :class:`Recording` whose ``counters`` they fill.
    A block nested in an open one yields the open one."""
    open_rec = _RECORDING.get()
    if open_rec is not None:
        yield open_rec
        return
    rec = Recording()
    token = _RECORDING.set(rec)
    try:
        yield rec
    finally:
        _RECORDING.reset(token)


def span(name: str):
    """A context for the span ``rad.<name>``: a
    ``torch.profiler.record_function`` while recording, else one shared
    object that does nothing (no torch call, no allocation)."""
    if _RECORDING.get() is None:
        return _NULL_SPAN
    from torch.profiler import record_function
    return record_function("rad." + name)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the open recording's counter ``name``; nothing while
    recording is off."""
    rec = _RECORDING.get()
    if rec is None:
        return
    rec.counters[name] = rec.counters.get(name, 0) + n


def _read_back(site: str):
    """The span around a host read of device state at ``site`` (counted as
    ``sync.<site>``): every such read on the traversal step's path goes
    through here."""
    count("sync." + site)
    return span("sync." + site)
