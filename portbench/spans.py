"""The program's spans joined to the device trace by launch.

Inside ``rad_tpu_torch.utils.profiling.recording()`` the port opens spans
named ``rad.<name>`` (``torch.profiler.record_function``) around the
traversal step, its sub-steps and read-backs, and the build's stages.
Where the device ran an operation is no guide to which span asked for it:
the host runs ahead of the device, so a kernel launched inside
``rad.step.expand`` may run while the host is already in
``rad.step.integrate``. The launch says it:

- a *host launch* is a CUDA runtime or driver call whose
  ``correlation_id()`` a device operation (kernel, copy, set) shares: a
  kernel launch, an async copy or set, a graph launch (one launch, however
  many kernels the graph holds);
- each host launch, and the device time of every operation linked to it,
  belongs to the innermost ``rad.`` or ``pb.`` span open on the launching
  thread when the host made the call, and to each span around that one.

:func:`launch_join` returns ``launches_by_span`` and ``device_s_by_span``,
both inclusive of nested spans, so they need no synchronisation at span
boundaries. :func:`idle_gaps` names each idle gap of the device by the
innermost ``rad.`` or ``pb.`` span open when it began: the rule of
:func:`portbench.trace.summarize`, which admits ``pb.`` spans alone, and
gives the same result on a trace without ``rad.`` spans.
"""

from __future__ import annotations

import collections
import heapq

from portbench.trace import _on_device

SPAN_PREFIXES = ("rad.", "pb.")
RUNTIME_ACTIVITIES = {"cuda_runtime", "cuda_driver"}


def _is_runtime_call(e) -> bool:
    """Whether a host event that is no span is a CUDA runtime or driver
    call (``activity_type`` where this torch has it, else its name, which
    is the CUDA API's:
    ``cudaLaunchKernel``, ``cudaMemcpyAsync``, ``cuLaunchKernel``...)."""
    kind = getattr(e, "activity_type", None)
    if kind is not None:
        return kind() in RUNTIME_ACTIVITIES
    return e.name().startswith("cu")


def _is_span(e) -> bool:
    """A ``rad.`` or ``pb.`` span (not one of the benchmark's zero-length
    ``pb.mark.`` marks)."""
    name = e.name()
    return (e.is_user_annotation() and name.startswith(SPAN_PREFIXES)
            and not name.startswith("pb.mark."))


def host_spans(events) -> list:
    """``(start_ns, end_ns, thread, name)`` of every ``rad.`` and ``pb.``
    span on the host (not its shadow on the device's timeline), sorted."""
    out = [(e.start_ns(), e.start_ns() + e.duration_ns(),
            e.start_thread_id(), e.name())
           for e in events if _is_span(e) and not _on_device(e)]
    out.sort()
    return out


def launch_join(events) -> dict:
    """``launches_by_span``, ``device_s_by_span`` (``{span name: ...}``,
    each span with the spans inside it), ``launches`` (all host launches)
    and ``device_s`` (device seconds of every linked operation)."""
    dev_s = collections.Counter()
    calls = {}
    spans = []
    for e in events:
        if _on_device(e):
            if not e.is_user_annotation():
                dev_s[e.correlation_id()] += e.duration_ns()
        elif e.is_user_annotation():
            if _is_span(e):
                spans.append((e.start_ns(), e.start_ns() + e.duration_ns(),
                              e.start_thread_id(), e.name()))
        elif _is_runtime_call(e):
            calls[e.correlation_id()] = (e.start_ns(), e.start_thread_id())
    launches = sorted((t, thread, corr) for corr, (t, thread)
                      in calls.items() if corr in dev_s)
    by_thread = collections.defaultdict(list)
    for s in spans:
        by_thread[s[2]].append(s)
    for ss in by_thread.values():
        # outer before inner where two start together
        ss.sort(key=lambda s: (s[0], -s[1]))
    n = collections.Counter()
    ns = collections.Counter()
    cursor = collections.Counter()
    stacks = collections.defaultdict(list)
    for t, thread, corr in launches:
        ss, stack = by_thread.get(thread, ()), stacks[thread]
        i = cursor[thread]
        while i < len(ss) and ss[i][0] <= t:
            while stack and stack[-1][1] <= ss[i][0]:
                stack.pop()
            stack.append(ss[i])
            i += 1
        cursor[thread] = i
        while stack and stack[-1][1] <= t:
            stack.pop()
        for name in {s[3] for s in stack}:
            n[name] += 1
            ns[name] += dev_s[corr]
    return {
        "launches_by_span": dict(n),
        "device_s_by_span": {k: v / 1e9 for k, v in ns.items()},
        "launches": len(launches),
        "device_s": sum(dev_s[c] for _, _, c in launches) / 1e9,
    }


def idle_gaps(intervals, spans, top: int = 10) -> list:
    """``[[name, seconds], ...]``, the ``top`` largest: each gap between
    the merged device ``intervals`` (``[(start_ns, end_ns), ...]``, as
    :func:`portbench.trace.summarize` keeps them) under the narrowest of
    ``spans`` (:func:`host_spans`) open at its start (the first of equals
    in their order), or "outside spans"."""
    idle = collections.Counter()
    open_spans = []     # (width, order, end, name), narrowest first
    i = 0
    for (_, g0), (g1, _) in zip(intervals, intervals[1:]):
        while i < len(spans) and spans[i][0] <= g0:
            s, e, _, name = spans[i]
            heapq.heappush(open_spans, (e - s, i, e, name))
            i += 1
        # gaps come in order, so a span closed at one is closed at the next
        while open_spans and open_spans[0][2] <= g0:
            heapq.heappop(open_spans)
        name = open_spans[0][3] if open_spans else "outside spans"
        idle[name] += (g1 - g0) / 1e9
    return [[k, v] for k, v in idle.most_common(top)]
