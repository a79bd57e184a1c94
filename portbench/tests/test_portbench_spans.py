"""The launch join (portbench.spans) on synthetic event lists: host
launches attributed by correlation id to the innermost span open on their
thread, totals inclusive of nested spans, and idle gaps named by the
innermost ``rad.`` or ``pb.`` span, as ``summarize`` names them when the
trace holds no ``rad.`` span."""

from __future__ import annotations

import pytest

from portbench.spans import host_spans, idle_gaps, launch_join
from portbench.trace import summarize


class Ev:
    """A profiler event as torch builds without ``activity_type`` give it:
    the device by ``device_type()``."""

    def __init__(self, name, start, dur, corr=0, thread=1, device=False,
                 annotation=False):
        self.n, self.s, self.d, self.c = name, start, dur, corr
        self.t, self.dev, self.a = thread, device, annotation

    def name(self):
        return self.n

    def start_ns(self):
        return self.s

    def duration_ns(self):
        return self.d

    def correlation_id(self):
        return self.c

    def start_thread_id(self):
        return self.t

    def is_user_annotation(self):
        return self.a

    def device_type(self):
        import torch
        return (torch.autograd.DeviceType.CUDA if self.dev
                else torch.autograd.DeviceType.CPU)


class KindEv(Ev):
    """The same with ``activity_type``, as newer torch builds give it."""

    def activity_type(self):
        if self.a:
            return "gpu_user_annotation" if self.dev else "user_annotation"
        if self.dev:
            return "kernel"
        return "cuda_runtime" if self.n.startswith("cu") else "cpu_op"


def span(name, start, dur, thread=1, kind=Ev):
    return kind(name, start, dur, thread=thread, annotation=True)


def launch(name, start, corr, thread=1, kind=Ev):
    return kind(name, start, 2, corr=corr, thread=thread)


def op(name, start, dur, corr, kind=Ev):
    return kind(name, start, dur, corr=corr, device=True)


def step_trace(kind=Ev):
    """Two steps on thread 1; the device runs behind the host, so most of
    step 0's work runs while the host is in step 1."""
    return [
        span("rad.step", 0, 100, kind=kind),
        span("rad.step.expand", 5, 40, kind=kind),
        launch("cudaLaunchKernel", 10, 101, kind=kind),
        launch("cudaMemsetAsync", 20, 102, kind=kind),
        span("rad.step.integrate", 50, 40, kind=kind),
        launch("cudaGraphLaunch", 60, 103, kind=kind),
        span("rad.step", 100, 100, kind=kind),
        span("rad.step.expand", 105, 40, kind=kind),
        launch("cudaLaunchKernel", 110, 104, kind=kind),
        span("rad.sync.loop", 190, 10, kind=kind),
        launch("cudaMemcpyAsync", 191, 105, kind=kind),
        launch("cudaStreamSynchronize", 192, 106, kind=kind),
        # CPU ops share the number space of correlation ids: not launches
        kind("aten::add", 9, 5, corr=101),
        kind("cudaMalloc", 12, 3, corr=107),
        op("kernel_a", 100, 30, 101, kind=kind),
        op("Memset (Device)", 130, 10, 102, kind=kind),
        # a graph: three operations, one launch
        op("graph_k1", 140, 10, 103, kind=kind),
        op("graph_k2", 150, 10, 103, kind=kind),
        op("graph_k3", 160, 10, 103, kind=kind),
        op("kernel_b", 170, 20, 104, kind=kind),
        op("Memcpy DtoH", 200, 5, 105, kind=kind),
        Ev("rad.step", 100, 30, device=True, annotation=True),
    ]


@pytest.mark.parametrize("kind", [Ev, KindEv], ids=["device_type",
                                                     "activity_type"])
def test_launches_belong_to_the_span_open_on_the_host(kind):
    j = launch_join(step_trace(kind))
    assert j["launches"] == 5
    assert j["launches_by_span"] == {
        "rad.step": 5, "rad.step.expand": 3, "rad.step.integrate": 1,
        "rad.sync.loop": 1}
    by = j["device_s_by_span"]
    assert by["rad.step.expand"] == pytest.approx(60e-9)
    assert by["rad.step.integrate"] == pytest.approx(30e-9)
    assert by["rad.sync.loop"] == pytest.approx(5e-9)
    # inclusive: the step holds every sub-step
    assert by["rad.step"] == pytest.approx(95e-9)
    assert j["device_s"] == pytest.approx(95e-9)


def test_a_graph_launch_counts_once_for_all_its_kernels():
    events = [span("rad.step", 0, 50),
              launch("cudaGraphLaunch", 10, 7)] + \
        [op(f"k{i}", 60 + 10 * i, 10, 7) for i in range(4)]
    j = launch_join(events)
    assert j["launches_by_span"] == {"rad.step": 1}
    assert j["device_s_by_span"]["rad.step"] == pytest.approx(40e-9)


def test_spans_of_another_thread_do_not_claim_a_launch():
    events = [span("rad.step", 0, 100, thread=1),
              span("pb.campaign.run", 0, 200, thread=2),
              launch("cudaLaunchKernel", 50, 9, thread=2),
              launch("cudaLaunchKernel", 150, 10, thread=1),
              op("k", 160, 10, 9), op("k", 170, 10, 10)]
    j = launch_join(events)
    assert j["launches_by_span"] == {"pb.campaign.run": 1}
    assert j["launches"] == 2


def test_nested_spans_of_one_name_count_a_launch_once():
    events = [span("rad.step", 0, 100), span("rad.step", 10, 50),
              launch("cudaLaunchKernel", 20, 1), op("k", 30, 10, 1)]
    assert launch_join(events)["launches_by_span"] == {"rad.step": 1}


def test_idle_gaps_name_the_innermost_rad_span():
    events = [
        span("pb.campaign.run", 0, 1000),
        span("rad.step", 100, 400),
        span("rad.step.expand", 110, 100),
        span("pb.mark.0", 300, 0),
        op("k1", 100, 50, 1),           # device [100, 150)
        op("k2", 250, 50, 2),           # gap [150, 250) opens in expand
        op("k3", 600, 100, 3),          # gap [300, 600) in step, no mark
        op("k4", 900, 10, 4),           # gap [700, 900) in campaign.run
    ]
    s = summarize(events, window_s=1e-6)
    got = dict(idle_gaps(s["intervals"], host_spans(events)))
    assert got == {"rad.step.expand": pytest.approx(100e-9),
                   "rad.step": pytest.approx(300e-9),
                   "pb.campaign.run": pytest.approx(200e-9)}
    # summarize alone admits pb. spans only
    assert dict(s["idle_gaps"]) == {"pb.campaign.run": pytest.approx(600e-9)}


@pytest.mark.parametrize("kind", [Ev, KindEv], ids=["device_type",
                                                     "activity_type"])
def test_a_trace_without_rad_spans_gives_the_same_gaps(kind):
    events = [e for e in step_trace(kind) if not e.n.startswith("rad.")]
    events += [span("pb.campaign.run", 0, 150, kind=kind),
               span("pb.campaign.read", 150, 60, kind=kind),
               span("pb.campaign.init", 140, 5, kind=kind)]
    s = summarize(events, window_s=1e-6)
    assert s["idle_gaps"]
    assert idle_gaps(s["intervals"], host_spans(events)) == s["idle_gaps"]


def test_no_device_operation_no_launch():
    j = launch_join([span("rad.step", 0, 10),
                     launch("cudaLaunchKernel", 2, 1)])
    assert j == {"launches_by_span": {}, "device_s_by_span": {},
                 "launches": 0, "device_s": 0.0}
    assert idle_gaps([], []) == []
