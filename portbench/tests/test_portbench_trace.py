"""The reduction from trace events to metrics, and the roofline arithmetic
from shapes."""

from __future__ import annotations

import pytest

from portbench.drivers.build import StageClock
from portbench.roofline import B1_OPS_PER_S, HBM_BYTES_PER_S, candidate_scan
from portbench.trace import busy_within, summarize


class Ev:
    def __init__(self, kind, name, start, dur, annotation=False):
        self.kind, self.n, self.s, self.d = kind, name, start, dur
        self.a = annotation

    def activity_type(self):
        return self.kind

    def name(self):
        return self.n

    def start_ns(self):
        return self.s

    def duration_ns(self):
        return self.d

    def is_user_annotation(self):
        return self.a


def test_summarize_unions_device_intervals_and_names_gaps():
    events = [
        Ev("user_annotation", "pb.campaign.run", 0, 1000, True),
        Ev("user_annotation", "pb.campaign.init", 0, 200, True),
        Ev("kernel", "k1", 100, 100),          # [100, 200)
        Ev("kernel", "k2", 150, 100),          # overlaps: [100, 250)
        Ev("gpu_memcpy", "Memcpy DtoH", 400, 50),
        Ev("kernel", "k1", 900, 50),
        Ev("gpu_user_annotation", "pb.campaign.run", 0, 1000, True),
        Ev("cpu_op", "aten::add", 0, 10),
        Ev("user_annotation", "pb.mark.0", 300, 0, True),
    ]
    s = summarize(events, window_s=1e-6)
    assert s["busy_s"] == pytest.approx(250e-9)
    assert s["idle_pct"] == pytest.approx(75.0)
    assert s["device_ops"][0] == ["k1", pytest.approx(150e-9)]
    gaps = dict(s["idle_gaps"])
    # gap [250, 400) and [450, 900) began inside run, outside init
    assert gaps == {"pb.campaign.run": pytest.approx(600e-9)}
    assert s["marks"] == {"pb.mark.0": 300}
    assert busy_within(s, 0, 175) == pytest.approx(75e-9)
    assert busy_within(s, 200, 1000) == pytest.approx(150e-9)


def test_summarize_without_device_events():
    s = summarize([Ev("cpu_op", "aten::add", 0, 10)], window_s=1.0)
    assert s["busy_s"] == 0.0 and s["idle_pct"] is None


def test_candidate_scan_counts_pairs_from_layer_sizes():
    n = 1_000_000
    r = candidate_scan([n, 62_500, 1], 1024, 64)
    ops = 2 * 1024 * (n * (n - 1) / 2 + 62_500 * 62_499 / 2)
    assert r["ops"] == pytest.approx(ops)
    assert r["bytes"] == (n + 62_500) * (128 + 4 + 8 * 64)
    assert r["bound"] == "operations"
    assert r["least_s"] == pytest.approx(ops / B1_OPS_PER_S)
    assert 0.06 < r["least_s"] < 0.07
    small = candidate_scan([10], 1024, 64)
    assert small["bound"] == "bytes"
    assert small["least_s"] == pytest.approx(
        10 * (128 + 4 + 8 * 9) / HBM_BYTES_PER_S)


class FakeTracer:
    def __init__(self):
        self.t = 0.0

    def mark(self, name):
        return self.t


def _two_layers(clock, tr):
    # layer 0: candidates 5 s, then selection 2 s ending at t=7, then
    # symmetrization; layer 1 adds 1 s of candidates and 0.5 of selection
    tr.t = 7.0
    clock["selection"] = 2.0
    tr.t = 7.5
    clock["candidates"] = 5.0
    clock["symmetrization"] = 0.5
    tr.t = 9.5
    clock["selection"] = 2.5
    tr.t = 9.7
    clock["candidates"] = 6.0
    clock["symmetrization"] = 0.6


def test_stage_clock_places_each_candidates_stage_before_its_selection():
    tr = FakeTracer()
    clock = StageClock(tr)
    _two_layers(clock, tr)
    spans = clock.candidate_spans(2)
    assert [(a, b) for a, b, _, _ in spans] == [(0.0, 5.0), (8.0, 9.0)]
    assert [(m, t) for _, _, m, t in spans] == [(0, 7.0), (3, 9.5)]
    assert clock["candidates"] == 6.0


@pytest.mark.parametrize("n_layers", [1, 3])
def test_stage_clock_refuses_another_count_of_layers(n_layers):
    tr = FakeTracer()
    clock = StageClock(tr)
    _two_layers(clock, tr)
    with pytest.raises(RuntimeError, match="stage_times"):
        clock.candidate_spans(n_layers)


def test_stage_clock_refuses_candidates_written_before_selection():
    tr = FakeTracer()
    clock = StageClock(tr)
    clock["candidates"] = 5.0
    clock["selection"] = 2.0
    clock["symmetrization"] = 0.5
    with pytest.raises(RuntimeError, match="stage_times"):
        clock.candidate_spans(1)
