"""The probed build cell (``tree_probed_m16.build_p16``) at small sizes on
the CPU: its driver against the reference, the control and a planted
fault that must come out not correct, the placing of the probed scan's
spans from the ``stage_times`` writes, and its readers on a synthetic
trace summary. Its own size runs on the card (``test_cuda_*``)."""

from __future__ import annotations

import math
import time

import numpy as np
import pytest
import torch

from portbench import run
from portbench.drivers import build_probed as drv
from portbench.roofline_probed import probed_scan
from portbench.trace import Tracer, busy_within

CELL = "tree_probed_m16.build_p16"
CPU = torch.device("cpu")
# 20 clusters of 1,024 rows (4 x 4 needed), the last with 480 pads
SMALL = dict(n_molecules=20_000, probes=4, probe_csize=1024, q_block=256,
             probe_min_n=0, warmup_rows=16_384)
PROBED_CONFIG = {
    "name": "tree_probed_m16",
    "source": "https://github.com/keiserlab/rad/blob/main/examples/"
              "DUDEZ_example.ipynb",
    "file": "portbench/configs/tree_probed_m16.json",
    "reduced": ["n_molecules", "fingerprints"]}
PROBED_CELL = {"name": CELL, "config": "tree_probed_m16",
               "traffic": "build_probed", "chips": 1}
PROBED_METRICS = [
    {"name": name, "unit": unit, "better": better, "source": source,
     "layer": layer, "moves": "build_rows_per_s", "workloads": [CELL]}
    for name, unit, better, source, layer in [
        ("partition_s.build_probed", "s", "lower", "program_span",
         "build stages"),
        ("probe_scan_device_s.build_probed", "s", "lower", "device_trace",
         "build stages"),
        ("selection_s.build_probed", "s", "lower", "program_span",
         "build stages"),
        ("probe_scan_roofline_pct.build_probed", "%", "higher",
         "device_trace", "kernels"),
        ("device_idle_pct.build_probed", "%", "lower", "device_trace",
         "device")]]
METRICS = [m["name"] for m in PROBED_METRICS]


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    torch.set_num_threads(4)


def test_benchmark_lists_the_probed_cell(spec):
    """The committed spec holds the configuration, the cell, its place in
    ``build_rows_per_s`` and its five metrics, each at the end of its
    list."""
    config, cell = spec["configs"][-1], spec["workloads"][-1]
    assert {k: config[k] for k in PROBED_CONFIG} == PROBED_CONFIG
    assert {k: cell[k] for k in PROBED_CELL} == PROBED_CELL
    rows = {m["name"]: m for m in spec["end_to_end"]}["build_rows_per_s"]
    assert rows["workloads"][-1] == CELL
    assert spec["per_layer"][-len(PROBED_METRICS):] == PROBED_METRICS


def _run(spec, seed=2 ** 31 + 99, trace=False, **kw):
    line = run.run_cell(spec, CELL, seed, 0.5, trace, CPU, sizes=SMALL,
                        **kw)
    assert line.pop("_forbidden") == []
    return line


def test_driver_matches_the_reference(spec):
    line = _run(spec)
    assert line["correct"] is True, line["checks"]
    assert line["failed"] == 0 and line["attempted"] >= 1
    assert set(line["checks"]) == {"edge_mismatch", "node_order_mismatch"}
    # no card: no peak memory
    assert set(line["metrics"]) == {"build_rows_per_s", "setup_s"}


def test_control_is_not_correct(spec):
    line = _run(spec, control=True)
    assert line["correct"] is False
    assert line["checks"]["edge_mismatch"]["value"] > 0


def test_changed_probe_list_is_not_correct(spec, monkeypatch):
    from rad_tpu_torch.build import probe

    real = probe.qblock_probes

    def planted(*a, **kw):
        tab = real(*a, **kw).copy()
        tab[0, -1] = max(set(range(tab.max() + 1)) - set(tab[0].tolist()))
        tab[0] = sorted(tab[0])
        return tab

    monkeypatch.setattr(probe, "qblock_probes", planted)
    line = _run(spec)
    assert line["correct"] is False and line["failed"] >= 1


def test_traced_run_places_every_scan_span(spec):
    # the CPU has no device trace: the stage counters read, and the
    # spans are placed from the writes (a wrong order would raise)
    line = _run(spec, seed=5, trace=True)
    assert set(line["metrics"]) == {"partition_s.build_probed",
                                    "selection_s.build_probed"}
    assert line["correct"] is True


def test_set_up_refuses_a_layer_that_would_not_probe(spec):
    _, _, config, traffic = run.cell_of(spec, CELL)
    config = dict(config, n_molecules=1_000_000)     # under probe_min_n
    with pytest.raises(RuntimeError, match="would not probe"):
        drv.make(config, traffic, 1, CPU).setup()


@pytest.mark.parametrize("fault", [False, True])
def test_set_up_makes_the_reference_while_the_kernels_compile(
        spec, monkeypatch, fault):
    # a compilation that outlasts the library: the reference is made in
    # its shadow, and the window's builds are held to it; a failed one
    # fails set-up
    def slow(self):
        time.sleep(1.0)
        if fault:
            self.error = RuntimeError("nvcc failed")

    monkeypatch.setattr(drv.Compile, "run", slow)
    _, _, config, traffic = run.cell_of(spec, CELL)
    for key, value in SMALL.items():
        (config if key in config else traffic)[key] = value
    b = drv.make(config, traffic, 11, CPU)
    if fault:
        with pytest.raises(RuntimeError, match="nvcc failed"):
            b.setup()
        return
    b.setup()
    assert b._ref is not None and "reference" in b.parts
    monkeypatch.setattr(drv.BuildProbed, "_reference", None)
    b.window(0.1, Tracer(False))
    assert all(c["value"] == 0 for c in b.check())


class _Marks:
    """A tracer whose marks read a host clock that steps by 1 s."""

    def __init__(self):
        self.t = 0.0

    def mark(self, name):
        self.t += 1.0
        return self.t


def _probed_writes(clock, groups=3):
    """The writes of a build whose layer 0 probes (its selection written
    once for each of ``groups`` groups, 0.25 s each) and whose layer 1 is
    exact."""
    clock["probed_layers"] = [0]
    clock["bisection"] = 0.5
    clock["probe_tables"] = 0.1
    for g in range(groups):
        clock["selection"] = 0.25 * (g + 1)
    clock["candidates"] = 1.0
    clock["symmetrization"] = 0.1
    clock["selection"] += 0.25
    clock["candidates"] += 1.0
    clock["symmetrization"] += 0.1


def test_scan_spans_follow_the_stage_times_writes():
    clock = drv.ProbedClock(_Marks())
    _probed_writes(clock)
    spans = clock.scan_spans([1000, 40], [0], 256)
    # marks at 1 s steps: bisection 1, probe tables 2, selections 3, 4, 5
    assert spans == [(2.0, 2.75, 2, 3.0), (3.0, 3.75, 3, 4.0),
                     (4.0, 4.75, 4, 5.0)]


@pytest.mark.parametrize("change", ["swap", "extra", "missing", "groups"])
def test_scan_spans_refuse_a_write_order_they_cannot_place(change):
    clock = drv.ProbedClock(_Marks())
    _probed_writes(clock, groups=5 if change == "groups" else 3)
    events = clock.events
    if change == "swap":
        events[0], events[1] = events[1], events[0]
    elif change == "extra":
        events.append(("selection", 99.0, 0.1, len(events)))
    elif change == "missing":
        del events[-1]
    with pytest.raises(RuntimeError, match="probe_scan_device_s"):
        # 5 groups cannot come from 1,000 rows in q-blocks of 256
        clock.scan_spans([1000, 40], [0], 256)


def _ctx(trace=True):
    counters = {"units": 1, "wall_s": 50.0, "build_rows": 4_194_304,
                "build_s": 48.0, "ndim": 1024, "k": 64,
                "layer_sizes": [4_194_304, 262_144, 16_384, 1_024, 64, 4],
                "partition_s": [6.0], "selection_s": [25.0]}
    summary = None
    if trace:
        counters.update(probed_layers=[0], probe_scan_device_s=2.0)
        summary = {"busy_s": 12.0, "window_s": 100.0, "idle_pct": 88.0,
                   "device_ops": [], "idle_gaps": [], "intervals": [],
                   "marks": {}}
    config = {"probes": 16, "probe_csize": 8192, "q_block": 4096}
    return dict(counters=counters, trace=summary, setup_s=80.0,
                window_peak_bytes=3 << 30, config=config, traffic={})


@pytest.mark.parametrize("name", METRICS)
def test_metric_reads_a_synthetic_summary_and_none_without_input(name):
    read = run.reader(name)
    value = read(_ctx())
    assert value is not None and math.isfinite(value) and value > 0
    missing = _ctx(trace=False)
    for key in ("partition_s", "selection_s"):
        missing["counters"].pop(key)
    assert read(missing) is None


def test_roofline_counts_pairs_from_the_layer_sizes():
    ctx = _ctx()
    got = run.reader("probe_scan_roofline_pct.build_probed")(ctx)
    least = 1024 * 4096 * 16 * 8192 * 2 * 1024 / (8 * 1979e12)
    assert got == pytest.approx(100 * least / 2.0)
    assert 0.0711 < least < 0.0712
    r = probed_scan([5000, 300], [0], 1024, 64, 16, 8192, 4096)
    assert r["ops"] == 2.0 * 1024 * 2 * 4096 * 16 * 8192


def test_traced_scan_seconds_from_the_trace():
    clock = drv.ProbedClock(_Marks())
    _probed_writes(clock)
    b = drv.BuildProbed.__new__(drv.BuildProbed)
    b.layer_sizes, b.kw = [1000, 40], {"q_block": 256}
    # the profiler's clock runs 10 s ahead of the host's; the device is
    # busy [12.5, 13.5] s and [14.0, 16.0] s
    marks = {f"pb.mark.{i}": (i + 1 + 10) * 1e9 for i in range(20)}
    summary = {"marks": marks,
               "intervals": [(12.5e9, 13.5e9), (14.0e9, 16.0e9)]}
    # scans [12, 12.75], [13, 13.75], [14, 14.75] on the profiler's clock
    assert b._scan_device_s(summary, clock) == pytest.approx(
        0.25 + 0.5 + 0.75)


def test_busy_in_spans_is_busy_within_each_span():
    rng = np.random.default_rng(3)
    edges = np.sort(rng.choice(10_000, 400, replace=False)).astype(float)
    intervals = [tuple(p) for p in edges.reshape(-1, 2)]
    summary = {"intervals": intervals}
    spans = [tuple(sorted(rng.uniform(-100, 10_100, 2)))
             for _ in range(50)] + [(edges[4], edges[5]), (0.0, 0.0)]
    want = sum(busy_within(summary, a, b) for a, b in spans)
    assert drv.busy_in_spans(intervals, spans) == pytest.approx(want)
    assert drv.busy_in_spans([], spans) == 0.0


# -- on the card, at a size a test run holds --------------------------------

@pytest.mark.gpu
def test_cuda_driver_matches_the_reference_and_control_fails(spec):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda", 0)
    sizes = dict(n_molecules=524_288, probe_min_n=0, warmup_rows=524_288)
    for control in (False, True):
        line = run.run_cell(spec, CELL, 2 ** 31 + 3, 1.0, False, dev,
                            control=control, sizes=sizes)
        assert line["correct"] is (not control), line["checks"]
