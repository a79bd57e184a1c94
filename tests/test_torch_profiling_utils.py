"""rad_tpu_torch.utils.profiling: the cases of tests/test_checkpoint.py
(the named timer, a trace dump) run against the port, and the per-kernel
sum over a dump."""

import json
import os

import pytest
import torch

from rad_tpu_torch.utils import Timer, profile_trace
from rad_tpu_torch.utils.profiling import aggregate_device_ops


def test_timer_sections():
    t = Timer()
    with t.section("a"):
        pass
    with t.section("a"):
        pass
    s = t.stats()
    assert s["a"]["count"] == 2
    assert s["a"]["total_seconds"] >= 0
    assert set(s["a"]) == {"total_seconds", "count", "avg_ms"}


def test_profile_trace_writes_dump(tmp_path):
    logdir = str(tmp_path / "trace")
    with profile_trace(logdir):
        (torch.arange(1024.0) * 2).sum()
    found = [f for _, _, fs in os.walk(logdir) for f in fs]
    assert found, "profiler produced no trace files"
    # a CPU-only trace holds no device kernels
    assert aggregate_device_ops(logdir) == ({}, 0)


def test_aggregate_device_ops_sums_kernel_time(tmp_path):
    """Device events (kernels, copies, sets) sum per name in ns; host
    events and instant events do not count."""
    events = [
        {"ph": "X", "cat": "kernel", "name": "k1", "dur": 1.5},
        {"ph": "X", "cat": "kernel", "name": "k1", "dur": 2.25},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD", "dur": 4},
        {"ph": "X", "cat": "cpu_op", "name": "aten::mul", "dur": 100},
        {"ph": "i", "cat": "kernel", "name": "k1"},
    ]
    sub = tmp_path / "run" / "nested"
    sub.mkdir(parents=True)
    with open(sub / "a.pt.trace.json", "w") as f:
        json.dump({"traceEvents": events}, f)
    agg, n = aggregate_device_ops(str(tmp_path))
    assert agg == {"k1": 3750, "Memcpy HtoD": 4000} and n == 3
    with pytest.raises(RuntimeError, match="no"):
        aggregate_device_ops(str(tmp_path / "empty"))
