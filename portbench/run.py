"""Run one cell of the benchmark and print its result line.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout that holds ``BENCHMARK.json``. The run makes
its inputs from ``--seed``, sets up and warms up the cell (``setup_s``,
from the process's start to the first timed operation), measures for
``--seconds``, checks what the window produced against the reference
under ``portbench/reference/``, and prints one JSON line last on standard
output: ``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics, or with ``--trace 1`` its per-layer metrics, each read
by ``portbench/metrics/<name>.py``), ``device``, with ``--trace 1``
``breakdown``, and ``checks``, each compared number beside its limit
(also the last lines of standard error). It needs as many CUDA devices as
the cell asks for, and exits non-zero without a result when it finds
fewer, or when ``jax``, ``jaxlib``, ``flax`` or ``rad_tpu`` is loaded.
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "rad_tpu")


def process_age_s() -> float:
    """Seconds since this process started (its start time in boot-clock
    ticks from ``/proc/self/stat``)."""
    with open("/proc/self/stat") as f:
        fields = f.read().rsplit(")", 1)[1].split()
    start = int(fields[19]) / os.sysconf("SC_CLK_TCK")
    return time.clock_gettime(time.CLOCK_BOOTTIME) - start


def host_clock() -> tuple:
    """(every CPU's ticks, their steal ticks, this process's CPU seconds,
    wall seconds): read before and after the window, they say how much of
    the host other guests took and how busy this process kept a core."""
    try:
        with open("/proc/stat") as f:
            ticks = [int(v) for v in f.readline().split()[1:]]
        total, steal = sum(ticks[:8]), ticks[7]
    except (OSError, ValueError, IndexError):
        total = steal = 0
    t = os.times()
    return total, steal, t.user + t.system, time.perf_counter()


def host_note(before: tuple, after: tuple, unit_s) -> str:
    """One line on the host during the window: the steal share, this
    process's CPU seconds over the wall, and the units' quartiles."""
    d_total, d_steal, d_cpu, d_wall = (b - a for a, b in zip(before, after))
    steal = (f"{100.0 * d_steal / d_total:.2f} %" if d_total
             else "unreadable")
    note = (f"steal {steal} of CPU time, this process "
            f"{d_cpu / d_wall:.3f} CPU s a second")
    if len(unit_s) >= 2:
        q = statistics.quantiles(unit_s, n=4)
        note += (f", unit s q1 {q[0]:.4f} median {q[1]:.4f} q3 {q[2]:.4f}"
                 f" of {len(unit_s)}")
    return note


def set_cache_dirs(root: Path) -> None:
    """Every build cache at a fixed path inside the checkout."""
    os.environ["RAD_TPU_TORCH_BUILD_DIR"] = str(root / ".rad_tpu_torch_build")
    os.environ["TRITON_CACHE_DIR"] = str(root / ".portbench_cache" / "triton")


def forbidden_modules(names=None) -> list[str]:
    """Top-level names, compared whole, of loaded JAX modules and of the
    JAX package among ``names`` (default: ``sys.modules``)."""
    names = list(sys.modules) if names is None else names
    top = {name.split(".")[0] for name in names}
    return sorted(top.intersection(FORBIDDEN))


def load_spec(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def cell_of(spec: dict, name: str):
    """``(cell, config entry, config, traffic)`` of the cell ``name``."""
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise KeyError(f"no cell {name!r} in BENCHMARK.json "
                       f"(cells: {sorted(cells)})")
    cell = cells[name]
    entry = {c["name"]: c for c in spec["configs"]}[cell["config"]]
    with open(ROOT / entry["file"]) as f:
        config = json.load(f)
    with open(ROOT / "portbench" / "workloads" / f"{cell['traffic']}.json") \
            as f:
        traffic = json.load(f)
    return cell, entry, config, traffic


def metrics_of(spec: dict, cell_name: str, trace: bool) -> list[dict]:
    """The cell's end-to-end metrics, or with ``trace`` its per-layer
    ones: those that list the cell, or list no cells."""
    group = spec["per_layer"] if trace else spec["end_to_end"]
    return [m for m in group
            if "workloads" not in m or cell_name in m["workloads"]]


def reader(name: str):
    """``read(ctx)`` of ``portbench/metrics/<name>.py``."""
    path = ROOT / "portbench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"portbench_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def power_limit_w():
    """The card's power limit from ``nvidia-smi``, or None."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits"], capture_output=True,
            text=True, timeout=20, check=True).stdout.split()
        return float(out[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def run_cell(spec: dict, cell_name: str, seed: int, seconds: float,
             trace: bool, device, control: bool = False,
             sizes: dict | None = None) -> dict:
    """Set up, measure, check; returns the result line as a dict (before
    the JAX check, which :func:`main` makes). ``control`` puts the
    reference at the precision below the configuration's in the program's
    place; ``sizes`` overrides keys of the configuration and the traffic
    (the tests' small sizes)."""
    import torch

    from portbench.trace import Tracer

    cell, _, config, traffic = cell_of(spec, cell_name)
    for key, value in (sizes or {}).items():
        (config if key in config else traffic)[key] = value
    drivers = importlib.import_module(
        f"portbench.drivers.{traffic['driver']}")
    drv = drivers.make(config, traffic, seed, device)
    drv.setup()
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.synchronize(device)
        setup_peak = torch.cuda.max_memory_allocated(device)
        torch.cuda.reset_peak_memory_stats(device)
    setup_s = process_age_s()
    print(f"portbench: set-up {setup_s:.3f} s "
          f"{json.dumps(getattr(drv, 'parts', {}))}", file=sys.stderr)

    tracer = Tracer(trace, traffic.get("trace_units", (1, 1)))
    before = host_clock()
    counters = drv.window(seconds, tracer, control=control)
    host = host_note(before, host_clock(), counters.get("unit_s", []))
    window_peak = None
    if cuda:
        torch.cuda.synchronize(device)
        window_peak = torch.cuda.max_memory_allocated(device)
    ctx = dict(counters=counters, trace=tracer.summary, setup_s=setup_s,
               window_peak_bytes=window_peak, config=config, traffic=traffic)
    metrics = {}
    for m in metrics_of(spec, cell_name, trace):
        value = reader(m["name"])(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    print(f"portbench: window {counters['units']} units in "
          f"{counters['wall_s']:.3f} s; {host}", file=sys.stderr)
    found = forbidden_modules()
    drv.release()
    t0 = time.perf_counter()
    checks = drv.check()
    print(f"portbench: reference and comparison "
          f"{time.perf_counter() - t0:.3f} s", file=sys.stderr)
    line = {
        "correct": bool(checks) and all(c["value"] <= c["limit"]
                                        for c in checks),
        "attempted": int(counters["units"]),
        "failed": int(drv.failed),
        "metrics": metrics,
        "device": {
            "platform": "gpu" if cuda else device.type,
            "kind": (torch.cuda.get_device_name(device) if cuda
                     else str(device)),
            "count": 1,
            "memory_peak_bytes": (max(setup_peak, window_peak) if cuda
                                  else None),
            "power_limit_w": power_limit_w() if cuda else None,
        },
    }
    if trace and tracer.summary is not None:
        line["device"]["busy_s"] = tracer.summary["busy_s"]
        line["device"]["window_s"] = tracer.summary["window_s"]
        line["breakdown"] = {"device_ops": tracer.summary["device_ops"],
                             "idle_gaps": tracer.summary["idle_gaps"]}
    line["checks"] = {c["name"]: {"value": c["value"], "limit": c["limit"]}
                      for c in checks}
    line["_forbidden"] = found
    return line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    set_cache_dirs(ROOT)
    spec = load_spec()
    cell, *_ = cell_of(spec, args.workload)

    import torch

    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < int(cell["chips"]):
        print(f"portbench: the cell needs {cell['chips']} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              "; nothing measured", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    line = run_cell(spec, args.workload, args.seed, args.seconds,
                    bool(args.trace), device)
    found = sorted(set(line.pop("_forbidden")) | set(forbidden_modules()))
    if found:
        print(f"portbench: modules loaded that the run may not load: "
              f"{found}; no result", file=sys.stderr)
        return 3
    for name, c in line["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
