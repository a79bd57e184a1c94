"""Where the time goes on the 1M main path, on one CUDA card.

    python -m rad_tpu_torch.profiling          # needs one CUDA device

Builds the library of ``chip_smoke.py`` phase 4 (1,000,000 x 1024 bits,
M = 16, seed 0) and reports, every figure from this run:

1. the build's stage seconds (``stage_times``);
2. the traversal step at batch 8: host timers split into expand /
   download / score / integrate over ``STEPS_TIMED`` steps (the device is
   synchronized between the parts), then ``torch.profiler`` over the real
   ``traverse()`` loop: the device's busy share of wall time, and kernel
   launches and CUDA runtime calls per step;
3. one layer-0 candidate q-block (4096 queries against every column block:
   bucket kernel, decode, merge sort) and one selection chunk (2048 rows):
   wall ms, device ms and the kernels that take the device time, from
   ``torch.profiler``.

The host-timed parts (1 and the step split of 2) run before the profiler
is first started, so its overhead cannot reach them.

The last line is one JSON object holding every figure printed above it.
"""

from __future__ import annotations

import collections
import json
import subprocess
import sys
import time

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from rad_tpu_torch.build.exact import (_one_qblock, _round_up,
                                      _select_layer, build_hnsw_exact)
from rad_tpu_torch.fp.pack import popcount_rows_np
from rad_tpu_torch.store import InMemorySmilesStore
from rad_tpu_torch.synthetic import make_library
from rad_tpu_torch.traverse.driver import DeviceTraverser

N = 1_000_000
M = 16
BATCH = 8
WARM_SCORED = 2_500
STEPS_TIMED = 300
PROFILE_SCORED = 500


def _device_summary(prof, top: int = 6):
    """(device ms, {kernel: ms} of the ``top`` largest, {CUDA runtime
    call: count}) over every event ``prof`` recorded."""
    kernels = collections.Counter()
    calls = collections.Counter()
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            kernels[e.name[:70]] += e.device_time_total / 1e3
        elif e.name.startswith("cuda"):
            calls[e.name] += 1
    return (sum(kernels.values()), dict(kernels.most_common(top)),
            dict(calls))


def _profiled(fn):
    """Run ``fn`` once under the profiler: (result, wall ms, summary)."""
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    return out, wall, _device_summary(prof)


def _report(name: str, wall: float, summary, steps: int = 1) -> dict:
    dev_ms, kernels, calls = summary
    launches = calls.get("cudaLaunchKernel", 0)
    print(f"[{name}] wall {wall:.3f} ms, device {dev_ms:.3f} ms "
          f"(busy {dev_ms / wall:.1%}), {launches} kernel launches"
          + (f" over {steps} steps" if steps > 1 else ""), flush=True)
    for k, ms in kernels.items():
        print(f"    {ms / dev_ms:6.1%} {ms:9.3f} ms  {k}")
    print(f"    runtime calls: {calls}")
    return dict(wall_ms=wall, device_ms=dev_ms, busy=dev_ms / wall,
                steps=steps, kernels_ms=kernels, runtime_calls=calls)


def profile_build_blocks(packed: np.ndarray, dev) -> dict:
    """One layer-0 candidate q-block and one selection chunk, at the
    builder's default blocks, on the whole library as layer 0."""
    n, w = packed.shape
    n_pad = _round_up(n, 1 << 13)
    pad = np.zeros((n_pad - n, w), np.uint32)
    d_packed = torch.from_numpy(
        np.concatenate([packed, pad]).view(np.int32)).to(dev)
    d_pops = torch.from_numpy(np.concatenate(
        [popcount_rows_np(packed), np.zeros(n_pad - n, np.int32)])).to(dev)
    k, q_block, col_block, sel_block = 4 * M, 4096, 1 << 13, 2048

    def qblock():
        return _one_qblock(d_packed, d_pops, 0, n, k, q_block, col_block, 64)

    qblock()  # warm-up: kernel load, allocator
    (cand_d, cand_i), wall, summary = _profiled(qblock)
    out = {"qblock": _report(f"q-block 4096 x {n_pad:,}", wall, summary)}

    def select():
        return _select_layer(d_packed, d_pops, cand_d[:sel_block],
                             cand_i[:sel_block], n, M, 4 * M, sel_block)

    select()
    _, wall, summary = _profiled(select)
    out["selection_chunk"] = _report("selection chunk 2048 rows", wall,
                                     summary)
    return out


def profile_traversal(graph, scores: np.ndarray, dev) -> dict:
    store = InMemorySmilesStore({i: f"MOL_{i}" for i in range(N)})

    def scoring_fn(smiles: str) -> float:
        return float(scores[int(smiles[4:])])

    t = DeviceTraverser(graph, scoring_fn, smiles_store=store,
                        batch_size=BATCH, device=dev)
    t.prime()
    t.traverse(n_to_score=WARM_SCORED)

    split = dict(expand=0.0, download=0.0, score=0.0, integrate=0.0)
    fresh = 0
    for _ in range(STEPS_TIMED):
        t0 = time.perf_counter()
        state, out = t._expand(t.state)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        to_score = out["to_score"].cpu().numpy()
        t2 = time.perf_counter()
        new_scores = t._bridge.score_batch(to_score)
        t3 = time.perf_counter()
        t.state = t._integrate(state, out, new_scores)
        torch.cuda.synchronize()
        t4 = time.perf_counter()
        for part, dt in zip(split, (t1 - t0, t2 - t1, t3 - t2, t4 - t3)):
            split[part] += dt
        fresh += int((to_score >= 0).sum())
    per_step = {p: s * 1e3 / STEPS_TIMED for p, s in split.items()}
    print(f"[traversal step, host timers, {STEPS_TIMED} steps of batch "
          f"{BATCH}] ms per step: "
          + ", ".join(f"{p} {ms:.3f}" for p, ms in per_step.items())
          + f"; total {sum(per_step.values()):.3f}; fresh molecules per "
          f"step {fresh / STEPS_TIMED:.2f}", flush=True)

    steps0 = t.stats["steps"]
    target = t.n_scored + PROFILE_SCORED
    _, wall, summary = _profiled(lambda: t.traverse(n_to_score=target))
    steps = t.stats["steps"] - steps0
    rep = _report("traverse() under the profiler", wall, summary, steps)
    rep["launches_per_step"] = (
        rep["runtime_calls"].get("cudaLaunchKernel", 0) / max(steps, 1))
    # the profiler slows the host; the unprofiled step is the fairer base
    rep["busy_of_timed_step"] = (rep["device_ms"] / max(steps, 1)
                                 / sum(per_step.values()))
    print(f"    per step: {wall / steps:.3f} ms wall, "
          f"{rep['device_ms'] / steps:.3f} ms device "
          f"({rep['busy_of_timed_step']:.1%} of the host-timed step), "
          f"{rep['launches_per_step']:.1f} kernel launches")
    t.shutdown()
    return dict(host_ms_per_step=per_step,
                fresh_per_step=fresh / STEPS_TIMED, profiled=rep)


def main() -> int:
    if not torch.cuda.is_available():
        print("profiling: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda:0")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    print(f"[device] {smi.strip().splitlines()[0]} | torch "
          f"{torch.__version__} CUDA {torch.version.cuda}", flush=True)
    packed, scores = make_library(N, seed=0)
    stage = {}
    t0 = time.perf_counter()
    graph = build_hnsw_exact(packed, connectivity=M, seed=0, device=dev,
                             stage_times=stage)
    result = {"build_s": dict(stage, total=time.perf_counter() - t0)}
    print(f"[build] {N:,} x 1024 bits, M={M}, layers {graph.layer_sizes}: "
          + ", ".join(f"{s} {v:.2f} s" for s, v in result["build_s"].items()),
          flush=True)
    # graph keys are the library rows, so scores index by key
    result["traversal"] = profile_traversal(graph, scores, dev)
    del graph
    result["build_blocks"] = profile_build_blocks(packed, dev)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
