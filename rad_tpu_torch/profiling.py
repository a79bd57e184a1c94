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
3. the device-scored step (``fused_run``, batch 64, Tanimoto to one
   library row) with the K1/K2 kernels on and off: ms per step by host
   timers over ``DS_STEPS_TIMED`` steps (turns on, off, off, on), then
   ``torch.profiler`` over ``DS_STEPS_PROFILED`` steps of each: device
   busy share, kernel launches, stream synchronisations and memcpys per
   step, and K1's and K2's device time per call on those real steps;
4. one layer-0 candidate q-block (4096 queries against every column block
   of 8,192 rows: the bucket kernel on the tensor cores, decode, mask,
   merge sort) and one selection chunk (2048 rows): wall ms, device ms,
   launches and the kernels that take the device time, from
   ``torch.profiler``. On an NVIDIA H100 80GB HBM3 at 700.00 W the
   q-block read 63.5 ms of wall and 24.3 ms of device time over 2,341
   launches (19 a column block): the merge sort took half the device
   time, the bucket kernel a quarter (0.053 ms a call), and the host's
   launches set the pace.

The host-timed parts (1, the step split of 2 and the timers of 3) run
before the profiler is first started, so its overhead cannot reach them.

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

from rad_tpu_torch.build.exact import (_round_up, _scan,
                                      _select_layer, build_hnsw_exact)
from rad_tpu_torch.fp.pack import popcount_rows_np, to_torch_packed
from rad_tpu_torch.fp.tanimoto import tanimoto_rows_to_target
from rad_tpu_torch.store import InMemorySmilesStore
from rad_tpu_torch.synthetic import make_library
from rad_tpu_torch.traverse import device as tdev
from rad_tpu_torch.traverse.driver import DeviceTraverser

N = 1_000_000
M = 16
BATCH = 8
WARM_SCORED = 2_500
STEPS_TIMED = 300
PROFILE_SCORED = 500
DS_BATCH = 64
DS_WARM_STEPS = 100
DS_STEPS_TIMED = 300
DS_STEPS_PROFILED = 50


# the K1 / K2 kernels' names in csrc/candidates.cu
CANDIDATE_KERNELS = {"K1": "candidate_filter_kernel",
                     "K2": "integrate_candidates_kernel"}


def _device_summary(prof, top: int = 6):
    """(device ms, {kernel: ms} of the ``top`` largest, {CUDA runtime
    call: count}, {K1 / K2: (device ms, launches)}) over every event
    ``prof`` recorded."""
    kernels = collections.Counter()
    calls = collections.Counter()
    named = {k: [0.0, 0] for k in CANDIDATE_KERNELS}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            kernels[e.name[:70]] += e.device_time_total / 1e3
            for k, name in CANDIDATE_KERNELS.items():
                if name in e.name:
                    named[k][0] += e.device_time_total / 1e3
                    named[k][1] += 1
        elif e.name.startswith("cuda"):
            calls[e.name] += 1
    return (sum(kernels.values()), dict(kernels.most_common(top)),
            dict(calls), named)


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
    dev_ms, kernels, calls, _ = summary
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
        return _scan(d_packed, d_pops, 0, q_block, n, k, q_block, col_block,
                     64, approx=False)

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


class DeviceScored:
    """The device-scored loop of ``chip_smoke.py`` phase 5a on ``graph``:
    each run starts from a state primed on the top layer and warmed by
    ``DS_WARM_STEPS`` steps."""

    def __init__(self, graph, dev):
        self.dg = tdev.prepare_device_graph(graph, dev)
        self.packed = to_torch_packed(np.asarray(graph.packed), dev)
        self.pops = torch.from_numpy(
            np.asarray(graph.popcounts).astype(np.int32)).to(dev)
        n_top = graph.layer_sizes[graph.max_level]
        self.seeds = torch.arange(n_top, dtype=torch.int32, device=dev)
        self.target, self.tpop = self.packed[17], self.pops[17]
        self.seed_scores = tanimoto_rows_to_target(
            self.packed[:n_top], self.pops[:n_top], self.target, self.tpop)

    def steps(self, state, n: int, fused: bool):
        return tdev.fused_run(state, self.dg, self.packed, self.pops,
                              self.target, self.tpop, 10 ** 9, DS_BATCH,
                              max_steps=n, fused_candidates=fused)

    def warm_state(self):
        st = tdev.prime(tdev.init_state(self.dg), self.dg, self.seeds,
                        self.seed_scores)
        return self.steps(st, DS_WARM_STEPS, False)

    def timed(self) -> dict:
        """Host-timed ms per step, K1/K2 on and off, in turns."""
        ms = {True: [], False: []}
        for fused in (True, False, False, True):
            st = self.warm_state()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            self.steps(st, DS_STEPS_TIMED, fused)
            torch.cuda.synchronize()
            ms[fused].append((time.perf_counter() - t0) * 1e3
                             / DS_STEPS_TIMED)
        out = {f"k1k2_{'on' if f else 'off'}_ms_per_step": sum(v) / len(v)
               for f, v in ms.items()}
        print(f"[device-scored step, host timers, {DS_STEPS_TIMED} steps of "
              f"batch {DS_BATCH} after {DS_WARM_STEPS}] ms per step: K1/K2 "
              f"on {out['k1k2_on_ms_per_step']:.3f}, off "
              f"{out['k1k2_off_ms_per_step']:.3f}", flush=True)
        return out

    def profiled(self) -> dict:
        out = {}
        for fused in (True, False):
            st = self.warm_state()
            _, wall, summary = _profiled(
                lambda: self.steps(st, DS_STEPS_PROFILED, fused))
            name = f"k1k2_{'on' if fused else 'off'}"
            rep = _report(f"device-scored step, K1/K2 "
                          f"{'on' if fused else 'off'}, under the profiler",
                          wall, summary, DS_STEPS_PROFILED)
            per_step = {k: v / DS_STEPS_PROFILED
                        for k, v in rep["runtime_calls"].items()}
            rep["launches_per_step"] = per_step.get("cudaLaunchKernel", 0)
            rep["stream_syncs_per_step"] = per_step.get(
                "cudaStreamSynchronize", 0)
            rep["memcpys_per_step"] = per_step.get("cudaMemcpyAsync", 0)
            print(f"    per step: {rep['device_ms'] / DS_STEPS_PROFILED:.3f}"
                  f" ms device, {rep['launches_per_step']:.1f} kernel "
                  f"launches, {rep['stream_syncs_per_step']:.1f} stream "
                  f"synchronisations, {rep['memcpys_per_step']:.1f} "
                  f"memcpys", flush=True)
            for k, (ms, n) in summary[3].items():
                if n:
                    rep[f"{k}_device_ms_per_call"] = ms / n
                    print(f"    {k} ({CANDIDATE_KERNELS[k]}): "
                          f"{ms / n * 1e3:.2f} us device per call over {n} "
                          f"calls", flush=True)
            out[name] = rep
        return out


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
    device_scored = DeviceScored(graph, dev)
    result["device_scored"] = device_scored.timed()
    # graph keys are the library rows, so scores index by key
    result["traversal"] = profile_traversal(graph, scores, dev)
    result["device_scored"].update(device_scored.profiled())
    del graph, device_scored
    result["build_blocks"] = profile_build_blocks(packed, dev)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
