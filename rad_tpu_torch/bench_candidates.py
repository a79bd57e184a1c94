"""K1 and K2, the fused candidate kernels of the device-scored step, timed
on one CUDA card at the step's shapes.

    python -m rad_tpu_torch.bench_candidates [--k --n --rows --calls]

Inputs: ``--k`` 2,048 candidates (batch 64 x M0 32) over the 1M graph's
``--n`` 1,000,000 ids and ``--rows`` 1,066,610 (node, level) rows, by
the recipe of ``tests/test_pallas_ops.py`` (:func:`candidate_case`, seed
5); K2 takes K1's output as its ``to_score``. Then the same with every
candidate, row and ``to_score`` entry one unscored id: the batch whose
duplicates meet in one slot of the kernels' dedup table. For each kernel,
over ``--calls`` calls (best of three windows):

  eager_ms     CUDA events around calls made back to back: what a caller
               waits, the host's launch path and the kernel together;
  host_us      the host's clock around calls that are only enqueued (the
               card finishes each before the next arrives);
  device_ms    K1: the calls replayed from a CUDA graph. K2 sets marks in
               its tables, so a replayed graph would find them set: its
               device time is ``torch.profiler``'s kernel time over calls
               that each get their own copy of the tables, made just
               before the call, so that the tables are in L2 as a step
               finds them (K1's too, beside the graph's).

Only the wrappers' public signatures are used, so the file times any
tree's kernels that keep them. The last line is one JSON object with
every figure and the card's ``nvidia-smi`` name and power limit; without
a CUDA device the run exits non-zero.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from rad_tpu_torch.bench import event_ms
from rad_tpu_torch.traverse import candidate_ops as ops

__all__ = ["candidate_case", "step_inputs", "k1_times", "k2_times", "main"]


def candidate_case(rng, n: int, k: int, n_rows: int):
    """The recipe of tests/test_pallas_ops.py make_case: ~20 % invalid
    candidates, half of the second half copied from the first (duplicates),
    about half the ids scored, 40 % of the rows enqueued. Returns numpy
    ``(cand, scored, scores, enqueued, row)``."""
    cand = rng.integers(-1, n, size=k).astype(np.int32)
    cand[rng.random(k) < 0.2] = -1
    cand[k // 2:] = np.where(rng.random(k - k // 2) < 0.5,
                             cand[: k - k // 2], cand[k // 2:])
    scored = rng.random(n) < 0.5
    scores = np.where(scored, rng.random(n), np.inf).astype(np.float32)
    enqueued = rng.random(n_rows) < 0.4
    row = np.minimum(np.maximum(cand, 0) + rng.integers(0, 3, size=k),
                     n_rows - 1).astype(np.int32)
    return cand, scored, scores, enqueued, row


def step_inputs(k: int, n: int, n_rows: int, device,
                one_id: bool = False) -> dict:
    """:func:`candidate_case` (seed 5) on ``device``, with ``ts`` (K1's
    output by its plain twin) and ``new_scores`` for K2; ``one_id``: every
    candidate, row and ``ts`` entry the first unscored id."""
    names = ("cand", "scored", "scores", "enqueued", "row")
    arrays = candidate_case(np.random.default_rng(5), n, k, n_rows)
    if one_id:
        cand, scored, _, enqueued, row = arrays
        j = int(np.flatnonzero(~scored)[0])
        cand[:], row[:], enqueued[j] = j, j, False
    x = {name: torch.from_numpy(a).to(device)
         for name, a in zip(names, arrays)}
    x["ts"] = (x["cand"].clone() if one_id else
               ops.candidate_filter_plain(x["cand"], x["scored"]))
    x["new_scores"] = torch.rand(k, generator=torch.Generator().manual_seed(
        5)).to(device)
    return x


def _event_ms(calls) -> float:
    """Milliseconds the current stream is busy with the calls in
    ``calls`` (a list of thunks), per call."""
    return event_ms(lambda: [fn() for fn in calls]) / len(calls)


def _host_us(calls) -> float:
    """Microseconds of the host's clock per call, the calls enqueued."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for fn in calls:
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt * 1e6 / len(calls)


def _graph_ms(fn, calls: int) -> float:
    """Milliseconds per call of ``fn`` replayed from a CUDA graph of
    ``calls`` calls (best of three replays)."""
    graph = torch.cuda.CUDAGraph()
    stream = torch.cuda.Stream()
    with torch.cuda.stream(stream):
        fn()
        with torch.cuda.graph(graph, stream=stream):
            for _ in range(calls):
                fn()
    graph.replay()
    torch.cuda.synchronize()
    return min(_event_ms([graph.replay]) for _ in range(3)) / calls


def _profiled_ms(calls, kernel: str) -> float:
    """Device milliseconds per launch of the kernels whose name holds
    ``kernel``, from ``torch.profiler`` over the calls."""
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for fn in calls:
            fn()
        torch.cuda.synchronize()
    times = [e.device_time_total for e in prof.events()
             if e.device_type == DeviceType.CUDA and kernel in e.name]
    if not times:
        raise RuntimeError(f"the profiler saw no {kernel} launch")
    return sum(times) / len(times) / 1e3


def k1_times(x: dict, calls: int = 200) -> dict:
    """K1's figures (see the module's docstring) on :func:`step_inputs`."""
    def k1():
        return ops.candidate_filter(x["cand"], x["scored"])

    thunks = [k1] * calls
    k1()
    return dict(
        eager_ms=min(_event_ms(thunks) for _ in range(3)),
        host_us=min(_host_us(thunks) for _ in range(3)),
        device_ms=_graph_ms(k1, 20),
        profiler_ms=_profiled_ms(thunks[:50], "candidate_filter_kernel"))


def k2_times(x: dict, calls: int = 200) -> dict:
    """K2's figures on :func:`step_inputs`, every call on its own copy of
    the tables (as a step finds them: not yet marked by this batch)."""
    tables = ("scored", "scores", "enqueued")

    def k2(copy):
        return ops.integrate_candidates(x["ts"], x["new_scores"], x["cand"],
                                        x["row"], *copy)

    def thunks(count):   # copies made beforehand: the calls alone timed
        copies = [[x[t].clone() for t in tables] for _ in range(count)]
        torch.cuda.synchronize()
        return [lambda c=c: k2(c) for c in copies]

    def copied_just_before():
        return k2([x[t].clone() for t in tables])

    thunks(2)[0]()
    out = dict(eager_ms=min(_event_ms(thunks(calls)) for _ in range(3)),
               host_us=min(_host_us(thunks(calls)) for _ in range(3)))
    out["device_ms"] = min(
        _profiled_ms([copied_just_before] * 50, "integrate_candidates_kernel")
        for _ in range(2))
    return out


def nvidia_smi_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--k", type=int, default=2048)
    ap.add_argument("--n", type=int, default=1_000_000)
    ap.add_argument("--rows", type=int, default=1_066_610)
    ap.add_argument("--calls", type=int, default=200)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("bench_candidates: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda:0")
    result = {"card": nvidia_smi_line(), "k": args.k, "n": args.n,
              "rows": args.rows}
    for case in ("step", "one id"):
        x = step_inputs(args.k, args.n, args.rows, dev,
                        one_id=case == "one id")
        result[case] = {"candidate_filter": k1_times(x, args.calls),
                        "integrate_candidates": k2_times(x, args.calls)}
        for name, r in result[case].items():
            print(f"[{name}, {case}] K={args.k} N={args.n:,}: eager "
                  f"{r['eager_ms']:.4f} ms, device {r['device_ms']:.4f} ms, "
                  f"host {r['host_us']:.2f} us per call"
                  + (f" (profiler {r['profiler_ms']:.4f} ms)"
                     if "profiler_ms" in r else ""), flush=True)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
