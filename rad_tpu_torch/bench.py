"""Benchmark: Tanimoto distance evaluations per second on one CUDA card.

    python -m rad_tpu_torch.bench          # needs a CUDA device

The port's counterpart of the repo's ``bench.py``, on its problem: the
1-NN sweep of ``--q`` 2048 queries over a ``--n`` 2^20-row library of
1024-bit fingerprints (``random_fingerprints(n, 1024, 0.1, seed=0)``; the
queries are the library's first rows). Two paths, each timed with CUDA
events for a single sweep (best of 4) and chained (``--chain`` sweeps over
distinct query blocks launched back to back between two events, best of
``--reps``):

* ``matmul`` — :func:`matmul_min_dist`, the counterpart of ``bench.py``'s
  ``_xla_min_dist``: a blocked bf16 ``torch.mm`` of unpacked bits, the
  exact epilogue and a running min, in plain torch;
* ``kernel`` — :func:`~rad_tpu_torch.fp.kernels.tanimoto_nn` with the
  fast epilogue (``approx=True``).

The host baseline is ``bench.py``'s numpy popcount sweep on ``--cpu-n``
rows. Prints each path's rate and ms per sweep, then one JSON line
``{"metric": "tanimoto_dist_evals_per_sec_per_chip", "value", "unit",
"vs_baseline"}`` with the best rate of either path. Without a CUDA device
it exits non-zero and measures nothing.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from rad_tpu_torch.fp import kernels
from rad_tpu_torch.fp.pack import (popcount_rows, random_fingerprints,
                                   to_torch_packed)
from rad_tpu_torch.fp.tanimoto import intersections_bf16, unpack_to_dtype

__all__ = ["cpu_tanimoto_rate", "unpack_to_dtype", "intersections_bf16",
           "matmul_min_dist", "event_ms", "main"]

METRIC = "tanimoto_dist_evals_per_sec_per_chip"


def cpu_tanimoto_rate(db: np.ndarray, n_q: int = 64, reps: int = 3) -> float:
    """Distance evaluations per second of a numpy popcount Tanimoto sweep
    on the host (``bench.py``'s baseline)."""
    q = db[:n_q]
    if hasattr(np, "bitwise_count"):
        popc = np.bitwise_count
    else:
        lut = np.array([bin(i).count("1") for i in range(256)], np.uint8)
        popc = lambda x: lut[x.view(np.uint8)].reshape(*x.shape[:-1], -1)
    pops = popc(db).sum(-1, dtype=np.int32)
    best = np.inf
    for _ in range(reps):
        t0 = time.perf_counter()
        inter = popc(q[:, None, :] & db[None, :, :]).sum(-1, dtype=np.int32)
        union = pops[:n_q, None] + pops[None, :] - inter
        d = 1.0 - inter / np.maximum(union, 1)
        d.min(axis=1)
        best = min(best, time.perf_counter() - t0)
    return n_q * db.shape[0] / best


def matmul_min_dist(db: torch.Tensor, q: torch.Tensor,
                    block: int) -> torch.Tensor:
    """``[Q]`` f32 min Tanimoto distance over ``db`` by blocks of
    ``block`` rows, the op order of ``bench.py``'s ``_xla_min_dist``:
    ``1 - inter / max(union, 1)`` (an empty pair counts distance 1)."""
    q_bits = unpack_to_dtype(q)
    q_pops = popcount_rows(q).to(torch.float32)
    best = torch.full((q.shape[0],), float("inf"), device=q.device)
    for lo in range(0, db.shape[0], block):
        blk = db[lo:lo + block]
        d_pops = popcount_rows(blk).to(torch.float32)
        inter = intersections_bf16(q_bits, unpack_to_dtype(blk))
        union = q_pops[:, None] + d_pops[None, :] - inter
        dist = 1.0 - inter / torch.clamp(union, min=1.0)
        best = torch.minimum(best, dist.amin(dim=1))
    return best


def event_ms(fn) -> float:
    """Milliseconds ``fn`` keeps the current stream busy (CUDA events)."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end)


def _measure(sweep, db, q_blocks, reps: int) -> dict:
    """Best ms of one sweep (of 4) and best ms per sweep of a chain of
    ``len(q_blocks)`` sweeps (of ``reps``), after one warm-up of each."""
    sweep(db, q_blocks[0])
    single = min(event_ms(lambda: sweep(db, q_blocks[0]))
                 for _ in range(4))
    out = {"single_ms": single}
    k = len(q_blocks)
    if k > 1:
        def chain():
            for qb in q_blocks:
                sweep(db, qb)

        chain()
        out["chain_ms"] = min(event_ms(chain) for _ in range(reps)) / k
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=1 << 20,
                    help="library size (packed 1024-bit fingerprints)")
    ap.add_argument("--q", type=int, default=2048, help="query batch")
    ap.add_argument("--block", type=int, default=1 << 14,
                    help="db rows per step of the matmul path")
    ap.add_argument("--cpu-n", type=int, default=1 << 15,
                    help="library size for the host baseline")
    ap.add_argument("--chain", type=int, default=8,
                    help="sweeps per chained measurement")
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("rad_tpu_torch.bench: no CUDA device (torch.cuda.is_available()"
              " is false); nothing measured", file=sys.stderr)
        return 1
    dev = torch.device("cuda:0")
    n = (args.n // 1024) * 1024
    db_np = random_fingerprints(n, n_bits=1024, density=0.1, seed=0)
    cpu_rate = cpu_tanimoto_rate(db_np[:args.cpu_n])
    print(f"host baseline (numpy popcount, {min(args.cpu_n, n):,} rows): "
          f"{cpu_rate:.4e} dist-evals/s", flush=True)

    db = to_torch_packed(db_np, dev)
    k = max(1, min(args.chain, n // args.q))
    q_blocks = [db[i * args.q:(i + 1) * args.q] for i in range(k)]
    paths = {
        "matmul": lambda d, q: matmul_min_dist(d, q, args.block),
        "kernel": lambda d, q: kernels.tanimoto_nn(q, d, approx=True)[0],
    }
    best = 0.0
    for name, sweep in paths.items():
        res = _measure(sweep, db, q_blocks, args.reps)
        for stage, ms in res.items():
            rate = args.q * n / (ms * 1e-3)
            best = max(best, rate)
            print(f"{name} {stage.split('_')[0]}: {ms:.4f} ms/sweep, "
                  f"{rate:.4e} dist-evals/s ({args.q} x {n:,} x 1024 bits,"
                  f" {torch.cuda.get_device_name(dev)})", flush=True)
    print(json.dumps({"metric": METRIC, "value": best, "unit": "dist-evals/s",
                      "vs_baseline": best / cpu_rate}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
