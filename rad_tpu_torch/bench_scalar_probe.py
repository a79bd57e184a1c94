"""Microprobe: the cost of the traversal step's per-candidate primitives
inside one kernel, on one CUDA card.

    python -m rad_tpu_torch.bench_scalar_probe [--k --n --reps --chain-steps]

The port's counterpart of ``benchmarks/bench_scalar_probe.py``, on its
inputs (``np.random.default_rng(0)``: ``--k`` 8192 candidate ids over
``--n`` 2^20 table rows, two random bitmaps, a score table). Three probes,
each one kernel over all candidates
(:mod:`rad_tpu_torch.traverse.candidate_ops`):

  gather   — sum of table[idx[i]]             (the load-only floor)
  checkset — bitmap test-and-set + a counter  (the enqueue primitive)
  chain    — scored test, compacted emit, enqueue test-and-set, score
             lookup: the whole per-candidate work of expand + integrate

Each is timed as ``--chain-steps`` launches back to back between two CUDA
events, best of ``--reps``. ``breakeven_ns`` is measured in the same run:
the time per candidate of the chain of torch operations that ``chain``
would replace (its plain twin, on the card). Prints one JSON line
``{"metric": "scalar_loop_probe", "gather_ns", "checkset_ns", "chain_ns",
"k", "n", "breakeven_ns"}``, nanoseconds per candidate. A probe that fails
to build or launch fails the run; without a CUDA device it exits non-zero.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from rad_tpu_torch.bench import event_ms
from rad_tpu_torch.traverse import candidate_ops as ops

__all__ = ["probe_inputs", "time_probe", "main"]


def probe_inputs(k: int, n: int, device) -> dict:
    """The benchmark's inputs (generator seed 0, the reference's draws in
    the reference's order): ``idx`` [k, 1] ids, ``tab`` [n, 1] small
    ints, the ``bm`` and ``scored`` bitmaps [n / 32, 1] (31 random bits a
    word), ``scores`` [n, 1] in [0, 1)."""
    if n % 32:
        raise ValueError(f"n = {n} must be a multiple of 32")
    words = n // 32
    rng = np.random.default_rng(0)
    arrays = {
        "idx": rng.integers(0, n, size=(k, 1)).astype(np.int32),
        "tab": rng.integers(0, 100, size=(n, 1)).astype(np.int32),
        "bm": rng.integers(0, 2**31, size=(words, 1)).astype(np.int32),
        "scored": rng.integers(0, 2**31, size=(words, 1)).astype(np.int32),
        "scores": rng.random((n, 1)).astype(np.float32),
    }
    return {name: torch.from_numpy(a).to(device)
            for name, a in arrays.items()}


def time_probe(label: str, fn, k: int, chain_steps: int, reps: int) -> float:
    """Best nanoseconds per candidate over ``reps`` chains of
    ``chain_steps`` back-to-back calls, after one warm-up chain."""
    def chain():
        for _ in range(chain_steps):
            fn()

    chain()
    best = min(event_ms(chain) for _ in range(reps))
    ns = best / chain_steps / k * 1e6
    print(f"  {label}: {best:.4f} ms / {chain_steps} calls -> {ns:.3f} "
          f"ns/candidate", file=sys.stderr, flush=True)
    return ns


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--k", type=int, default=8192, help="candidates")
    ap.add_argument("--n", type=int, default=1 << 20, help="table rows")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--chain-steps", type=int, default=16,
                    help="launches chained per timed run")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("rad_tpu_torch.bench_scalar_probe: no CUDA device "
              "(torch.cuda.is_available() is false); nothing measured",
              file=sys.stderr)
        return 1
    dev = torch.device("cuda:0")
    x = probe_inputs(args.k, args.n, dev)
    idx, bm, scored, scores = x["idx"], x["bm"], x["scored"], x["scores"]
    timed = {
        "gather_ns": lambda: ops.scalar_gather(idx, x["tab"]),
        "checkset_ns": lambda: ops.scalar_checkset(idx, bm),
        "chain_ns": lambda: ops.scalar_chain(idx, scored, bm, scores),
        # the torch operations one chain kernel stands for
        "breakeven_ns": lambda: ops.scalar_chain_plain(idx, scored, bm,
                                                       scores),
    }
    results = {name: time_probe(name[:-3], fn, args.k, args.chain_steps,
                                args.reps)
               for name, fn in timed.items()}
    breakeven = results.pop("breakeven_ns")
    print(json.dumps({"metric": "scalar_loop_probe", **results,
                      "k": args.k, "n": args.n, "breakeven_ns": breakeven,
                      "device": torch.cuda.get_device_name(dev)}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
