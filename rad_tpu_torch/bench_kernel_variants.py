"""A/B microbench of the 1-NN Tanimoto kernel on one CUDA card.

    python -m rad_tpu_torch.bench_kernel_variants [--variants ...]

The port's counterpart of ``benchmarks/bench_kernel_variants.py``, on its
problem (``--q`` 2048 queries, ``--n`` 2^20 rows, 1024 bits, density 0.1,
seed 0). Variants:

* ``exact`` / ``approx`` — :func:`~rad_tpu_torch.fp.kernels.tanimoto_nn`;
* ``floor`` (also ``floor-t``, ``dot``, ``floor-bf16``, ``dot-bf16``) —
  each query's max intersection, no epilogue: the intersection stage's
  ceiling. The TPU modes differ only in VMEM layout and MXU operand and
  give the same output, so all run one kernel here;
* ``unpack`` — the TPU unpack stage's checksum. The Hopper kernels have no
  unpack stage, so its time measures nothing of theirs;
* ``exact-pk`` — the exact divide with the fast epilogue's packed-key max
  (``exact-pk`` − ``approx``: the cost of the exact divide);
* ``newton`` — the approximate reciprocal plus one Newton step, then
  min+argmin (a probe, not a product path).

Each is timed as ``--chain`` sweeps over distinct query blocks between two
CUDA events, best of 6. Prints one JSON line ``{"metric":
"nn_kernel_variants", ...}``. Without a CUDA device it exits non-zero.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from rad_tpu_torch.bench import event_ms
from rad_tpu_torch.fp import kernels
from rad_tpu_torch.fp.pack import random_fingerprints, to_torch_packed

__all__ = ["make_floor_kernel", "make_epilogue_probe", "time_variant",
           "main", "FLOOR_MODES"]

# the TPU floor modes; every one computes each query's max intersection
FLOOR_MODES = ("floor", "floor-t", "dot", "floor-bf16", "dot-bf16")


def make_floor_kernel(q_tile: int, n_tile: int, compute_dtype=None,
                      mode: str = "floor"):
    """``run(q_packed, db_packed) -> int32 [Q, 1]``: the max intersection
    over the db (any of :data:`FLOOR_MODES`; ``compute_dtype`` is the TPU's
    MXU operand type and changes nothing) or, with ``mode="unpack"``, the
    TPU unpack stage's checksum. Q % q_tile == 0, N % n_tile == 0."""
    kernel_mode = "unpack" if mode == "unpack" else "floor"
    if mode != "unpack" and mode not in FLOOR_MODES:
        raise ValueError(f"unknown floor mode {mode!r}")

    def run(q_packed, db_packed):
        return kernels.nn_floor(q_packed, db_packed, q_tile, n_tile,
                                kernel_mode)[:, None]

    return run


def make_epilogue_probe(q_tile: int, n_tile: int, compute_dtype=None,
                        mode: str = "exact-pk"):
    """``run(q_packed, db_packed) -> [Q, 1]``: ``"exact-pk"`` int32 packed
    keys (exact divide, the fast epilogue's single max) or ``"newton"`` f32
    min distances (approximate reciprocal + one Newton step, then min).
    ``q_tile`` and ``compute_dtype`` change nothing."""
    if mode not in ("exact-pk", "newton"):
        raise ValueError(f"unknown epilogue probe {mode!r}")

    def run(q_packed, db_packed):
        if q_packed.shape[0] % q_tile:
            raise ValueError(f"q_tile={q_tile} must divide the query rows "
                             f"({q_packed.shape[0]})")
        return kernels.nn_epilogue_probe(q_packed, db_packed, n_tile,
                                         mode)[:, None]

    return run


def time_variant(name, fn, db, qk, reps: int = 6) -> float:
    """Best seconds per sweep: ``len(qk)`` sweeps over distinct query
    blocks launched back to back between two CUDA events, after one
    warm-up chain."""
    def chain():
        for qb in qk:
            fn(db, qb)

    chain()
    best = min(event_ms(chain) for _ in range(reps)) * 1e-3
    print(f"  {name}: {best / len(qk) * 1e3:.4f} ms/sweep", file=sys.stderr,
          flush=True)
    return best / len(qk)


def _variant_fn(v: str, q_tile: int, n_tile: int):
    if v in FLOOR_MODES or v == "unpack":
        run = make_floor_kernel(q_tile, n_tile, mode=v)
    elif v in ("exact-pk", "newton"):
        run = make_epilogue_probe(q_tile, n_tile, mode=v)
    elif v in ("exact", "approx"):
        return lambda dbp, qp: kernels.tanimoto_nn(
            qp, dbp, q_tile=q_tile, n_tile=n_tile, approx=(v == "approx"))[0]
    else:
        raise ValueError(f"unknown variant {v!r}")
    return lambda dbp, qp: run(qp, dbp)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=1 << 20)
    ap.add_argument("--q", type=int, default=2048)
    ap.add_argument("--q-tile", type=int, default=512)
    ap.add_argument("--n-tile", type=int, default=1024)
    ap.add_argument("--variants", nargs="+",
                    default=["exact", "approx", "floor"])
    ap.add_argument("--chain", type=int, default=8,
                    help="sweeps per timed chain (distinct query blocks)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("rad_tpu_torch.bench_kernel_variants: no CUDA device "
              "(torch.cuda.is_available() is false); nothing measured",
              file=sys.stderr)
        return 1
    dev = torch.device("cuda:0")
    fns = {v: _variant_fn(v, args.q_tile, args.n_tile)
           for v in args.variants}
    n = (args.n // args.n_tile) * args.n_tile
    db = to_torch_packed(random_fingerprints(n, n_bits=1024, density=0.1,
                                             seed=0), dev)
    k = max(1, min(args.chain, n // args.q))
    qk = [db[i * args.q:(i + 1) * args.q] for i in range(k)]
    results = {}
    for v, fn in fns.items():
        best = time_variant(v, fn, db, qk)
        results[v] = {"ms": best * 1e3, "rate": args.q * n / best}
    print(json.dumps({"metric": "nn_kernel_variants", "n": n, "q": args.q,
                      "q_tile": args.q_tile, "n_tile": args.n_tile,
                      "chain": k, "device": torch.cuda.get_device_name(dev),
                      "results": results}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
