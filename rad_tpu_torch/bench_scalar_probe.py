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

Two options print one more JSON line each before that one:

  --split      each probe's time split (:func:`probe_times`: eager ms,
               host microseconds a call, device ms replayed from a CUDA
               graph) through the public wrappers only, so the file times
               any tree's probes that keep their signatures; and the host
               microseconds of two layouts of ``chain``'s outputs
               (:func:`output_layouts_us`);
  --clusters   K,...: at each k, the device ms and host microseconds a
               call of each probe on one CTA and on a cluster of eight, in
               turns 1, 8, 8, 1 (:func:`cluster_times`).
"""

from __future__ import annotations

import argparse
import functools
import json
import sys

import numpy as np
import torch

from rad_tpu_torch.bench import event_ms
from rad_tpu_torch.bench_candidates import (_event_ms, _graph_ms, _host_us,
                                            nvidia_smi_line)
from rad_tpu_torch.traverse import candidate_ops as ops

__all__ = ["probe_inputs", "time_probe", "probe_times", "output_layouts_us",
           "cluster_times", "main"]


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


def probe_times(fn, calls: int = 200) -> dict:
    """One probe's time three ways, over ``calls`` calls (best of three
    windows): ``eager_ms``, CUDA events around calls made back to back
    (what a caller waits); ``host_us``, the host's clock around calls that
    are only enqueued; ``device_ms``, the calls replayed from a CUDA graph
    (the kernel without the host's launch path)."""
    fn()
    thunks = [fn] * calls
    return dict(eager_ms=min(_event_ms(thunks) for _ in range(3)),
                host_us=min(_host_us(thunks) for _ in range(3)),
                device_ms=_graph_ms(fn, 20))


def output_layouts_us(k: int, device, calls: int = 200) -> dict:
    """Host microseconds a call of two ways to make ``chain``'s outputs
    (no kernel): ``"views"``, one f32 buffer of two and one int32 of one
    cut into the returned ``[1, 1]`` and 0-d tensors (three allocations,
    four views); ``"empties"``, each output allocated as it is returned
    (four allocations). Best of three windows."""
    def views():
        out_f = torch.empty((2,), dtype=torch.float32, device=device)
        out_i = torch.empty((1,), dtype=torch.int32, device=device)
        emit = torch.empty((k, 1), dtype=torch.int32, device=device)
        return out_f[:1].reshape(1, 1), emit, out_i[0], out_f[1]

    def empties():
        return (torch.empty((1, 1), dtype=torch.float32, device=device),
                torch.empty((k, 1), dtype=torch.int32, device=device),
                torch.empty((), dtype=torch.int32, device=device),
                torch.empty((), dtype=torch.float32, device=device))

    layouts = {"views": views, "empties": empties}
    best = {name: [] for name in layouts}
    for name in ("views", "empties", "empties", "views"):
        best[name].append(_host_us([layouts[name]] * calls))
    return {name: min(v) for name, v in best.items()}


def cluster_times(k: int, n: int, device, calls: int = 20) -> dict:
    """Each probe at ``k`` candidates over ``n`` rows on one CTA and on a
    cluster of eight, in turns 1, 8, 8, 1: device ms a
    call (replayed from a CUDA graph of ``calls`` calls) and the host's
    microseconds a call (200 calls enqueued), ``{probe: {"1": {"device_ms":
    [two readings], "host_us": [two]}, "8": {...}}}``."""
    x = probe_inputs(k, n, device)
    fns = {"gather": lambda c: ops._gather_cuda(x["idx"], x["tab"], c),
           "checkset": lambda c: ops._checkset_cuda(x["idx"], x["bm"], c),
           "chain": lambda c: ops._chain_cuda(x["idx"], x["scored"],
                                              x["bm"], x["scores"], c)}
    out = {}
    for name, fn in fns.items():
        got = {str(c): {"device_ms": [], "host_us": []} for c in (1, 8)}
        for c in (1, 8, 8, 1):
            call = functools.partial(fn, c)
            got[str(c)]["device_ms"].append(_graph_ms(call, calls))
            got[str(c)]["host_us"].append(_host_us([call] * 200))
        out[name] = got
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--k", type=int, default=8192, help="candidates")
    ap.add_argument("--n", type=int, default=1 << 20, help="table rows")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--chain-steps", type=int, default=16,
                    help="launches chained per timed run")
    ap.add_argument("--split", action="store_true",
                    help="also print each probe's eager, host and device "
                         "time")
    ap.add_argument("--clusters", default="",
                    help="comma-separated k: also print each probe's "
                         "device and host time on 1 and 8 CTAs")
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
    if args.split:
        split = {name[:-3]: probe_times(fn) for name, fn in timed.items()
                 if name != "breakeven_ns"}
        print(json.dumps({"metric": "scalar_probe_split", "k": args.k,
                          "n": args.n, **split,
                          "outputs_us": output_layouts_us(args.k, dev),
                          "card": nvidia_smi_line()}), flush=True)
    if args.clusters:
        ks = [int(k) for k in args.clusters.split(",")]
        print(json.dumps({"metric": "scalar_probe_clusters", "n": args.n,
                          **{str(k): cluster_times(k, args.n, dev)
                             for k in ks},
                          "card": nvidia_smi_line()}), flush=True)
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
