"""The cluster-probed build swept over probes and granularity: build
seconds, edge recall@10 and search recall@10 per ef.

    python -m rad_tpu_torch.bench_probe_sweep [--n 10000000]
        [--sweep qblock:16,qblock:32] [--library batched|morgan]
        [--seed 0] [--device cuda]

The port of ``benchmarks/bench_probe_sweep.py``, with its flags and its
records, plus ``--seed`` (the build's seed, the reference's hard-coded 0:
the level sort and the bisection change with it, so an error bar over
partitions is a sweep over seeds) and ``--cache-dir``. Left out by
design: ``--cooldown`` and the ``utils/launcher`` supervision,
workarounds for a remote device link.

Each sweep point (``granularity:probes``; ``exact:0`` is the all-pairs
build, the baseline the probed recalls read against) is one build
(:func:`one_build`) and one evaluation (:class:`RecallEval`) over
``--recall`` member queries (rng 17) and their brute-force top-10, taken
once (:func:`~rad_tpu_torch.fp.tanimoto.bruteforce_topk_blocked`, the
matrix kernel) and kept in keys, so every build is read against the same
truth: the edge recall@10 of the queries' layer-0 rows (a member query's
own row counts) and the beam search's recall@10 at each ``--ef``. Sweep
builds pad the probe lists to ``--width`` as the reference does (a dead
probe is skipped here: no graph or time changes); ``--throughput`` builds
one point unpadded twice and keeps the faster.

Libraries (:func:`load_library`, cached as ``.npy`` in the temporary
directory): ``batched``, the mutation tree of
``examples/enrichment_example.py`` (the sequential recipe up to 2M rows,
the batched one above, as the reference draws them, under the reference's
file names); ``morgan``, ``make_smiles_library(n, seed=0)`` through the
in-tree Morgan fingerprints (:mod:`rad_tpu_torch.chem`), radius 2, on
a host process pool of the CPU count. The
reference fingerprints its morgan library with a substring hash, not
Morgan, and caches it as ``morgan_lib_*``; this library is cached as
``morgan_ecfp_lib_*`` so that the two never mix.

A sweep record lists the layers that probed (``probed_layers``: a layer
with fewer than ``4 * probes`` clusters builds exact). Every record goes
to ``--results`` (JSONL, flushed at once) and to
stderr; the last line of stdout is ``{"metric": "probe_sweep", "n",
"csize", "results_file", "results": [...]}``. Runs on the first CUDA
device unless ``--device`` names another; without one it exits non-zero.
"""

from __future__ import annotations

import argparse
import gc
import json
import multiprocessing
import os
import sys
import tempfile
import time

import numpy as np
import torch

from rad_tpu_torch.devices import resolve_device

__all__ = ["load_library", "morgan_fingerprints_parallel", "member_queries",
           "RecallEval", "one_build", "parse_points", "main"]

SEQUENTIAL_MAX_N = 2_000_000


def log(*a) -> None:
    print(*a, file=sys.stderr, flush=True)


def _morgan_chunk(args):
    from rad_tpu_torch.chem import morgan_fingerprints_packed

    smiles, n_bits, radius = args
    return morgan_fingerprints_packed(smiles, radius=radius, n_bits=n_bits)


def morgan_fingerprints_parallel(smiles, n_bits: int = 1024,
                                 radius: int = 2,
                                 processes: int | None = None,
                                 chunk: int = 8192) -> np.ndarray:
    """:func:`rad_tpu_torch.chem.morgan_fingerprints_packed` of
    ``smiles`` over a pool of ``processes`` host processes (default: the
    CPU count; 1 runs in this process), ``chunk`` molecules a task. The
    same array as one call. The pool is spawned, not forked: a caller may
    already hold a CUDA context, which a forked child must not inherit."""
    processes = processes or os.cpu_count() or 1
    parts = [(smiles[i:i + chunk], n_bits, radius)
             for i in range(0, len(smiles), chunk)]
    if processes == 1 or len(parts) <= 1:
        out = [_morgan_chunk(p) for p in parts]
    else:
        with multiprocessing.get_context("spawn").Pool(processes) as pool:
            out = pool.map(_morgan_chunk, parts)
    if not out:
        return np.zeros((0, -(-n_bits // 32)), np.uint32)
    return np.concatenate(out)


def load_library(n: int, n_bits: int, kind: str = "batched",
                 processes: int | None = None,
                 cache_dir: str | None = None) -> np.ndarray:
    """``[n, n_bits/32]`` uint32 fingerprints of the ``batched`` or
    ``morgan`` library, from ``cache_dir`` (default: the temporary
    directory) when cached there, else made and cached."""
    from rad_tpu_torch import synthetic

    cache_dir = cache_dir or tempfile.gettempdir()
    if kind == "morgan":
        cache = os.path.join(cache_dir, f"morgan_ecfp_lib_n{n}_b{n_bits}.npy")
    elif kind == "batched":
        cache = os.path.join(cache_dir, f"bes_lib_n{n}_b{n_bits}_s0.npy")
    else:
        raise ValueError(f"library kind {kind!r}: 'batched' or 'morgan'")
    if os.path.exists(cache):
        log(f"library loaded from {cache}")
        return np.load(cache)
    t0 = time.perf_counter()
    if kind == "morgan":
        from rad_tpu_torch.chem.library import make_smiles_library

        smiles, _scores = make_smiles_library(n, seed=0)
        fps = morgan_fingerprints_parallel(smiles, n_bits=n_bits, radius=2,
                                           processes=processes)
    elif n > SEQUENTIAL_MAX_N:
        fps, _ = synthetic.make_library(n, n_bits, seed=0, batch=1 << 20)
    else:
        fps = synthetic.make_library_sequential(n, n_bits, seed=0)[0]
    np.save(cache, fps)
    log(f"{kind} library generated ({time.perf_counter() - t0:.0f}s) -> "
        f"{cache}")
    return fps


def member_queries(n: int, count: int) -> np.ndarray:
    """The evaluation's member query rows (rng 17), as the reference
    draws them."""
    return np.random.default_rng(17).choice(n, size=count, replace=False)


class RecallEval:
    """Edge recall@10 and search recall@10 per ef of a graph over
    ``fps``, for the member queries ``fps[qidx]``; the brute-force truth
    (in keys) is taken on the first graph and kept."""

    def __init__(self, fps: np.ndarray, qidx: np.ndarray, efs, device):
        self.qidx = np.asarray(qidx)
        self.q = np.ascontiguousarray(fps[self.qidx])
        self.efs = [int(e) for e in efs]
        self.device = device
        self.truth = None

    def _truth(self, g) -> None:
        from rad_tpu_torch.fp.pack import to_torch_packed
        from rad_tpu_torch.fp.tanimoto import bruteforce_topk_blocked

        t0 = time.perf_counter()
        keys = np.asarray(g.keys)
        _, ids = bruteforce_topk_blocked(
            to_torch_packed(self.q, self.device),
            to_torch_packed(np.asarray(g.packed), self.device), 10)
        self.truth = keys[np.maximum(ids.cpu().numpy(), 0)]
        log(f"ground truth: {time.perf_counter() - t0:.1f}s")

    def __call__(self, g) -> dict:
        from rad_tpu_torch.search.knn import search_device

        if self.truth is None:
            self._truth(g)
        keys = np.asarray(g.keys)
        n = len(keys)
        out = {}
        row_of = np.empty(n, np.int64)
        row_of[keys] = np.arange(n)
        adj = np.asarray(g.neighbors[0])[row_of[self.qidx]]
        adj_keys = np.where(adj >= 0, keys[np.maximum(adj, 0)], -1)
        edge = np.mean([
            len((set(adj_keys[r].tolist()) | {int(self.qidx[r])})
                & set(self.truth[r].tolist())) / 10.0
            for r in range(len(self.qidx))])
        out["edge_recall_at_10"] = round(float(edge), 4)
        log(f"edge recall: {edge:.4f}")
        for ef in self.efs:
            t0 = time.perf_counter()
            _, ids = search_device(g, self.q, k=10, expansion_search=ef,
                                   device=self.device)
            ids = ids.cpu().numpy()
            ids = np.where(ids >= 0, keys[np.maximum(ids, 0)], -1)
            rec = float(np.mean([
                len(set(ids[r].tolist()) & set(self.truth[r].tolist()))
                / 10.0 for r in range(len(self.qidx))]))
            log(f"recall eval ef={ef}: {time.perf_counter() - t0:.1f}s "
                f"-> {rec:.4f}")
            out[f"recall_at_10_ef{ef}"] = rec
        return out


def one_build(fps: np.ndarray, gran: str, probes: int, width: int | None,
              connectivity: int = 16, csize: int = 1 << 13,
              probe_sample: int = 16, seed: int = 0, device=None,
              stage_times: dict | None = None, **kw):
    """One build of the sweep: ``gran == "exact"`` the all-pairs build,
    else the ``gran``-probed build (``probes`` of ``csize``-row clusters,
    lists padded to ``width``; ``probe_min_n=0``). Returns ``(graph,
    seconds)``; ``kw`` goes to the builder."""
    from rad_tpu_torch.build.exact import build_hnsw_exact

    device = resolve_device(device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    if gran == "exact":
        g = build_hnsw_exact(fps, connectivity=connectivity, seed=seed,
                             device=device, stage_times=stage_times, **kw)
    else:
        g = build_hnsw_exact(
            fps, connectivity=connectivity, seed=seed, probes=probes,
            probe_csize=csize, probe_sample=probe_sample,
            probe_granularity=gran, probe_width=width, probe_min_n=0,
            device=device, stage_times=stage_times, **kw)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return g, time.perf_counter() - t0


def parse_points(spec: str):
    """``"qblock:16,exact:0"`` → ``[("qblock", 16), ("exact", 0)]``."""
    points = []
    for tok in spec.split(","):
        if tok.strip():
            gran, p = tok.strip().split(":")
            points.append((gran, int(p)))
    return points


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=10_000_000)
    ap.add_argument("--n-bits", type=int, default=1024)
    ap.add_argument("--connectivity", type=int, default=16)
    ap.add_argument("--csize", type=int, default=1 << 13)
    ap.add_argument("--sweep", default="qblock:16,qblock:32,qblock:64",
                    help="comma list of granularity:probes sweep points "
                         "(exact:0 = the all-pairs build; probe lists "
                         "padded to --width)")
    ap.add_argument("--width", type=int, default=64,
                    help="probe_width of the sweep builds")
    ap.add_argument("--throughput", default=None,
                    help="granularity:probes for the unpadded build, "
                         "built twice and the faster kept")
    ap.add_argument("--recall", type=int, default=500)
    ap.add_argument("--ef", default="32,128",
                    help="comma list of search expansion widths")
    ap.add_argument("--probe-sample", type=int, default=16)
    ap.add_argument("--save", default=None,
                    help="save the throughput build's graph here (.npz)")
    ap.add_argument("--results", default=os.path.join(
        tempfile.gettempdir(), "probe_sweep_results.jsonl"))
    ap.add_argument("--library", default="batched",
                    choices=["batched", "morgan"])
    ap.add_argument("--seed", type=int, default=0,
                    help="the builds' seed (level sort, bisection, probe "
                         "samples)")
    ap.add_argument("--cache-dir", default=None,
                    help="where libraries are cached (default: the "
                         "temporary directory)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the first CUDA device)")
    args = ap.parse_args(argv)
    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        print(f"rad_tpu_torch.bench_probe_sweep: {e}; nothing measured",
              file=sys.stderr)
        return 1
    cuda = device.type == "cuda"
    log(f"device: {torch.cuda.get_device_name(device) if cuda else device}")

    fps = load_library(args.n, args.n_bits, kind=args.library,
                       cache_dir=args.cache_dir)
    n = fps.shape[0]
    m = args.connectivity
    efs = [int(x) for x in str(args.ef).split(",") if x.strip()]
    evaluate = RecallEval(fps, member_queries(n, args.recall), efs, device)
    build_kw = dict(connectivity=m, csize=args.csize,
                    probe_sample=args.probe_sample, seed=args.seed,
                    device=device)
    records = []

    with open(args.results, "a", buffering=1) as results_f:
        def record(rec: dict) -> None:
            rec = {"n": n, "library": args.library, "seed": args.seed,
                   **rec}
            results_f.write(json.dumps(rec) + "\n")
            results_f.flush()
            os.fsync(results_f.fileno())
            records.append(rec)
            log(f"RECORDED {rec}")

        for gran, p in parse_points(args.sweep):
            log(f"=== sweep {gran}:{p} (width {args.width}) ===")
            times = {}
            g, dt = one_build(fps, gran, p, args.width, stage_times=times,
                              **build_kw)
            rec = evaluate(g)
            record({"kind": "sweep", "granularity": gran, "probes": p,
                    "width": args.width, "build_s": round(dt, 2),
                    "probed_layers": times.get("probed_layers", []),
                    **rec})
            del g
            gc.collect()

        if args.throughput:
            (gran, p), = parse_points(args.throughput)
            log(f"=== throughput {gran}:{p} (unpadded) ===")
            g, dt1 = one_build(fps, gran, p, None, **build_kw)
            rec = evaluate(g)
            del g
            gc.collect()
            g2, dt2 = one_build(fps, gran, p, None, **build_kw)
            best = min(dt1, dt2)
            record({"kind": "throughput", "granularity": gran, "probes": p,
                    "build_s": round(best, 2),
                    "nodes_per_s": round(n / best, 1),
                    "cold_build_s": round(dt1, 2), **rec})
            if args.save:
                t0 = time.perf_counter()
                g2.save(args.save)
                record({"kind": "save", "path": args.save,
                        "save_s": round(time.perf_counter() - t0, 1),
                        "bytes": os.path.getsize(args.save)})
            del g2
            gc.collect()

    print(json.dumps({"metric": "probe_sweep", "n": n, "csize": args.csize,
                      "results_file": args.results, "results": records}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
