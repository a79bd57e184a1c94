"""Recall and queries per second of the beam search against brute force,
over a sweep of ``expansion_search``.

    python -m rad_tpu_torch.bench_recall [--n 100000] [--q 256]
        [--builder native|host|exact|device] [--device cuda]

The port of ``benchmarks/bench_recall.py``, with its flags and its JSON
line, plus ``"builder"``. It builds a graph over N fingerprints (the
``tree`` library of ``examples/enrichment_example.py:make_library``,
:func:`rad_tpu_torch.synthetic.make_library_sequential`; ``uniform``
random bits; or the ``packed`` member of ``--fps-npz``), searches it with
:func:`~rad_tpu_torch.search.knn.search_device` at each ef, and reports
recall@k against the exact top-k of
:func:`~rad_tpu_torch.fp.tanimoto.bruteforce_topk_blocked` (the matrix
kernel).

``--builder``: ``native`` (the default, as in the reference) is the C++
builder on every host core (:func:`~rad_tpu_torch.native.
build_hnsw_native`); ``host`` the numpy host builder
(:func:`~rad_tpu_torch.build.reference.build_hnsw`), the reference's
fallback when its native builder is missing, which the port does not take
silently; ``exact`` the all-pairs builder on the card
(:func:`~rad_tpu_torch.build.exact.build_hnsw_exact`); ``device`` the
batched beam insert (:func:`~rad_tpu_torch.build.device.build_hnsw_device`,
1,024 rows a batch, ``benchmarks/bench_build_device.py``'s default). Recall belongs to a graph: a number from
one builder is not a number from another. ``--graph-cache`` saves the
built graph, or loads it when the file exists (whatever built it).

``qps`` is one search call of the q queries, timed on the host clock after
a warm call; ``qps_chained`` searches ``--chain`` blocks of q distinct
member queries back to back, timed by CUDA events with one
synchronisation at the end (best of three). Progress goes to stderr; the
last line is ``{"metric": "recall@10_sweep", "n", "connectivity",
"expansion_add", "builder", "results": [{"ef", "recall", "qps",
"qps_chained"}, ...]}``. Runs on the first CUDA device unless
``--device`` names another; without one it exits non-zero.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

from rad_tpu_torch.devices import resolve_device

__all__ = ["build_graph", "load_fingerprints", "recall_at_k", "main"]

BUILDERS = ("native", "host", "exact", "device")
DEVICE_BUILD_BATCH = 1024


def log(*a) -> None:
    print(*a, file=sys.stderr, flush=True)


def load_fingerprints(library: str, n: int, n_bits: int, q: int,
                      fps_npz: str | None = None):
    """``(fingerprints [n, n_bits/32] uint32, queries [q, ...])`` as the
    reference draws them: member queries (rng 99) of the ``tree`` library
    or of ``fps_npz``; for ``uniform``, fresh random queries (seed 99)."""
    from rad_tpu_torch.fp.pack import random_fingerprints
    from rad_tpu_torch.synthetic import make_library_sequential

    if fps_npz:
        with np.load(fps_npz, allow_pickle=False) as z:
            fps = np.ascontiguousarray(z["packed"], dtype=np.uint32)
        if fps.shape != (n, n_bits // 32):
            raise ValueError(f"{fps_npz}: packed is {fps.shape}, expected "
                             f"{(n, n_bits // 32)}")
        log(f"loaded {len(fps)} packed fps from {fps_npz}")
    elif library == "tree":
        fps = make_library_sequential(n, n_bits, seed=0)[0]
    else:
        fps = random_fingerprints(n, n_bits=n_bits, density=0.1, seed=0)
        return fps, random_fingerprints(q, n_bits=n_bits, density=0.1,
                                        seed=99)
    rng = np.random.default_rng(99)
    return fps, fps[rng.choice(n, q, replace=False)]


def build_graph(builder: str, fps: np.ndarray, connectivity: int,
                expansion_add: int, device):
    """The graph of ``fps`` from one of :data:`BUILDERS` (seed 0)."""
    if builder == "native":
        from rad_tpu_torch.native import build_hnsw_native
        return build_hnsw_native(fps, connectivity=connectivity,
                                 expansion_add=expansion_add, seed=0)
    if builder == "host":
        from rad_tpu_torch.build.reference import build_hnsw
        return build_hnsw(fps, connectivity=connectivity,
                          expansion_add=expansion_add, seed=0)
    if builder == "exact":
        from rad_tpu_torch.build.exact import build_hnsw_exact
        return build_hnsw_exact(fps, connectivity=connectivity,
                                expansion_add=expansion_add, seed=0,
                                device=device)
    if builder == "device":
        from rad_tpu_torch.build.device import build_hnsw_device
        return build_hnsw_device(fps, connectivity=connectivity,
                                 expansion_add=expansion_add, seed=0,
                                 batch_size=DEVICE_BUILD_BATCH,
                                 device=device)
    raise ValueError(f"builder={builder!r}: one of {BUILDERS}")


def recall_at_k(found: np.ndarray, truth: np.ndarray, k: int) -> float:
    """Mean over queries of ``|found[i] ∩ truth[i]| / k``."""
    return float(np.mean([len(set(f.tolist()) & set(t.tolist())) / k
                          for f, t in zip(found, truth)]))


def _chained_seconds(graph, blocks, kw: dict, device) -> float:
    """Best of three back-to-back searches of every block, timed with
    one synchronisation at the end (CUDA events on a card)."""
    from rad_tpu_torch.search.knn import search_device

    best = float("inf")
    for rep in range(4):            # one warm pass, then three timed
        if device.type == "cuda":
            torch.cuda.synchronize(device)
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            for qb in blocks:
                search_device(graph, qb, **kw)
            stop.record()
            stop.synchronize()
            dt = start.elapsed_time(stop) / 1e3
        else:
            t0 = time.perf_counter()
            for qb in blocks:
                search_device(graph, qb, **kw)
            dt = time.perf_counter() - t0
        if rep:
            best = min(best, dt)
    return best


def main(argv=None, result: dict | None = None) -> int:
    """Run the sweep; ``result``, when given, receives the JSON record
    (``"record"``), the graph (``"graph"``), the queries and their true
    top-k node ids (``"queries"``, ``"truth"``)."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=100_000)
    ap.add_argument("--q", type=int, default=256)
    ap.add_argument("--n-bits", type=int, default=1024)
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--connectivity", type=int, default=16)
    ap.add_argument("--expansion-add", type=int, default=128)
    ap.add_argument("--efs", type=int, nargs="+",
                    default=[16, 32, 64, 128, 256])
    ap.add_argument("--library", choices=["tree", "uniform"],
                    default="tree",
                    help="'tree' = clustered analog-series manifold; "
                         "'uniform' = i.i.d. random bits (distance "
                         "concentration)")
    ap.add_argument("--chain", type=int, default=8,
                    help="query blocks searched back to back for the "
                         "chained q/s")
    ap.add_argument("--expand-width", type=int, default=4,
                    help="beam entries expanded per iteration (E)")
    ap.add_argument("--packed-adj", action="store_true",
                    help="search over the bit-packed neighbor table "
                         "(rad_tpu_torch.graph.adjpack); result-identical")
    ap.add_argument("--graph-cache", default=None,
                    help="save the built graph here (.npz), or load it "
                         "when the file exists")
    ap.add_argument("--fps-npz", default=None,
                    help="load packed fingerprints from this npz's "
                         "'packed' member; overrides --library, checks --n")
    ap.add_argument("--builder", choices=BUILDERS, default="native",
                    help="native = the C++ builder on the host's cores; "
                         "host = the numpy host builder (the reference's "
                         "fallback); exact = the all-pairs builder; "
                         "device = the batched beam insert")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the first CUDA device)")
    args = ap.parse_args(argv)
    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        print(f"rad_tpu_torch.bench_recall: {e}; nothing measured",
              file=sys.stderr)
        return 1

    from rad_tpu_torch.fp.pack import to_torch_packed
    from rad_tpu_torch.fp.tanimoto import bruteforce_topk_blocked
    from rad_tpu_torch.graph.storage import HNSWGraph
    from rad_tpu_torch.search.knn import search_device

    graph = None
    builder = args.builder
    if args.graph_cache and os.path.exists(args.graph_cache):
        log(f"loading cached graph {args.graph_cache} ...")
        graph = HNSWGraph.load(args.graph_cache, mmap=False)
        if len(graph) != args.n or graph.connectivity != args.connectivity:
            raise ValueError(f"{args.graph_cache}: {len(graph)} nodes, M = "
                             f"{graph.connectivity}; expected {args.n}, "
                             f"{args.connectivity}")
        fps = np.asarray(graph.packed)
        rng = np.random.default_rng(99)
        queries = fps[rng.choice(args.n, args.q, replace=False)]
        builder = "cache"
    else:
        fps, queries = load_fingerprints(args.library, args.n, args.n_bits,
                                         args.q, args.fps_npz)
        log(f"building {args.n}-node graph ({args.builder}, {device}) ...")
        t0 = time.perf_counter()
        graph = build_graph(args.builder, fps, args.connectivity,
                            args.expansion_add, device)
        log(f"build: {time.perf_counter() - t0:.1f}s")
        if args.graph_cache:
            graph.save(args.graph_cache)
            log(f"saved graph cache -> {args.graph_cache}")

    log("exact ground truth ...")
    _, true_ids = bruteforce_topk_blocked(
        to_torch_packed(queries, device),
        to_torch_packed(np.asarray(graph.packed), device), args.k,
        block=1 << 14)
    true_ids = true_ids.cpu().numpy()

    rng_c = np.random.default_rng(7)
    blocks = [fps[rng_c.choice(args.n, args.q, replace=False)]
              for _ in range(args.chain)]
    results = []
    for ef in args.efs:
        kw = dict(k=args.k, expansion_search=ef,
                  expand_width=args.expand_width,
                  packed_adjacency=args.packed_adj, device=device)
        search_device(graph, queries, **kw)            # warm
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        ids = search_device(graph, queries, **kw)[1].cpu().numpy()
        dt = time.perf_counter() - t0
        recall = recall_at_k(ids, true_ids, args.k)
        qps = args.q / dt
        qps_chain = (args.chain * args.q
                     / _chained_seconds(graph, blocks, kw, device)
                     if blocks else None)
        log(f"ef={ef:4d}  recall@{args.k}={recall:.3f}  {qps:.0f} q/s "
            f"single-call / {qps_chain or 0:.0f} q/s chained")
        results.append({"ef": ef, "recall": recall, "qps": qps,
                        "qps_chained": qps_chain})

    record = {
        "metric": f"recall@{args.k}_sweep",
        "n": args.n,
        "connectivity": args.connectivity,
        "expansion_add": args.expansion_add,
        "builder": builder,
        "results": results,
    }
    if result is not None:
        result.update(record=record, graph=graph, queries=queries,
                      truth=true_ids)
    print(json.dumps(record))
    return 0


if __name__ == "__main__":
    sys.exit(main())
