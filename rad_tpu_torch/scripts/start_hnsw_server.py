"""Launch an HNSW index HTTP server.

The command line of the repo's ``scripts/start_hnsw_server.py`` on the
port: load a persisted index (memory-mapped) or build a random test index,
optionally attach a SMILES SQLite database and an API key, and serve.

    python -m rad_tpu_torch.scripts.start_hnsw_server \\
        --hnsw-path library.npz --database-path library.db \\
        --host 0.0.0.0 --port 8000

    python -m rad_tpu_torch.scripts.start_hnsw_server --test-data 1000

The server needs no CUDA: it answers from the graph's host arrays, and
``--test-data`` builds with the numpy host builder. Nothing on this path
initialises CUDA, so ``--workers N`` can fork after the graph is loaded.
"""

from __future__ import annotations

import argparse
import logging
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="rad_tpu_torch HNSW index "
                                             "server")
    ap.add_argument("--hnsw-path", help="path to a persisted index (.npz)")
    ap.add_argument("--test-data", type=int, default=None, metavar="N",
                    help="serve a random N-vector test index instead")
    ap.add_argument("--test-dim", type=int, default=64,
                    help="fingerprint bits for --test-data")
    ap.add_argument("--host", default="0.0.0.0")
    ap.add_argument("--port", type=int, default=8000)
    ap.add_argument("--workers", type=int, default=1,
                    help="server processes sharing the port via "
                         "SO_REUSEPORT (kernel accept() load balancing). "
                         "Each worker maps the same index, sharing the OS "
                         "page cache. Requires port != 0 and is "
                         "incompatible with --enable-coordination "
                         "(per-process state).")
    ap.add_argument("--database-path", help="SMILES SQLite (nodes table)")
    ap.add_argument("--api-key", default=None)
    ap.add_argument("--enable-cors", action="store_true")
    ap.add_argument("--cache-dir", default=".rad_tpu_cache",
                    help="persistent top-level-node cache directory")
    ap.add_argument("--static-dir", default=None,
                    help="directory served under /static/")
    ap.add_argument("--no-view", action="store_true",
                    help="load the index fully instead of memory-mapping")
    ap.add_argument("--enable-coordination", action="store_true",
                    help="expose /coordination/* so scoring workers on "
                         "other machines can join this head node")
    ap.add_argument("--debug", action="store_true")
    args = ap.parse_args(argv)

    logging.basicConfig(
        level=logging.DEBUG if args.debug else logging.INFO,
        format="%(asctime)s %(levelname)s %(name)s: %(message)s")
    log = logging.getLogger("start_hnsw_server")

    if not args.hnsw_path and args.test_data is None:
        ap.error("provide --hnsw-path or --test-data")

    from rad_tpu_torch.graph.storage import HNSWGraph
    from rad_tpu_torch.server.http_server import run_hnsw_server
    from rad_tpu_torch.store.smiles_store import SQLiteSmilesStore

    # host arrays only: neither the load nor the host builder touches CUDA,
    # so the forked workers below start from a process without a CUDA
    # context (one cannot be inherited across fork)
    if args.hnsw_path:
        log.info("loading index from %s (mmap=%s)", args.hnsw_path,
                 not args.no_view)
        graph = HNSWGraph.load(args.hnsw_path, mmap=not args.no_view)
    else:
        log.info("building random test index (%d x %d bits)",
                 args.test_data, args.test_dim)
        from rad_tpu_torch.build.reference import build_hnsw
        from rad_tpu_torch.fp import random_fingerprints
        fps = random_fingerprints(args.test_data, n_bits=args.test_dim,
                                  seed=0)
        graph = build_hnsw(fps, connectivity=8, expansion_add=40)

    if args.workers < 1:
        ap.error("--workers must be >= 1")
    if args.workers > 1:
        if args.enable_coordination:
            ap.error("--workers > 1 is incompatible with "
                     "--enable-coordination (coordination state is "
                     "per-process; run one coordination server)")
        if args.port == 0:
            ap.error("--workers > 1 needs a fixed --port (each worker "
                     "binds the same port via SO_REUSEPORT)")

    store = None
    if args.database_path:
        store = SQLiteSmilesStore(args.database_path)
        log.info("SMILES DB: %s (%d rows)", args.database_path, len(store))

    coordination = None
    if args.enable_coordination:
        from rad_tpu_torch.service.local import LocalHNSWService
        from rad_tpu_torch.traverse.coordinator import CoordinationService
        coordination = CoordinationService(LocalHNSWService(graph, store))
        coordination.start()
        log.info("coordination endpoints enabled (/coordination/*)")

    log.info("index: %d nodes, max_level=%d", len(graph), graph.max_level)

    def serve(worker_store, reuse_port):
        run_hnsw_server(graph, host=args.host, port=args.port,
                        smiles_store=worker_store, api_key=args.api_key,
                        enable_cors=args.enable_cors,
                        cache_dir=args.cache_dir,
                        static_dir=args.static_dir,
                        coordination=coordination, reuse_port=reuse_port)

    if args.workers == 1:
        serve(store, reuse_port=False)
        return 0

    # fork the workers before serving: the mapped graph is inherited
    # copy-on-write (one page-cache copy for all of them); each opens its
    # own SQLite connection (sqlite handles do not survive a fork)
    import multiprocessing as mp

    def child():
        child_store = (SQLiteSmilesStore(args.database_path)
                       if args.database_path else None)
        serve(child_store, reuse_port=True)

    ctx = mp.get_context("fork")
    if store is not None:
        store.close()
    procs = [ctx.Process(target=child, daemon=True)
             for _ in range(args.workers - 1)]
    for p in procs:
        p.start()
    log.info("%d worker processes sharing port %d (SO_REUSEPORT)",
             args.workers, args.port)
    try:
        child()
    finally:
        for p in procs:
            p.terminate()
    return 0


if __name__ == "__main__":
    sys.exit(main())
