"""The traversal engine at 100M nodes on one card.

    python -m rad_tpu_torch.bench_scale [--n 100000000] [--budget 10000000]
        [--mode hash|fps|id] [--no-score-table] [--packed-adj]

The port of ``benchmarks/bench_scale.py``, with its flags and its JSON
line. Everything large is made on the card: the layered HNSW-shaped random
adjacency (:func:`make_device_graph`, in ``--gen-chunks`` chunks, so no
``[R, 2m]`` temporary stands beside the table), the score table and the
fingerprints, each from a ``torch.Generator`` on the device seeded as the
reference seeds its keys (0 for the graph, 1 for the score source, 7 for
the target). The bits differ from the reference's threefry draws; the
graph keeps its shape rules, and the engine runs are held to the
reference's on one numpy graph and table (``tests/test_torch_scale.py``).

Modes:
  ``hash`` (default): a ``[N]`` f32 table of uniform scores gathered by
      node id (:func:`~rad_tpu_torch.traverse.device.make_device_run`);
  ``fps``: random 1024-bit fingerprints and the Tanimoto-to-target scorer
      (:func:`~rad_tpu_torch.traverse.device.fused_run`);
  ``id``: the score is computed from the node id in the step (the
      golden-ratio hash :func:`id_score`); with ``--no-score-table`` the
      ``[N]`` score table is never allocated (:func:`make_id_run`).

The reference's ``--mem-analysis`` (XLA's ahead-of-time memory analysis
of an abstract program) has no CUDA counterpart and is not ported: each
run prints its ``torch.cuda.max_memory_allocated`` instead, beside the
bytes of the graph, the score source and every state tensor. Progress
goes to stderr; the last line is ``{"metric":
"scale_traversal_nodes_per_sec", "value", ...}``. Runs on the first CUDA
device unless ``--device`` names another; without one it exits non-zero.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import sys
import time

import numpy as np
import torch

from rad_tpu_torch.devices import resolve_device

__all__ = ["hnsw_layer_sizes", "make_device_graph", "id_score",
           "make_id_run", "tensor_bytes", "main"]

GOLDEN = 0.6180339887498949


def log(*a) -> None:
    print(*a, file=sys.stderr, flush=True)


def hnsw_layer_sizes(n: int, m: int) -> list[int]:
    """Expected HNSW layer occupancy: n_l = round(n * m^-l), min 1."""
    sizes = []
    l = 0
    while True:
        nl = int(round(n * m ** (-l)))
        if nl < 1:
            break
        sizes.append(nl)
        if nl == 1:
            break
        l += 1
    return sizes


def make_device_graph(n: int, m: int, seed: int, n_chunks: int = 64,
                      packed_bits: int | None = None, device=None):
    """HNSW-shaped random layered graph, its adjacency made on ``device``.

    Layer 0 caps at 2m neighbors and the layers above at m; every id is
    drawn uniformly from its own layer (no self loops: a draw of the row's
    own node moves to the next id of the layer); a layer of one node has
    no edges; the flat ``[R, 2m]`` table is ``-1`` padded. ``packed_bits``
    packs each chunk to bit fields (:mod:`rad_tpu_torch.graph.adjpack`)
    before it lands, so the int32 table is never resident. Returns
    ``(DeviceGraph, layer sizes)``."""
    from rad_tpu_torch.graph.adjpack import (pack_adjacency_rows,
                                             packed_adj_words)
    from rad_tpu_torch.traverse.device import DeviceGraph

    device = resolve_device(device)
    sizes = hnsw_layer_sizes(n, m)
    offsets = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int64)
    r = int(offsets[-1])
    m0 = 2 * m
    max_level = len(sizes) - 1
    offsets_host = np.concatenate([offsets, [r]]).astype(np.int32)
    offs = torch.from_numpy(offsets_host.astype(np.int64)).to(device)
    szs = torch.tensor(sizes + [1], dtype=torch.int64, device=device)
    width = packed_adj_words(m0, packed_bits) if packed_bits else m0
    adj = torch.empty((r, width), dtype=torch.int32, device=device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    chunk = -(-r // n_chunks)
    cols = torch.arange(m0, device=device)[None, :]
    for lo in range(0, r, chunk):
        rows = torch.arange(lo, min(lo + chunk, r), device=device)
        lev = torch.clamp(torch.searchsorted(offs[: max_level + 2], rows,
                                             right=True) - 1, 0, max_level)
        nl = szs[lev][:, None]
        ids = torch.randint(0, 1 << 31, (rows.shape[0], m0), generator=gen,
                            device=device) % nl
        node = (rows - offs[lev])[:, None]
        ids = torch.where(ids == node, (ids + 1) % nl, ids)
        cap = torch.where(lev == 0, m0, m)[:, None]
        ids = torch.where((cols < cap) & (nl > 1), ids, -1).to(torch.int32)
        if packed_bits:
            ids = pack_adjacency_rows(ids, packed_bits)
        adj[lo:lo + rows.shape[0]] = ids
        del ids, rows, lev, nl, node, cap
    return DeviceGraph(adj=adj, offsets=offs.to(torch.int32),
                       offsets_host=offsets_host, n_nodes=n, n_rows=r,
                       m0=m0, max_level=max_level,
                       adj_bits=packed_bits or 32), sizes


def id_score(ids: torch.Tensor) -> torch.Tensor:
    """A pseudo-random f32 in [0, 1) from each node id (the golden-ratio
    hash), bit-equal to the reference's."""
    x = ids.to(torch.float32) * GOLDEN
    return x - torch.floor(x)


def make_id_run(batch: int, no_score_table: bool):
    """The id-mode run: each step's ``to_score`` scored by
    :func:`id_score`. With ``no_score_table`` the state ops recompute a
    candidate's score from its id and never write one, so the state may
    hold the one-slot dummy of ``init_state(score_table=False)``.

    Returns ``(run(state, n_to_score, dg) -> state, id_score)``: the loop
    stops once ``n_scored >= n_to_score``, after 2**20 steps, or when the
    frontier empties."""
    from rad_tpu_torch.traverse import device as tdev

    if no_score_table:
        class _IdOps(tdev.DenseStateOps):
            @staticmethod
            def gather_scores(arr, idx):
                return id_score(idx)

            @staticmethod
            def scatter_scores(arr, idx, vals):
                return None

        ops = _IdOps()
    else:
        ops = tdev.DENSE_OPS

    def run(state, n_to_score, dg):
        n_to_score = int(n_to_score)
        steps = 0
        while steps < (1 << 20):
            n_scored, live = torch.stack(
                [state.n_scored.long(),
                 tdev.frontier_live(state).long()]).tolist()
            if n_scored >= n_to_score or live <= 0:
                break
            state, out = tdev.expand(state, dg, batch, ops=ops)
            ts = out["to_score"]
            scores = torch.where(ts >= 0, id_score(ts), tdev.INF)
            state = tdev.integrate(
                state, dg, out["exp_node"], out["exp_level"],
                out["exp_score"], out["exp_valid"], out["cand"], ts, scores,
                ops=ops)
            steps += 1
        return state

    return run, id_score


def tensor_bytes(obj) -> dict:
    """``{field: bytes}`` of every tensor field of a dataclass (a
    DeviceGraph or a TraversalState)."""
    return {f.name: getattr(obj, f.name).numel()
            * getattr(obj, f.name).element_size()
            for f in dataclasses.fields(obj)
            if torch.is_tensor(getattr(obj, f.name))}


def _random_words(rows: int, w: int, gen, device, step: int = 1 << 21):
    """``[rows, w]`` int32 of uniform random bits, drawn ``step`` rows at
    a time (bounds the int64 draw beside the table)."""
    out = torch.empty((rows, w), dtype=torch.int32, device=device)
    for lo in range(0, rows, step):
        hi = min(lo + step, rows)
        draw = torch.randint(0, 1 << 32, (hi - lo, w), generator=gen,
                             device=device)
        out[lo:hi] = (draw - (1 << 31)).to(torch.int32)
        del draw
    return out


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None, result: dict | None = None) -> int:
    """Run the benchmark; ``result``, when given, receives the JSON
    record (``"record"``), the graph (``"graph"``) and the last run's
    final state (``"state"``)."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=100_000_000)
    ap.add_argument("--m", type=int, default=8,
                    help="connectivity (reference README default 8)")
    ap.add_argument("--budget", type=int, default=10_000_000,
                    help="n_to_score (default 10%% of 100M)")
    ap.add_argument("--batch", type=int, default=1024)
    ap.add_argument("--frontier", type=int, default=1 << 22)
    ap.add_argument("--buffer", type=int, default=1 << 17)
    ap.add_argument("--head", default="auto")
    ap.add_argument("--mode", choices=["hash", "fps", "id"], default="hash",
                    help="'id' = score computed from the node id in-loop")
    ap.add_argument("--n-bits", type=int, default=1024)
    ap.add_argument("--log-capacity", type=int, default=None,
                    help="order-log ring capacity (default n)")
    ap.add_argument("--no-score-table", action="store_true",
                    help="id mode only: never allocate the [N] f32 score "
                         "table; candidate scores come from their ids")
    ap.add_argument("--packed-adj", action="store_true",
                    help="bit-packed adjacency (ceil(log2(n+1))-bit "
                         "fields, rad_tpu_torch.graph.adjpack)")
    ap.add_argument("--runs", type=int, default=3)
    ap.add_argument("--gen-chunks", type=int, default=64,
                    help="chunks the adjacency is generated in")
    ap.add_argument("--profile", metavar="DIR",
                    help="trace one more run with torch.profiler into DIR "
                         "and print the top device kernels")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the first CUDA device)")
    args = ap.parse_args(argv)
    if args.no_score_table and args.mode != "id":
        ap.error("--no-score-table requires --mode id")
    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        print(f"rad_tpu_torch.bench_scale: {e}; nothing measured",
              file=sys.stderr)
        return 1
    cuda = device.type == "cuda"

    from rad_tpu_torch.fp.pack import popcount_rows
    from rad_tpu_torch.fp.tanimoto import tanimoto_rows_to_target
    from rad_tpu_torch.graph.adjpack import adj_bits_for
    from rad_tpu_torch.traverse import device as tdev

    bits = adj_bits_for(args.n) if args.packed_adj else None
    log(f"device: {torch.cuda.get_device_name(device) if cuda else device}")
    t0 = time.perf_counter()
    dg, sizes = make_device_graph(args.n, args.m, seed=0, packed_bits=bits,
                                  n_chunks=args.gen_chunks, device=device)
    _sync(device)
    graph_bytes = dg.adj.numel() * dg.adj.element_size()
    log(f"graph generated on the device: {time.perf_counter() - t0:.1f}s, "
        f"R={dg.n_rows}, levels={len(sizes)}, adj {tuple(dg.adj.shape)} "
        f"{dg.adj.dtype}{f' ({bits}-bit fields)' if bits else ''} "
        f"({graph_bytes / 1e9:.2f} GB)")

    gen = torch.Generator(device=device)
    gen.manual_seed(1)
    source = {}
    if args.mode == "hash":
        # the score table rides in the pops argument, gathered by node id
        source["packed"] = torch.zeros((args.n, 1), dtype=torch.uint8,
                                       device=device)
        source["pops"] = torch.rand((args.n,), generator=gen, device=device)
    elif args.mode == "fps":
        w = args.n_bits // 32
        packed = _random_words(args.n, w, gen, device)
        step = 1 << 21
        pops = torch.empty((args.n,), dtype=torch.int32, device=device)
        for lo in range(0, args.n, step):
            pops[lo:lo + step] = popcount_rows(packed[lo:lo + step])
        gen_t = torch.Generator(device=device)
        gen_t.manual_seed(7)
        target = _random_words(1, w, gen_t, device)[0]
        t_pop = popcount_rows(target[None, :])[0]
        source.update(packed=packed, pops=pops, target=target)
    source_bytes = sum(t.numel() * t.element_size() for t in source.values())
    if source:
        _sync(device)
        log(f"score source ready ({source_bytes / 1e9:.2f} GB)")

    n_top = sizes[-1] if sizes[-1] > 1 else (
        sizes[-2] if len(sizes) > 1 else 1)
    top_ids = torch.arange(max(n_top, 1), dtype=torch.int32, device=device)
    head = args.head
    if head != "auto":
        head = None if head.lower() == "none" else int(head)

    def fresh_state():
        s = tdev.init_state(dg, frontier_capacity=args.frontier,
                            buffer_capacity=args.buffer,
                            head_capacity=head,
                            log_capacity=args.log_capacity,
                            score_table=not args.no_score_table)
        if args.mode == "hash":
            seed_scores = source["pops"][: top_ids.shape[0]]
        elif args.mode == "id":
            seed_scores = id_score(top_ids)
        else:
            seed_scores = tanimoto_rows_to_target(
                source["packed"][: top_ids.shape[0]],
                source["pops"][: top_ids.shape[0]], source["target"], t_pop)
        return tdev.prime(s, dg, top_ids, seed_scores)

    if args.mode == "hash":
        run = tdev.make_device_run(dg, source["packed"], source["pops"],
                                   lambda _rows, table_rows: table_rows,
                                   batch=args.batch)
        run_fn = lambda st: run(st, args.budget)
    elif args.mode == "id":
        run_id, _ = make_id_run(args.batch, args.no_score_table)
        run_fn = lambda st: run_id(st, args.budget, dg)
    else:
        run_fn = lambda st: tdev.fused_run(
            st, dg, source["packed"], source["pops"], source["target"],
            t_pop, args.budget, batch=args.batch)

    def one_run(what: str) -> dict:
        if cuda:
            torch.cuda.reset_peak_memory_stats(device)
        state = fresh_state()
        _sync(device)
        t0 = time.perf_counter()
        state = run_fn(state)
        scored = int(state.n_scored)   # a host read: the run has ended
        dt = time.perf_counter() - t0
        rec = dict(seconds=dt, n_scored=scored,
                   n_dropped=int(state.n_dropped),
                   n_steps=int(state.n_steps),
                   peak_bytes=(torch.cuda.max_memory_allocated(device)
                               if cuda else None))
        log(f"{what}: {dt:.2f}s, {scored} scored -> {scored / dt:.0f} "
            f"nodes/s (dropped {rec['n_dropped']}, {rec['n_steps']} steps, "
            f"{1e3 * dt / max(rec['n_steps'], 1):.2f} ms a step, peak "
            f"{rec['peak_bytes']} bytes)")
        return rec, state

    log("first run ...")
    first, state = one_run("first run")
    runs = []
    for i in range(args.runs):
        state = None   # release the previous final state first
        rec, state = one_run(f"run {i}")
        runs.append(rec)
    if not runs:
        runs = [first]
    state_bytes = tensor_bytes(state)
    log_ids = tdev.read_order_log(state)
    distinct = len(np.unique(log_ids)) == len(log_ids)

    if args.profile:
        from rad_tpu_torch.utils.profiling import (aggregate_device_ops,
                                                   profile_trace)
        prof_state = fresh_state()
        _sync(device)
        with profile_trace(args.profile):
            prof_state = run_fn(prof_state)
            _ = int(prof_state.n_scored)
        del prof_state
        ops, n_ev = aggregate_device_ops(args.profile)
        total = sum(ops.values())
        log(f"profile: {n_ev} events, {total / 1e6:.1f} ms total device "
            f"time")
        for name, ns in sorted(ops.items(), key=lambda kv: -kv[1])[:25]:
            log(f"  {ns / 1e6:10.2f} ms  {name}")

    best = min(runs, key=lambda r: r["seconds"])
    record = {
        "metric": "scale_traversal_nodes_per_sec",
        "value": best["n_scored"] / best["seconds"],
        "unit": "nodes/s",
        "n": args.n,
        "mode": args.mode,
        "budget": args.budget,
        "batch": args.batch,
        "m": args.m,
        "packed_adj_bits": bits,
        "no_score_table": bool(args.no_score_table),
        "seconds_per_step": best["seconds"] / max(best["n_steps"], 1),
        "peak_bytes": max((r["peak_bytes"] or 0) for r in runs) or None,
        "graph_bytes": graph_bytes,
        "score_source_bytes": source_bytes,
        "state_bytes": state_bytes,
        "order_log_distinct": distinct,
        "first_run": first,
        "runs": runs,
        "device": torch.cuda.get_device_name(device) if cuda else str(device),
    }
    if result is not None:
        result.update(record=record, graph=dg, state=state)
    print(json.dumps(record))
    return 0 if math.isfinite(record["value"]) else 1


if __name__ == "__main__":
    sys.exit(main())
