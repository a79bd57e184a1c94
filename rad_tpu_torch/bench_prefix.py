"""The two-stage prefix-screened beam search: recall and queries per
second per screen.

    python -m rad_tpu_torch.bench_prefix [--n 100000] [--device cuda]

The port of ``benchmarks/bench_prefix.py``, with its flags and its JSON
line. The screen (``search_device(prefix_filter=, prefix_keep=)``) ranks
each candidate wave by Tanimoto over a compact ``[N, prefix_bits / 32]``
copy of the fingerprints and gives only the best ``keep`` full-width
distances, so the per-wave fingerprint gather shrinks by ``W / pw`` and
the merge sorts ``ef + keep`` keys instead of ``ef + E·M0``.

The library is :func:`rad_tpu_torch.synthetic.make_library` (the
mutation-tree recipe, seed 0), not the reference's ``enrichment_example``
library. The graph comes from the reference's builder, the C++ builder on
every host core (:func:`~rad_tpu_torch.native.build_hnsw_native`). The
truth is the brute force (:func:`~rad_tpu_torch.fp.tanimoto.
bruteforce_topk_blocked`). Each config is searched twice, the second time
timed (host clock, ids read back). Progress goes to stderr; the last line
is ``{"metric": "prefix_filter_sweep", "n", "ef", "results": [{
"prefix_bits", "keep", "recall", "qps"}, ...]}``. Runs on the first CUDA
device unless ``--device`` names another; without one it exits non-zero.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from rad_tpu_torch.devices import resolve_device

__all__ = ["parse_configs", "sweep", "full_keep_witness", "main"]

CONFIGS = "0:0,128:32,128:64,256:32,256:64"


def log(*a) -> None:
    print(*a, file=sys.stderr, flush=True)


def parse_configs(spec: str):
    """``"0:0,128:32"`` → ``[(0, 0), (128, 32)]`` (prefix bits, keep;
    ``0:0`` is the unscreened search)."""
    return [tuple(int(x) for x in s.split(":")) for s in spec.split(",")]


def sweep(graph, queries: np.ndarray, truth: np.ndarray, configs, k: int,
          ef: int, expand_width: int, device) -> list:
    """Search ``graph`` with ``queries`` under each ``(prefix_bits,
    keep)`` config, once to warm and once timed. ``truth``: ``[B, >= k]``
    true neighbors as keys. Returns one dict a config: ``prefix_bits``,
    ``keep``, ``recall`` (recall@k), ``qps``, ``seconds``, and the timed
    run's ``dists`` / ``ids`` (numpy, ids as node ids)."""
    from rad_tpu_torch.graph.storage import host_keys_view
    from rad_tpu_torch.search.knn import search_device

    keys = host_keys_view(graph.keys)
    true_sets = [set(t[:k].tolist()) for t in truth]
    out = []
    for pf, keep in configs:
        kw = dict(k=k, expansion_search=ef, expand_width=expand_width,
                  device=device)
        if pf:
            kw.update(prefix_filter=pf, prefix_keep=keep)
        search_device(graph, queries, **kw)
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        d, ids = search_device(graph, queries, **kw)
        d, ids = d.cpu().numpy(), ids.cpu().numpy()
        dt = time.perf_counter() - t0
        mapped = np.asarray(keys[np.maximum(ids, 0)])
        recall = float(np.mean([len(set(mapped[i].tolist()) & true_sets[i])
                                / k for i in range(len(queries))]))
        out.append({"prefix_bits": pf, "keep": keep, "recall": recall,
                    "qps": len(queries) / dt, "seconds": dt, "dists": d,
                    "ids": ids})
    return out


def _record_beam(graph, queries, device, **kw):
    """``search_device`` on ``queries`` as one batch, with each iteration
    of its layer-0 loop recorded: the entry points, then per iteration
    the expanded ids ``[B, E]`` and the full-width wave (ids, valid,
    distances) ``[B, width]`` that enters the merge. Returns ``(dists,
    ids, ep, d_ep, steps)``, numpy."""
    from rad_tpu_torch.fp.pack import popcount_rows
    from rad_tpu_torch.search import knn

    dg, packed, pops = knn._prep(graph, device)
    adjacency_rows, query_dist = knn.adjacency_rows, knn._query_dist
    expanded, waves = [], []

    def adjacency_rec(dg_, u):
        if u.dim() == 2:                 # the beam loop's [B, E] ids
            expanded.append(u.cpu().numpy())
        return adjacency_rows(dg_, u)

    def query_dist_rec(q, q_pop, rows_packed, rows_pops, ids, valid):
        d = query_dist(q, q_pop, rows_packed, rows_pops, ids, valid)
        if expanded and rows_packed is packed:     # stage 2, not stage 1
            waves.append((ids.cpu().numpy(), valid.cpu().numpy(),
                          d.cpu().numpy()))
        return d

    knn.adjacency_rows, knn._query_dist = adjacency_rec, query_dist_rec
    try:
        d, ids = knn.search_device(graph, queries, chunk_size=len(queries),
                                   device=device, **kw)
    finally:
        knn.adjacency_rows, knn._query_dist = adjacency_rows, query_dist
    # the first iteration expands slot 0 of every beam: the entry point
    ep = torch.from_numpy(expanded[0][:, 0]).to(device)
    q = torch.from_numpy(np.ascontiguousarray(
        np.asarray(queries, np.uint32)).view(np.int32)).to(device)
    d_ep = query_dist(q, popcount_rows(q), packed, pops, ep[:, None],
                      torch.ones((len(ep), 1), dtype=torch.bool,
                                 device=device))[:, 0]
    return (d.cpu().numpy(), ids.cpu().numpy(), ep.cpu().numpy(),
            d_ep.cpu().numpy(), list(zip(expanded, waves)))


def _replay(ep, d_ep, steps, k: int, ef: int, e: int, d, ids):
    """The beam loop's bookkeeping (expand the E best unexpanded entries,
    merge the wave with a stable sort) replayed in numpy over the
    recorded waves. Returns per iteration the ids it expands (−1 where a
    query has no work), their distances and the beam's distances before
    the merge, and checks that the replay expands what the search did and
    ends at its result."""
    b = len(ep)
    beam_d = np.full((b, ef), np.inf, np.float32)
    beam_id = np.full((b, ef), -1, np.int64)
    beam_d[:, 0], beam_id[:, 0] = d_ep, ep
    expanded = np.zeros((b, ef), bool)
    max_iters = (16 * ef) // max(e, 1) + 256
    out = []
    for it, (u_rec, (rows, valid, d_n)) in enumerate(steps):
        active = (~expanded & np.isfinite(beam_d)).any(1) & (it < max_iters)
        key = np.where(expanded, np.inf, beam_d)
        sel = np.argsort(key, axis=1, kind="stable")[:, :e]
        key_s = np.take_along_axis(key, sel, 1)
        work = np.isfinite(key_s) & active[:, None]
        u = np.take_along_axis(beam_id, sel, 1)
        if not np.array_equal(u[work], u_rec[work]):
            raise AssertionError(f"replay: iteration {it} expands other ids "
                                 f"than the search")
        out.append((np.where(work, u, -1), np.where(work, key_s, np.inf),
                    beam_d.copy(), np.where(valid, rows, -1), d_n))
        exp_new = expanded.copy()
        np.put_along_axis(exp_new, sel,
                          work | np.take_along_axis(expanded, sel, 1), 1)
        all_d = np.concatenate([beam_d, d_n], 1)
        order = np.argsort(all_d, axis=1, kind="stable")[:, :ef]
        all_id = np.concatenate([beam_id, np.where(valid, rows, -1)], 1)
        all_e = np.concatenate([exp_new, np.zeros_like(valid)], 1)
        keep = active[:, None]
        beam_d = np.where(keep, np.take_along_axis(all_d, order, 1), beam_d)
        beam_id = np.where(keep, np.take_along_axis(all_id, order, 1),
                           beam_id)
        expanded = np.where(keep, np.take_along_axis(all_e, order, 1),
                            expanded)
    if not (np.array_equal(beam_d[:, :k], d)
            and np.array_equal(beam_id[:, :k], ids)):
        raise AssertionError("replay: the beams end elsewhere than the "
                             "search")
    return out


def _wave_set(ids: np.ndarray, dists: np.ndarray) -> set:
    return {(int(i), float(x)) for i, x in zip(ids, dists) if i >= 0}


def full_keep_witness(graph, queries, prefix_bits: int, k: int, ef: int,
                      expand_width: int, device,
                      visited_capacity: int | None = None) -> list:
    """Why the screen that keeps the whole wave (``keep = E·M0``) ends
    elsewhere than the unscreened search, query by query.

    Keeping the whole wave changes only the order in which the wave
    enters the stable merge, so the two beams hold the same distances,
    slot for slot, and may differ only in which of several equal-distance
    entries they hold. Both searches run on ``queries`` as one batch with
    their layer-0 loops recorded and replayed (:func:`_replay`); then, per
    query, iteration by iteration: while both expand the same ids, their
    waves must be the same (id, distance) sets; at the first iteration
    where they expand different ids, their beams must hold the same
    distances and the ids they expand must have equal distances — a tie.
    Returns one dict a query — ``same`` (ids and distances equal),
    ``step`` (the first iteration that expands different ids, or None),
    ``tie`` (the distances of the ids only one run expands there),
    ``fault`` (None, or what broke the rule) — and the two runs' ``(dists,
    ids)``, unscreened first. ``visited_capacity`` forces the hashed
    visited set, as a larger batch takes it."""
    device = resolve_device(device)
    m0 = 2 * graph.connectivity
    kw = dict(k=k, expansion_search=ef, expand_width=expand_width,
              visited_capacity=visited_capacity)
    e = min(expand_width, max(ef, k))
    runs = []
    for screen in ({}, dict(prefix_filter=prefix_bits,
                            prefix_keep=expand_width * m0)):
        d, ids, ep, d_ep, steps = _record_beam(graph, queries, device,
                                               **kw, **screen)
        runs.append((d, ids, _replay(ep, d_ep, steps, k, max(ef, k), e,
                                     d, ids)))
    (da, ia, sa), (db, ib, sb) = runs
    out = []
    for j in range(len(queries)):
        r = dict(same=bool(np.array_equal(da[j], db[j])
                           and np.array_equal(ia[j], ib[j])),
                 step=None, tie=None, fault=None)
        for t in range(max(len(sa), len(sb))):
            xa = sa[t] if t < len(sa) else None
            xb = sb[t] if t < len(sb) else None
            ua = sorted(xa[0][j][xa[0][j] >= 0].tolist()) if xa else []
            ub = sorted(xb[0][j][xb[0][j] >= 0].tolist()) if xb else []
            if ua != ub:
                ka = np.sort(xa[1][j]) if xa else None
                kb = np.sort(xb[1][j]) if xb else None
                r["step"] = t
                if (xa and xb and np.array_equal(xa[2][j], xb[2][j])
                        and np.array_equal(ka, kb)):
                    # the distances of the ids only one of them expands
                    r["tie"] = sorted(
                        {float(x) for u, x in zip(xa[0][j], xa[1][j])
                         if u >= 0 and u not in ub}
                        | {float(x) for u, x in zip(xb[0][j], xb[1][j])
                           if u >= 0 and u not in ua})
                else:
                    r["fault"] = (f"iteration {t}: the beams expand "
                                  f"different ids at different distances")
                break
            if ua and _wave_set(xa[3][j], xa[4][j]) != _wave_set(
                    xb[3][j], xb[4][j]):
                r["fault"] = (f"iteration {t}: the same expansions gave "
                              f"different waves")
                break
        else:
            if not np.array_equal(da[j], db[j]):
                r["fault"] = ("the same expansions throughout ended at "
                              "different distances")
        out.append(r)
    return out, (da, ia), (db, ib)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=100_000)
    ap.add_argument("--q", type=int, default=512)
    ap.add_argument("--n-bits", type=int, default=1024)
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--connectivity", type=int, default=16)
    ap.add_argument("--expansion-add", type=int, default=128)
    ap.add_argument("--ef", type=int, default=64)
    ap.add_argument("--expand-width", type=int, default=4)
    ap.add_argument("--configs", default=CONFIGS,
                    help="comma list of prefixbits:keep (0:0 = baseline)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the first CUDA device)")
    args = ap.parse_args(argv)
    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        print(f"rad_tpu_torch.bench_prefix: {e}; nothing measured",
              file=sys.stderr)
        return 1

    from rad_tpu_torch.fp.pack import to_torch_packed
    from rad_tpu_torch.fp.tanimoto import bruteforce_topk_blocked
    from rad_tpu_torch.native import build_hnsw_native
    from rad_tpu_torch.synthetic import make_library

    fps, _ = make_library(args.n, args.n_bits, seed=0)
    rng = np.random.default_rng(99)
    queries = fps[rng.choice(args.n, args.q, replace=False)]
    log(f"building {args.n}-node graph (native) ...")
    t0 = time.perf_counter()
    graph = build_hnsw_native(fps, connectivity=args.connectivity,
                              expansion_add=args.expansion_add, seed=0)
    log(f"build: {time.perf_counter() - t0:.1f}s")

    log("exact ground truth ...")
    _, true_ids = bruteforce_topk_blocked(
        to_torch_packed(queries, device), to_torch_packed(fps, device),
        args.k, block=1 << 14)
    results = sweep(graph, queries, true_ids.cpu().numpy(),
                    parse_configs(args.configs), args.k, args.ef,
                    args.expand_width, device)
    for r in results:
        log(f"prefix={r['prefix_bits']:4d} keep={r['keep']:3d}  "
            f"recall@{args.k}={r['recall']:.3f}  {r['qps']:.0f} q/s")
    print(json.dumps({
        "metric": "prefix_filter_sweep",
        "n": args.n,
        "ef": args.ef,
        "results": [{key: r[key] for key in ("prefix_bits", "keep",
                                             "recall", "qps")}
                    for r in results],
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
