"""Partition-and-stitch HNSW construction past one builder's scale.

The port of :mod:`rad_tpu.build.partition`, edge-identical to it. The
library is split round-robin into S shards (each a uniform 1/S sample),
each shard gets an independent sub-graph, and the sub-graphs merge into
one level-sorted :class:`~rad_tpu_torch.graph.storage.HNSWGraph` whose
shard boundaries are then stitched:

* **layer 0**: every node searches every other shard's sub-graph for its
  ``stitch_k`` nearest neighbors there (a batched HNSW search per shard
  pair, :func:`rad_tpu_torch.search.knn.search_device`); the candidate
  edges are applied in both directions and each affected row re-selected
  over (existing ∪ entrants);
* **layers >= 1**: memberships shrink geometrically (≈ N / M^l), so the
  cross-shard k-NN there is exact, a blocked brute force per shard pair
  (:func:`rad_tpu_torch.fp.tanimoto.bruteforce_topk_blocked`, whose
  distances come from the matrix kernel on the card), merged the same
  way.

Re-selection runs the batched builder's diversity heuristic
(:func:`rad_tpu_torch.build.device._select_neighbors`) on ``device``;
the rest of the merge is numpy on the host, as in the reference.
"""

from __future__ import annotations

import functools
import logging
import time
from typing import Callable, List

import numpy as np
import torch

from rad_tpu_torch.devices import resolve_device
from rad_tpu_torch.fp.pack import popcount_rows_np, to_torch_packed
from rad_tpu_torch.graph.storage import HNSWGraph

logger = logging.getLogger(__name__)

__all__ = ["build_hnsw_partitioned"]


def _resolve_builder(builder, device) -> Callable[..., HNSWGraph]:
    """Map a builder name to a callable (build_hnsw's kwargs); the device
    builders run on ``device``.

    ``"auto"`` is the native C++ builder when its library compiles
    (:func:`~rad_tpu_torch.native.native_available`), else the numpy host
    builder. The reference's ``"auto"`` takes the native builder whenever
    its module imports, and so raises at build time on a host without a
    compiler."""
    if callable(builder):
        return builder
    if builder == "auto":
        from rad_tpu_torch.native import native_available
        builder = "native" if native_available() else "host"
    if builder == "host":
        from rad_tpu_torch.build.reference import build_hnsw
        return build_hnsw
    if builder == "native":
        from rad_tpu_torch.native import build_hnsw_native
        return build_hnsw_native
    if builder == "device":
        from rad_tpu_torch.build.device import build_hnsw_device
        return functools.partial(build_hnsw_device, device=device)
    if builder == "exact":
        from rad_tpu_torch.build.exact import build_hnsw_exact
        return functools.partial(build_hnsw_exact, device=device)
    raise ValueError(f"unknown builder {builder!r}")


def _pair_dist_np(packed: np.ndarray, pops: np.ndarray,
                  a: np.ndarray, b: np.ndarray,
                  valid: np.ndarray) -> np.ndarray:
    """Tanimoto distance between id arrays ``a`` and ``b`` (same shape):
    the similarity divided in f64, then cast to f32, as the reference
    does."""
    sa = np.maximum(a, 0)
    sb = np.maximum(b, 0)
    inter = popcount_rows_np(packed[sa] & packed[sb]).astype(np.int64)
    union = pops[sa].astype(np.int64) + pops[sb] - inter
    with np.errstate(divide="ignore", invalid="ignore"):
        sim = np.where(union > 0, inter / np.maximum(union, 1), 1.0)
    d = (1.0 - sim).astype(np.float32)
    return np.where(valid, d, np.float32(np.inf))


def _merge_edges_into_layer(
    table: np.ndarray,
    packed: np.ndarray,
    pops: np.ndarray,
    e_src: np.ndarray,
    e_dst: np.ndarray,
    e_d: np.ndarray,
    heuristic: bool,
    heuristic_chunk: int = 2048,
    device=None,
) -> np.ndarray:
    """Apply directed candidate edges (src→dst, d) to a padded layer table
    (in place; returned).

    Both directions are merged: every edge also enters as (dst→src, d).
    Each affected row is rewritten as a selection over (existing
    neighbors ∪ candidate entrants): the HNSW diversity heuristic with
    backfill on ``device`` in ``heuristic_chunk``-row chunks when
    ``heuristic``, else the plain distance-top-cap.
    """
    cap = table.shape[1]
    src = np.concatenate([e_src, e_dst])
    dst = np.concatenate([e_dst, e_src])
    d = np.concatenate([e_d, e_d])

    # group by src, ascending distance; keep at most `cap` entrants per row
    # (more can never survive the top-cap selection)
    order = np.lexsort((d, src))
    src, dst, d = src[order], dst[order], d[order]
    first = np.empty(src.shape, np.bool_)
    first[:1] = True
    first[1:] = src[1:] != src[:-1]
    group = np.cumsum(first) - 1
    starts = np.flatnonzero(first)
    rank = np.arange(src.shape[0]) - starts[group]
    keep = rank < cap
    rows_aff = src[starts]                       # unique affected rows
    r = rows_aff.shape[0]
    ent_ids = np.full((r, cap), -1, np.int64)
    ent_d = np.full((r, cap), np.inf, np.float32)
    ent_ids[group[keep], rank[keep]] = dst[keep]
    ent_d[group[keep], rank[keep]] = d[keep]

    existing = table[rows_aff].astype(np.int64)  # [R, cap]
    ex_d = _pair_dist_np(packed, pops,
                         np.broadcast_to(rows_aff[:, None], existing.shape),
                         existing, existing >= 0)
    all_ids = np.concatenate([existing, ent_ids], axis=1)   # [R, 2cap]
    all_d = np.concatenate([ex_d, ent_d], axis=1)

    # per-row dedupe (an entrant may already be an edge, or appear in both
    # directions): sort by id, invalidate repeats, then sort ascending by d
    by_id = np.argsort(all_ids, axis=1, kind="stable")
    sid = np.take_along_axis(all_ids, by_id, axis=1)
    dup = np.zeros_like(sid, np.bool_)
    dup[:, 1:] = (sid[:, 1:] == sid[:, :-1]) & (sid[:, 1:] >= 0)
    dup_orig = np.zeros_like(dup)
    np.put_along_axis(dup_orig, by_id, dup, axis=1)
    all_d = np.where(dup_orig | (all_ids < 0), np.inf, all_d)

    by_d = np.argsort(all_d, axis=1, kind="stable")
    cand_ids = np.take_along_axis(all_ids, by_d, axis=1)
    cand_d = np.take_along_axis(all_d, by_d, axis=1)
    cand_ids = np.where(np.isfinite(cand_d), cand_ids, -1)

    if not heuristic:
        table[rows_aff] = cand_ids[:, :cap].astype(np.int32)
        return table

    from rad_tpu_torch.build.device import _select_neighbors

    device = resolve_device(device)
    packed_t = to_torch_packed(packed, device)
    pops_t = torch.from_numpy(np.asarray(pops, np.int32)).to(device)
    k = cand_ids.shape[1]
    for lo in range(0, r, heuristic_chunk):
        hi = min(lo + heuristic_chunk, r)
        sel = _select_neighbors(
            packed_t, pops_t,
            torch.from_numpy(rows_aff[lo:hi].astype(np.int32)).to(device),
            torch.from_numpy(cand_d[lo:hi]).to(device),
            torch.from_numpy(cand_ids[lo:hi].astype(np.int32)).to(device),
            cap, k, torch.ones(hi - lo, dtype=torch.bool, device=device))
        table[rows_aff[lo:hi]] = sel.cpu().numpy()
    return table


def build_hnsw_partitioned(
    packed: np.ndarray,
    keys: np.ndarray | None = None,
    n_shards: int = 4,
    connectivity: int = 16,
    expansion_add: int = 200,
    ndim: int | None = None,
    seed: int = 0,
    builder: str | Callable[..., HNSWGraph] = "auto",
    stitch_k: int | None = None,
    stitch_ef: int | None = None,
    heuristic: bool = True,
    search_chunk: int = 4096,
    builder_kwargs: dict | None = None,
    device=None,
    stage_times: dict | None = None,
) -> HNSWGraph:
    """Build an HNSW graph by partitioning, independent sub-builds and a
    cross-shard stitch. Same parameter semantics as
    :func:`rad_tpu_torch.build.reference.build_hnsw`, plus:

    n_shards:   number of partitions (round-robin over input rows).
    builder:    'native' (the C++ builder on the host's cores; what
                'auto' picks when its library compiles), 'host' (the numpy
                builder; 'auto' otherwise), 'device' (the batched beam
                builder), 'exact' (the all-pairs builder, whose O(shard²)
                distances are the regime sharding creates), or a callable
                with build_hnsw's kwargs, run once per shard. 'device' and
                'exact' shards build on ``device``.
    stitch_k:   cross-shard nearest neighbors requested per (node, shard)
                pair for the layer-0 stitch (default: ``connectivity``).
    stitch_ef:  search beam width of the stitch queries
                (default: ``max(64, 2*stitch_k)``).
    heuristic:  re-select stitched rows with the HNSW diversity heuristic
                (default) instead of a plain distance-top-cap merge.
    search_chunk: query chunk of the layer-0 stitch searches.
    builder_kwargs: extra kwargs forwarded verbatim to every per-shard
                builder call (e.g. ``{"probes": 16}`` for 'exact').

    ``device`` runs the device builders, the stitch searches, the upper
    layers' brute force and the heuristic. ``stage_times``, when given,
    accumulates seconds under ``"sub_builds"``, ``"stitch_search"`` (the
    layer-0 searches), ``"merge"`` (every layer's merge) and
    ``"stitch_upper"`` (the layers >= 1 brute force); each stage ends
    with its results on the host, so the device needs no extra
    synchronisation for that.

    Deterministic given (packed, seed, n_shards, builder, stitch params),
    and the same graph on every device.
    """
    device = resolve_device(device)
    packed = np.ascontiguousarray(packed, dtype=np.uint32)
    n, w = packed.shape
    ndim = ndim or w * 32
    m = connectivity
    if keys is None:
        keys = np.arange(n, dtype=np.int64)
    keys = np.asarray(keys, dtype=np.int64)
    if n_shards < 1:
        raise ValueError("n_shards must be >= 1")
    n_shards = min(n_shards, n)
    build = _resolve_builder(builder, device)
    if n_shards == 1:
        return build(packed, keys=keys, connectivity=m,
                     expansion_add=expansion_add, ndim=ndim, seed=seed,
                     **(builder_kwargs or {}))
    stitch_k = stitch_k or m
    stitch_ef = stitch_ef or max(64, 2 * stitch_k)
    times = stage_times if stage_times is not None else {}
    for stage in ("sub_builds", "stitch_search", "merge", "stitch_upper"):
        times.setdefault(stage, 0.0)

    def lap(stage: str, t0: float) -> float:
        # every stage ends with its results copied to the host
        t1 = time.perf_counter()
        times[stage] += t1 - t0
        return t1

    # ------------------------------------------------------------ partition
    t0 = time.perf_counter()
    shard_of = np.arange(n) % n_shards           # uniform sample per shard
    sub_graphs: List[HNSWGraph] = []
    for s in range(n_shards):
        idx = np.flatnonzero(shard_of == s)
        logger.info("building shard %d/%d (%d nodes)", s + 1, n_shards,
                    idx.size)
        # sub keys = ORIGINAL row indices, so local ids map back exactly
        sub_graphs.append(build(
            packed[idx], keys=idx.astype(np.int64), connectivity=m,
            expansion_add=expansion_add, ndim=ndim,
            seed=seed * 1_000_003 + s, **(builder_kwargs or {})))
    t0 = lap("sub_builds", t0)

    # -------------------------------------------------------------- merge
    levels_orig = np.empty(n, np.int32)
    for g in sub_graphs:
        levels_orig[np.asarray(g.keys)] = np.asarray(g.levels)
    order = np.lexsort((np.arange(n), -levels_orig))
    gid_of_orig = np.empty(n, np.int64)
    gid_of_orig[order] = np.arange(n)
    g_packed = packed[order]
    g_pops = popcount_rows_np(g_packed)
    g_levels = levels_orig[order]
    g_shard = shard_of[order]
    max_level = int(g_levels[0]) if n else 0
    layer_sizes = [int((g_levels >= l).sum()) for l in range(max_level + 1)]

    tables: List[np.ndarray] = [
        np.full((layer_sizes[l], 2 * m if l == 0 else m), -1, np.int32)
        for l in range(max_level + 1)
    ]
    sub_gids: List[np.ndarray] = []              # local id -> global id
    for g in sub_graphs:
        l2g = gid_of_orig[np.asarray(g.keys)]
        sub_gids.append(l2g)
        for l, t in enumerate(g.neighbors):
            t = np.asarray(t)
            mapped = np.where(t >= 0,
                              l2g[np.maximum(t, 0).astype(np.int64)],
                              -1).astype(np.int32)
            # table width can exceed the sub table's (never narrower)
            tables[l][l2g[:t.shape[0]], : t.shape[1]] = mapped

    # -------------------------------------------------------------- stitch
    # layer 0: per shard pair (s queries t), batched sub-graph searches
    from rad_tpu_torch.search.knn import search_device

    e_src: List[np.ndarray] = []
    e_dst: List[np.ndarray] = []
    e_d: List[np.ndarray] = []
    for t, g_t in enumerate(sub_graphs):
        k_t = min(stitch_k, len(g_t))
        if k_t == 0:
            continue
        l2g_t = sub_gids[t]
        for s in range(n_shards):
            if s == t:
                continue
            q_orig = np.flatnonzero(shard_of == s)
            # a query's result does not depend on its chunk: fewer queries
            # than a chunk run unpadded
            d_st, i_st = search_device(
                g_t, packed[q_orig], k=k_t,
                expansion_search=max(stitch_ef, k_t),
                chunk_size=min(search_chunk, q_orig.size), device=device)
            d_st = d_st.cpu().numpy()
            i_st = i_st.cpu().numpy()
            valid = i_st >= 0
            e_src.append(np.broadcast_to(
                gid_of_orig[q_orig][:, None], i_st.shape)[valid])
            e_dst.append(l2g_t[np.maximum(i_st, 0).astype(np.int64)][valid])
            e_d.append(d_st[valid])
    t0 = lap("stitch_search", t0)
    if e_src:
        tables[0] = _merge_edges_into_layer(
            tables[0], g_packed, g_pops,
            np.concatenate(e_src), np.concatenate(e_dst),
            np.concatenate(e_d), heuristic, device=device)
    t0 = lap("merge", t0)

    # layers >= 1: exact cross-shard k-NN among the (small) layer members
    from rad_tpu_torch.fp.tanimoto import bruteforce_topk_blocked

    for l in range(1, max_level + 1):
        n_l = layer_sizes[l]
        members = np.arange(n_l)
        e_src, e_dst, e_d = [], [], []
        for t in range(n_shards):
            mem_t = members[g_shard[:n_l] == t]
            if mem_t.size == 0:
                continue
            k_t = min(stitch_k, mem_t.size)
            q_mem = members[g_shard[:n_l] != t]
            if q_mem.size == 0:
                continue
            d_qt, j_qt = bruteforce_topk_blocked(
                to_torch_packed(g_packed[q_mem], device),
                to_torch_packed(g_packed[mem_t], device), k_t)
            d_qt = d_qt.cpu().numpy()
            j_qt = j_qt.cpu().numpy()
            valid = np.isfinite(d_qt)
            e_src.append(np.broadcast_to(q_mem[:, None], j_qt.shape)[valid])
            e_dst.append(mem_t[np.maximum(j_qt, 0).astype(np.int64)][valid])
            e_d.append(d_qt[valid])
        t0 = lap("stitch_upper", t0)
        if e_src:
            tables[l] = _merge_edges_into_layer(
                tables[l], g_packed, g_pops,
                np.concatenate(e_src), np.concatenate(e_dst),
                np.concatenate(e_d), heuristic, device=device)
        t0 = lap("merge", t0)

    return HNSWGraph(
        packed=g_packed,
        popcounts=g_pops,
        keys=keys[order],
        levels=g_levels,
        neighbors=tuple(tables),
        ndim=ndim,
        connectivity=m,
    )
