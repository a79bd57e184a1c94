"""Batched HNSW k-NN search (greedy descent + layer-0 beam), plain torch.

The port of :mod:`rad_tpu.search.knn`: B queries run in lockstep as one
batch, each performing the standard HNSW query — greedy routing through
the upper layers, then an ``expansion_search``-wide beam on layer 0 that
expands ``expand_width`` (E) entries per iteration. The reference's
``vmap`` of ``while_loop`` is a batch dimension and a host loop here: a
query whose loop condition is false keeps its state while the others run
on, and the loop stops when no query has work left (one synchronisation
per iteration).

Beam state per query: ``(beam_d [ef], beam_id [ef], expanded [ef])`` plus
a visited set — a dense ``[B, N]`` map while it fits
:data:`~rad_tpu_torch.search.visited.DENSE_VISITED_BUDGET`, else the
bounded id hash table of :mod:`rad_tpu_torch.search.visited`.

Tie rules: every ``lax.top_k`` is a stable ascending sort (ties keep the
smaller index), and so is the beam merge. The reference sorts the merge
with the unstable ``lax.sort``, so among equal distances its beam order
is XLA's, not necessarily this one.
"""

from __future__ import annotations

import numpy as np
import torch

from rad_tpu_torch.devices import resolve_device
from rad_tpu_torch.fp.pack import popcount, popcount_rows
from rad_tpu_torch.fp.tanimoto import similarity_from_counts
from rad_tpu_torch.graph.storage import HNSWGraph
from rad_tpu_torch.search.visited import (hashset_check_insert_batch,
                                          hashset_init, use_dense_visited,
                                          visited_capacity_for)
from rad_tpu_torch.traverse.device import (adjacency_rows,
                                           prepare_device_graph)

__all__ = ["search_device"]

INF = float("inf")


def _query_dist(q, q_pop, packed, pops, ids, valid):
    """``[B, K]`` Tanimoto distances from query ``q[b]`` to rows
    ``ids[b]`` (+inf where not ``valid``)."""
    safe = torch.clamp(ids, min=0).long()
    inter = popcount(packed[safe] & q[:, None, :]).sum(-1)
    union = q_pop[:, None] + pops[safe] - inter
    d = 1.0 - similarity_from_counts(inter, union)
    return torch.where(valid, d, INF)


def _first_min(d):
    """Index of the first minimum along the last axis (``argmin``)."""
    pos = torch.arange(d.shape[-1], device=d.device)
    at_min = d == d.amin(-1, keepdim=True)
    return torch.where(at_min, pos, d.shape[-1]).amin(-1)


def _search_batch(packed, pops, dg, queries, k: int, ef: int,
                  expand_width: int, visited_capacity: int | None):
    """One batch of the search → ``(dists [B, k], node_ids [B, k])``."""
    dev = packed.device
    n = packed.shape[0]
    b = queries.shape[0]
    m0 = dg.m0
    e = min(expand_width, ef)
    offsets = dg.offsets_host
    dense = visited_capacity is None and use_dense_visited(b, n)
    if visited_capacity is None:
        visited_capacity = visited_capacity_for(ef, m0, n)
    # tie-churn safety net of the reference (a normal search converges in
    # about a few times ef / E iterations)
    max_iters = (16 * ef) // max(e, 1) + 256
    q_pop = popcount_rows(queries)
    bidx = torch.arange(b, device=dev)

    # ---- greedy descent through layers max_level..1 ----------------------
    ep = torch.zeros(b, dtype=torch.int64, device=dev)
    d_ep = _query_dist(queries, q_pop, packed, pops, ep[:, None],
                       torch.ones((b, 1), dtype=torch.bool, device=dev))[:, 0]
    for l in range(dg.max_level, 0, -1):
        # a query that did not improve recomputes the same step, so the
        # batch may run until none improves
        while True:
            row = adjacency_rows(dg, int(offsets[l]) + ep)   # [B, M0]
            d_n = _query_dist(queries, q_pop, packed, pops, row, row >= 0)
            j = _first_min(d_n)
            best = d_n[bidx, j]
            better = best < d_ep
            ep = torch.where(better, row[bidx, j].long(), ep)
            d_ep = torch.where(better, best, d_ep)
            if not bool(better.any()):
                break

    # ---- layer-0 beam ----------------------------------------------------
    beam_d = torch.full((b, ef), INF, device=dev)
    beam_d[:, 0] = d_ep
    beam_id = torch.full((b, ef), -1, dtype=torch.int32, device=dev)
    beam_id[:, 0] = ep.to(torch.int32)
    expanded = torch.zeros((b, ef), dtype=torch.bool, device=dev)
    if dense:
        # one sentinel column takes the dropped writes
        visited = torch.zeros((b, n + 1), dtype=torch.bool, device=dev)
        visited[bidx, ep] = True
    else:
        visited, _ = hashset_check_insert_batch(
            hashset_init(visited_capacity, b, dev), ep[:, None].int(),
            torch.ones((b, 1), dtype=torch.bool, device=dev))
    it = torch.zeros(b, dtype=torch.int32, device=dev)

    while True:
        active = ((~expanded & torch.isfinite(beam_d)).any(1)
                  & (it < max_iters))
        if not bool(active.any()):
            break
        # the E best unexpanded entries (top_k: ties to the smaller slot)
        key = beam_d.masked_fill(expanded, INF)
        key_s, sel = torch.sort(key, dim=1, stable=True)
        key_s, sel = key_s[:, :e], sel[:, :e]
        has_work = torch.isfinite(key_s) & active[:, None]
        # sel holds distinct slots of each row: a deterministic scatter
        exp_new = expanded.clone().scatter_(
            1, sel, has_work | expanded.gather(1, sel))
        u = torch.clamp(beam_id.gather(1, sel), min=0).long()
        rows = adjacency_rows(dg, u).reshape(b, e * m0)      # [B, E*M0]
        valid = (rows >= 0) & has_work.repeat_interleave(m0, dim=1)
        if dense:
            seen = visited.gather(1, torch.clamp(rows, min=0).long())
            valid = valid & ~seen
        else:
            # beam membership: exact duplicate prevention independent of
            # the capacity-bounded table
            in_beam = (rows[:, :, None] == beam_id[:, None, :]).any(-1)
            valid = valid & ~in_beam
        # intra-wave dedup: keep the first occurrence of each id
        wkey = torch.where(valid, rows, n).long()
        sk, perm = torch.sort(wkey, dim=1, stable=True)
        prev = torch.cat([torch.full((b, 1), -1, dtype=sk.dtype,
                                     device=dev), sk[:, :-1]], 1)
        first = torch.zeros_like(valid)
        first.scatter_(1, perm, (sk != prev) & (sk < n))
        valid = valid & first
        if dense:
            visited.scatter_(1, torch.where(valid, rows, n).long(),
                             torch.ones_like(valid))
        else:
            visited, seen = hashset_check_insert_batch(visited, rows, valid)
            valid = valid & ~seen
        d_n = _query_dist(queries, q_pop, packed, pops, rows, valid)
        new_ids = torch.where(valid, rows, -1)
        all_d = torch.cat([beam_d, d_n], 1)
        sd, order = torch.sort(all_d, dim=1, stable=True)
        order = order[:, :ef]
        all_id = torch.cat([beam_id, new_ids], 1)
        all_e = torch.cat([exp_new, torch.zeros_like(valid)], 1)
        keep = active[:, None]
        beam_d = torch.where(keep, sd[:, :ef], beam_d)
        beam_id = torch.where(keep, all_id.gather(1, order), beam_id)
        expanded = torch.where(keep, all_e.gather(1, order), expanded)
        it = it + active.int()
    return beam_d[:, :k], beam_id[:, :k]


def _prep(graph: HNSWGraph, device, packed_adjacency: bool | int = False):
    """Per-graph device arrays (adjacency, fingerprints, popcounts),
    cached on the graph object per device and adjacency layout."""
    cache = graph.__dict__.setdefault("_search_prep", {})
    key = (str(torch.device(device)), packed_adjacency)
    if key not in cache:
        dg = prepare_device_graph(graph, device,
                                  packed_adjacency=packed_adjacency)
        packed = torch.from_numpy(np.ascontiguousarray(
            np.asarray(graph.packed, np.uint32)).view(np.int32)).to(device)
        pops = torch.from_numpy(np.asarray(graph.popcounts).astype(
            np.int32)).to(device)
        cache[key] = (dg, packed, pops)
    return cache[key]


def search_device(
    graph: HNSWGraph,
    queries: np.ndarray,
    k: int = 10,
    expansion_search: int = 64,
    expand_width: int = 4,
    chunk_size: int | None = None,
    visited_capacity: int | None = None,
    prefix_filter: int | None = None,
    prefix_keep: int | None = None,
    packed_adjacency: bool | int = False,
    device=None,
):
    """Search a built graph on ``device``: ``(dists [B, k], node_ids [B,
    k])`` torch tensors, ascending, +inf/−1 padded.

    Query batches larger than ``chunk_size`` (default ``min(B, 4096)``)
    run in equal chunks (the last padded with copies of the last query),
    which bounds the B·H visited tables. ``visited_capacity`` forces the
    hash table at that size. ``packed_adjacency=True`` (or a field
    width) searches over the bit-packed neighbor table
    (:mod:`rad_tpu_torch.graph.adjpack`): the same results from
    ``bits / 32`` of the adjacency memory. ``prefix_filter``/
    ``prefix_keep`` are not ported.
    """
    if prefix_filter or prefix_keep:
        raise NotImplementedError(
            "prefix_filter/prefix_keep: the two-stage prefix screen is not "
            "ported (ROADMAP Queue 1 item 8)")
    device = resolve_device(device)
    dg, packed, pops = _prep(graph, device, packed_adjacency)
    queries = np.atleast_2d(np.asarray(queries, np.uint32))
    q_all = torch.from_numpy(np.ascontiguousarray(queries).view(
        np.int32)).to(device)
    ef = max(expansion_search, k)
    b = q_all.shape[0]
    if chunk_size is None:
        chunk_size = max(1, min(b, 4096))
    pad = (-b) % chunk_size
    if pad:
        q_all = torch.cat([q_all, q_all[-1:].expand(pad, -1)])
    outs = [_search_batch(packed, pops, dg, q_all[lo:lo + chunk_size], k, ef,
                          expand_width, visited_capacity)
            for lo in range(0, q_all.shape[0], chunk_size)]
    d = torch.cat([o[0] for o in outs])[:b]
    i = torch.cat([o[1] for o in outs])[:b]
    return d, i
