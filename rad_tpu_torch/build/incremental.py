"""True incremental insertion into a built HNSW graph (usearch ``add``).

The port of :mod:`rad_tpu.build.incremental`, edge-identical to it. Node
ids are level-sorted, so appending nodes renumbers: the new nodes' ids
interleave with the old ones'. The insert then costs O(K): each new node
runs the batched builder's greedy descent, beam, heuristic selection and
reverse links (:func:`rad_tpu_torch.build.device._insert_batch`) against
the existing graph, instead of the O(N + K) rebuild of
``HNSWIndex.add``.

Adjacency rows only ever reference inserted nodes (rows not yet inserted
are all ``-1``, and nothing links to them before their own reverse links),
so the beam's prefix mask becomes ``id < batch start OR is_old[id]``.

New levels come from the same geometric distribution, clamped to the
graph's ``max_level``: a node above the hierarchy would displace the entry
point with an edge-less node. That clamp is the documented difference from
a from-scratch build.
"""

from __future__ import annotations

import logging
import math

import numpy as np
import torch

from rad_tpu_torch.build.device import _insert_batch, _padded_tables
from rad_tpu_torch.build.reference import sample_levels
from rad_tpu_torch.devices import resolve_device
from rad_tpu_torch.fp.pack import popcount_rows_np
from rad_tpu_torch.graph.storage import HNSWGraph

logger = logging.getLogger(__name__)

__all__ = ["insert_into_graph"]


def insert_into_graph(
    graph: HNSWGraph,
    new_packed: np.ndarray,
    new_keys: np.ndarray | None = None,
    expansion_add: int = 200,
    seed: int = 0,
    batch_size: int = 128,
    heuristic_k: int | None = None,
    stitch: bool = True,
    device=None,
) -> HNSWGraph:
    """Insert ``new_packed`` rows into a built graph on ``device``,
    returning a NEW graph: ids are renumbered to keep the level-sorted
    invariant, keys are stable (the usearch identity model).

    Cost is O(K) insert work plus an O(N + K) renumber and copy of the
    stored arrays; existing nodes are relinked only where reverse links
    attach the newcomers.
    """
    device = resolve_device(device)
    m = graph.connectivity
    n = len(graph)
    new_packed = np.ascontiguousarray(np.atleast_2d(new_packed),
                                      dtype=np.uint32)
    k = new_packed.shape[0]
    if new_packed.shape[1] != np.asarray(graph.packed).shape[1]:
        raise ValueError("fingerprint width mismatch")
    if new_keys is None:
        start = int(np.asarray(graph.keys).max()) + 1 if n else 0
        new_keys = np.arange(start, start + k, dtype=np.int64)
    new_keys = np.asarray(new_keys, dtype=np.int64)
    if new_keys.shape[0] != k:
        raise ValueError(
            f"new_keys has {new_keys.shape[0]} entries for {k} "
            f"fingerprints (mismatched lengths would silently drop or "
            f"misattribute keys)")
    if np.intersect1d(new_keys, np.asarray(graph.keys)).size:
        raise ValueError("duplicate keys (multi-key indexes unsupported)")
    heuristic_k = heuristic_k or max(4 * m, 32)
    ef = max(expansion_add, 2 * m)

    old_levels = np.asarray(graph.levels)
    new_levels = np.minimum(sample_levels(k, m, seed),
                            max(graph.max_level, 0)).astype(np.int32)

    # ------------------------------------------------- renumber (interleave)
    levels_all = np.concatenate([old_levels, new_levels])
    is_new_in = np.concatenate([np.zeros(n, np.int8), np.ones(k, np.int8)])
    order = np.lexsort((np.arange(n + k), is_new_in, -levels_all))
    inv = np.empty(n + k, np.int64)
    inv[order] = np.arange(n + k)

    packed_all = np.concatenate(
        [np.asarray(graph.packed), new_packed])[order]
    keys_all = np.concatenate([np.asarray(graph.keys), new_keys])[order]
    levels_sorted = levels_all[order]
    is_old_sorted = is_new_in[order] == 0
    max_level = int(levels_sorted[0]) if n + k else 0
    layer_sizes = [int((levels_sorted >= l).sum())
                   for l in range(max_level + 1)]

    old_to_new = inv[:n]
    tables = []
    for l, t in enumerate(graph.neighbors):
        t = np.asarray(t)
        tab = np.full((layer_sizes[l], t.shape[1]), -1, np.int32)
        mapped = np.where(t >= 0, old_to_new[np.maximum(t, 0)],
                          -1).astype(np.int32)
        tab[old_to_new[:t.shape[0]]] = mapped
        tables.append(tab)

    # ------------------------------------------------------------- insert
    pops_all = popcount_rows_np(packed_all)
    packed_t = torch.from_numpy(packed_all.view(np.int32)).to(device)
    pops_t = torch.from_numpy(pops_all).to(device)
    levels_t = torch.from_numpy(levels_sorted).to(device)
    is_old_t = torch.from_numpy(is_old_sorted).to(device)
    layers = _padded_tables(tables, device)

    new_gids = np.sort(inv[n:]).astype(np.int32)
    for bi in range(math.ceil(k / batch_size)):
        chunk = new_gids[bi * batch_size:(bi + 1) * batch_size]
        batch_ids = torch.from_numpy(np.concatenate(
            [chunk, np.full(batch_size - chunk.shape[0], -1, np.int32)])
        ).to(device)
        active = batch_ids >= 0
        safe_ids = torch.clamp(batch_ids, min=0)
        _insert_batch(layers, packed_t, pops_t, safe_ids, active,
                      levels_t[safe_ids.long()],
                      torch.full_like(batch_ids, int(chunk[0])), m, ef,
                      heuristic_k, stitch, extra_visible=is_old_t)

    return HNSWGraph(
        packed=packed_all,
        popcounts=pops_all,
        keys=keys_all,
        levels=levels_sorted,
        neighbors=tuple(t[:-1].cpu().numpy() for t in layers),
        ndim=graph.ndim,
        connectivity=m,
    )
