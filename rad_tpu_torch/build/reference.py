"""The host (numpy) HNSW builder and search, and the level sampling
shared by the builders.

A copy of :mod:`rad_tpu.build.reference`, kept edge-identical to it (the
``heapq`` tie order included): the standard HNSW construction (Malkov &
Yashunin, 2016) with usearch's parameters ``connectivity`` (M; layer 0
gets 2M slots) and ``expansion_add`` (the construction beam), over packed
Tanimoto popcounts. Node levels are sampled for the whole library up
front and ids are assigned in descending-level order, so layer ``l`` is
the id range ``[0, N_l)`` (see :mod:`rad_tpu_torch.graph.storage`).

These builders run on the host by definition; the graph they return is
searched and traversed on whatever device its caller names.
:func:`search_hnsw` is the host oracle of
:func:`rad_tpu_torch.search.knn.search_device`.
"""

from __future__ import annotations

import heapq
import math
from typing import List, Sequence

import numpy as np

from rad_tpu_torch.fp.pack import popcount_rows_np
from rad_tpu_torch.graph.storage import HNSWGraph

__all__ = ["build_hnsw", "search_hnsw", "sample_levels",
           "select_neighbors_heuristic"]


def sample_levels(n: int, connectivity: int, seed: int = 0) -> np.ndarray:
    """Geometric level sampling with multiplier 1/ln(M) (HNSW paper).

    Draws exactly what ``rad_tpu.build.reference.sample_levels`` draws for
    equal arguments — the graphs of the two packages can only match if
    their levels do."""
    rng = np.random.default_rng(seed)
    mult = 1.0 / math.log(max(connectivity, 2))
    u = rng.random(n)
    return np.floor(-np.log(np.clip(u, 1e-300, 1.0)) * mult).astype(np.int32)


# candidate rows of one distance block of the heuristic (256 rows against
# 256 candidates of 1024 bits is a 32 MiB intermediate)
_PAIRWISE_ROWS = 256


def _popcount_words(x: np.ndarray) -> np.ndarray:
    if hasattr(np, "bitwise_count"):
        return np.bitwise_count(x)
    lut = np.array([bin(i).count("1") for i in range(256)], dtype=np.uint8)
    return lut[x.view(np.uint8)].reshape(*x.shape, 4).sum(-1)


class _TanimotoDist:
    """Vectorized one-vs-many (and many-vs-many) Tanimoto over packed
    rows. The reference also counts the distances it computes; nothing
    reads that count, and the heuristic here computes them in blocks, so
    the port keeps none."""

    def __init__(self, packed: np.ndarray):
        self.packed = packed
        self.pops = popcount_rows_np(packed).astype(np.int64)

    def __call__(self, q: int, ids: np.ndarray) -> np.ndarray:
        return self.pairwise([q], ids)[0]

    def pairwise(self, rows, cols) -> np.ndarray:
        """``[len(rows), len(cols)]`` distances: entry ``(a, b)`` has the
        bits of ``self(rows[a], [cols[b]])[0]``."""
        rows = np.asarray(rows, dtype=np.int64)
        cols = np.asarray(cols, dtype=np.int64)
        inter = _popcount_words(
            self.packed[rows][:, None, :] & self.packed[cols][None, :, :]
        ).sum(-1, dtype=np.int64)
        union = self.pops[rows][:, None] + self.pops[cols][None, :] - inter
        # the denominator is at least 1: no divide needs guarding
        sim = np.where(union > 0, inter / np.maximum(union, 1), 1.0)
        return (1.0 - sim).astype(np.float32)


def select_neighbors_heuristic(
    dist_fn,
    q: int,
    candidates: List[tuple],
    m: int,
    keep_pruned: bool = True,
) -> List[int]:
    """HNSW neighbor-selection heuristic (Algorithm 4 of the paper).

    Keeps candidate ``c`` only if it is closer to ``q`` than to every
    already-selected neighbor (diversity pruning); optionally backfills with
    pruned candidates to reach ``m``. With a :class:`_TanimotoDist` the
    candidate-to-selected distances come from blocks of
    :data:`_PAIRWISE_ROWS` candidates against the candidates before them,
    made as the scan reaches each block (the values of a call each); any
    other ``dist_fn`` is called once a candidate.
    """
    cand = sorted(candidates)
    ids = [c for _, c in cand]
    blocked = isinstance(dist_fn, _TanimotoDist)
    block, block0 = [], 0
    selected: List[int] = []
    sel_pos: List[int] = []
    pruned: List[int] = []
    for j, (d_cq, c) in enumerate(cand):
        if len(selected) >= m:
            break
        if not selected:
            selected.append(c)
            sel_pos.append(j)
            continue
        if blocked:
            if j >= block0 + len(block):
                # Python floats of f32 values compare as the f32 values do
                end = min(j + _PAIRWISE_ROWS, len(cand))
                block = dist_fn.pairwise(ids[j:end], ids[:end]).tolist()
                block0 = j
            row = block[j - block0]
            closer = all(d_cq < row[p] for p in sel_pos)
        else:
            closer = bool((d_cq < dist_fn(c, np.array(selected))).all())
        if closer:
            selected.append(c)
            sel_pos.append(j)
        else:
            pruned.append(c)
    if keep_pruned:
        for c in pruned:
            if len(selected) >= m:
                break
            selected.append(c)
    return selected


def _search_layer(
    dist_fn, q: int, entry_points: Sequence[tuple], ef: int,
    neighbors_l: np.ndarray, visited: set,
) -> List[tuple]:
    """Best-first beam search on one layer (Algorithm 2 of the paper).

    ``entry_points``: iterable of ``(dist, id)``. Returns up to ``ef``
    ``(dist, id)`` results, ascending by distance.
    """
    cand: List[tuple] = []   # min-heap by dist
    result: List[tuple] = []  # max-heap via negated dist
    for d, e in entry_points:
        if e in visited:
            continue
        visited.add(e)
        heapq.heappush(cand, (d, e))
        heapq.heappush(result, (-d, e))
    while cand:
        d_c, c = heapq.heappop(cand)
        if result and d_c > -result[0][0] and len(result) >= ef:
            break
        row = neighbors_l[c]
        nbrs = row[row >= 0]
        new = np.array([x for x in nbrs.tolist() if x not in visited],
                       dtype=np.int64)
        if new.size == 0:
            continue
        visited.update(new.tolist())
        dists = dist_fn(q, new)
        worst = -result[0][0] if result else np.inf
        for d_n, nid in zip(dists.tolist(), new.tolist()):
            if len(result) < ef or d_n < worst:
                heapq.heappush(cand, (d_n, nid))
                heapq.heappush(result, (-d_n, nid))
                if len(result) > ef:
                    heapq.heappop(result)
                worst = -result[0][0]
    out = sorted((-nd, i) for nd, i in result)
    return out


def build_hnsw(
    packed: np.ndarray,
    keys: np.ndarray | None = None,
    connectivity: int = 16,
    expansion_add: int = 200,
    ndim: int | None = None,
    seed: int = 0,
    extend_candidates: bool = False,
) -> HNSWGraph:
    """Build an HNSW graph over packed fingerprints (host, exact semantics).

    Parameters are usearch's: ``connectivity`` = M, ``expansion_add`` =
    efC.
    ``keys`` are the user keys (default: 0..N-1 before level-sorting —
    i.e. key == original row index of ``packed``).

    ``extend_candidates`` enables the HNSW paper's Algorithm-4 candidate
    extension: before neighbor selection, the beam's candidate set is
    augmented with the candidates' own neighbors (re-scored against the
    inserted node). Helps link quality in low-margin regimes (uniform
    random bits, where distances concentrate);
    off by default to match usearch behavior.
    """
    packed = np.ascontiguousarray(packed, dtype=np.uint32)
    n, w = packed.shape
    ndim = ndim or w * 32
    m = connectivity
    m0 = 2 * m
    if keys is None:
        keys = np.arange(n, dtype=np.int64)
    keys = np.asarray(keys, dtype=np.int64)

    levels_raw = sample_levels(n, m, seed)
    # Descending-level id assignment (stable within a level for determinism).
    order = np.lexsort((np.arange(n), -levels_raw))
    packed = packed[order]
    keys = keys[order]
    levels = levels_raw[order]
    max_level = int(levels[0]) if n else 0
    layer_sizes = [int((levels >= l).sum()) for l in range(max_level + 1)]

    dist = _TanimotoDist(packed)
    neighbors = [
        np.full((layer_sizes[l], m0 if l == 0 else m), -1, dtype=np.int32)
        for l in range(max_level + 1)
    ]

    def _link(l: int, a: int, bs: List[int]):
        row = neighbors[l][a]
        row[:] = -1
        row[: len(bs)] = bs

    def _add_reverse(l: int, b: int, a: int):
        """Add edge b→a, re-pruning with the heuristic on overflow."""
        row = neighbors[l][b]
        cap = row.shape[0]
        cur = row[row >= 0]
        if a in cur:
            return
        if cur.size < cap:
            row[cur.size] = a
            return
        cand_ids = np.concatenate([cur, [a]])
        cand_d = dist(b, cand_ids)
        cand = list(zip(cand_d.tolist(), cand_ids.tolist()))
        sel = select_neighbors_heuristic(dist, b, cand, cap)
        _link(l, b, sel)

    for i in range(1, n):
        l_i = int(levels[i])
        ep = 0
        d_ep = float(dist(i, np.array([ep]))[0])
        # Greedy descent through layers above the node's level.
        for lc in range(max_level, l_i, -1):
            improved = True
            while improved:
                improved = False
                row = neighbors[lc][ep]
                nbrs = row[(row >= 0) & (row < i)]
                if nbrs.size == 0:
                    break
                ds = dist(i, nbrs)
                j = int(np.argmin(ds))
                if ds[j] < d_ep:
                    d_ep = float(ds[j])
                    ep = int(nbrs[j])
                    improved = True
        # Beam search + link on each layer from min(l_i, max) down to 0.
        eps = [(d_ep, ep)]
        for lc in range(min(l_i, max_level), -1, -1):
            visited = {i}
            # Only already-inserted nodes are reachable: the adjacency rows of
            # nodes > i are still all -1, so no masking is needed.
            found = _search_layer(dist, i, eps, expansion_add,
                                  neighbors[lc], visited)
            cap = m0 if lc == 0 else m
            cand = found
            if extend_candidates and found:
                seen = {c for _, c in found} | {i}
                ext_ids = []
                for _, c in found:
                    row = neighbors[lc][c]
                    for nb in row[row >= 0].tolist():
                        if nb not in seen:
                            seen.add(nb)
                            ext_ids.append(nb)
                if ext_ids:
                    ext_ids = np.asarray(ext_ids, dtype=np.int64)
                    ext_d = dist(i, ext_ids)
                    cand = sorted(found + list(zip(ext_d.tolist(),
                                                   ext_ids.tolist())))
            sel = select_neighbors_heuristic(dist, i, cand, cap)
            _link(lc, i, sel)
            for b in sel:
                _add_reverse(lc, b, i)
            eps = found if found else eps

    return HNSWGraph(
        packed=packed,
        popcounts=popcount_rows_np(packed),
        keys=keys,
        levels=levels,
        neighbors=tuple(neighbors),
        ndim=ndim,
        connectivity=m,
    )


def search_hnsw(
    graph: HNSWGraph,
    query_packed: np.ndarray,
    k: int = 10,
    expansion_search: int = 64,
) -> tuple:
    """Host kNN search over a built graph (greedy descent + layer-0 beam).

    Returns ``(dists [B, k], ids [B, k])`` with ``-1``/``inf`` padding when
    fewer than ``k`` reachable. Oracle for the jitted device search.
    """
    query_packed = np.atleast_2d(np.asarray(query_packed, dtype=np.uint32))
    n = len(graph)
    packed = np.asarray(graph.packed)
    pops = popcount_rows_np(packed).astype(np.int64)
    neighbors = [np.asarray(t) for t in graph.neighbors]
    b = query_packed.shape[0]
    out_d = np.full((b, k), np.inf, dtype=np.float32)
    out_i = np.full((b, k), -1, dtype=np.int64)
    q_pops = popcount_rows_np(query_packed).astype(np.int64)

    for qi in range(b):
        qrow = query_packed[qi]

        def qdist(ids: np.ndarray) -> np.ndarray:
            ids = np.asarray(ids, dtype=np.int64)
            inter = _popcount_words(qrow[None, :] & packed[ids]).sum(
                -1, dtype=np.int64)
            union = q_pops[qi] + pops[ids] - inter
            with np.errstate(divide="ignore", invalid="ignore"):
                sim = np.where(union > 0, inter / np.maximum(union, 1), 1.0)
            return (1.0 - sim).astype(np.float32)

        ep, d_ep = 0, float(qdist(np.array([0]))[0])
        for lc in range(graph.max_level, 0, -1):
            improved = True
            while improved:
                improved = False
                row = neighbors[lc][ep]
                nbrs = row[row >= 0]
                if nbrs.size == 0:
                    break
                ds = qdist(nbrs)
                j = int(np.argmin(ds))
                if ds[j] < d_ep:
                    d_ep, ep = float(ds[j]), int(nbrs[j])
                    improved = True
        # layer-0 beam (reuses _search_layer with a query-distance adapter)
        visited = {ep}
        cand = [(d_ep, ep)]
        result = [(-d_ep, ep)]
        ef = max(expansion_search, k)
        while cand:
            d_c, c = heapq.heappop(cand)
            if result and d_c > -result[0][0] and len(result) >= ef:
                break
            row = neighbors[0][c]
            nbrs = row[row >= 0]
            new = np.array([x for x in nbrs.tolist() if x not in visited],
                           dtype=np.int64)
            if new.size == 0:
                continue
            visited.update(new.tolist())
            ds = qdist(new)
            worst = -result[0][0] if result else np.inf
            for d_n, nid in zip(ds.tolist(), new.tolist()):
                if len(result) < ef or d_n < worst:
                    heapq.heappush(cand, (d_n, nid))
                    heapq.heappush(result, (-d_n, nid))
                    if len(result) > ef:
                        heapq.heappop(result)
                    worst = -result[0][0]
        top = sorted((-nd, i) for nd, i in result)[:k]
        for j, (d, i) in enumerate(top):
            out_d[qi, j] = d
            out_i[qi, j] = i
    return out_d, out_i
