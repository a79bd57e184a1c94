"""Batched HNSW construction on one device: the beam insert, plain torch.

The port of :mod:`rad_tpu.build.device`, edge-identical to it. Levels are
sampled for the whole library up front and nodes ordered level-descending,
so the build is one sweep of batched insertions against a growing prefix:

1. all B nodes of a batch run the greedy descent and a per-layer beam of
   ``expansion_add`` against the built prefix (ids at or past the batch's
   first are invisible) — :func:`_beam_search_batch`;
2. the vectorized diversity heuristic with backfill picks each node's
   links — :func:`_select_neighbors` (Algorithm 4 of the HNSW paper);
3. reverse links are a sorted segment merge: the batch's (target ← new)
   edges sorted by (target, distance), each target row rewritten as the
   distance-best ``cap`` of its existing links and its entrants —
   :func:`_apply_reverse_links`;
4. a layer-0 stitch merges each node's nearest peers of its own batch into
   its row — :func:`_stitch_batch`.

The reference's ``while_loop`` bodies are host loops here that read their
condition once an iteration (one synchronisation); rows whose condition is
false go on running as no-ops, as in a batched ``while_loop``. Every sort
is a stable ``torch.sort`` (``lax.sort`` keeps ties in input order on the
CPU, and ``lax.top_k`` ties to the lower index).

Padded tables: every adjacency table the insert primitives write carries
one trailing sentinel row (index ``N_l``), and the dense visited map one
trailing sentinel column (index ``N``). The reference's ``mode="drop"``
scatters send inactive rows past the end; here they land in the sentinel,
which is never read, so no write goes out of bounds and none needs a
host-side mask. The logical table is ``t[:-1]``.
"""

from __future__ import annotations

import logging
import math

import numpy as np
import torch

from rad_tpu_torch.build.reference import sample_levels
from rad_tpu_torch.devices import resolve_device
from rad_tpu_torch.fp.kernels import exact_fp32_matmul, unpack_bitmajor
from rad_tpu_torch.fp.pack import popcount, popcount_rows_np
from rad_tpu_torch.fp.tanimoto import similarity_from_counts
from rad_tpu_torch.graph.storage import HNSWGraph
from rad_tpu_torch.search.visited import (hashset_check_insert_batch,
                                          hashset_init, use_dense_visited,
                                          visited_capacity_for)

logger = logging.getLogger(__name__)

__all__ = ["build_hnsw_device"]

INF = float("inf")


def _dist_rows(packed, pops, q_ids, cand_ids, valid):
    """Tanimoto distance between node ``q_ids[b]`` and ``cand_ids[b, :]``.

    q_ids: [B], cand_ids: [B, K], valid: [B, K] → [B, K] f32, +inf where
    not ``valid``."""
    q = packed[q_ids.long()]                              # [B, W]
    safe = torch.clamp(cand_ids, min=0).long()
    c = packed[safe]                                      # [B, K, W]
    inter = popcount(c & q[:, None, :]).sum(-1)
    union = pops[q_ids.long()][:, None] + pops[safe] - inter
    d = 1.0 - similarity_from_counts(inter, union)
    return torch.where(valid, d, torch.full_like(d, INF))


def _sort_rows(d, *payload):
    """Stable ascending sort of ``d [B, K]`` along its rows, each payload
    ``[B, K]`` gathered the same way."""
    sd, order = torch.sort(d, dim=1, stable=True)
    return (sd, *(p.gather(1, order) for p in payload))


def _beam_search_batch(packed, pops, adj_l, q_ids, ep_ids, ep_ds,
                       prefix_limit, active, ef: int, n: int,
                       extra_visible=None):
    """Masked batched beam search at one layer over the built prefix.

    adj_l: [N_l (+ 1), M_l]; ep_ids/ep_ds: [B, S] seed candidates; active:
    [B] (inactive rows keep no seeds). Returns (beam_d, beam_id) [B, ef]
    ascending. Candidates with id >= prefix_limit (not yet inserted) are
    invisible unless ``extra_visible`` (an [>= N_l] bool tensor in node-id
    space) marks them, which is how incremental insertion exposes the
    graph it inserts into.

    The visited set is a dense [B, N + 1] map while
    :func:`~rad_tpu_torch.search.visited.use_dense_visited` allows (read at
    call time), else the bounded id hash table with a beam-membership mask;
    the iteration cap ``16 * ef + 256`` bounds tie churn, as in the
    reference."""
    b, s = ep_ids.shape
    m_l = adj_l.shape[1]
    dev = ep_ids.device
    dense = use_dense_visited(b, n)
    max_iters = 16 * ef + 256

    beam_d = torch.full((b, ef), INF, device=dev)
    beam_d[:, :s] = torch.where(active[:, None], ep_ds, INF)
    beam_id = torch.full((b, ef), -1, dtype=torch.int32, device=dev)
    beam_id[:, :s] = torch.where(active[:, None], ep_ids, -1)
    beam_d, beam_id = _sort_rows(beam_d, beam_id)
    expanded = ~torch.isfinite(beam_d)
    if dense:
        visited = torch.zeros((b, n + 1), dtype=torch.bool, device=dev)
        visited.scatter_(1, torch.where(beam_id >= 0, beam_id, n).long(),
                         True)
    else:
        visited = hashset_init(visited_capacity_for(ef, m_l, n), batch=b,
                               device=dev)
        visited, _ = hashset_check_insert_batch(visited, beam_id,
                                                beam_id >= 0)
    new_e = torch.zeros((b, m_l), dtype=torch.bool, device=dev)

    it = 0
    while it < max_iters and bool((~expanded & torch.isfinite(beam_d))
                                  .any()):
        sel = torch.where(expanded, INF, beam_d).argmin(1, keepdim=True)
        has_work = (~expanded.gather(1, sel)
                    & torch.isfinite(beam_d.gather(1, sel)))    # [B, 1]
        expanded.scatter_(1, sel, True)
        u = torch.clamp(beam_id.gather(1, sel)[:, 0], min=0).long()
        nbrs = adj_l[u]                                         # [B, M_l]
        safe = torch.clamp(nbrs, min=0).long()
        vis = nbrs < prefix_limit[:, None]
        if extra_visible is not None:
            vis = vis | extra_visible[safe]
        valid = (nbrs >= 0) & vis & has_work
        if dense:
            valid = valid & ~visited.gather(1, safe)
            visited.scatter_(1, torch.where(valid, nbrs, n).long(), True)
        else:
            in_beam = (nbrs[:, :, None] == beam_id[:, None, :]).any(2)
            valid = valid & ~in_beam
            visited, seen = hashset_check_insert_batch(visited, nbrs, valid)
            valid = valid & ~seen
        d_n = _dist_rows(packed, pops, q_ids, nbrs, valid)
        sd, si, se = _sort_rows(
            torch.cat([beam_d, d_n], 1),
            torch.cat([beam_id, torch.where(valid, nbrs, -1)], 1),
            torch.cat([expanded, new_e], 1))
        beam_d, beam_id, expanded = sd[:, :ef], si[:, :ef], se[:, :ef]
        it += 1
    return beam_d, beam_id


def _pairwise_intersections(rows: torch.Tensor) -> torch.Tensor:
    """``[B, K, W]`` packed rows → ``[B, K, K]`` exact intersection counts
    as f32, one batched fp32 matmul over unpacked 0/1 bits (exact: integer
    sums far below 2**24, TF32 off)."""
    bits = unpack_bitmajor(rows, torch.float32)           # [B, K, d]
    with exact_fp32_matmul():
        return torch.bmm(bits, bits.transpose(1, 2))


def _select_neighbors(packed, pops, q_ids, cand_d, cand_id, m: int,
                      heuristic_k: int, active, mxu_pairs: bool = False):
    """Vectorized HNSW neighbor-selection heuristic with backfill.

    cand_d/cand_id: [B, K] ascending. Returns sel_ids [B, m] (-1 padded)
    in candidate order. A candidate is kept iff it is closer to the query
    than to every kept candidate; free slots then backfill with the
    nearest pruned candidates (keepPrunedConnections).

    ``mxu_pairs`` is accepted for the reference's signature and changes
    nothing: the reference's flag swaps its SWAR popcount block for an
    int8 matmul with the same values, and the port's pairwise block is
    always one exact fp32 matmul."""
    b, k = cand_d.shape
    kh = min(heuristic_k, k)
    top_d = cand_d[:, :kh]
    top_i = cand_id[:, :kh]
    valid = torch.isfinite(top_d) & (top_i >= 0) & active[:, None]

    safe = torch.clamp(top_i, min=0).long()
    inter = _pairwise_intersections(packed[safe])         # [B, kh, kh]
    p = pops[safe].to(torch.float32)
    union = p[:, :, None] + p[:, None, :] - inter
    pair_d = 1.0 - similarity_from_counts(inter, union)

    sel_mask = torch.zeros((b, kh), dtype=torch.bool, device=cand_d.device)
    n_sel = torch.zeros((b,), dtype=torch.int32, device=cand_d.device)
    for j in range(kh):
        viol = (sel_mask & (pair_d[:, j, :] <= top_d[:, j, None])).any(dim=1)
        take = valid[:, j] & ~viol & (n_sel < m)
        sel_mask[:, j] = take
        n_sel += take
    for j in range(kh):
        take = valid[:, j] & ~sel_mask[:, j] & (n_sel < m)
        sel_mask[:, j] |= take
        n_sel += take

    # compact selected ids (in candidate order) into [B, m]
    pos = torch.arange(kh, dtype=torch.int32, device=cand_d.device)
    order_key = torch.where(sel_mask, pos[None, :], kh)
    _, order = torch.sort(order_key, dim=1, stable=True)
    ids = torch.where(sel_mask, top_i, -1).gather(1, order)
    return ids[:, :m]


def _apply_reverse_links(packed, pops, adj_l, fwd_ids, src_ids, cap: int,
                         active):
    """Distance-merge reverse edges (j ← i) into the rows of all targets.

    adj_l: [N_l + 1, cap] padded (written in place and returned); fwd_ids:
    [B, m] forward selections of src_ids [B]. Each affected row j is
    rewritten as the distance-best ``cap`` of (existing ∪ entrants); at
    most ``cap`` entrants a row are taken, in (distance, source order)."""
    b, m = fwd_ids.shape
    k = b * m
    n_l = adj_l.shape[0] - 1
    dev = fwd_ids.device

    j_flat = fwd_ids.reshape(-1)
    i_flat = torch.repeat_interleave(src_ids, m)
    ok = (j_flat >= 0) & torch.repeat_interleave(active, m)
    d_flat = _dist_rows(packed, pops, torch.clamp(i_flat, min=0),
                        torch.clamp(j_flat, min=0)[:, None],
                        ok[:, None])[:, 0]
    j_key = torch.where(ok, j_flat, n_l)      # the sentinel sorts last
    # lexicographic (j, d), ties in input order: two stable passes
    o1 = torch.sort(d_flat, stable=True)[1]
    o2 = torch.sort(j_key[o1], stable=True)[1]
    order = o1[o2]
    sj, sd, si = j_key[order], d_flat[order], i_flat[order]

    first = torch.ones_like(sj, dtype=torch.bool)
    first[1:] = sj[1:] != sj[:-1]
    first &= sj < n_l
    # entrants of the row at a first occurrence p: positions p .. p+cap-1
    # while sj still equals sj[p]
    pos = (torch.arange(k, device=dev)[:, None]
           + torch.arange(cap, device=dev)[None, :])             # [k, cap]
    pos_c = torch.clamp(pos, max=k - 1)
    ent_same = (sj[pos_c] == sj[:, None]) & (pos < k)
    ent_ids = torch.where(ent_same, si[pos_c], -1)
    ent_d = torch.where(ent_same, sd[pos_c], INF)

    row_j = torch.where(first, sj, 0)
    existing = adj_l[row_j.long()]                               # [k, cap]
    ex_valid = (existing >= 0) & first[:, None]
    ex_d = _dist_rows(packed, pops, row_j, existing, ex_valid)
    sd2, sids2 = _sort_rows(
        torch.cat([ex_d, torch.where(first[:, None], ent_d, INF)], 1),
        torch.cat([existing, ent_ids], 1))
    new_rows = torch.where(torch.isfinite(sd2[:, :cap]), sids2[:, :cap], -1)
    adj_l[torch.where(first, sj, n_l).long()] = new_rows
    return adj_l


def _stitch_batch(packed, pops, adj0, batch_ids, active, m: int, cap: int):
    """Layer-0 intra-batch stitch: distance-merge each batch node's nearest
    in-batch peers into its row (both directions through the symmetry of
    the batch). adj0: [N + 1, cap] padded, written in place and
    returned."""
    b = batch_ids.shape[0]
    n0 = adj0.shape[0] - 1
    ids = batch_ids.long()
    inter = _pairwise_intersections(packed[ids][None])[0]        # [B, B]
    p = pops[ids].to(torch.float32)
    d = 1.0 - similarity_from_counts(inter, p[:, None] + p[None, :] - inter)
    mask = (active[:, None] & active[None, :]
            & ~torch.eye(b, dtype=torch.bool, device=d.device))
    d = torch.where(mask, d, INF)
    # lax.top_k(-d): the smallest distances, ties to the lower index
    peer_d, idx = torch.sort(d, dim=1, stable=True)
    peer_d, idx = peer_d[:, :min(m, b)], idx[:, :min(m, b)]
    peer_ids = torch.where(torch.isfinite(peer_d), batch_ids[idx], -1)

    existing = adj0[ids]
    ex_valid = (existing >= 0) & active[:, None]
    ex_d = _dist_rows(packed, pops, batch_ids, existing, ex_valid)
    sd, sids = _sort_rows(torch.cat([ex_d, peer_d], 1),
                          torch.cat([existing, peer_ids], 1))
    new_rows = torch.where(torch.isfinite(sd[:, :cap]), sids[:, :cap], -1)
    adj0[torch.where(active, batch_ids, n0).long()] = new_rows
    return adj0


def _insert_batch(layers, packed, pops, batch_ids, active, lv, prefix,
                  m: int, ef: int, heuristic_k: int, stitch: bool,
                  extra_visible=None) -> None:
    """Insert one batch of nodes into the padded ``layers`` (in place).

    batch_ids: [B] node ids, in range (inactive rows hold any valid id);
    lv: their levels; prefix: [B] the first invisible id. Per layer, top
    down: the greedy descent for nodes living below it, the beam for the
    nodes on it, selection, forward and reverse links, and at layer 0 the
    stitch. The reference's incremental greedy body
    (``rad_tpu/build/incremental.py:81``) does not mask rows that stopped
    improving: such a row recomputes the best neighbor of an unchanged
    entry point, which again is not better, so the masked body here gives
    the same descent."""
    b = batch_ids.shape[0]
    n = packed.shape[0]
    dev = batch_ids.device
    pad_d = torch.full((b, ef - 1), INF, device=dev)
    pad_i = torch.full((b, ef - 1), -1, dtype=torch.int32, device=dev)
    # entry point: node 0, the top of the hierarchy
    eps_i = torch.zeros((b, 1), dtype=torch.int32, device=dev)
    eps_d = _dist_rows(packed, pops, batch_ids, eps_i, active[:, None])
    for l in range(len(layers) - 1, -1, -1):
        adj_l = layers[l]
        n_l = adj_l.shape[0] - 1
        cap = adj_l.shape[1]
        in_layer = (lv >= l) & active
        above = (lv < l) & active

        # greedy step for nodes whose level < l (descend only)
        g_ep, g_d, improved = eps_i[:, 0], eps_d[:, 0], above
        while bool(improved.any()):
            nbrs = adj_l[torch.clamp(g_ep, max=n_l - 1).long()]
            valid = (nbrs >= 0) & (above & improved)[:, None]
            d_n = _dist_rows(packed, pops, batch_ids, nbrs, valid)
            jbest = d_n.argmin(1, keepdim=True)
            dbest = d_n.gather(1, jbest)[:, 0]
            improved = dbest < g_d
            g_ep = torch.where(improved, nbrs.gather(1, jbest)[:, 0], g_ep)
            g_d = torch.where(improved, dbest, g_d)

        # beam for the nodes that live on this layer
        beam_d, beam_id = _beam_search_batch(
            packed, pops, adj_l, batch_ids, eps_i, eps_d, prefix, in_layer,
            ef, n, extra_visible)
        sel = _select_neighbors(packed, pops, batch_ids, beam_d, beam_id,
                                min(m, cap), heuristic_k, in_layer)
        fwd = torch.full((b, cap), -1, dtype=torch.int32, device=dev)
        fwd[:, :sel.shape[1]] = sel
        adj_l[torch.where(in_layer, batch_ids, n_l).long()] = fwd
        _apply_reverse_links(packed, pops, adj_l, sel, batch_ids, cap,
                             in_layer)
        if l == 0 and stitch:
            _stitch_batch(packed, pops, adj_l, batch_ids, active, m, cap)

        # seeds for the next layer down: the beam if on this layer, else
        # the greedy entry point
        eps_d = torch.where(in_layer[:, None], beam_d,
                            torch.cat([g_d[:, None], pad_d], 1))
        eps_i = torch.where(in_layer[:, None], beam_id,
                            torch.cat([g_ep[:, None], pad_i], 1))


def _padded_tables(tables, device):
    """Host ``[N_l, M_l]`` tables → device tables with a sentinel row."""
    return [torch.from_numpy(np.concatenate(
        [t, np.full((1, t.shape[1]), -1, np.int32)])).to(device)
        for t in tables]


def build_hnsw_device(
    packed: np.ndarray,
    keys: np.ndarray | None = None,
    connectivity: int = 16,
    expansion_add: int = 200,
    ndim: int | None = None,
    seed: int = 0,
    batch_size: int = 128,
    heuristic_k: int | None = None,
    stitch: bool = True,
    fused_loop: bool = False,
    device=None,
) -> HNSWGraph:
    """Build an HNSW graph with batched insertion on ``device``.

    Same parameter semantics as the host builder
    (:func:`rad_tpu_torch.build.reference.build_hnsw`); ``batch_size``
    trades build speed against fidelity to the sequential insertion order
    (nodes of one batch see each other only through the stitch).
    Deterministic given (fingerprints, seed, batch_size), and the same
    graph on every device.

    ``fused_loop`` is accepted for the reference's signature and changes
    nothing: there it compiles the whole sweep into one program for a
    high-latency device link, a workaround the port does not carry. The
    sweep here is a host loop of batches either way.
    """
    device = resolve_device(device)
    packed = np.ascontiguousarray(packed, dtype=np.uint32)
    n, w = packed.shape
    ndim = ndim or w * 32
    m = connectivity
    m0 = 2 * m
    if keys is None:
        keys = np.arange(n, dtype=np.int64)
    keys = np.asarray(keys, dtype=np.int64)
    heuristic_k = heuristic_k or max(4 * m, 32)

    levels_raw = sample_levels(n, m, seed)
    order = np.lexsort((np.arange(n), -levels_raw))
    packed = packed[order]
    keys = keys[order]
    levels = levels_raw[order]
    max_level = int(levels[0]) if n else 0
    layer_sizes = [int((levels >= l).sum()) for l in range(max_level + 1)]
    pops_np = popcount_rows_np(packed)

    packed_t = torch.from_numpy(packed.view(np.int32)).to(device)
    pops_t = torch.from_numpy(pops_np).to(device)
    levels_t = torch.from_numpy(levels).to(device)
    layers = _padded_tables(
        [np.full((layer_sizes[l], m0 if l == 0 else m), -1, np.int32)
         for l in range(max_level + 1)], device)

    ef = max(expansion_add, m0)
    offs = torch.arange(batch_size, dtype=torch.int32, device=device)
    for bi in range(math.ceil(max(n - 1, 0) / batch_size)):
        b_lo = 1 + bi * batch_size  # node 0 needs no insertion
        batch_ids = b_lo + offs
        active = batch_ids < n
        safe_ids = torch.clamp(batch_ids, max=n - 1)
        _insert_batch(layers, packed_t, pops_t, safe_ids, active,
                      levels_t[safe_ids.long()],
                      torch.full_like(batch_ids, b_lo), m, ef, heuristic_k,
                      stitch)

    return HNSWGraph(
        packed=packed,
        popcounts=pops_np,
        keys=keys,
        levels=levels,
        neighbors=tuple(t[:-1].cpu().numpy() for t in layers),
        ndim=ndim,
        connectivity=m,
    )
