"""Exact-kNN HNSW construction on one device: the all-pairs builder.

The single-device path of :func:`rad_tpu.build.exact.build_hnsw_exact`,
edge-identical to it:

1. sample all levels up front and order nodes level-descending;
2. per layer (top -> 0): top-K candidates among the layer's nodes —
   big layers through the bucket reduction (one winner per
   ``block_bucket`` columns, so a query's self bucket loses its runner-up,
   exactly as in the reference): :func:`~rad_tpu_torch.fp.kernels.
   tanimoto_bucket_topk` keeps each row's running top-K on the card, one
   launch a layer (the reference's loop over column blocks with one stable
   sort per block stays for buckets under 8 columns, and on the card for K
   past the kernel's instances or rows too wide for it); small layers
   through
   :func:`~rad_tpu_torch.fp.kernels.tanimoto_matrix` and an exact stable
   top-K, merged block by block. The
   candidates are exact over all columns, or, with ``probes=``, over the
   layer's cluster-probed subset (:mod:`rad_tpu_torch.build.probe`, whose
   loop keeps :func:`~rad_tpu_torch.fp.kernels.tanimoto_bucketmin`);
3. the vectorized diversity heuristic over the candidate lists;
4. symmetrization: forward + reverse edges sorted by (destination,
   distance, source); each row keeps its distance-best ``cap`` entrants.

On probed layers steps 2 and 3 stream, whatever ``stream_select`` says:
each group of scanned query blocks goes straight through selection, and
the ``[n_pad, k]`` candidate tables are never allocated. The reference
builds the same graph either way and streams only past 6 GiB of tables.

The reference's small-layer reduction is ``lax.approx_max_k``, which is an
exact top-k everywhere but on a TPU; the port computes the exact stable
top-k. The reference's sharded, chunked, spanned and bucketed forms (and
its dispatch bounding) are not ported; the mesh-sharded form is
:mod:`rad_tpu_torch.build.exact_sharded`.
"""

from __future__ import annotations

import itertools
import logging
import time

import numpy as np
import torch

from rad_tpu_torch.build.device import _dist_rows, _select_neighbors
from rad_tpu_torch.build.reference import sample_levels
from rad_tpu_torch.devices import resolve_device
from rad_tpu_torch.fp.kernels import (bucket_topk_serves,
                                      decode_bucket_keys,
                                      tanimoto_bucket_topk,
                                      tanimoto_bucketmin, tanimoto_matrix)
from rad_tpu_torch.fp.pack import popcount_rows_np
from rad_tpu_torch.graph.storage import HNSWGraph
from rad_tpu_torch.utils.profiling import count, span

logger = logging.getLogger(__name__)

__all__ = ["build_hnsw_exact"]

INF = float("inf")

# arguments of rad_tpu's builder whose forms this package does not carry,
# with where the ROADMAP lists each
_NOT_BY_DESIGN = "not ported by design"
_UNPORTED = {"approx_recall": _NOT_BY_DESIGN,
             "pairs_per_dispatch": _NOT_BY_DESIGN,
             "use_pallas": _NOT_BY_DESIGN, "interpret": _NOT_BY_DESIGN}


def _merge_topk(cat_d, cat_i, k: int):
    """Smallest-k (d, id) columns via one stable sort: ties keep the
    earlier position (the reference's ``lax.sort(..., is_stable=True)``)."""
    sd, order = torch.sort(cat_d, dim=1, stable=True)
    return sd[:, :k], cat_i.gather(1, order[:, :k])


def _allpairs_topk(packed, pops, n_real: int, k: int, q_block: int,
                   col_block: int, bucket: int | None, approx: bool = False):
    """Top-k neighbor (dists, ids) of every row of ``packed`` among rows
    ``< n_real`` (self excluded), blocked in both dimensions.

    packed: [N_pad, W]; rows past ``n_real`` are padding (or real rows of
    non-members on upper layers) and are masked by id. Returns ``[N_pad,
    k]`` f32 / int32, ascending, INF/-1 tails; padded query rows are junk.
    ``approx`` runs the bucket kernel's approximate-reciprocal epilogue.
    """
    return _scan(packed, pops, 0, packed.shape[0], n_real, k, q_block,
                 col_block, bucket, approx)


def _scan(packed, pops, q0: int, q1: int, n_real: int, k: int, q_block: int,
          col_block: int, bucket: int | None, approx: bool):
    """Top-k (dists, ids) of query rows ``[q0, q1)`` against every column
    (the reference's ``_make_one_qblock``, q-block by q-block): a bucket
    scan in one :func:`tanimoto_bucket_topk` call where it serves
    (buckets of 8 columns or more; on the card, ``k`` and the row width
    within the kernel's instances), else :func:`_one_qblock_loop` q-block
    by q-block. A bucket scan counts the path it took, once a call:
    ``build.bucket_topk`` or ``build.bucket_loop``."""
    if bucket is not None:
        if bucket >= 8 and bucket_topk_serves(packed, k, bucket):
            count("build.bucket_topk")
            return tanimoto_bucket_topk(packed, q0, q1, n_real, k, bucket,
                                        pops=pops, approx=approx)
        count("build.bucket_loop")
    if q1 - q0 == q_block:
        return _one_qblock_loop(packed, pops, q0, n_real, k, q_block,
                                col_block, bucket, approx)
    dev = packed.device
    out_d = torch.empty((q1 - q0, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((q1 - q0, k), dtype=torch.int32, device=dev)
    for b0 in range(q0, q1, q_block):
        out_d[b0 - q0:b0 - q0 + q_block], out_i[b0 - q0:b0 - q0 + q_block] = \
            _one_qblock_loop(packed, pops, b0, n_real, k, q_block, col_block,
                             bucket, approx)
    return out_d, out_i


def _one_qblock_loop(packed, pops, q0: int, n_real: int, k: int,
                     q_block: int, col_block: int, bucket: int | None,
                     approx: bool):
    """:func:`_scan` of one q-block, column block by column block: each
    block's bucket winners (or matrix top-k) merged into the running top-k
    by one stable sort."""
    n_pad = packed.shape[0]
    dev = packed.device
    col_ids = torch.arange(col_block, dtype=torch.int32, device=dev)
    q = packed[q0:q0 + q_block]
    q_pops = pops[q0:q0 + q_block]
    q_ids = torch.arange(q0, q0 + q_block, dtype=torch.int32,
                         device=dev)[:, None]
    best_d = torch.full((q_block, k), INF, device=dev)
    best_i = torch.full((q_block, k), -1, dtype=torch.int32, device=dev)
    for c0 in range(0, n_pad, col_block):
        db = packed[c0:c0 + col_block]
        db_pops = pops[c0:c0 + col_block]
        if bucket is not None:
            keys = tanimoto_bucketmin(q, db, bucket, q_pops, db_pops,
                                      approx=approx)
            blk_d, local = decode_bucket_keys(keys, bucket)
            blk_i = c0 + local
            bad = (blk_i >= n_real) | (blk_i == q_ids)
            blk_d = blk_d.masked_fill(bad, INF)
            blk_i = blk_i.masked_fill(bad, -1)
        else:
            d = tanimoto_matrix(q, db, q_pops, db_pops)
            ids = (c0 + col_ids)[None, :]
            d = d.masked_fill((ids >= n_real) | (ids == q_ids), INF)
            blk_d, blk_i = _merge_topk(d, ids.expand(q_block, -1), k)
        # exact merge of the block's winners: [q_block, k + width]
        best_d, best_i = _merge_topk(torch.cat([best_d, blk_d], 1),
                                     torch.cat([best_i, blk_i], 1), k)
    return best_d, best_i


def _one_qblock_probed(packed_cl, pops_cl, perm_cl, cols, q0: int, k: int,
                       q_block: int, csize: int, bucket: int | None,
                       approx: bool):
    """Top-k (dists, permuted positions) of permuted query rows ``[q0, q0
    + q_block)`` over the clusters ``cols`` (ascending, −1 dead) — the
    reference's ``_make_one_qblock_probed``. Everything is in permuted
    space: ``perm_cl[p]`` is the layer id at position ``p`` (−1 pads).

    A dead probe is skipped: its block is all masked, and merging an
    all-INF block after the running best changes nothing (the stable sort
    keeps the running entries first). The q-block is the span
    ``build.probe_scan`` and counts ``build.probe_qblocks``; each cluster
    it scans counts the path it took, ``build.probe_bucket`` or
    ``build.probe_matrix``."""
    count("build.probe_qblocks")
    path = "build.probe_bucket" if bucket is not None else \
        "build.probe_matrix"
    with span("build.probe_scan"):
        dev = packed_cl.device
        q = packed_cl[q0:q0 + q_block]
        q_pops = pops_cl[q0:q0 + q_block]
        q_pos = torch.arange(q0, q0 + q_block, dtype=torch.int32,
                             device=dev)[:, None]
        col_ids = torch.arange(csize, dtype=torch.int32, device=dev)
        best_d = torch.full((q_block, k), INF, device=dev)
        best_i = torch.full((q_block, k), -1, dtype=torch.int32, device=dev)
        for ci in cols:
            if ci < 0:
                continue
            count(path)
            c0 = ci * csize
            db = packed_cl[c0:c0 + csize]
            db_pops = pops_cl[c0:c0 + csize]
            blk_perm = perm_cl[c0:c0 + csize]
            if bucket is not None:
                keys = tanimoto_bucketmin(q, db, bucket, q_pops, db_pops,
                                          approx=approx)
                blk_d, local = decode_bucket_keys(keys, bucket)
                blk_pos = c0 + local
                bad = (blk_perm[local.long()] < 0) | (blk_pos == q_pos)
                blk_d = blk_d.masked_fill(bad, INF)
                blk_i = blk_pos.masked_fill(bad, -1)
            else:
                d = tanimoto_matrix(q, db, q_pops, db_pops)
                pos = (c0 + col_ids)[None, :]
                d = d.masked_fill((blk_perm[None, :] < 0) | (pos == q_pos),
                                  INF)
                blk_d, blk_i = _merge_topk(d, pos.expand(q_block, -1), k)
            best_d, best_i = _merge_topk(torch.cat([best_d, blk_d], 1),
                                         torch.cat([best_i, blk_i], 1), k)
        return best_d, best_i


def _probed_blocks(packed_l, pops_l, n_real: int, k: int, q_block: int,
                   csize: int, bucket: int | None, probes: int,
                   probe_sample: int, seed: int, packed_host: np.ndarray,
                   probe_granularity: str = "qblock",
                   probe_width: int | None = None,
                   bucket_approx: bool = False, times: dict | None = None):
    """Cluster-probed top-k: the subquadratic form of
    :func:`_allpairs_topk`, one query block at a time.

    Partitions the layer's ``n_real`` rows into ``C = ceil(n_real /
    csize)`` balanced clusters (:func:`~rad_tpu_torch.build.probe.
    bisect_clusters`), gives each query block (``probe_granularity=
    "qblock"``) or each cluster (``"cluster"``) a ``probes``-long probe
    list, and scans each real query block only against its probed
    clusters. Candidates are exact within the probed set. ``probe_width``
    pads the probe lists with dead (−1) probes, which change nothing.

    Returns an iterator over the real query blocks in permuted order:
    each item is the block's ``[q_block, k]`` (dists, layer ids),
    ascending, INF/−1 tails (:func:`_allpairs_topk`'s convention), and its
    rows' layer ids (−1 at pad positions). ``times``, when given, gets the
    seconds of the partition (``"bisection"``) and the probe lists
    (``"probe_tables"``) added.
    """
    packed_cl, pops_cl, perm_cl, probe_tab = _probed_layout(
        packed_l, pops_l, k, q_block, csize, probes, probe_sample, seed,
        packed_host, probe_granularity, probe_width, times)
    nq = perm_cl.shape[0] // q_block
    # per-qblock lists index directly; per-cluster lists by q-block // qpc
    # (nq == C only when csize == q_block, where they agree)
    sdiv = 1 if probe_tab.shape[0] == nq else csize // q_block

    def blocks():
        # pads occupy the tail of permuted space: only real q-blocks scan
        for qi in range(-(-n_real // q_block)):
            q0 = qi * q_block
            bd, bpos = _one_qblock_probed(
                packed_cl, pops_cl, perm_cl, probe_tab[qi // sdiv].tolist(),
                q0, k, q_block, csize, bucket, bucket_approx)
            ids = torch.where(bpos >= 0,
                              perm_cl[torch.clamp(bpos, min=0).long()], -1)
            yield bd, ids, perm_cl[q0:q0 + q_block]

    return blocks()


def _probed_layout(packed_l, pops_l, k: int, q_block: int, csize: int,
                   probes: int, probe_sample: int, seed: int,
                   packed_host: np.ndarray, probe_granularity: str = "qblock",
                   probe_width: int | None = None, times: dict | None = None):
    """The probed stage's layout of a layer: its balanced partition into
    ``csize``-row clusters and the probe lists, as ``(packed_cl, pops_cl,
    perm_cl, probe_tab)``: the cluster-contiguous copy of the layer (pad
    positions zero), its popcounts, the permutation (``perm_cl[p]`` the
    layer id at position ``p``, −1 pads) and the probe lists (numpy)."""
    from rad_tpu_torch.build.probe import (bisect_clusters, cluster_probes,
                                           qblock_probes)

    dev = packed_l.device
    if csize % q_block:
        raise ValueError(f"probe csize {csize} must be a multiple of "
                         f"q_block {q_block}")
    if k > csize:
        raise ValueError(f"candidates k={k} exceeds probe csize {csize}")
    if probe_granularity not in ("qblock", "cluster"):
        raise ValueError(
            f"unknown probe_granularity {probe_granularity!r}")
    t0 = time.perf_counter()
    with span("build.bisection"):
        perm = bisect_clusters(packed_host, csize, seed=seed,
                               dev_rows=packed_l)
    t1 = time.perf_counter()
    with span("build.probe_tables"):
        if probe_granularity == "qblock":
            probe_tab = qblock_probes(packed_host, perm, csize, q_block,
                                      probes, sample=probe_sample,
                                      seed=seed + 1, device=dev)
        else:
            probe_tab = cluster_probes(packed_host, perm, csize, probes,
                                       sample=probe_sample, seed=seed + 1,
                                       device=dev)
    if probe_width is not None and probe_width > probe_tab.shape[1]:
        probe_tab = np.pad(probe_tab,
                           ((0, 0), (0, probe_width - probe_tab.shape[1])),
                           constant_values=-1)
    t2 = time.perf_counter()
    if times is not None:
        times["bisection"] = times.get("bisection", 0.0) + t1 - t0
        times["probe_tables"] = times.get("probe_tables", 0.0) + t2 - t1

    # the cluster-contiguous copy of the layer; pad positions hold zeros
    perm_cl = torch.from_numpy(perm).to(dev)
    src = torch.clamp(perm_cl, min=0).long()
    pad = (perm_cl < 0)
    packed_cl = packed_l[src].masked_fill_(pad[:, None], 0)
    pops_cl = pops_l[src].masked_fill_(pad, 0)
    del src
    return packed_cl, pops_cl, perm_cl, probe_tab


def _select_probed(blocks, packed, pops, n_pad: int, k: int, q_block: int,
                   m: int, heuristic_k: int, sel_block: int,
                   times: dict | None = None, sync: bool = False):
    """Diversity selection streamed into the probed scan (the reference's
    ``select_stream``): each group of ``max(1, sel_block / q_block)`` of
    :func:`_probed_blocks`' query blocks is selected in permuted row
    order, ``sel_block`` rows at a time, and its ``sel`` / ``sel_d`` rows
    scattered to their layer rows; pad positions go to a sentinel row.
    The ``[n_pad, k]`` candidate tables never exist. Selection is per row,
    so the grouping changes no result: :func:`_select_layer`'s ``(sel,
    sel_d)`` over the tables the blocks make. ``times["selection"]`` gets
    the selection's seconds, measured after a device synchronisation when
    ``sync``."""
    dev = packed.device
    width = min(m, min(heuristic_k, k))
    sel = torch.full((n_pad + 1, width), -1, dtype=torch.int32, device=dev)
    sel_d = torch.full((n_pad + 1, width), INF, device=dev)
    per_group = max(1, sel_block // q_block)
    while group := list(itertools.islice(blocks, per_group)):
        bd, ids, perm_rows = (torch.cat(x) for x in zip(*group))
        del group
        if sync and dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        with span("build.selection"):
            for r0 in range(0, bd.shape[0], sel_block):
                qi = perm_rows[r0:r0 + sel_block]
                active = qi >= 0
                safe_q = torch.where(active, qi, 0)
                s = _select_neighbors(packed, pops, safe_q,
                                      bd[r0:r0 + sel_block],
                                      ids[r0:r0 + sel_block], m,
                                      heuristic_k, active)
                rows = torch.where(active, qi, n_pad).long()
                sel[rows] = s
                sel_d[rows] = _dist_rows(packed, pops, safe_q, s,
                                         (s >= 0) & active[:, None])
            del bd, ids
            if sync and dev.type == "cuda":
                torch.cuda.synchronize(dev)
        if times is not None:
            times["selection"] = (times.get("selection", 0.0)
                                  + time.perf_counter() - t0)
    return sel[:n_pad], sel_d[:n_pad]


def _select_layer(packed, pops, cand_d, cand_id, n_real: int, m: int,
                  heuristic_k: int, sel_block: int):
    """Diversity selection + per-selection distances, ``sel_block`` rows
    at a time. Returns (sel [N_pad, m'] int32, sel_d [N_pad, m'] f32);
    padded rows select nothing."""
    n_pad, k = cand_d.shape
    dev = cand_d.device
    width = min(m, min(heuristic_k, k))
    sel = torch.full((n_pad, width), -1, dtype=torch.int32, device=dev)
    sel_d = torch.full((n_pad, width), INF, device=dev)
    for r0 in range(0, min(n_pad, n_real), sel_block):
        qi = torch.arange(r0, r0 + sel_block, dtype=torch.int32, device=dev)
        active = qi < n_real
        safe_q = torch.clamp(qi, max=n_real - 1)
        s = _select_neighbors(packed, pops, safe_q,
                              cand_d[r0:r0 + sel_block],
                              cand_id[r0:r0 + sel_block], m, heuristic_k,
                              active)
        sel[r0:r0 + sel_block] = s
        sel_d[r0:r0 + sel_block] = _dist_rows(
            packed, pops, safe_q, s, (s >= 0) & active[:, None])
    return sel, sel_d


def _symmetrize(sel, sel_d, n_real: int, cap: int):
    """Rows = distance-best ``cap`` incident edges (forward + reverse).

    Every selection (i -> j, d) contributes edges (i, j) and (j, i); each
    destination keeps its ``cap`` nearest distinct entrants. The
    reference's one 3-key sort over (dst, d, src) is three stable
    single-key sorts here, least significant key first."""
    n_pad, m = sel.shape
    dev = sel.device
    src = torch.arange(n_pad, dtype=torch.int32,
                       device=dev).repeat_interleave(m)
    dst = sel.reshape(-1)
    d = sel_d.reshape(-1)
    ok = (dst >= 0) & (src < n_real)
    sentinel = torch.full_like(dst, n_pad)
    e_dst = torch.cat([torch.where(ok, dst, sentinel),
                       torch.where(ok, src, sentinel)])
    e_src = torch.cat([src, torch.where(ok, dst, sentinel)])
    e_d = torch.cat([d.masked_fill(~ok, INF)] * 2)

    perm = torch.sort(e_src, stable=True).indices
    perm = perm[torch.sort(e_d[perm], stable=True).indices]
    perm = perm[torch.sort(e_dst[perm], stable=True).indices]
    sd_key, sdist, ssrc = e_dst[perm], e_d[perm], e_src[perm]

    # drop duplicate (dst, src) pairs (mutual selections appear twice)
    same = (sd_key[1:] == sd_key[:-1]) & (ssrc[1:] == ssrc[:-1])
    dup = torch.cat([torch.zeros(1, dtype=torch.bool, device=dev), same])
    valid = (sd_key < n_pad) & torch.isfinite(sdist) & ~dup
    first = torch.cat([torch.ones(1, dtype=torch.bool, device=dev),
                       sd_key[1:] != sd_key[:-1]])
    c = torch.cumsum(valid, 0)
    base_at_start = torch.where(first, c - valid.long(), -1)
    rank = c - 1 - torch.cummax(base_at_start, 0).values
    keep = valid & (rank < cap)

    # rank-limited scatter; dropped entries land in a sentinel row
    rows = torch.full(((n_pad + 1) * cap,), -1, dtype=torch.int32,
                      device=dev)
    flat = torch.where(keep, sd_key.long() * cap + rank, n_pad * cap)
    rows[flat] = torch.where(keep, ssrc, -1)
    return rows.view(n_pad + 1, cap)[:n_pad]


def _round_up(x: int, mult: int) -> int:
    return ((x + mult - 1) // mult) * mult


def build_hnsw_exact(
    packed: np.ndarray,
    keys: np.ndarray | None = None,
    connectivity: int = 16,
    expansion_add: int | None = None,
    ndim: int | None = None,
    seed: int = 0,
    candidates: int | None = None,
    heuristic_k: int | None = None,
    q_block: int = 4096,
    col_block: int = 1 << 13,
    sel_block: int = 2048,
    block_bucket: int | None = 64,
    bucket_approx: bool = False,
    bucket_q_tile: int | None = None,
    bucket_n_tile: int | None = None,
    symm_mode: str | None = None,
    probes: int | None = None,
    probe_csize: int | None = None,
    probe_sample: int = 16,
    probe_granularity: str = "qblock",
    probe_width: int | None = None,
    probe_min_n: int = 2_000_000,
    stream_select: bool | str = "auto",
    mesh=None,
    mesh_axis: str = "graph",
    device=None,
    stage_times: dict | None = None,
    **unported,
) -> HNSWGraph:
    """Build an HNSW graph from exact per-layer top-K neighbor lists.

    Parameters follow ``rad_tpu.build.exact.build_hnsw_exact``:
    ``expansion_add`` is accepted for API parity and ignored (exact
    candidates are the infinite-beam limit); ``candidates`` (default
    ``max(heuristic_k, 4*M)``) is the exact-kNN depth fed to the
    heuristic; ``block_bucket`` selects the fused bucket reduction on
    layers of at least ``max(q_block, col_block, sel_block)`` nodes
    (``None`` disables it). ``bucket_approx`` runs the bucket kernel's
    approximate-reciprocal epilogue (candidate order can differ at
    near-ties; selection recomputes the chosen distances exactly).
    ``bucket_q_tile``/``bucket_n_tile`` are the reference's Pallas tilings:
    accepted, and they change no result. ``symm_mode`` accepts
    ``None``/``"sort"`` — the reference's other forms are bit-identical
    workarounds that are not ported.

    ``probes`` switches large layers to the subquadratic cluster-probed
    candidate stage (:func:`_probed_blocks`): ``probe_csize``-row
    clusters (default: the layer's column block), each query block
    scanning its ``probes`` nearest clusters by min distance over
    ``probe_sample`` sampled members. A layer probes when it has at least
    ``probe_min_n`` nodes and ``4 * probes`` clusters, ``candidates`` fit
    a cluster and the cluster is a whole number of q-blocks; a request
    that probes no layer logs a warning. ``probe_granularity`` ("qblock"
    / "cluster") and ``probe_width`` as in the reference.
    ``stream_select`` ("auto", True or False) is accepted for the
    reference's signature and changes nothing: probed layers always
    stream selection into the scan (:func:`_select_probed`), which builds
    the graph of the reference's table path and of its streamed path.

    ``mesh`` (a 1-D :class:`~rad_tpu_torch.parallel.mesh.Mesh` with axis
    ``mesh_axis``) distributes the build: every layer of at least the
    mesh's padding unit ``max(q_block, col_block, sel_block, D * q_block,
    D * sel_block)`` runs its three stages split over the D shards
    (:mod:`rad_tpu_torch.build.exact_sharded`: q-block and row spans per
    shard, one all-to-all in the symmetrization), and the graph is the
    single-device build's, edge for edge. The fingerprints are replicated
    on each shard's device (one copy per distinct device); smaller layers
    run on the lead device. The bucket reduction serves the layers it
    serves without a mesh, so the mesh's larger padding unit changes no
    candidate.

    ``device`` is where the fingerprints are uploaded and every stage
    runs: the CUDA kernels on a CUDA device, their plain twins on the CPU
    (with a ``mesh``, its lead device unless ``device`` is given).
    ``stage_times``, when given, accumulates seconds per stage under
    ``"candidates"``, ``"selection"`` and ``"symmetrization"``, and, once
    a layer probes, ``"bisection"`` and ``"probe_tables"`` (not part of
    ``"candidates"``), and, when ``probes`` is given, lists this build's
    probed layers under ``"probed_layers"``; the device is synchronized at each stage boundary
    for that. Inside :func:`rad_tpu_torch.utils.profiling.recording` the
    three stages are the spans ``build.candidates``, ``build.selection``
    and ``build.symmetrization``, and a probed layer's partition, probe
    lists and q-block scans the spans ``build.bisection``,
    ``build.probe_tables`` and ``build.probe_scan``.
    """
    bad = sorted(k for k in unported if k in _UNPORTED)
    if bad:
        raise NotImplementedError(
            f"build_hnsw_exact: {bad} belong to forms of the reference "
            f"builder that are not ported (ROADMAP: "
            f"{'; '.join(sorted({_UNPORTED[k] for k in bad}))})")
    if unported:
        raise TypeError(f"unexpected arguments {sorted(unported)}")
    if symm_mode not in (None, "sort"):
        raise NotImplementedError(
            f"symm_mode={symm_mode!r}: only the 'sort' symmetrization is "
            f"ported; the reference's other forms are {_NOT_BY_DESIGN}")
    if stream_select not in ("auto", True, False):
        raise ValueError(f"stream_select={stream_select!r}")
    if mesh is not None:
        if list(getattr(mesh, "shape", {})) != [mesh_axis]:
            raise ValueError(f"mesh= needs a 1-D Mesh with the axis "
                             f"{mesh_axis!r} (rad_tpu_torch.parallel."
                             f"make_mesh), got {mesh!r}")
        if device is None:
            device = mesh.lead
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
    candidates = candidates or max(heuristic_k, 2 * m0)
    for name, v in (("q_block", q_block), ("col_block", col_block),
                    ("sel_block", sel_block)):
        if v & (v - 1):
            raise ValueError(f"{name}={v} must be a power of two")
    times = stage_times if stage_times is not None else {}
    for stage in ("candidates", "selection", "symmetrization"):
        times.setdefault(stage, 0.0)
    probed_layers = []
    if probes is not None:
        times["probed_layers"] = probed_layers

    levels_raw = sample_levels(n, m, seed)
    order = np.lexsort((np.arange(n), -levels_raw))
    packed = packed[order]
    keys = keys[order]
    levels = levels_raw[order]
    max_level = int(levels[0]) if n else 0
    layer_sizes = tuple(int((levels >= l).sum())
                        for l in range(max_level + 1))
    pops_np = popcount_rows_np(packed)

    big = big_single = max(q_block, col_block, sel_block)
    if mesh is not None:
        # sharded layers split into whole q-blocks and selection chunks
        # per shard; the unit also pads (reductions mask rows >= n_real)
        d_mesh = mesh.shape[mesh_axis]
        big = max(big, d_mesh * q_block, d_mesh * sel_block)
    if n >= big:
        n_pad0 = _round_up(n, big)
    elif n > 1:
        n_pad0 = max(1 << max(n - 1, 1).bit_length(), 1024)
    else:
        n_pad0 = 1
    # every small layer shares one padded shape (the reference's compile
    # unit); kept so the padding — and with it the bucket path's handling
    # of non-member rows — is the reference's
    small_unit = min(big, 8192)

    def _pad_for(n_l: int):
        """Padded size + (q, col, sel) blocks for an n_l-node layer."""
        if n_l >= big:
            return _round_up(n_l, big), q_block, col_block, sel_block
        if n_l <= small_unit:
            n_pad = min(small_unit, n_pad0)
            return n_pad, n_pad, n_pad, min(sel_block, n_pad)
        n_pad = min(_round_up(n_l, small_unit), n_pad0)
        return (n_pad, min(q_block, n_pad), min(col_block, n_pad),
                min(sel_block, n_pad))

    # one upload, zero-padded to layer 0's padded size; every layer uses a
    # prefix, so upper-layer pads hold real rows of non-members (masked by
    # id; the bucket path can lose one boundary-bucket winner to them, as
    # the reference does)
    packed_pad = np.concatenate(
        [packed, np.zeros((n_pad0 - n, w), np.uint32)])
    pops_pad = np.concatenate([pops_np, np.zeros(n_pad0 - n, np.int32)])
    dev_packed = torch.from_numpy(packed_pad.view(np.int32)).to(device)
    dev_pops = torch.from_numpy(pops_pad).to(device)
    if mesh is not None:
        from rad_tpu_torch.build import exact_sharded as xs
        rep_packed = xs.replicate(dev_packed, mesh)
        rep_pops = xs.replicate(dev_pops, mesh)

    neighbors = []
    for l in range(max_level + 1):
        n_l = layer_sizes[l]
        cap = m0 if l == 0 else m
        if n_l <= 1:
            neighbors.append(np.full((n_l, cap), -1, np.int32))
            continue
        n_pad, qb, cb, sb = _pad_for(n_l)
        k = min(candidates, n_pad)
        packed_l = dev_packed[:n_pad]
        pops_l = dev_pops[:n_pad]
        # the bucket reduction's layers do not depend on the mesh
        bkt = block_bucket if block_bucket and n_l >= big_single else None
        sharded = mesh is not None and n_l >= big
        csz = probe_csize or cb
        use_probe = (probes is not None
                     and n_l >= probe_min_n
                     and -(-n_l // csz) >= 4 * probes
                     and k <= csz
                     and csz % qb == 0)
        if probes is not None and not use_probe:
            logger.info("layer %d (n=%d): probes=%d requested but layer "
                        "stays exact (below probe_min_n=%d, or too few "
                        "clusters, or k>csize)", l, n_l, probes,
                        probe_min_n)
        if use_probe:
            probed_layers.append(l)

        t0 = time.perf_counter()
        other0 = _other_stage_seconds(times)
        sel0 = times["selection"]
        if sharded:
            sel, sel_d = _sharded_stages(
                xs, mesh, mesh_axis, [t[:n_pad] for t in rep_packed],
                [t[:n_pad] for t in rep_pops], packed_l, pops_l, n_l, n_pad,
                k, qb, cb, sb, bkt, bucket_approx, min(m, cap), heuristic_k,
                times, stage_times,
                (csz, probes, probe_sample, seed * 1_000_003 + 7919 * (l + 1),
                 packed[:n_l], probe_granularity, probe_width)
                if use_probe else None)
        elif use_probe:
            # selection streams into the scan and times itself
            with span("build.candidates"):
                sel, sel_d = _select_probed(
                    _probed_blocks(packed_l, pops_l, n_l, k, qb, csz, bkt,
                                   probes, probe_sample,
                                   seed * 1_000_003 + 7919 * (l + 1),
                                   packed[:n_l], probe_granularity,
                                   probe_width, bucket_approx, times),
                    packed_l, pops_l, n_pad, k, qb, min(m, cap),
                    heuristic_k, sb, times, sync=stage_times is not None)
        else:
            with span("build.candidates"):
                cand_d, cand_id = _allpairs_topk(packed_l, pops_l, n_l, k,
                                                 qb, cb, bkt, bucket_approx)
                _sync_if(stage_times, device)
            t_sel = time.perf_counter()
            with span("build.selection"):
                sel, sel_d = _select_layer(packed_l, pops_l, cand_d,
                                           cand_id, n_l, min(m, cap),
                                           heuristic_k, sb)
                del cand_d, cand_id
                _sync_if(stage_times, device)
            times["selection"] += time.perf_counter() - t_sel
        _sync_if(stage_times, device)
        t1 = time.perf_counter()
        with span("build.symmetrization"):
            if sharded:
                rows = xs.symmetrize_sharded(sel, sel_d, n_l, cap, mesh,
                                             mesh_axis).full()
            else:
                rows = _symmetrize(sel, sel_d, n_l, cap)
            neighbors.append(rows[:n_l].cpu().numpy())
        t2 = time.perf_counter()
        # the partition, the probe lists and the selection count as stages
        # of their own
        cand_s = t1 - t0 - (_other_stage_seconds(times) - other0)
        times["candidates"] += cand_s
        times["symmetrization"] += t2 - t1
        logger.info("layer %d (n=%d, %s%s%s): %.2fs candidates, %.2fs "
                    "selection, %.2fs symmetrization", l, n_l,
                    f"bucket {bkt}" if bkt else "matrix",
                    f", {probes} probes of {csz}" if use_probe else "",
                    f", {mesh.shape[mesh_axis]} shards" if sharded
                    else ", selection streamed" if use_probe else "",
                    cand_s, times["selection"] - sel0, t2 - t1)
        del sel, sel_d, rows

    if probes is not None and not probed_layers:
        # a probed build was requested but every layer stayed exact
        logger.warning(
            "probes=%d requested but NO layer used the probed candidate "
            "stage (all below probe_min_n=%d or too small) — this is a "
            "fully exact build; pass probe_min_n=0 to force probing",
            probes, probe_min_n)

    return HNSWGraph(
        packed=packed,
        popcounts=pops_np,
        keys=keys,
        levels=levels,
        neighbors=tuple(neighbors),
        ndim=ndim,
        connectivity=m,
    )


def _sharded_stages(xs, mesh, axis, rep_packed, rep_pops, packed_l, pops_l,
                    n_l: int, n_pad: int, k: int, qb: int, cb: int, sb: int,
                    bkt, approx: bool, m: int, heuristic_k: int, times: dict,
                    stage_times, probe):
    """A sharded layer's candidates (exact, or probed when ``probe`` holds
    the probed stage's settings) and selection, timed into ``times``
    (the candidate stage's seconds are counted by the caller)."""
    with span("build.candidates"):
        if probe is None:
            cand_d, cand_id = xs.allpairs_topk_sharded(
                rep_packed, rep_pops, n_l, k, qb, cb, bkt, mesh, axis,
                approx)
        else:
            csz, probes, probe_sample, seed, host, granularity, width = probe
            layout = _probed_layout(packed_l, pops_l, k, qb, csz, probes,
                                    probe_sample, seed, host, granularity,
                                    width, times)
            cand_d, cand_id = xs.probed_topk_sharded(
                *(xs.replicate(t, mesh) for t in layout[:3]), layout[3],
                n_pad, k, qb, csz, bkt, mesh, axis, approx, n_real=n_l)
            del layout
        _sync_mesh(stage_times, mesh)
    t0 = time.perf_counter()
    with span("build.selection"):
        sel, sel_d = xs.select_layer_sharded(rep_packed, rep_pops, cand_d,
                                             cand_id, n_l, m, heuristic_k,
                                             sb, mesh, axis)
        _sync_mesh(stage_times, mesh)
    times["selection"] += time.perf_counter() - t0
    return sel, sel_d


def _sync_mesh(stage_times, mesh) -> None:
    """Wait for every card of the mesh when stage times are taken."""
    if stage_times is not None:
        for d in {str(d): d for d in mesh.devices.flat}.values():
            _sync_if(stage_times, d)


def _other_stage_seconds(times: dict) -> float:
    """Seconds of the stages timed inside a layer's candidate stage: the
    partition, the probe lists and the selection."""
    return (times.get("bisection", 0.0) + times.get("probe_tables", 0.0)
            + times.get("selection", 0.0))


def _sync_if(stage_times, device) -> None:
    """Wait for the device when stage times are being taken."""
    if stage_times is not None and torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
