"""Exact-kNN HNSW construction on one device: the all-pairs builder.

The single-device path of :func:`rad_tpu.build.exact.build_hnsw_exact`,
edge-identical to it:

1. sample all levels up front and order nodes level-descending;
2. per layer (top -> 0): blocked exact top-K among the layer's nodes —
   big layers through :func:`~rad_tpu_torch.fp.kernels.tanimoto_bucketmin`
   (one winner per ``block_bucket`` columns, so a query's self bucket
   loses its runner-up, exactly as in the reference), small layers through
   :func:`~rad_tpu_torch.fp.kernels.tanimoto_matrix` and an exact stable
   top-K; a running top-K merge with one stable sort per block;
3. the vectorized diversity heuristic over the exact candidate lists;
4. symmetrization: forward + reverse edges sorted by (destination,
   distance, source); each row keeps its distance-best ``cap`` entrants.

The reference's small-layer reduction is ``lax.approx_max_k``, which is an
exact top-k everywhere but on a TPU; the port computes the exact stable
top-k. The reference's probed, sharded, streamed, chunked, spanned and
bucketed forms (and its dispatch bounding) are not ported.
"""

from __future__ import annotations

import logging
import time

import numpy as np
import torch

from rad_tpu_torch.build.device import _dist_rows, _select_neighbors
from rad_tpu_torch.build.reference import sample_levels
from rad_tpu_torch.fp.kernels import (decode_bucket_keys, tanimoto_bucketmin,
                                      tanimoto_matrix)
from rad_tpu_torch.fp.pack import popcount_rows_np
from rad_tpu_torch.graph.storage import HNSWGraph

logger = logging.getLogger(__name__)

__all__ = ["build_hnsw_exact"]

INF = float("inf")

# arguments of rad_tpu's builder whose forms this package does not carry
_UNPORTED = ("approx_recall", "bucket_approx", "bucket_q_tile",
             "bucket_n_tile", "pairs_per_dispatch", "probes", "probe_csize",
             "probe_sample", "probe_granularity", "probe_width",
             "probe_min_n", "stream_select", "mesh", "mesh_axis",
             "use_pallas", "interpret")


def _merge_topk(cat_d, cat_i, k: int):
    """Smallest-k (d, id) columns via one stable sort: ties keep the
    earlier position (the reference's ``lax.sort(..., is_stable=True)``)."""
    sd, order = torch.sort(cat_d, dim=1, stable=True)
    return sd[:, :k], cat_i.gather(1, order[:, :k])


def _allpairs_topk(packed, pops, n_real: int, k: int, q_block: int,
                   col_block: int, bucket: int | None):
    """Top-k neighbor (dists, ids) of every row of ``packed`` among rows
    ``< n_real`` (self excluded), blocked in both dimensions.

    packed: [N_pad, W]; rows past ``n_real`` are padding (or real rows of
    non-members on upper layers) and are masked by id. Returns ``[N_pad,
    k]`` f32 / int32, ascending, INF/-1 tails; padded query rows are junk.
    """
    n_pad = packed.shape[0]
    dev = packed.device
    out_d = torch.empty((n_pad, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((n_pad, k), dtype=torch.int32, device=dev)
    for q0 in range(0, n_pad, q_block):
        out_d[q0:q0 + q_block], out_i[q0:q0 + q_block] = _one_qblock(
            packed, pops, q0, n_real, k, q_block, col_block, bucket)
    return out_d, out_i


def _one_qblock(packed, pops, q0: int, n_real: int, k: int, q_block: int,
                col_block: int, bucket: int | None):
    """Top-k (dists, ids) of query rows ``[q0, q0 + q_block)`` against
    every column block (the reference's ``_make_one_qblock``)."""
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
            keys = tanimoto_bucketmin(q, db, bucket, q_pops, db_pops)
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
    symm_mode: str | None = None,
    device="cpu",
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
    (``None`` disables it). ``symm_mode`` accepts ``None``/``"sort"`` —
    the reference's other forms are bit-identical workarounds that are not
    ported.

    ``device`` is where the fingerprints are uploaded and every stage
    runs: the CUDA kernels on a CUDA device, their plain twins on the CPU.
    ``stage_times``, when given, accumulates seconds per stage under
    ``"candidates"``, ``"selection"`` and ``"symmetrization"`` (the device
    is synchronized at each stage boundary for that).
    """
    bad = sorted(k for k in unported if k in _UNPORTED)
    if bad:
        raise NotImplementedError(
            f"build_hnsw_exact: {bad} belong to forms of the reference "
            f"builder that are not ported (ROADMAP Queue 1 item 7)")
    if unported:
        raise TypeError(f"unexpected arguments {sorted(unported)}")
    if symm_mode not in (None, "sort"):
        raise NotImplementedError(
            f"symm_mode={symm_mode!r}: only the 'sort' symmetrization is "
            f"ported (ROADMAP Queue 1 item 7)")
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

    levels_raw = sample_levels(n, m, seed)
    order = np.lexsort((np.arange(n), -levels_raw))
    packed = packed[order]
    keys = keys[order]
    levels = levels_raw[order]
    max_level = int(levels[0]) if n else 0
    layer_sizes = tuple(int((levels >= l).sum())
                        for l in range(max_level + 1))
    pops_np = popcount_rows_np(packed)

    big = max(q_block, col_block, sel_block)
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
        bkt = block_bucket if block_bucket and n_l >= big else None

        t0 = time.perf_counter()
        cand_d, cand_id = _allpairs_topk(packed_l, pops_l, n_l, k, qb, cb,
                                         bkt)
        _sync_if(stage_times, device)
        t1 = time.perf_counter()
        sel, sel_d = _select_layer(packed_l, pops_l, cand_d, cand_id, n_l,
                                   min(m, cap), heuristic_k, sb)
        del cand_d, cand_id
        _sync_if(stage_times, device)
        t2 = time.perf_counter()
        rows = _symmetrize(sel, sel_d, n_l, cap)
        neighbors.append(rows[:n_l].cpu().numpy())
        t3 = time.perf_counter()
        times["candidates"] += t1 - t0
        times["selection"] += t2 - t1
        times["symmetrization"] += t3 - t2
        logger.info("layer %d (n=%d, %s): %.2fs candidates, %.2fs "
                    "selection, %.2fs symmetrization", l, n_l,
                    f"bucket {bkt}" if bkt else "matrix", t1 - t0, t2 - t1,
                    t3 - t2)
        del sel, sel_d, rows

    return HNSWGraph(
        packed=packed,
        popcounts=pops_np,
        keys=keys,
        levels=levels,
        neighbors=tuple(neighbors),
        ndim=ndim,
        connectivity=m,
    )


def _sync_if(stage_times, device) -> None:
    """Wait for the device when stage times are being taken."""
    if stage_times is not None and torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
