"""Mesh-sharded stages of the exact builder: the distributed build.

The port of :mod:`rad_tpu.build.exact_sharded`.
``build_hnsw_exact(mesh=...)`` routes each big layer's three stages
through these stages and builds the same graph, edge for edge, as the
single-device build:

* candidates — q-blocks are independent, so shard ``i`` runs the
  single-device scan (:func:`rad_tpu_torch.build.exact._scan`: one bucket
  top-k call on big layers) over its own contiguous span of q-blocks
  against the replicated fingerprints; the candidate tables come out
  split by rows. Probed layers scan each shard's span of permuted
  q-blocks and scatter the results to the shards that own the rows;
* selection — rows are independent; each shard selects for its own rows;
* symmetrization — the one global stage: a directed selection (i → j, d)
  must reach row i's and row j's incident-edge tables. Each shard folds
  its own source rows' edges into a full-height per-destination table
  (:func:`_fold_edges`), one :func:`~rad_tpu_torch.parallel.collectives.
  all_to_all` hands every shard the D partial tables of its own rows, and
  each merge-reduces them (:func:`_merge_rows`). Every fold and merge is
  a lossless truncation to the per-destination top-``cap`` by (distance,
  src), so any merge tree yields the global answer; the (dst, src) pairs
  that mutual selections emit from two shards are deduplicated in the
  merge.

The mesh is single-controller (:mod:`rad_tpu_torch.parallel.mesh`): one
process runs every shard's work on that shard's device, in shard order.
The stage functions take and return :class:`~rad_tpu_torch.parallel.
collectives.ShardedRows`; the Pallas knobs of the reference's stages
(``use_pallas``, ``interpret``, ``approx_recall``, ``bucket_opts``) are
not carried over, and ``approx`` is the bucket kernel's
approximate-reciprocal epilogue (``bucket_approx``).
"""

from __future__ import annotations

import numpy as np
import torch

from rad_tpu_torch.build.device import _dist_rows, _select_neighbors
from rad_tpu_torch.build.exact import INF, _one_qblock_probed, _scan
from rad_tpu_torch.parallel.collectives import ShardedRows, all_to_all

__all__ = ["allpairs_topk_sharded", "probed_topk_sharded",
           "select_layer_sharded", "symmetrize_sharded", "replicate"]

# edge rows per symmetrization sort (the reference's bound)
SYMM_EDGES_PER_SORT = 1 << 22


def replicate(arr, mesh) -> list:
    """``arr`` on every device of ``mesh`` (flat order), as a list; a
    device that repeats shares one copy."""
    t = arr if torch.is_tensor(arr) else torch.from_numpy(np.asarray(arr))
    return [t.to(d) for d in mesh.devices.flat]


def _axis(mesh, axis: str):
    """``[(shard, device)]`` for the shards this process drives."""
    return [(s, d) for s, (d, local) in enumerate(mesh.axis_devices(axis))
            if local]


def _rows(mesh, axis: str, shards: dict, size: int, sentinel=False):
    d = mesh.shape[axis]
    return ShardedRows([shards.get(s) for s in range(d)], size, mesh.lead,
                       sentinel=sentinel, group=mesh.group)


def allpairs_topk_sharded(packed, pops, n_real: int, k: int, q_block: int,
                          col_block: int, bucket: int | None, mesh,
                          axis: str, approx: bool = False):
    """Sharded :func:`rad_tpu_torch.build.exact._allpairs_topk`: shard
    ``i`` computes q-blocks ``[i·s, (i+1)·s)`` with the single-device
    body, so every row's result is the single-device one. ``packed`` /
    ``pops`` are per-device replicas (:func:`replicate`, flat mesh order)
    of the padded layer; ``n_pad`` must split into whole q-blocks per
    shard. Returns row-split ([n_pad, k] dists, [n_pad, k] ids)."""
    n_pad = packed[0].shape[0]
    d_mesh = mesh.shape[axis]
    nq = n_pad // q_block
    if nq % d_mesh:
        raise ValueError(f"n_pad={n_pad} q-blocks ({nq}) must divide "
                         f"evenly over the {d_mesh}-device '{axis}' axis")
    s = nq // d_mesh
    out_d, out_i = {}, {}
    for i, _ in _axis(mesh, axis):
        out_d[i], out_i[i] = _scan(packed[i], pops[i], i * s * q_block,
                                   (i + 1) * s * q_block, n_real, k, q_block,
                                   col_block, bucket, approx)
    size = s * q_block
    return _rows(mesh, axis, out_d, size), _rows(mesh, axis, out_i, size)


def probed_topk_sharded(packed_cl, pops_cl, perm_cl, probe_tab, n_pad: int,
                        k: int, q_block: int, csize: int, bucket, mesh,
                        axis: str, approx: bool = False, n_real=None):
    """Sharded probed candidate stage: shard ``i`` runs the probed
    q-block body over its span of permuted q-blocks (the real ones:
    padding occupies the tail of permuted space), and each block's rows
    are scattered to the shards that own them. ``packed_cl`` /
    ``pops_cl`` / ``perm_cl`` are per-device replicas of the
    cluster-contiguous layer and its permutation, ``probe_tab`` the probe
    lists (numpy). Returns row-split ([n_pad, k] dists, [n_pad, k] layer
    ids) over ``n_pad`` rows, each shard with a sentinel slot."""
    d_mesh = mesh.shape[axis]
    nq_total = perm_cl[0].shape[0] // q_block
    nq = nq_total if n_real is None else -(-n_real // q_block)
    span = -(-nq // d_mesh)
    sdiv = 1 if probe_tab.shape[0] == nq_total else csize // q_block
    rs = n_pad // d_mesh
    shards = _axis(mesh, axis)
    cand_d = _rows(mesh, axis, {
        s: torch.full((rs + 1, k), INF, device=dv) for s, dv in shards},
        rs, sentinel=True)
    cand_i = _rows(mesh, axis, {
        s: torch.full((rs + 1, k), -1, dtype=torch.int32, device=dv)
        for s, dv in shards}, rs, sentinel=True)
    for i, _ in shards:
        for qi in range(i * span, min((i + 1) * span, nq)):
            q0 = qi * q_block
            bd, bpos = _one_qblock_probed(
                packed_cl[i], pops_cl[i], perm_cl[i],
                probe_tab[qi // sdiv].tolist(), q0, k, q_block, csize,
                bucket, approx)
            perm = perm_cl[i]
            ids = torch.where(bpos >= 0,
                              perm[torch.clamp(bpos, min=0).long()], -1)
            rows = perm[q0:q0 + q_block]         # -1 at pad positions
            cand_d[rows] = bd
            cand_i[rows] = ids
    return cand_d, cand_i


def select_layer_sharded(packed, pops, cand_d, cand_id, n_real: int,
                         m: int, heuristic_k: int, sel_block: int, mesh,
                         axis: str):
    """Sharded :func:`rad_tpu_torch.build.exact._select_layer`: each shard
    selects for its own rows from its candidate shard against its
    fingerprint replica. ``n_pad`` must split into ``sel_block`` chunks
    per shard. Returns row-split (sel [n_pad, m'], sel_d [n_pad, m'])."""
    d_mesh = mesh.shape[axis]
    rs = cand_d.shard_size
    n_pad = rs * d_mesh
    if rs % sel_block:
        raise ValueError(f"n_pad={n_pad} rows must split into "
                         f"sel_block={sel_block} chunks per device")
    k = cand_d.shape[1]
    width = min(m, min(heuristic_k, k))
    sel, sel_d = {}, {}
    for i, device in _axis(mesh, axis):
        cd, ci = cand_d.shards[i], cand_id.shards[i]
        p, pp = packed[i], pops[i]
        s_out = torch.full((rs, width), -1, dtype=torch.int32, device=device)
        d_out = torch.full((rs, width), INF, device=device)
        for c0 in range(0, rs, sel_block):
            r0 = i * rs + c0
            if r0 >= n_real:
                break
            qi = torch.arange(r0, r0 + sel_block, dtype=torch.int32,
                              device=device)
            active = qi < n_real
            safe_q = torch.clamp(qi, max=n_real - 1)
            s = _select_neighbors(p, pp, safe_q, cd[c0:c0 + sel_block],
                                  ci[c0:c0 + sel_block], m, heuristic_k,
                                  active)
            s_out[c0:c0 + sel_block] = s
            d_out[c0:c0 + sel_block] = _dist_rows(
                p, pp, safe_q, s, (s >= 0) & active[:, None])
        sel[i], sel_d[i] = s_out, d_out
    return _rows(mesh, axis, sel, rs), _rows(mesh, axis, sel_d, rs)


def _sort_d_src(d: torch.Tensor, s: torch.Tensor):
    """Row-wise lexicographic sort by (distance, src): two stable
    passes, least significant key first."""
    s, order = torch.sort(s, dim=1, stable=True)
    d = d.gather(1, order)
    d, order = torch.sort(d, dim=1, stable=True)
    return d, s.gather(1, order)


def _merge_rows(run_d, run_s, ch_d, ch_s, cap: int):
    """Fold a ``[rows, cap]`` (d, src) contribution into the running
    per-row table: sort by (d, src), drop adjacent same-src duplicates (a
    (dst, src) edge's copies carry one distance, so they sort together),
    sort again, truncate to ``cap`` (the reference's ``_merge_rows``)."""
    cat_d, cat_s = _sort_d_src(torch.cat([run_d, ch_d], 1),
                               torch.cat([run_s, ch_s], 1))
    dup = torch.zeros_like(cat_s, dtype=torch.bool)
    dup[:, 1:] = (cat_s[:, 1:] == cat_s[:, :-1]) & (cat_s[:, 1:] >= 0)
    cat_d, cat_s = _sort_d_src(cat_d.masked_fill(dup, INF),
                               cat_s.masked_fill(dup, -1))
    return cat_d[:, :cap], cat_s[:, :cap]


def _fold_edges(run_d, run_s, sel_sub, sel_d_sub, r0: int, n_real: int,
                cap: int):
    """Fold the edges of source rows ``[r0, r0 + b)`` (their selections
    ``sel_sub`` / ``sel_d_sub``) into the running full-height
    per-destination tables: forward + reverse edges sorted by (dst,
    distance, src), deduplicated, each destination's best ``cap`` kept
    and merged in (the reference's ``_fold_edges``)."""
    n_pad = run_d.shape[0]
    b, cc = sel_sub.shape
    device = sel_sub.device
    src = (r0 + torch.arange(b, dtype=torch.int32, device=device)
           ).repeat_interleave(cc)
    dst = sel_sub.reshape(-1)
    d = sel_d_sub.reshape(-1)
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
    dup = torch.zeros_like(sd_key, dtype=torch.bool)
    dup[1:] = (sd_key[1:] == sd_key[:-1]) & (ssrc[1:] == ssrc[:-1])
    valid = (sd_key < n_pad) & torch.isfinite(sdist) & ~dup
    first = torch.ones_like(valid)
    first[1:] = sd_key[1:] != sd_key[:-1]
    c = torch.cumsum(valid, 0)
    rank = c - 1 - torch.cummax(torch.where(first, c - valid.long(), -1),
                                0).values
    keep = valid & (rank < cap)
    flat = torch.where(keep, sd_key.long() * cap + rank, n_pad * cap)
    ch_s = torch.full(((n_pad + 1) * cap,), -1, dtype=torch.int32,
                      device=device)
    ch_d = torch.full(((n_pad + 1) * cap,), INF, device=device)
    ch_s[flat] = torch.where(keep, ssrc, -1)
    ch_d[flat] = sdist.masked_fill(~keep, INF)
    return _merge_rows(run_d, run_s, ch_d.view(n_pad + 1, cap)[:n_pad],
                       ch_s.view(n_pad + 1, cap)[:n_pad], cap)


def symmetrize_sharded(sel, sel_d, n_real: int, cap: int, mesh, axis: str,
                       edges_per_sort: int = SYMM_EDGES_PER_SORT):
    """Sharded per-destination top-``cap`` incident-edge merge: shard
    ``i`` folds the edges of its own source rows into a full-height
    ``[n_pad, cap]`` table (``edges_per_sort`` edge rows a fold), one
    all-to-all hands every shard the D partial tables of its own rows,
    and a merge in shard order finishes. The result equals the
    single-device :func:`rad_tpu_torch.build.exact._symmetrize`.
    ``sel`` / ``sel_d`` are row-split (ShardedRows or per-shard lists);
    returns the row-split ``[n_pad, cap]`` neighbor table."""
    d_mesh = mesh.shape[axis]
    shards = getattr(sel, "shards", sel)
    shards_d = getattr(sel_d, "shards", sel_d)
    rs, m = next(t for t in shards if t is not None).shape
    n_pad = rs * d_mesh
    b = max(1, min(rs, edges_per_sort // (2 * m)))
    blocks = [None] * d_mesh
    for i, device in _axis(mesh, axis):
        run_d = torch.full((n_pad, cap), INF, device=device)
        run_s = torch.full((n_pad, cap), -1, dtype=torch.int32,
                           device=device)
        for c0 in range(0, rs, b):
            run_d, run_s = _fold_edges(run_d, run_s, shards[i][c0:c0 + b],
                                       shards_d[i][c0:c0 + b], i * rs + c0,
                                       n_real, cap)
        blocks[i] = [(run_d[j * rs:(j + 1) * rs], run_s[j * rs:(j + 1) * rs])
                     for j in range(d_mesh)]
    devices = [d for d, _ in mesh.axis_devices(axis)]
    recv_d = all_to_all([None if x is None else [t[0] for t in x]
                         for x in blocks], devices, mesh.group)
    recv_s = all_to_all([None if x is None else [t[1] for t in x]
                         for x in blocks], devices, mesh.group)
    out = {}
    for j, _ in _axis(mesh, axis):
        out_d, out_s = recv_d[j][0], recv_s[j][0]
        for i in range(1, d_mesh):
            out_d, out_s = _merge_rows(out_d, out_s, recv_d[j][i],
                                       recv_s[j][i], cap)
        out[j] = out_s
    return _rows(mesh, axis, out, rs)
