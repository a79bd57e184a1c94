"""The cluster-probed HNSW build, written out plainly: the reference for
the probed build cell.

A frozen statement of the graph that ``HNSWIndex.build(probes=...)``
makes, in plain torch and numpy, importing nothing of the program:

1. levels and node order as :mod:`portbench.reference.build`;
2. a layer ``l`` of ``n_l`` nodes probes when ``n_l >= probe_min_n``, it
   has at least ``4 * probes`` clusters (``C = ceil(n_l / csize)``), its
   ``k`` candidates fit a cluster and a cluster is a whole number of
   ``q_block`` rows; every other layer is the exact reference's. Its
   seed is ``s = level_seed * 1,000,003 + 7,919 (l + 1)``;
3. the partition: ``C * csize`` positions, the layer's ids in order and
   then ``-1`` pads. While a group spans more than one cluster, every
   such group (in position order) draws two distinct members ``a``, ``b``
   by ``default_rng(s).choice(members, 2, replace=False)`` (one member:
   ``a`` alone, ``b`` the empty row); each node scores ``d(x, a) - d(x,
   b)`` (f32, ``d = 1 - inter / max(union, 1)``) against its group's
   anchors, a node of a finished group against the first live group's;
   one stable sort by (group, score) orders every group, pads last, and
   each group of ``t`` clusters splits into its first ``t // 2`` and the
   rest;
4. the probe lists, ``default_rng(s + 1)``: ``sample`` members of each
   cluster, then of each ``q_block``-row group of positions (the
   clusters' own when ``q_block == csize``), each by ``choice(members,
   sample, replace=members < sample)``; the MIN distance over the two
   samples' pairs; a group with no member probes nothing and no one
   probes an empty cluster; a group's own cluster comes first (distance
   -1); the ``probes`` nearest by a stable sort, in ascending cluster id;
5. the scan of each real q-block (those that hold a node) over its
   probed clusters: per cluster, buckets of 64 columns, each offering its
   largest similarity with the 6 low mantissa bits cleared, ties to the
   last column, at distance ``1 -`` that truncated similarity; a winner
   that is the query itself or a pad is dropped. The winners of all the
   probed clusters, cluster by cluster, go through one stable sort by
   distance, and the first ``k`` are the row's candidates;
6. selection and symmetrization as in :mod:`portbench.reference.build`.

``sim_dtype`` rounds every similarity of the scan and the selection to a
lower precision: the control.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference.build import (BUCKET, INF, _round_up, _Rows,
                                       _select, _symmetrize, sample_levels)
from portbench.reference.tanimoto import (matmul_dtype, popcount,
                                          popcount_rows, similarity,
                                          unpack_bits)

CHUNK = 1 << 20     # rows a bisection score pass takes at once


def layer_unit(q_block: int, col_block: int, sel_block: int) -> int:
    """The program's layer unit: the size from which a layer takes the
    bucket scan and pads to a multiple of it (``max`` of its blocks)."""
    return max(q_block, col_block, sel_block)


def padded(n: int, n_l: int, big: int) -> int:
    """Columns a layer's scan covers: a multiple of ``big`` from ``big``
    nodes on; below, one shared size, ``min(big, 8192)`` or the whole
    library's padded size if smaller."""
    n_pad0 = _round_up(n, big) if n >= big else max(
        1 << max(n - 1, 1).bit_length(), 1024)
    small = min(big, 8192)
    if n_l >= big:
        return _round_up(n_l, big)
    if n_l <= small:
        return min(small, n_pad0)
    return min(_round_up(n_l, small), n_pad0)


def probes_layer(n_l: int, k: int, probes: int, csize: int, q_block: int,
                 probe_min_n: int) -> bool:
    """Whether a layer of ``n_l`` nodes takes the probed scan."""
    return (n_l >= probe_min_n and -(-n_l // csize) >= 4 * probes
            and k <= csize and csize % q_block == 0)


def layer_seed(level_seed: int, layer: int) -> int:
    return level_seed * 1_000_003 + 7919 * (layer + 1)


def _distance_to(words, pops_f, anchors):
    """f32 ``1 - inter / max(union, 1)`` of each row to its anchor row."""
    inter = popcount(words & anchors).sum(-1).to(torch.float32)
    union = pops_f + popcount(anchors).sum(-1).to(torch.float32) - inter
    return 1.0 - inter / torch.clamp(union, min=1.0)


def bisect(packed: np.ndarray, words: torch.Tensor, csize: int,
           seed: int) -> np.ndarray:
    """Item 3: ``[C * csize]`` int64, the layer id at each position, -1
    pads. ``packed`` the layer's rows on the host, ``words`` the same as
    int32 on the device."""
    n, w = packed.shape
    c = max(1, -(-n // csize))
    n_tot = c * csize
    rng = np.random.default_rng(seed)
    ord_ = np.concatenate([np.arange(n, dtype=np.int64),
                           np.full(n_tot - n, -1, np.int64)])
    if c == 1:
        return ord_
    dev = words.device
    pops_f = popcount_rows(words).to(torch.float32)
    groups = [(0, c)]
    while any(t > 1 for _, t in groups):
        live = [(s, t) for s, t in groups if t > 1]
        a = np.zeros((len(live), w), np.uint32)
        b = np.zeros((len(live), w), np.uint32)
        gid = np.zeros(n, np.int64)
        for gi, (s, t) in enumerate(live):
            members = ord_[s * csize:(s + t) * csize]
            real = members[members >= 0]
            gid[real] = gi
            if real.size >= 2:
                ia, ib = rng.choice(real.size, size=2, replace=False)
                a[gi], b[gi] = packed[real[ia]], packed[real[ib]]
            elif real.size == 1:
                a[gi] = packed[real[0]]
        a_t = torch.from_numpy(a.view(np.int32)).to(dev)
        b_t = torch.from_numpy(b.view(np.int32)).to(dev)
        g_t = torch.from_numpy(gid).to(dev)
        scores = np.empty(n, np.float32)
        for lo in range(0, n, CHUNK):
            hi = min(lo + CHUNK, n)
            g = g_t[lo:hi]
            scores[lo:hi] = (
                _distance_to(words[lo:hi], pops_f[lo:hi], a_t[g])
                - _distance_to(words[lo:hi], pops_f[lo:hi], b_t[g])
            ).cpu().numpy()
        group_of = np.empty(n_tot, np.uint64)
        for gi, (s, t) in enumerate(groups):
            group_of[s * csize:(s + t) * csize] = gi
        score = np.full(n_tot, np.inf, np.float32)
        real = ord_ >= 0
        score[real] = scores[ord_[real]] + np.float32(0.0)   # -0.0 -> +0.0
        # the float's bits made monotone as an unsigned key
        bits = score.view(np.uint32)
        bits = np.where(bits & 0x80000000, ~bits,
                        bits | np.uint32(0x80000000)).astype(np.uint64)
        ord_ = ord_[np.argsort((group_of << np.uint64(32)) | bits,
                               kind="stable")]
        groups = [half for s, t in groups
                  for half in ([(s, t)] if t == 1
                               else [(s, t // 2), (s + t // 2, t - t // 2)])]
    return ord_


def _sample(packed, perm, span: int, sample: int, rng):
    """``[G, sample, W]`` sampled members of each ``span``-position group
    and the mask of groups with none."""
    n_groups = perm.size // span
    reps = np.zeros((n_groups, sample, packed.shape[1]), np.uint32)
    empty = np.zeros(n_groups, np.bool_)
    for gi in range(n_groups):
        members = perm[gi * span:(gi + 1) * span]
        real = members[members >= 0]
        if real.size == 0:
            empty[gi] = True
            continue
        take = rng.choice(real.size, size=sample, replace=real.size < sample)
        reps[gi] = packed[real[take]]
    return reps, empty


def _min_distance(qreps, reps, device) -> np.ndarray:
    """``[G, C]`` MIN distance over each pair of sampled rows."""
    g, sample, w = qreps.shape
    c = reps.shape[0]
    words_q = torch.from_numpy(qreps.reshape(-1, w).view(np.int32)).to(device)
    words_c = torch.from_numpy(reps.reshape(-1, w).view(np.int32)).to(device)
    dtype = matmul_dtype(words_q.device)
    bits_c = unpack_bits(words_c, dtype)
    pops_c = popcount_rows(words_c).to(torch.float32)
    out = np.empty((g, c), np.float32)
    step = max(1, (1 << 24) // max(c * sample, 1))
    for g0 in range(0, g, step):
        q = words_q[g0 * sample:(g0 + step) * sample]
        inter = _mm(unpack_bits(q, dtype), bits_c)
        union = popcount_rows(q).to(torch.float32)[:, None] + pops_c[None, :]
        d = 1.0 - similarity(inter, union - inter)
        out[g0:g0 + step] = d.view(-1, sample, c, sample).amin(
            dim=(1, 3)).cpu().numpy()
    return out


def _mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """f32 ``a @ b.T`` of 0/1 rows (exact counts)."""
    if a.device.type == "cuda":
        return torch.mm(a, b.T, out_dtype=torch.float32)
    return a @ b.T


def probe_lists(packed, perm, csize: int, q_block: int, probes: int,
                sample: int, seed: int, device) -> np.ndarray:
    """Item 4: ``[C * csize / q_block, probes]`` cluster ids, -1 pads."""
    c = perm.size // csize
    nq = perm.size // q_block
    probes = min(probes, c)
    rng = np.random.default_rng(seed)
    reps, empty = _sample(packed, perm, csize, sample, rng)
    if q_block == csize:
        qreps, qempty = reps, empty
    else:
        qreps, qempty = _sample(packed, perm, q_block, sample, rng)
    d = _min_distance(qreps, reps, device)
    d[qempty, :] = np.inf
    d[:, empty] = np.inf
    own = np.arange(nq) // (csize // q_block)
    live = np.flatnonzero(~qempty & ~empty[own])
    d[live, own[live]] = -1.0
    order = np.argsort(d, axis=1, kind="stable")[:, :probes]
    near = np.take_along_axis(d, order, axis=1)
    ids = np.where(np.isfinite(near), order, np.iinfo(np.int32).max)
    ids = np.sort(ids, axis=1)
    return np.where(ids == np.iinfo(np.int32).max, -1, ids)


def _probed_candidates(rows: _Rows, packed_l: np.ndarray, n_l: int, k: int,
                       probes: int, csize: int, q_block: int, sample: int,
                       seed: int, sim_dtype):
    """Items 3-5 for one layer: ``[n_l, k]`` (distance, layer id),
    ascending, INF / -1 tails."""
    dev = rows.words.device
    perm_np = bisect(packed_l, rows.words[:n_l], csize, seed)
    tab = probe_lists(packed_l, perm_np, csize, q_block, probes, sample,
                      seed + 1, dev)
    perm = torch.from_numpy(perm_np).to(dev)
    src = torch.clamp(perm, min=0)
    pad = perm < 0
    bits = rows.bits[src].masked_fill_(pad[:, None], 0)
    pops = rows.pops[src].masked_fill_(pad, 0).to(torch.float32)
    # a node's row is never empty, so no real query's union is 0: the
    # divide runs at max(union, 1) (pad queries' rows are dropped)
    in_place = bool((rows.pops[:n_l] > 0).all())
    local = torch.arange(csize, device=dev, dtype=torch.int32) % BUCKET
    bucket_col = torch.arange(0, csize, BUCKET, device=dev)
    out_d = torch.full((n_l, k), INF, device=dev)
    out_i = torch.full((n_l, k), -1, dtype=torch.int64, device=dev)
    for qi in range(-(-n_l // q_block)):
        q0, q1 = qi * q_block, (qi + 1) * q_block
        q_pos = torch.arange(q0, q1, device=dev)[:, None]
        win_d, win_pos = [], []
        for ci in tab[qi].tolist():
            if ci < 0:
                continue
            c0 = ci * csize
            inter = _mm(bits[q0:q1], bits[c0:c0 + csize])
            union = pops[q0:q1, None] + pops[None, c0:c0 + csize]
            union -= inter
            if in_place and sim_dtype == torch.float32:
                sim = inter.div_(union.clamp_(min=1.0))
            else:
                sim = similarity(inter, union, sim_dtype)
            del union
            keys = sim.view(torch.int32)
            keys &= ~(BUCKET - 1)
            keys |= local
            win = keys.view(q_block, -1, BUCKET).amax(dim=2)
            del sim, keys, inter
            pos = c0 + bucket_col[None, :] + (win & (BUCKET - 1)).long()
            d = 1.0 - (win & ~(BUCKET - 1)).view(torch.float32)
            bad = pad[pos] | (pos == q_pos)
            win_d.append(d.masked_fill(bad, INF))
            win_pos.append(pos.masked_fill(bad, -1))
        d = torch.cat(win_d, 1)
        pos = torch.cat(win_pos, 1)
        sd, order = torch.sort(d, dim=1, stable=True)
        top = pos.gather(1, order[:, :k])
        ids = torch.where(top >= 0, perm[torch.clamp(top, min=0)], -1)
        width = min(k, d.shape[1])
        node = perm[q0:q1]
        real = node >= 0
        out_d[node[real], :width] = sd[real, :width]
        out_i[node[real], :width] = ids[real]
    return out_d, out_i


def _exact_candidates(rows: _Rows, n_l: int, n_pad: int, k: int,
                      bucketed: bool, sim_dtype, q_block: int = 2048):
    """Top-``k`` (distance, id) of every member over the first ``n_pad``
    rows, ascending, INF / -1 tails (:mod:`portbench.reference.build`'s
    item 2, its bucket scan from ``big`` nodes on)."""
    dev = rows.words.device
    out_d = torch.full((n_l, k), INF, device=dev)
    out_i = torch.full((n_l, k), -1, dtype=torch.int64, device=dev)
    col = torch.arange(n_pad, device=dev)
    local = (col % BUCKET).to(torch.int32)
    bucket_col = torch.arange(0, n_pad, BUCKET, device=dev)
    pc = rows.pops[:n_pad].to(torch.float32)
    for q0 in range(0, n_l, q_block):
        q1 = min(q0 + q_block, n_l)
        q_ids = torch.arange(q0, q1, device=dev)[:, None]
        inter = _mm(rows.bits[q0:q1], rows.bits[:n_pad])
        union = pc[None, :] + rows.pops[q0:q1].to(torch.float32)[:, None]
        sim = similarity(inter, union - inter, sim_dtype)
        del inter, union
        if bucketed:
            keys = sim.view(torch.int32)
            keys &= ~(BUCKET - 1)
            keys |= local
            win = keys.view(q1 - q0, -1, BUCKET).amax(dim=2)
            del sim, keys
            ids = bucket_col[None, :] + (win & (BUCKET - 1)).long()
            d = 1.0 - (win & ~(BUCKET - 1)).view(torch.float32)
        else:
            ids = col[None, :].expand(q1 - q0, -1)
            d = 1.0 - sim
        bad = (ids >= n_l) | (ids == q_ids)
        sd, order = torch.sort(d.masked_fill(bad, INF), dim=1, stable=True)
        width = min(k, sd.shape[1])     # a small layer may offer fewer
        out_d[q0:q1, :width] = sd[:, :width]
        out_i[q0:q1, :width] = ids.masked_fill(bad, -1).gather(
            1, order[:, :width])
    return out_d, out_i


def build(packed: np.ndarray, m: int, seed: int, device, probes: int,
          csize: int, sample: int, q_block: int, probe_min_n: int,
          col_block: int = 8192, sel_block: int = 2048,
          sim_dtype=torch.float32):
    """The reference graph of ``packed`` (``[n, W]`` uint32, input order)
    built with ``probes`` per q-block: ``(order, levels, [neighbours of
    layer l as [n_l, cap] int32], probed layers)``; ``order[i]`` is the
    input row of node ``i``. ``q_block``, ``col_block`` and ``sel_block``
    are the program's blocks (its defaults 4096, 8192 and 2048): they set
    the layers' padding and the size from which a layer takes the bucket
    scan, and change nothing else."""
    n = packed.shape[0]
    levels_raw = sample_levels(n, m, seed)
    order = np.lexsort((np.arange(n), -levels_raw))
    levels = levels_raw[order]
    ordered = np.ascontiguousarray(packed[order])
    max_level = int(levels[0]) if n else 0
    sizes = [int((levels >= l).sum()) for l in range(max_level + 1)]
    big = layer_unit(q_block, col_block, sel_block)
    n_cols = max(padded(n, s, big) for s in sizes)
    rows = _Rows(ordered, device, max(n_cols, n))
    heuristic_k = max(4 * m, 32)
    k_cand = max(heuristic_k, 4 * m)
    neighbours, probed = [], []
    for l, n_l in enumerate(sizes):
        cap = 2 * m if l == 0 else m
        if n_l <= 1:
            neighbours.append(np.full((n_l, cap), -1, np.int32))
            continue
        n_pad = padded(n, n_l, big)
        k = min(k_cand, n_pad)
        if probes_layer(n_l, k, probes, csize, q_block, probe_min_n):
            if n_l < big:
                raise ValueError(f"a probed layer of {n_l} nodes takes the "
                                 f"bucket scan only from {big} nodes")
            probed.append(l)
            cand_d, cand_i = _probed_candidates(
                rows, ordered[:n_l], n_l, k, probes, csize, q_block, sample,
                layer_seed(seed, l), sim_dtype)
        else:
            cand_d, cand_i = _exact_candidates(rows, n_l, n_pad, k,
                                               n_l >= big, sim_dtype)
        sel, sel_d = _select(rows, cand_d, cand_i, min(m, cap), heuristic_k,
                             sim_dtype, 8192)
        del cand_d, cand_i
        neighbours.append(_symmetrize(sel, sel_d, cap).to(torch.int32)
                          .cpu().numpy())
        del sel, sel_d
    del rows
    return order, levels, neighbours, probed
