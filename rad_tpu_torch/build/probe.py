"""Cluster-probed candidate generation for the exact builder.

The port of :mod:`rad_tpu.build.probe`, array-equal to it. The exact
builder's all-pairs stage is O(N²) distance evaluations; the probed stage
partitions a layer into balanced, contiguous clusters and lets every query
block scan only its ``probes`` most-proximate clusters — each scan still a
full bucket-kernel block, O(N·probes·csize) evaluations in all.

* :func:`bisect_clusters` — balanced two-anchor median bisection
  (score = d(x, a) − d(x, b) for two random members a, b of the current
  group, split at the median). Anchor scores are plain torch on the
  layer's device; each level's order is one stable host sort of a packed
  (group, score) u64 key.
* :func:`cluster_probes` / :func:`qblock_probes` — per-cluster or
  per-query-block probe lists by MIN distance over sampled members, the
  sampled distance sweeps through
  :func:`~rad_tpu_torch.fp.kernels.tanimoto_matrix` (its plain twin on the
  CPU).

Every random draw is the reference's ``numpy.random.default_rng`` draw in
the reference's order, so partitions and probe tables are array-equal.
The reference's fixed-shape dispatch padding (anchor padding, bounded
score chunks, overlapped distance chunks) is not carried: it changes no
output.
"""

from __future__ import annotations

import numpy as np
import torch

from rad_tpu_torch.devices import resolve_device
from rad_tpu_torch.fp.kernels import tanimoto_matrix
from rad_tpu_torch.fp.pack import popcount, popcount_rows

__all__ = ["bisect_clusters", "cluster_probes", "qblock_probes"]

# distance entries per sampled-sweep block (bounds the [rows, C*sample]
# f32 block, as the reference's chunking does)
_SWEEP_ENTRIES = 1 << 26


def _bisect_scores(rows, pops, anchors_a, anchors_b, group_id):
    """Median-split score per row, d(x, a_g) − d(x, b_g) in f32, with the
    reference's ``1 - inter / max(union, 1)`` (an empty pair scores
    distance 1, not 0)."""
    pops = pops.to(torch.float32)

    def dist(anchors):
        t = anchors[group_id]
        inter = popcount(rows & t).sum(-1).to(torch.float32)
        t_pop = popcount(t).sum(-1).to(torch.float32)
        union = pops + t_pop - inter
        return 1.0 - inter / torch.clamp(union, min=1.0)

    return dist(anchors_a) - dist(anchors_b)


def bisect_clusters(packed: np.ndarray, csize: int, seed: int = 0,
                    dev_rows: torch.Tensor | None = None) -> np.ndarray:
    """Partition ``n`` fingerprint rows into ``C = ceil(n / csize)``
    balanced clusters of exactly ``csize`` members each.

    Returns ``perm`` [C * csize] int32: ``perm[p]`` is the original row at
    permuted position ``p``; positions ``p // csize`` index clusters; the
    ``C*csize − n`` pad entries are −1 and occupy the tail.

    ``dev_rows``: the rows already on a device (int32 bit-view; rows past
    ``n`` are ignored) — the scores run there. Default: ``packed`` on the
    CPU.
    """
    n, w = packed.shape
    c = max(1, -(-n // csize))
    n_tot = c * csize
    rng = np.random.default_rng(seed)
    if c == 1:
        return np.concatenate(
            [np.arange(n, dtype=np.int32),
             np.full(n_tot - n, -1, np.int32)])
    if dev_rows is None:
        dev_rows = torch.from_numpy(np.ascontiguousarray(packed)
                                    .view(np.int32))
    rows = dev_rows[:n]
    dev = rows.device
    pops = popcount_rows(rows)

    ord_ = np.concatenate([np.arange(n, dtype=np.int64),
                           np.full(n_tot - n, -1, np.int64)])
    # groups as (start, n_clusters) spans over ord_; every split keeps
    # cluster-aligned boundaries so leaves are exactly csize
    groups = [(0, c)]
    while any(t > 1 for _, t in groups):
        live = [(s, t) for s, t in groups if t > 1]
        anchors_a = np.zeros((len(live), w), np.uint32)
        anchors_b = np.zeros((len(live), w), np.uint32)
        # rows of finished (leaf) groups keep group 0's anchors: their
        # scores still order them inside their leaf, as in the reference
        gid = np.zeros(n, np.int64)
        for gi, (s, t) in enumerate(live):
            members = ord_[s * csize:(s + t) * csize]
            real = members[members >= 0]
            gid[real] = gi
            if real.size >= 2:
                ai, bi = rng.choice(real.size, size=2, replace=False)
                anchors_a[gi] = packed[real[ai]]
                anchors_b[gi] = packed[real[bi]]
            elif real.size == 1:
                anchors_a[gi] = packed[real[0]]
        scores = _bisect_scores(
            rows, pops, torch.from_numpy(anchors_a.view(np.int32)).to(dev),
            torch.from_numpy(anchors_b.view(np.int32)).to(dev),
            torch.from_numpy(gid).to(dev)).cpu().numpy()
        gid_ord = np.empty(n_tot, np.uint64)
        s_ord = np.full(n_tot, np.inf, np.float32)
        for gi, (s, t) in enumerate(groups):
            gid_ord[s * csize:(s + t) * csize] = gi
        valid = ord_ >= 0
        # + 0.0 folds -0.0 into +0.0, which lexsort ties with it
        s_ord[valid] = scores[ord_[valid]] + np.float32(0.0)
        # one stable sort on a packed (group, score) u64 key — the float
        # bits map monotonically to u32; stability supplies the position
        # tie-break; pads (+inf) fall to each group's tail
        sb = s_ord.view(np.uint32)
        sb = np.where(sb & 0x80000000,
                      ~sb, sb | np.uint32(0x80000000)).astype(np.uint64)
        order = np.argsort((gid_ord << np.uint64(32)) | sb, kind="stable")
        ord_ = ord_[order]
        nxt = []
        for s, t in groups:
            if t == 1:
                nxt.append((s, t))
            else:
                tl = t // 2
                nxt.append((s, tl))
                nxt.append((s + tl, t - tl))
        groups = nxt
    return ord_.astype(np.int32)


def _sample_reps(packed, perm, group: int, n_groups: int, sample: int,
                 rng):
    """``[G, sample, W]`` sampled member rows of each ``group``-row span
    of ``perm`` (with replacement below ``sample`` members) and the mask
    of spans with no member."""
    w = packed.shape[1]
    reps = np.zeros((n_groups, sample, w), np.uint32)
    empty = np.zeros(n_groups, np.bool_)
    for gi in range(n_groups):
        members = perm[gi * group:(gi + 1) * group]
        real = members[members >= 0]
        if real.size == 0:
            empty[gi] = True
            continue
        take = rng.choice(real.size, size=sample, replace=real.size < sample)
        reps[gi] = packed[real[take]]
    return reps, empty


def _min_linkage(qreps: np.ndarray, reps: np.ndarray, device) -> np.ndarray:
    """``[G, C]`` min distance between each query group's and each
    cluster's sampled rows, in bounded query blocks."""
    g, sample, w = qreps.shape
    c = reps.shape[0]
    flat = torch.from_numpy(reps.reshape(-1, w).view(np.int32)).to(device)
    qflat = torch.from_numpy(qreps.reshape(-1, w).view(np.int32)).to(device)
    flat_pops = popcount_rows(flat)
    qcb = max(1, min(g, _SWEEP_ENTRIES // max(flat.shape[0], 1) // sample))
    out = np.empty((g, c), np.float32)
    for g0 in range(0, g, qcb):
        g1 = min(g0 + qcb, g)
        q = qflat[g0 * sample:g1 * sample]
        d = tanimoto_matrix(q, flat, popcount_rows(q), flat_pops)
        out[g0:g1] = d.reshape(g1 - g0, sample, c, sample).amin(
            dim=(1, 3)).cpu().numpy()
    return out


def cluster_probes(packed: np.ndarray, perm: np.ndarray, csize: int,
                   probes: int, sample: int = 16, seed: int = 0,
                   device=None) -> np.ndarray:
    """Per-cluster probe lists over a :func:`bisect_clusters` partition.

    Returns [C, probes] int32: cluster ``c``'s probe targets, ascending
    cluster id, −1-padded; the own cluster is always present. Proximity =
    MIN distance over ``sample``×``sample`` sampled member pairs, computed
    on ``device``.
    """
    c = perm.size // csize
    probes = min(probes, c)
    rng = np.random.default_rng(seed)
    reps, empty = _sample_reps(packed, perm, csize, c, sample, rng)
    dcc = _min_linkage(reps, reps, resolve_device(device))
    dcc[empty, :] = np.inf
    dcc[:, empty] = np.inf
    np.fill_diagonal(dcc, -1.0)  # self is always the first probe
    return _probe_lists(dcc, probes)


def _probe_lists(dmat: np.ndarray, probes: int) -> np.ndarray:
    """Top-``probes`` ascending-id probe lists from a proximity matrix
    (rows = scanning groups, cols = clusters; inf = never probe)."""
    order = np.argsort(dmat, axis=1, kind="stable")[:, :probes]
    chosen_d = np.take_along_axis(dmat, order, axis=1)
    out = np.where(np.isfinite(chosen_d), order, -1).astype(np.int32)
    # ascending cluster id per row (−1 pads last) → deterministic merges
    key = np.where(out >= 0, out, np.iinfo(np.int32).max)
    out = np.sort(key, axis=1)
    return np.where(out == np.iinfo(np.int32).max, -1, out).astype(np.int32)


def qblock_probes(packed: np.ndarray, perm: np.ndarray, csize: int,
                  q_block: int, probes: int, sample: int = 16,
                  seed: int = 0, device=None) -> np.ndarray:
    """Per-QUERY-BLOCK probe lists: each ``q_block``-row scan group picks
    its own ``probes`` nearest clusters by MIN distance from ``sample`` of
    its own members to each cluster's sampled members (same scan cost as
    :func:`cluster_probes`, finer coverage; at ``csize == q_block`` the two
    coincide). The group's own cluster is always its first probe.

    Returns [NQ, probes] int32, ascending cluster ids, −1-padded, where
    ``NQ = perm.size // q_block``.
    """
    c = perm.size // csize
    nq = perm.size // q_block
    qpc = csize // q_block
    probes = min(probes, c)
    rng = np.random.default_rng(seed)
    reps, empty = _sample_reps(packed, perm, csize, c, sample, rng)
    # at q_block == csize the scan groups ARE the clusters: same reps
    if q_block == csize:
        qreps, qempty = reps, empty
    else:
        qreps, qempty = _sample_reps(packed, perm, q_block, nq, sample, rng)
    dqc = _min_linkage(qreps, reps, resolve_device(device))
    dqc[qempty, :] = np.inf
    dqc[:, empty] = np.inf
    own = np.arange(nq) // qpc
    live_q = ~qempty & ~empty[own]
    dqc[np.flatnonzero(live_q), own[live_q]] = -1.0  # own cluster first
    return _probe_lists(dqc, probes)
