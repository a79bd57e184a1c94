"""The exact HNSW build, written out plainly: the reference for the build
cell and for the graph that the API cell traverses.

A frozen statement of the graph that ``HNSWIndex.build()`` makes below
its probing threshold, in plain torch, importing nothing of the program:

1. levels ``floor(-ln(u) / ln(M))`` from ``numpy.random.default_rng
   (seed).random(n)``; nodes ordered by level descending, then by input
   position;
2. per layer ``l`` (its first ``n_l`` nodes), each node's candidates: the
   ``K`` nearest by Tanimoto distance, ties to the smaller id, self and
   non-members excluded. On a layer of at least ``BIG`` nodes the columns
   (the first ``n_pad`` rows, ``n_pad`` = ``n_l`` rounded up to ``BIG``;
   rows past ``n_l`` are zero padding or nodes of the layer below) fall in
   buckets of 64; each bucket offers one winner, the largest similarity
   with its 6 low mantissa bits cleared, ties to the last column, and its
   distance is ``1 -`` that truncated similarity; the winner is dropped
   when it is the query itself or not a member, so that bucket offers
   nothing. Smaller layers rank every column, exactly;
3. selection: walking the first 64 candidates in order, keep one when no
   kept candidate lies at or below its candidate distance from it
   (pairwise distances exact), up to M; then fill free slots with the
   pruned ones in order;
4. symmetrization: every selection ``i -> j`` at exact distance ``d``
   gives edges ``(i, j)`` and ``(j, i)``; each row keeps its ``cap`` best
   distinct entrants ordered by (distance, source), ``cap = 2M`` on layer
   0 and ``M`` above, ``-1`` padded.

``sim_dtype`` rounds every similarity to a lower precision: the control.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from portbench.reference.tanimoto import (matmul_dtype, popcount_rows,
                                          similarity, unpack_bits)

INF = float("inf")
BIG = 8192          # the layer size from which the bucket path runs
BUCKET = 64


def sample_levels(n: int, m: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    mult = 1.0 / math.log(max(m, 2))
    u = rng.random(n)
    return np.floor(-np.log(np.clip(u, 1e-300, 1.0)) * mult).astype(np.int32)


def _round_up(x: int, mult: int) -> int:
    return -(-x // mult) * mult


def _padded(n: int, n_l: int) -> int:
    """Columns a layer's candidate scan covers."""
    n_pad0 = _round_up(n, BIG) if n >= BIG else max(
        1 << max(n - 1, 1).bit_length(), 1024)
    if n_l >= BIG:
        return _round_up(n_l, BIG)
    if n_l <= BIG:
        return min(BIG, n_pad0)
    return min(_round_up(n_l, BIG), n_pad0)


class _Rows:
    """The ordered library on the device: words, popcounts and 0/1 bits
    for the products."""

    def __init__(self, packed: np.ndarray, device, n_cols: int):
        n, w = packed.shape
        pad = np.zeros((n_cols - n, w), np.uint32) if n_cols > n else \
            np.zeros((0, w), np.uint32)
        words = np.concatenate([packed, pad]).view(np.int32)
        self.words = torch.from_numpy(words).to(device)
        self.pops = popcount_rows(self.words)
        self.dtype = matmul_dtype(self.words.device)
        self.bits = torch.empty((self.words.shape[0], w * 32),
                                dtype=self.dtype, device=device)
        for lo in range(0, self.words.shape[0], 1 << 16):
            self.bits[lo:lo + (1 << 16)] = unpack_bits(
                self.words[lo:lo + (1 << 16)], self.dtype)

    def inter(self, q0: int, q1: int, c1: int) -> torch.Tensor:
        """``[q1 - q0, c1]`` f32 intersections of rows ``[q0, q1)`` with
        rows ``[0, c1)``."""
        a, b = self.bits[q0:q1], self.bits[:c1].T
        if a.device.type == "cuda":
            return torch.mm(a, b, out_dtype=torch.float32)
        return a @ b


def _candidates(rows: _Rows, n_l: int, n_pad: int, k: int, sim_dtype,
                q_block: int):
    """Top-``k`` (distance, id) of every member, ascending, INF/-1 tails."""
    dev = rows.words.device
    out_d = torch.full((n_l, k), INF, device=dev)
    out_i = torch.full((n_l, k), -1, dtype=torch.int64, device=dev)
    col = torch.arange(n_pad, device=dev)
    bucketed = n_l >= BIG
    if bucketed:
        local = (col % BUCKET).to(torch.int32)
        bucket_col = torch.arange(0, n_pad, BUCKET, device=dev)
    pc = rows.pops[:n_pad].to(torch.float32)
    # a member's row is never empty, so no union is 0 and the divide runs
    # in place (the general form where one is)
    in_place = bool((rows.pops[:n_l] > 0).all())
    for q0 in range(0, n_l, q_block):
        q1 = min(q0 + q_block, n_l)
        q_ids = torch.arange(q0, q1, device=dev)[:, None]
        inter = rows.inter(q0, q1, n_pad)
        union = pc[None, :] + rows.pops[q0:q1].to(torch.float32)[:, None]
        union -= inter
        if in_place:
            sim = inter.div_(union)
            if sim_dtype != torch.float32:
                sim = sim.to(sim_dtype).to(torch.float32)
        else:
            sim = similarity(inter, union, sim_dtype)
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
        d = d.masked_fill(bad, INF)
        ids = ids.masked_fill(bad, -1)
        sd, order = torch.sort(d, dim=1, stable=True)
        out_d[q0:q1] = sd[:, :k]
        out_i[q0:q1] = ids.gather(1, order[:, :k])
        del d, ids, sd, order
    return out_d, out_i


def _dist_pairs(rows: _Rows, a: torch.Tensor, b: torch.Tensor,
                sim_dtype) -> torch.Tensor:
    """Exact distances between rows ``a [B, K]`` and ``b [B, J]``."""
    inter = torch.bmm(rows.bits[a], rows.bits[b].transpose(1, 2)).to(
        torch.float32)
    pa = rows.pops[a].to(torch.float32)
    pb = rows.pops[b].to(torch.float32)
    return 1.0 - similarity(inter, pa[:, :, None] + pb[:, None, :] - inter,
                            sim_dtype)


def _select(rows: _Rows, cand_d, cand_i, m: int, heuristic_k: int,
            sim_dtype, block: int):
    """Selection of every member: ``(sel [n_l, m] ids, sel_d)``."""
    n_l, k = cand_d.shape
    kh = min(heuristic_k, k)
    dev = cand_d.device
    sel = torch.full((n_l, m), -1, dtype=torch.int64, device=dev)
    sel_d = torch.full((n_l, m), INF, device=dev)
    for r0 in range(0, n_l, block):
        r1 = min(r0 + block, n_l)
        top_d, top_i = cand_d[r0:r1, :kh], cand_i[r0:r1, :kh]
        valid = torch.isfinite(top_d) & (top_i >= 0)
        safe = torch.clamp(top_i, min=0)
        pair_d = _dist_pairs(rows, safe, safe, sim_dtype)
        b = r1 - r0
        mask = torch.zeros((b, kh), dtype=torch.bool, device=dev)
        n_sel = torch.zeros((b,), dtype=torch.int64, device=dev)
        for j in range(kh):
            viol = (mask & (pair_d[:, j, :] <= top_d[:, j, None])).any(1)
            take = valid[:, j] & ~viol & (n_sel < m)
            mask[:, j] = take
            n_sel += take
        for j in range(kh):
            take = valid[:, j] & ~mask[:, j] & (n_sel < m)
            mask[:, j] |= take
            n_sel += take
        pos = torch.arange(kh, device=dev)
        order = torch.sort(torch.where(mask, pos[None, :], kh), dim=1,
                           stable=True).indices
        s = torch.where(mask, top_i, -1).gather(1, order)[:, :m]
        width = s.shape[1]
        sel[r0:r1, :width] = s
        q = torch.arange(r0, r1, device=dev)[:, None]
        d = _dist_pairs(rows, q, torch.clamp(s, min=0), sim_dtype)[:, 0, :]
        sel_d[r0:r1, :width] = d.masked_fill(s < 0, INF)
    return sel, sel_d


def _symmetrize(sel, sel_d, cap: int) -> torch.Tensor:
    n_l, m = sel.shape
    dev = sel.device
    src = torch.arange(n_l, device=dev).repeat_interleave(m)
    dst = sel.reshape(-1)
    d = sel_d.reshape(-1)
    ok = dst >= 0
    # (destination, distance, source) of every forward and reverse edge
    e_dst = torch.cat([torch.where(ok, dst, n_l), torch.where(ok, src, n_l)])
    e_src = torch.cat([src, torch.where(ok, dst, n_l)])
    e_d = torch.cat([d.masked_fill(~ok, INF)] * 2)
    perm = torch.sort(e_src, stable=True).indices
    perm = perm[torch.sort(e_d[perm], stable=True).indices]
    perm = perm[torch.sort(e_dst[perm], stable=True).indices]
    kd, dd, ks = e_dst[perm], e_d[perm], e_src[perm]
    dup = torch.zeros_like(kd, dtype=torch.bool)
    dup[1:] = (kd[1:] == kd[:-1]) & (ks[1:] == ks[:-1])
    valid = (kd < n_l) & torch.isfinite(dd) & ~dup
    first = torch.ones_like(kd, dtype=torch.bool)
    first[1:] = kd[1:] != kd[:-1]
    c = torch.cumsum(valid.long(), 0)
    base = torch.where(first, c - valid.long(), -1)
    rank = c - 1 - torch.cummax(base, 0).values
    keep = valid & (rank < cap)
    out = torch.full(((n_l + 1) * cap,), -1, dtype=torch.int64, device=dev)
    out[torch.where(keep, kd * cap + rank, n_l * cap)] = torch.where(
        keep, ks, -1)
    return out.view(n_l + 1, cap)[:n_l]


def build(packed: np.ndarray, m: int, seed: int, device,
          sim_dtype=torch.float32, q_block: int = 2048,
          sel_block: int = 8192):
    """The reference graph of ``packed`` (``[n, W]`` uint32, input order):
    ``(order, levels, [neighbours of layer l as [n_l, cap] int32])``;
    ``order[i]`` is the input row of node ``i``."""
    n = packed.shape[0]
    levels_raw = sample_levels(n, m, seed)
    order = np.lexsort((np.arange(n), -levels_raw))
    levels = levels_raw[order]
    max_level = int(levels[0]) if n else 0
    sizes = [int((levels >= l).sum()) for l in range(max_level + 1)]
    n_cols = max(_padded(n, s) for s in sizes)
    rows = _Rows(packed[order], device, max(n_cols, n))
    heuristic_k = max(4 * m, 32)
    k_cand = max(heuristic_k, 4 * m)
    neighbours = []
    for l, n_l in enumerate(sizes):
        cap = 2 * m if l == 0 else m
        if n_l <= 1:
            neighbours.append(np.full((n_l, cap), -1, np.int32))
            continue
        n_pad = _padded(n, n_l)
        k = min(k_cand, n_pad)
        cand_d, cand_i = _candidates(rows, n_l, n_pad, k, sim_dtype, q_block)
        sel, sel_d = _select(rows, cand_d, cand_i, min(m, cap), heuristic_k,
                             sim_dtype, sel_block)
        del cand_d, cand_i
        neighbours.append(_symmetrize(sel, sel_d, cap).to(torch.int32)
                          .cpu().numpy())
        del sel, sel_d
    del rows
    return order, levels, neighbours
