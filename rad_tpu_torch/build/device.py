"""Neighbor-selection primitives shared by the builders.

The two pieces of ``rad_tpu.build.device`` the exact builder uses:
:func:`_dist_rows` (Tanimoto distance from a node to candidate ids) and
:func:`_select_neighbors` (the vectorized HNSW diversity heuristic with
backfill, Algorithm 4 of the HNSW paper).
"""

from __future__ import annotations

import torch

from rad_tpu_torch.fp.kernels import exact_fp32_matmul, unpack_bitmajor
from rad_tpu_torch.fp.pack import popcount
from rad_tpu_torch.fp.tanimoto import similarity_from_counts

__all__ = ["_dist_rows", "_select_neighbors"]

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


def _pairwise_intersections(rows: torch.Tensor) -> torch.Tensor:
    """``[B, K, W]`` packed rows → ``[B, K, K]`` exact intersection counts
    as f32, one batched fp32 matmul over unpacked 0/1 bits (exact: integer
    sums far below 2**24, TF32 off)."""
    bits = unpack_bitmajor(rows, torch.float32)           # [B, K, d]
    with exact_fp32_matmul():
        return torch.bmm(bits, bits.transpose(1, 2))


def _select_neighbors(packed, pops, q_ids, cand_d, cand_id, m: int,
                      heuristic_k: int, active):
    """Vectorized HNSW neighbor-selection heuristic with backfill.

    cand_d/cand_id: [B, K] ascending. Returns sel_ids [B, m] (-1 padded)
    in candidate order. A candidate is kept iff it is closer to the query
    than to every kept candidate; free slots then backfill with the
    nearest pruned candidates (keepPrunedConnections)."""
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
