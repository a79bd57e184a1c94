"""Tanimoto distance over packed binary fingerprints (plain torch).

Distance ``1 - |a ∧ b| / |a ∨ b|`` over int32 bit-view rows, with the
conventions of :mod:`rad_tpu.fp.tanimoto`: a union of 0 counts as
similarity 1, and every divide is f32 ``inter / max(union, 1)``. These are
SWAR-popcount broadcasts — the reference math for small gathers. Large
distance blocks go through the kernels in :mod:`rad_tpu_torch.fp.kernels`.
"""

from __future__ import annotations

import torch

from rad_tpu_torch.fp.pack import popcount

__all__ = [
    "tanimoto_rows_to_target",
    "tanimoto_distance",
    "tanimoto_matrix",
    "bruteforce_topk",
    "similarity_from_counts",
]

INF = float("inf")


def similarity_from_counts(inter: torch.Tensor,
                           union: torch.Tensor) -> torch.Tensor:
    """f32 similarity ``inter / max(union, 1)``, 1 where ``union == 0``.

    Both counts are exact integers (< 2**24), so converting them to f32
    before the divide gives the same bits as JAX's int32 true divide."""
    inter = inter.to(torch.float32)
    union = union.to(torch.float32)
    return torch.where(union > 0, inter / torch.clamp(union, min=1.0),
                       torch.ones_like(inter))


def tanimoto_rows_to_target(rows: torch.Tensor, row_pops: torch.Tensor,
                            target_packed: torch.Tensor, target_pop,
                            valid: torch.Tensor | None = None
                            ) -> torch.Tensor:
    """``1 - Tanimoto(rows[i], target)`` (f32), ``+inf`` where ``valid``
    is False — the candidate scorer of ``rad_tpu``'s engines."""
    inter = popcount(rows & target_packed[None, :]).sum(-1)
    union = target_pop + row_pops - inter
    d = 1.0 - similarity_from_counts(inter, union)
    return d if valid is None else torch.where(valid, d,
                                               torch.full_like(d, INF))


def tanimoto_distance(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Tanimoto distance between packed rows (broadcasting over leading
    dims): ``[..., W]`` x ``[..., W]`` → ``[...]`` f32."""
    inter = popcount(a & b).sum(-1, dtype=torch.int32)
    union = popcount(a | b).sum(-1, dtype=torch.int32)
    return 1.0 - similarity_from_counts(inter, union)


def tanimoto_matrix(queries: torch.Tensor, db: torch.Tensor) -> torch.Tensor:
    """Dense ``[B, N]`` distance matrix via SWAR popcount (materializes a
    ``[B, N, W]`` intermediate — small blocks only)."""
    return tanimoto_distance(queries[:, None, :], db[None, :, :])


def bruteforce_topk(queries: torch.Tensor, db: torch.Tensor, k: int,
                    block: int | None = None):
    """Exact k-NN by Tanimoto distance: ``([B, k] dists, [B, k] ids)``.

    Ties resolve to the smaller id, as ``lax.top_k`` does in the
    reference. The scan runs over db blocks of ``block`` rows (default:
    bounded so one SWAR block holds ~4M pairs), merging a running top-k
    with a stable sort — the same result as one global stable sort, since
    earlier blocks hold the smaller ids.
    """
    b = queries.shape[0]
    n = db.shape[0]
    if block is None:
        block = max(1, (1 << 22) // max(b, 1))
    best_d = torch.full((b, 0), INF, device=queries.device)
    best_i = torch.full((b, 0), -1, dtype=torch.int64, device=queries.device)
    for lo in range(0, n, block):
        d = tanimoto_matrix(queries, db[lo:lo + block])
        ids = torch.arange(lo, lo + d.shape[1], device=queries.device)
        cat_d = torch.cat([best_d, d], dim=1)
        cat_i = torch.cat([best_i, ids.expand(b, -1)], dim=1)
        sd, order = torch.sort(cat_d, dim=1, stable=True)
        best_d = sd[:, :k]
        best_i = cat_i.gather(1, order[:, :k])
    return best_d, best_i
