"""Tanimoto distance over packed binary fingerprints (plain torch).

Distance ``1 - |a ∧ b| / |a ∨ b|`` over int32 bit-view rows, with the
conventions of :mod:`rad_tpu.fp.tanimoto`: a union of 0 counts as
similarity 1, and every divide is f32 ``inter / max(union, 1)``. These are
SWAR-popcount broadcasts — the reference math for small gathers — and
:func:`tanimoto_matrix_mxu`, the same matrix from one product of unpacked
0/1 operands. Large distance blocks go through the kernels in
:mod:`rad_tpu_torch.fp.kernels`.
"""

from __future__ import annotations

import torch

from rad_tpu_torch.fp.pack import popcount, popcount_rows

__all__ = [
    "tanimoto_rows_to_target",
    "tanimoto_distance",
    "tanimoto_matrix",
    "tanimoto_matrix_mxu",
    "unpack_to_dtype",
    "intersections_bf16",
    "bruteforce_topk",
    "bruteforce_topk_blocked",
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


def unpack_to_dtype(packed: torch.Tensor,
                    dtype=torch.bfloat16) -> torch.Tensor:
    """``[..., W]`` words → ``[..., W*32]`` 0/1 of ``dtype``, LSB-first per
    word (``rad_tpu.fp.tanimoto.unpack_to_dtype``)."""
    shifts = torch.arange(32, dtype=torch.int32, device=packed.device)
    bits = (packed[..., :, None] >> shifts) & 1
    return bits.reshape(*packed.shape[:-1], packed.shape[-1] * 32).to(dtype)


def intersections_bf16(a_bits: torch.Tensor,
                       b_bits: torch.Tensor) -> torch.Tensor:
    """``[A, D] x [B, D]`` 0/1 → ``[A, B]`` f32 intersection counts,
    exact: on the card one bf16 tensor-core product summed and written in
    f32; on the CPU the same product of the same values in f32."""
    if a_bits.device.type == "cuda":
        return torch.mm(a_bits.to(torch.bfloat16),
                        b_bits.to(torch.bfloat16).T, out_dtype=torch.float32)
    from rad_tpu_torch.fp.kernels import exact_fp32_matmul

    with exact_fp32_matmul():
        return a_bits.float() @ b_bits.float().T


def tanimoto_matrix_mxu(q_unpacked: torch.Tensor, db_unpacked: torch.Tensor,
                        q_pops: torch.Tensor,
                        db_pops: torch.Tensor) -> torch.Tensor:
    """``[B, N]`` f32 distances from pre-unpacked 0/1 operands (``[B, d]``,
    ``[N, d]``, e.g. from :func:`unpack_to_dtype`) and row popcounts, by
    one product (:func:`intersections_bf16`) and the reference's f32
    epilogue ``1 - inter / max(union, 1)``."""
    inter = intersections_bf16(q_unpacked, db_unpacked)
    union = (q_pops[:, None].to(torch.float32)
             + db_pops[None, :].to(torch.float32) - inter)
    sim = torch.where(union > 0, inter / torch.clamp(union, min=1.0),
                      torch.ones_like(inter))
    return 1.0 - sim


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


def bruteforce_topk_blocked(queries: torch.Tensor, db: torch.Tensor, k: int,
                            block: int = 1 << 16):
    """Memory-bounded exact k-NN (``rad_tpu.fp.tanimoto.
    bruteforce_topk_blocked``): a running ``[B, k]`` top-k merged with one
    ``block``-row distance block at a time, so the ``[B, N]`` matrix never
    exists. ``db`` is padded with empty rows to a whole number of blocks;
    those rows, and the initial ``(inf, -1)`` entries that fill the result
    when ``N < k``, sort last. Ties keep the smaller id. Each block's
    distances come from :func:`rad_tpu_torch.fp.kernels.tanimoto_matrix`
    (the CUDA kernel on the card, its plain twin on the CPU: the same
    values as :func:`tanimoto_matrix`, without its ``[B, block, W]``
    intermediate)."""
    from rad_tpu_torch.fp.kernels import tanimoto_matrix as matrix_kernel

    b = queries.shape[0]
    n, w = db.shape
    dev = queries.device
    nblocks = -(-n // block)
    pad = nblocks * block - n
    if pad:
        db = torch.cat([db, torch.zeros((pad, w), dtype=db.dtype,
                                        device=db.device)])
    q_pops, db_pops = popcount_rows(queries), popcount_rows(db)
    best_d = torch.full((b, k), INF, device=dev)
    best_i = torch.full((b, k), -1, dtype=torch.int64, device=dev)
    col = torch.arange(block, device=dev)
    for lo in range(0, nblocks * block, block):
        ids = lo + col
        d = matrix_kernel(queries, db[lo:lo + block], q_pops,
                          db_pops[lo:lo + block])
        d = d.masked_fill((ids >= n)[None, :], INF)
        cat_d = torch.cat([best_d, d], dim=1)
        cat_i = torch.cat([best_i, ids.expand(b, -1)], dim=1)
        sd, order = torch.sort(cat_d, dim=1, stable=True)
        best_d = sd[:, :k]
        best_i = cat_i.gather(1, order[:, :k])
    return best_d, best_i
