"""Tanimoto kernels over packed fingerprints: CUDA on the card, plain
torch on the CPU.

Two kernels, both in ``csrc/tanimoto.cu`` (see its header for the design
and what bounds it on an H100):

* :func:`tanimoto_matrix` — full ``[Q, N]`` f32 distance block; replaces
  ``rad_tpu.fp.kernels.tanimoto_matrix_pallas``;
* :func:`tanimoto_bucketmin` — one packed int32 key per query and per
  aligned run of ``bucket`` db rows (the f32 similarity's bits with the
  low ``log2(bucket)`` bits replaced by the in-bucket index, max over the
  bucket: winner sim AND position, equal sims to the larger index);
  replaces ``rad_tpu.fp.kernels.tanimoto_bucketmin_pallas``. Output is
  ``[Q, N / bucket]``, the orientation the JAX wrapper returns. With
  ``approx=True`` it runs the kernel's approximate-reciprocal epilogue
  instance (the reference's ``approx=True``).

Each public wrapper runs its ``*_plain`` twin for CPU tensors only; for a
CUDA tensor it launches the kernel or raises. ``<wrapper>.launches`` counts
kernel launches (the twin never counts); the approximate epilogue counts in
``tanimoto_bucketmin.approx_launches``.

Inputs are int32 bit-views of packed uint32 words; popcounts may be passed
precomputed (int32) to skip recounting.
"""

from __future__ import annotations

import contextlib
import ctypes

import torch

from rad_tpu_torch.fp.pack import popcount_rows
from rad_tpu_torch.fp.tanimoto import similarity_from_counts

__all__ = [
    "tanimoto_matrix",
    "tanimoto_matrix_plain",
    "tanimoto_bucketmin",
    "tanimoto_bucketmin_plain",
    "decode_bucket_keys",
    "unpack_bitmajor",
    "exact_fp32_matmul",
]


def unpack_bitmajor(packed: torch.Tensor,
                    dtype=torch.float32) -> torch.Tensor:
    """Unpack ``[..., W]`` 32-bit words → ``[..., W*32]`` 0/1 in bit-major
    order: feature ``b * (W*4) + byte`` is bit ``b`` of byte ``byte`` (the
    permutation of ``rad_tpu.fp.kernels.unpack_bitmajor``). Any fixed
    permutation leaves dot products, and hence Tanimoto, unchanged."""
    *lead, w = packed.shape
    as_bytes = packed.contiguous().view(torch.uint8).reshape(*lead, w * 4)
    shifts = torch.arange(8, dtype=torch.uint8, device=packed.device)
    bits = (as_bytes[..., None, :] >> shifts[:, None]) & 1
    return bits.reshape(*lead, 8 * w * 4).to(dtype)


@contextlib.contextmanager
def exact_fp32_matmul():
    """fp32 matmuls in full fp32 (TF32 off) for the block's duration.

    0/1 products summed in fp32 are exact integers below 2**24, so an
    intersection count from a matmul is exact — unless TF32 rounds the
    operands or the partial sums."""
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev


def _pops(packed, pops):
    return popcount_rows(packed) if pops is None else pops


def _similarity_plain(q, db, q_pops, db_pops,
                      approx: bool = False) -> torch.Tensor:
    """``[Q, N]`` f32 similarity: exact intersections from an fp32 matmul
    of unpacked bits, then the kernels' epilogue — with ``approx``, the
    f32 reciprocal of ``max(union, 1)`` times the intersection."""
    with exact_fp32_matmul():
        inter = unpack_bitmajor(q) @ unpack_bitmajor(db).T
    union = (_pops(q, q_pops).to(torch.float32)[:, None]
             + _pops(db, db_pops).to(torch.float32)[None, :]) - inter
    if approx:
        sim = inter * torch.reciprocal(torch.clamp(union, min=1.0))
        return torch.where(union > 0, sim, torch.ones_like(sim))
    return similarity_from_counts(inter, union)


def tanimoto_matrix_plain(q: torch.Tensor, db: torch.Tensor,
                          q_pops: torch.Tensor | None = None,
                          db_pops: torch.Tensor | None = None
                          ) -> torch.Tensor:
    """Plain-torch twin of :func:`tanimoto_matrix`: ``[Q, N]`` f32
    distances ``1 - sim``."""
    return 1.0 - _similarity_plain(q, db, q_pops, db_pops)


def tanimoto_bucketmin_plain(q: torch.Tensor, db: torch.Tensor,
                             bucket: int = 64,
                             q_pops: torch.Tensor | None = None,
                             db_pops: torch.Tensor | None = None,
                             approx: bool = False) -> torch.Tensor:
    """Plain-torch twin of :func:`tanimoto_bucketmin`: ``[Q, N/bucket]``
    int32 keys."""
    _check_bucket(db.shape[0], bucket)
    sim = _similarity_plain(q, db, q_pops, db_pops, approx)
    local = torch.arange(db.shape[0], dtype=torch.int32,
                         device=db.device) % bucket
    keys = (sim.view(torch.int32) & ~(bucket - 1)) | local
    return keys.reshape(q.shape[0], -1, bucket).amax(dim=2)


def decode_bucket_keys(keys: torch.Tensor, bucket: int):
    """Bucket keys → ``(dist, global_col)``: dist carries the truncated
    similarity (low ``log2(bucket)`` mantissa bits zeroed); ids are exact."""
    local = keys & (bucket - 1)
    sim = (keys & ~(bucket - 1)).view(torch.float32)
    col = torch.arange(keys.shape[-1], dtype=torch.int32,
                       device=keys.device) * bucket
    return 1.0 - sim, col + local


def _check_bucket(n: int, bucket: int) -> None:
    if bucket <= 0 or bucket & (bucket - 1) or n % bucket:
        raise ValueError(f"bucket={bucket} must be a power of two dividing "
                         f"the db rows ({n})")


def _check_inputs(q, db, q_pops, db_pops):
    if q.dim() != 2 or db.dim() != 2 or q.shape[1] != db.shape[1]:
        raise ValueError(f"expected [Q, W] and [N, W] packed words, got "
                         f"{tuple(q.shape)} and {tuple(db.shape)}")
    if q.dtype != torch.int32 or db.dtype != torch.int32:
        raise TypeError("packed fingerprints must be int32 bit-views")
    if q.device != db.device:
        raise ValueError(f"q on {q.device} but db on {db.device}")
    for name, p, rows in (("q_pops", q_pops, q.shape[0]),
                          ("db_pops", db_pops, db.shape[0])):
        if p is not None and (p.dtype != torch.int32 or p.device != q.device
                              or tuple(p.shape) != (rows,)):
            raise ValueError(f"{name} must be int32 [{rows}] on {q.device}")


def _launch(entry: str, q, db, q_pops, db_pops, *extra, out) -> None:
    """Call C entry point ``entry`` of the kernel library on ``q``'s
    current CUDA stream; raise on a launch error."""
    from rad_tpu_torch import _cuda

    lib = _cuda.load_library()
    ptr = ctypes.c_void_p
    with torch.cuda.device(q.device):
        q, db = q.contiguous(), db.contiguous()
        qp = _pops(q, q_pops).contiguous()
        dp = _pops(db, db_pops).contiguous()
        stream = torch.cuda.current_stream(q.device).cuda_stream
        code = getattr(lib, entry)(
            ptr(q.data_ptr()), ptr(qp.data_ptr()), q.shape[0],
            ptr(db.data_ptr()), ptr(dp.data_ptr()), db.shape[0], q.shape[1],
            *extra, ptr(out.data_ptr()), ptr(stream))
    _cuda.check(code, entry)


def tanimoto_matrix(q: torch.Tensor, db: torch.Tensor,
                    q_pops: torch.Tensor | None = None,
                    db_pops: torch.Tensor | None = None) -> torch.Tensor:
    """``[Q, N]`` f32 Tanimoto distances (0 where both rows are empty)."""
    _check_inputs(q, db, q_pops, db_pops)
    if q.device.type == "cpu":
        return tanimoto_matrix_plain(q, db, q_pops, db_pops)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    out = torch.empty((q.shape[0], db.shape[0]), dtype=torch.float32,
                      device=q.device)
    _launch("rad_tanimoto_matrix", q, db, q_pops, db_pops, out=out)
    tanimoto_matrix.launches += 1
    return out


tanimoto_matrix.launches = 0


def tanimoto_bucketmin(q: torch.Tensor, db: torch.Tensor, bucket: int = 64,
                       q_pops: torch.Tensor | None = None,
                       db_pops: torch.Tensor | None = None,
                       approx: bool = False) -> torch.Tensor:
    """Distance-min winner per ``bucket`` db rows as packed int32 keys
    ``[Q, N / bucket]``; decode with :func:`decode_bucket_keys`.

    ``approx=True`` swaps the exact f32 divide for the approximate
    reciprocal (the reference's ``approx=True``): winners can differ among
    near-ties, and decoded distances by a few ulp."""
    _check_inputs(q, db, q_pops, db_pops)
    _check_bucket(db.shape[0], bucket)
    if q.device.type == "cpu":
        return tanimoto_bucketmin_plain(q, db, bucket, q_pops, db_pops,
                                        approx)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    if bucket > 64 or db.shape[0] % 64:
        raise ValueError(f"the CUDA bucket kernel needs bucket <= 64 and db "
                         f"rows % 64 == 0 (bucket={bucket}, "
                         f"rows={db.shape[0]})")
    out = torch.empty((q.shape[0], db.shape[0] // bucket),
                      dtype=torch.int32, device=q.device)
    _launch("rad_tanimoto_bucketmin", q, db, q_pops, db_pops, bucket,
            int(approx), out=out)
    if approx:
        tanimoto_bucketmin.approx_launches += 1
    else:
        tanimoto_bucketmin.launches += 1
    return out


tanimoto_bucketmin.launches = 0
tanimoto_bucketmin.approx_launches = 0
