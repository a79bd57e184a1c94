"""Tanimoto kernels over packed fingerprints: CUDA on the card, plain
torch on the CPU.

Kernels in ``csrc/tanimoto.cu`` (see its header for the design and what
bounds it on an H100):

* :func:`tanimoto_matrix` — full ``[Q, N]`` f32 distance block; replaces
  ``rad_tpu.fp.kernels.tanimoto_matrix_pallas``;
* :func:`tanimoto_bucketmin` — one packed int32 key per query and per
  aligned run of ``bucket`` db rows (the f32 similarity's bits with the
  low ``log2(bucket)`` bits replaced by the in-bucket index, max over the
  bucket: winner sim AND position, equal sims to the larger index);
  replaces ``rad_tpu.fp.kernels.tanimoto_bucketmin_pallas``. Output is
  ``[Q, N / bucket]``, the orientation the JAX wrapper returns. With
  ``approx=True`` it runs the kernel's approximate-reciprocal epilogue
  instance (the reference's ``approx=True``);
* :func:`tanimoto_bucket_topk` — the exact builder's candidate scan: the
  bucket kernel's winners of a layer's query rows against all its rows,
  masked and merged into each row's running top-k on the card (one launch,
  or a split scan and a merge); no TPU kernel does this, the reference
  merges on the host;
* :func:`tanimoto_nn` — 1-NN per query over the whole db, exact or fast
  epilogue; replaces ``rad_tpu.fp.kernels.tanimoto_nn_pallas``;
* :func:`nn_floor` and :func:`nn_epilogue_probe` — the A/B probes of
  ``benchmarks/bench_kernel_variants.py``, instances of the 1-NN kernel
  (and one small kernel for the floor probe's ``unpack`` mode).

Every kernel here except the unpack probe takes its intersections from the
tensor cores (the 1-bit ``wgmma`` of ``csrc/tanimoto_mma.cuh``, packed
words in, exact counts out) and runs its epilogue on the accumulators.
:func:`div_counts_mismatches` is the card-side self-check of the divide
their exact epilogues run for rows of up to :data:`DIV_CHECKED_WORDS`
words (wider rows take the IEEE divide: the same bits).

Each public wrapper runs its ``*_plain`` twin for CPU tensors only; for a
CUDA tensor it launches the kernel or raises. ``<wrapper>.launches`` counts
kernel launches (the twin never counts); the approximate epilogue counts in
``tanimoto_bucketmin.approx_launches``,
``tanimoto_bucket_topk.approx_launches`` and
``tanimoto_nn.approx_launches``, the 1-NN kernel's wide instance also in
``tanimoto_nn.wide_launches``.

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
    "tanimoto_bucket_topk",
    "tanimoto_bucket_topk_plain",
    "bucket_topk_serves",
    "tanimoto_nn",
    "tanimoto_nn_plain",
    "default_n_tile",
    "DIV_CHECKED_WORDS",
    "BUCKET_MAX",
    "NN_MAX_WORDS",
    "nn_floor",
    "nn_floor_plain",
    "nn_epilogue_probe",
    "nn_epilogue_probe_plain",
    "unpack_bitmajor",
    "exact_fp32_matmul",
    "div_counts_mismatches",
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


def _counts_plain(q, db, q_pops, db_pops):
    """``[Q, N]`` f32 intersections (exact, from an fp32 matmul of
    unpacked bits) and unions."""
    with exact_fp32_matmul():
        inter = unpack_bitmajor(q) @ unpack_bitmajor(db).T
    union = (_pops(q, q_pops).to(torch.float32)[:, None]
             + _pops(db, db_pops).to(torch.float32)[None, :]) - inter
    return inter, union


def _similarity_plain(q, db, q_pops, db_pops,
                      approx: bool = False) -> torch.Tensor:
    """``[Q, N]`` f32 similarity: exact intersections, then the kernels'
    epilogue — with ``approx``, the f32 reciprocal of ``max(union, 1)``
    times the intersection."""
    inter, union = _counts_plain(q, db, q_pops, db_pops)
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


DIV_CHECKED_WORDS = 1024   # kDivCheckedWords of csrc/tanimoto.cu
BUCKET_MAX = 128           # the CUDA bucket kernel's db tile (columns)


def _check_bucket(n: int, bucket: int) -> None:
    if bucket <= 0 or bucket & (bucket - 1) or n % bucket:
        raise ValueError(f"bucket={bucket} must be a power of two dividing "
                         f"the db rows ({n})")


def _check_bucket_kernel(bucket: int) -> None:
    """What the CUDA bucket kernel takes beyond :func:`_check_bucket`: a
    bucket lies inside one of its 128-column db tiles."""
    if bucket > BUCKET_MAX:
        raise ValueError(f"the CUDA bucket kernel takes buckets of up to "
                         f"{BUCKET_MAX} db rows (bucket={bucket})")


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
    near-ties, and decoded distances by a few ulp. ``bucket`` is a power
    of two dividing N; the CUDA kernel takes buckets of up to
    :data:`BUCKET_MAX` rows and rows of any width."""
    _check_inputs(q, db, q_pops, db_pops)
    _check_bucket(db.shape[0], bucket)
    if q.device.type == "cpu":
        return tanimoto_bucketmin_plain(q, db, bucket, q_pops, db_pops,
                                        approx)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    _check_bucket_kernel(bucket)
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


# --- the bucket path's running top-k: tanimoto_bucket_topk -----------------
# Keys are (order32(d) << 32) | id, so one int64 order is the (d, id) order;
# rows with fewer than k winners end in _I64.max, decoded as INF / -1.
_TOPK_MAX_SPLITS = 8                  # the most lists the merge kernel reads
_TOPK_SCRATCH_BYTES = 16 << 20        # the most a call's splits allocate
_TOPK_PLAIN_ROWS = 1 << 12            # query rows a step of the twin
_TOPK_PLAIN_COLS = 1 << 13            # columns a step of the twin


def bucket_topk_serves(packed: torch.Tensor, k: int, bucket: int) -> bool:
    """Whether :func:`tanimoto_bucket_topk` takes ``packed``'s rows at
    ``k`` and ``bucket``: the twin takes any; the card's kernel takes
    buckets of 8 columns or more, k up to 256 and rows as wide as its
    instance keeps resident beside the rows' lists in shared memory
    (``rad_bucket_topk_max_words`` of ``csrc/tanimoto.cu``)."""
    if packed.device.type != "cuda":
        return True
    from rad_tpu_torch import _cuda

    return packed.shape[1] <= _cuda.load_library().rad_bucket_topk_max_words(
        k, bucket)


def _check_topk(packed, q0: int, q1: int, n_real: int, k: int, bucket: int,
                pops) -> None:
    if packed.dim() != 2 or packed.dtype != torch.int32:
        raise ValueError(f"expected [N, W] int32 packed words, got "
                         f"{tuple(packed.shape)} {packed.dtype}")
    n = packed.shape[0]
    if not 0 <= q0 <= q1 <= n:
        raise ValueError(f"query rows [{q0}, {q1}) outside the {n} rows")
    if k < 1 or n_real < 0:
        raise ValueError(f"k={k} and n_real={n_real} must be positive")
    _check_bucket(n, bucket)
    if pops is not None and (pops.dtype != torch.int32
                             or pops.device != packed.device
                             or tuple(pops.shape) != (n,)):
        raise ValueError(f"pops must be int32 [{n}] on {packed.device}")


def _topk_keys_plain(packed, pops, q0: int, q1: int, n_real: int, k: int,
                     bucket: int, approx: bool) -> torch.Tensor:
    """``[q1 - q0, k]`` int64 keys, ascending: the bucket winners of
    :func:`tanimoto_bucketmin_plain`, masked, merged into a running k
    smallest, ``_TOPK_PLAIN_ROWS`` rows by ``_TOPK_PLAIN_COLS`` columns."""
    n = packed.shape[0]
    dev = packed.device
    out = torch.empty((q1 - q0, k), dtype=torch.int64, device=dev)
    step = max(bucket, _TOPK_PLAIN_COLS)
    for r0 in range(q0, q1, _TOPK_PLAIN_ROWS):
        r1 = min(r0 + _TOPK_PLAIN_ROWS, q1)
        q, qp = packed[r0:r1], pops[r0:r1]
        rows = torch.arange(r0, r1, dtype=torch.int64, device=dev)[:, None]
        best = torch.full((r1 - r0, k), _I64.max, dtype=torch.int64,
                          device=dev)
        for c0 in range(0, n, step):
            c1 = min(c0 + step, n)
            d, col = decode_bucket_keys(tanimoto_bucketmin_plain(
                q, packed[c0:c1], bucket, qp, pops[c0:c1], approx), bucket)
            ids = (c0 + col).to(torch.int64)
            keys = _hi_lo(_order32(d), ids).masked_fill(
                (ids >= n_real) | (ids == rows), _I64.max)
            best = torch.cat([best, keys], 1).topk(
                k, dim=1, largest=False).values
        out[r0 - q0:r1 - q0] = best
    return out


def _topk_decode(keys: torch.Tensor):
    """Top-k keys → ``(dist f32, id int32)``, INF / -1 where empty."""
    d, ids = _decode_min(keys)
    empty = keys == _I64.max
    return d.masked_fill(empty, float("inf")), ids.masked_fill(empty, -1)


def tanimoto_bucket_topk_plain(packed: torch.Tensor, q0: int, q1: int,
                               n_real: int, k: int, bucket: int = 64,
                               pops: torch.Tensor | None = None,
                               approx: bool = False):
    """Plain-torch twin of :func:`tanimoto_bucket_topk`, any ``k`` and any
    row width."""
    _check_topk(packed, q0, q1, n_real, k, bucket, pops)
    return _topk_decode(_topk_keys_plain(packed, _pops(packed, pops), q0, q1,
                                         n_real, k, bucket, approx))


def tanimoto_bucket_topk(packed: torch.Tensor, q0: int, q1: int,
                         n_real: int, k: int, bucket: int = 64,
                         pops: torch.Tensor | None = None,
                         approx: bool = False):
    """The exact builder's candidate scan of query rows ``[q0, q1)`` of a
    layer's padded rows ``packed`` against all of its rows: ``([q1 - q0,
    k] f32 distances, [q1 - q0, k] int32 ids)``, ascending, INF / -1
    tails.

    Every ``bucket`` columns give one winner, :func:`tanimoto_bucketmin`'s
    (``approx`` its epilogue), dropped if its id is ``n_real`` or more or
    the query's own; the k smallest by ``(d, id)`` are kept, ``d`` the f32
    ``1 - sim`` of :func:`decode_bucket_keys`. That is the order of a stable
    merge of the winners over ascending column blocks, so the result does not
    depend on how the columns are split. On the card one kernel keeps each
    row's top-k (two launches when a call's rows alone do not fill the
    card: a split scan, then a merge) where :func:`bucket_topk_serves`;
    it raises elsewhere. Counts ``tanimoto_bucket_topk.launches`` /
    ``.approx_launches`` a call."""
    _check_topk(packed, q0, q1, n_real, k, bucket, pops)
    pops = _pops(packed, pops)
    if packed.device.type == "cpu":
        return _topk_decode(_topk_keys_plain(packed, pops, q0, q1, n_real, k,
                                             bucket, approx))
    if packed.device.type != "cuda":
        raise ValueError(f"unsupported device {packed.device}")
    _check_bucket_kernel(bucket)
    if not bucket_topk_serves(packed, k, bucket):
        raise ValueError(f"the CUDA bucket top-k takes buckets of 8 columns "
                         f"or more, k <= 256 and rows of up to "
                         f"rad_bucket_topk_max_words(k, bucket) words (k={k},"
                         f" bucket={bucket}, {packed.shape[1]} words)")
    from rad_tpu_torch import _cuda

    n, n_q = packed.shape[0], q1 - q0
    dev = packed.device
    out_d = torch.empty((n_q, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((n_q, k), dtype=torch.int32, device=dev)
    if n_q == 0:
        return out_d, out_i
    # where the call's rows alone leave SMs idle, the kernel splits the
    # columns into as many runs as the scratch holds lists, at most
    splits = max(1, min(_TOPK_MAX_SPLITS,
                        _TOPK_SCRATCH_BYTES // (n_q * k * 8)))
    scratch = (torch.empty((splits, n_q, k), dtype=torch.int64, device=dev)
               if splits > 1 else None)
    lib = _cuda.load_library()
    ptr = ctypes.c_void_p
    with torch.cuda.device(dev):
        packed, pops = packed.contiguous(), pops.contiguous()
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = lib.rad_tanimoto_bucket_topk(
            ptr(packed.data_ptr()), ptr(pops.data_ptr()), n, packed.shape[1],
            q0, n_q, min(n_real, n), bucket, int(approx), k, splits,
            ptr(scratch.data_ptr() if scratch is not None else 0),
            ptr(out_d.data_ptr()), ptr(out_i.data_ptr()), ptr(stream))
    _cuda.check(code, "rad_tanimoto_bucket_topk")
    if approx:
        tanimoto_bucket_topk.approx_launches += 1
    else:
        tanimoto_bucket_topk.launches += 1
    return out_d, out_i


tanimoto_bucket_topk.launches = 0
tanimoto_bucket_topk.approx_launches = 0


def div_counts_mismatches(device, max_union: int = 1 << 16) -> int:
    """The self-check of the divide that the tensor-core kernels' exact
    epilogues use (``div_counts`` in ``csrc/tanimoto.cu``: the in-range
    instruction sequence of the IEEE divide, without its branches): the
    number of pairs ``0 <= inter <= union <= max_union`` for which it
    differs from ``__fdiv_rn`` in any bit, counted on the CUDA ``device``.
    It must be 0; the default covers every pair of counts that fingerprints
    of up to 32,768 bits can give, the range in which the kernels use it."""
    from rad_tpu_torch import _cuda

    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"the check runs on a CUDA device, not {device}")
    lib = _cuda.load_library()
    out = torch.zeros(1, dtype=torch.int64, device=device)
    with torch.cuda.device(device):
        code = lib.rad_div_counts_check(
            int(max_union), ctypes.c_void_p(out.data_ptr()),
            ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream))
    _cuda.check(code, "rad_div_counts_check")
    return int(out.item())


# --- 1-NN over the whole db: tanimoto_nn and the A/B probes ---------------
# Each epilogue reduces one int64 key per (query, db row) to one per query;
# the key carries the tie rule (see csrc/tanimoto.cu). The kernel and the
# twin build the same keys, so their results are array-equal wherever the
# similarity is computed the same way.
_NN_EXACT, _NN_FAST, _NN_FLOOR, _NN_EXACT_PK, _NN_NEWTON = range(5)
_NN_MIN = (_NN_EXACT, _NN_NEWTON)
_I64 = torch.iinfo(torch.int64)
_LO32 = 0xFFFFFFFF
_NN_PLAIN_BLOCK = 1 << 14   # db rows per step of the plain twins' scan
# the widest rows whose query tile the CUDA 1-NN kernel keeps in shared
# memory (9 K chunks of 32 words); wider rows run its wide instance
NN_MAX_WORDS = 288


def default_n_tile(n: int) -> int:
    """The TPU wrapper's default: the largest power of two from 128 to
    2048 that divides ``n`` (128 if none larger does)."""
    n_tile = 128
    while n_tile < 2048 and n % (n_tile * 2) == 0:
        n_tile *= 2
    return n_tile


def _check_nn(q, db, q_pops, db_pops, n_tile: int) -> None:
    _check_inputs(q, db, q_pops, db_pops)
    if n_tile <= 0 or n_tile & (n_tile - 1) or db.shape[0] % n_tile:
        raise ValueError(f"n_tile={n_tile} must be a power of two dividing "
                         f"the db rows ({db.shape[0]})")


def _order32(x: torch.Tensor) -> torch.Tensor:
    """f32 → int32 with the same order (negative floats flipped)."""
    b = x.view(torch.int32)
    return torch.where(b < 0, b ^ 0x7FFFFFFF, b)


def _hi_lo(hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    return hi.to(torch.int64) * (1 << 32) + lo


def _nn_block_keys(inter, union, cols, epilogue: int, n_tile: int):
    """``[Q, B]`` int64 keys of one db block (``cols`` its int64 row ids),
    the kernel's ``nn_value`` in torch."""
    if epilogue == _NN_FLOOR:
        return inter.to(torch.int64)
    if epilogue == _NN_NEWTON:
        u = torch.clamp(union, min=1.0)
        r = torch.reciprocal(u)
        r = r * (2.0 - u * r)
        sim = torch.where(union > 0, inter * r, torch.ones_like(inter))
    elif epilogue == _NN_FAST:
        sim = inter * torch.reciprocal(torch.clamp(union, min=1.0))
        sim = torch.where(union > 0, sim, torch.ones_like(sim))
    else:
        sim = similarity_from_counts(inter, union)
    if epilogue in _NN_MIN:
        return _hi_lo(_order32(1.0 - sim), cols)
    low = n_tile - 1
    key = (sim.view(torch.int32) & ~low) | (cols & low).to(torch.int32)
    if epilogue == _NN_EXACT_PK:
        return key.to(torch.int64)
    return _hi_lo(key, _LO32 - cols // n_tile)


def _nn_keys_plain(q, db, q_pops, db_pops, epilogue: int, n_tile: int,
                   block: int = _NN_PLAIN_BLOCK) -> torch.Tensor:
    """Plain-torch twin of the kernel: ``[Q]`` int64 keys, the db scanned
    ``block`` rows at a time (memory stays ``O(Q * block)``)."""
    qp = _pops(q, q_pops)
    dp = _pops(db, db_pops)
    is_min = epilogue in _NN_MIN
    best = torch.full((q.shape[0],), _I64.max if is_min else _I64.min,
                      dtype=torch.int64, device=q.device)
    for lo in range(0, db.shape[0], block):
        hi = min(lo + block, db.shape[0])
        inter, union = _counts_plain(q, db[lo:hi], qp, dp[lo:hi])
        cols = torch.arange(lo, hi, dtype=torch.int64, device=q.device)
        keys = _nn_block_keys(inter, union, cols, epilogue, n_tile)
        best = (torch.minimum(best, keys.amin(dim=1)) if is_min
                else torch.maximum(best, keys.amax(dim=1)))
    return best


def _nn_keys(q, db, q_pops, db_pops, epilogue: int, n_tile: int,
             plain: bool, wrapper, counter: str = "launches") -> torch.Tensor:
    """``[Q]`` int64 keys: the twin when ``plain`` or for CPU tensors,
    else the kernel, counted in ``wrapper.<counter>``."""
    if plain or q.device.type == "cpu":
        return _nn_keys_plain(q, db, q_pops, db_pops, epilogue, n_tile)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    out = torch.full((q.shape[0],),
                     _I64.max if epilogue in _NN_MIN else _I64.min,
                     dtype=torch.int64, device=q.device)
    _launch("rad_tanimoto_nn", q, db, q_pops, db_pops, epilogue,
            n_tile.bit_length() - 1, out=out)
    setattr(wrapper, counter, getattr(wrapper, counter) + 1)
    if db.shape[1] > NN_MAX_WORDS:
        tanimoto_nn.wide_launches += 1
    return out


def _decode_min(keys: torch.Tensor):
    """Exact/Newton keys → ``(dist f32, id int32)``."""
    hi = (keys >> 32).to(torch.int32)
    bits = torch.where(hi < 0, hi ^ 0x7FFFFFFF, hi)
    return bits.view(torch.float32), (keys & _LO32).to(torch.int32)


def _decode_fast(keys: torch.Tensor, n_tile: int):
    """Fast keys → ``(dist, id)`` as ``rad_tpu/fp/kernels.py:422-426``:
    the truncated similarity and ``tile * n_tile + index``."""
    key = (keys >> 32).to(torch.int32)
    tile = _LO32 - (keys & _LO32)
    sim = (key & ~(n_tile - 1)).view(torch.float32)
    ids = tile * n_tile + (key & (n_tile - 1)).to(torch.int64)
    return 1.0 - sim, ids.to(torch.int32)


def _tanimoto_nn(q, db, n_tile, q_pops, db_pops, approx, plain: bool):
    n_tile = default_n_tile(db.shape[0]) if n_tile is None else n_tile
    _check_nn(q, db, q_pops, db_pops, n_tile)
    epilogue = _NN_FAST if approx else _NN_EXACT
    keys = _nn_keys(q, db, q_pops, db_pops, epilogue, n_tile, plain,
                    tanimoto_nn, "approx_launches" if approx else "launches")
    return _decode_fast(keys, n_tile) if approx else _decode_min(keys)


def tanimoto_nn(q: torch.Tensor, db: torch.Tensor, q_tile: int | None = None,
                n_tile: int | None = None,
                q_pops: torch.Tensor | None = None,
                db_pops: torch.Tensor | None = None, approx: bool = False,
                compute_dtype=None):
    """1-NN by Tanimoto: ``(min_dist f32 [Q], argmin_id int32 [Q])``;
    replaces ``rad_tpu.fp.kernels.tanimoto_nn_pallas``.

    Exact (default): the f32 distance of the matrix kernel, ties to the
    first id. ``approx=True`` is the throughput epilogue: approximate
    reciprocal, the similarity's bits with the low ``log2(n_tile)`` bits
    replaced by the index in its ``n_tile``-row tile, one max; ties in a
    tile go to the larger id, across tiles to the earlier tile, and the
    distance is the truncated one. ``n_tile`` (default
    :func:`default_n_tile`) must be a power of two dividing N; it changes
    the fast epilogue's result. ``q_tile`` and ``compute_dtype`` are the
    TPU kernel's tiling and MXU operand type: accepted, and they change no
    result. Counts ``tanimoto_nn.launches`` / ``.approx_launches``; a
    launch of the kernel's wide instance (rows of more than
    ``NN_MAX_WORDS`` words), from this wrapper or a probe's, also counts in
    ``tanimoto_nn.wide_launches``."""
    return _tanimoto_nn(q, db, n_tile, q_pops, db_pops, approx, plain=False)


tanimoto_nn.launches = 0
tanimoto_nn.approx_launches = 0
tanimoto_nn.wide_launches = 0


def tanimoto_nn_plain(q: torch.Tensor, db: torch.Tensor,
                      q_tile: int | None = None, n_tile: int | None = None,
                      q_pops: torch.Tensor | None = None,
                      db_pops: torch.Tensor | None = None,
                      approx: bool = False, compute_dtype=None):
    """Plain-torch twin of :func:`tanimoto_nn` (the fast epilogue with the
    f32 ``torch.reciprocal``), scanning N in blocks of 16,384 rows."""
    return _tanimoto_nn(q, db, n_tile, q_pops, db_pops, approx, plain=True)


def _check_probe(q, db, q_tile: int, n_tile: int) -> None:
    _check_nn(q, db, None, None, n_tile)
    if q_tile <= 0 or q.shape[0] % q_tile:
        raise ValueError(f"q_tile={q_tile} must divide the query rows "
                         f"({q.shape[0]})")


def _unpack_probe_plain(db: torch.Tensor, n_q: int, q_tile: int,
                        n_tile: int) -> torch.Tensor:
    first = db.reshape(-1, n_tile, db.shape[1])[:, :min(8, n_tile)]
    counts = unpack_bitmajor(first, torch.int32).sum(
        dim=1, dtype=torch.int32)                           # [tiles, d]
    return counts[:, :q_tile].amax(dim=0).repeat(n_q // q_tile)


def _floor(q, db, q_tile, n_tile, mode, plain: bool) -> torch.Tensor:
    _check_probe(q, db, q_tile, n_tile)
    if mode == "unpack":
        if q_tile > 32 * db.shape[1]:
            raise ValueError(f"q_tile={q_tile} exceeds the {32 * db.shape[1]}"
                             f" unpacked features")
        if plain or q.device.type == "cpu":
            return _unpack_probe_plain(db, q.shape[0], q_tile, n_tile)
        if q.device.type != "cuda":
            raise ValueError(f"unsupported device {q.device}")
        from rad_tpu_torch import _cuda

        out = torch.zeros(q.shape[0], dtype=torch.int32, device=q.device)
        lib = _cuda.load_library()
        with torch.cuda.device(q.device):
            db = db.contiguous()
            code = lib.rad_nn_unpack_probe(
                ctypes.c_void_p(db.data_ptr()), db.shape[0], db.shape[1],
                n_tile, q_tile, q.shape[0], ctypes.c_void_p(out.data_ptr()),
                ctypes.c_void_p(
                    torch.cuda.current_stream(q.device).cuda_stream))
        _cuda.check(code, "rad_nn_unpack_probe")
        nn_floor.launches += 1
        return out
    if mode != "floor":
        raise ValueError(f"mode={mode!r}: 'floor' or 'unpack'")
    # the floor reads no popcounts: zeros stand in, so none are counted
    pops = [torch.zeros(t.shape[0], dtype=torch.int32, device=t.device)
            for t in (q, db)]
    return _nn_keys(q, db, *pops, _NN_FLOOR, n_tile, plain,
                    nn_floor).to(torch.int32)


def nn_floor(q: torch.Tensor, db: torch.Tensor, q_tile: int, n_tile: int,
             mode: str = "floor") -> torch.Tensor:
    """The floor probe of ``benchmarks/bench_kernel_variants.py``
    (``make_floor_kernel``), ``int32 [Q]``.

    ``mode="floor"``: each query's max intersection over the db — what
    the TPU's ``floor``, ``floor-t`` and ``dot`` modes (and their bf16
    forms) all compute; they differ only in VMEM layout and MXU operand.
    ``mode="unpack"``: the TPU unpack stage's checksum (see
    ``csrc/tanimoto.cu``), which reads the db only. Q % q_tile == 0 and
    N % n_tile == 0. Counts both kernels in ``nn_floor.launches``."""
    return _floor(q, db, q_tile, n_tile, mode, plain=False)


nn_floor.launches = 0


def nn_floor_plain(q: torch.Tensor, db: torch.Tensor, q_tile: int,
                   n_tile: int, mode: str = "floor") -> torch.Tensor:
    """Plain-torch twin of :func:`nn_floor`."""
    return _floor(q, db, q_tile, n_tile, mode, plain=True)


def _epilogue_probe(q, db, n_tile, mode, q_pops, db_pops, plain: bool):
    epilogue = {"exact-pk": _NN_EXACT_PK, "newton": _NN_NEWTON}.get(mode)
    if epilogue is None:
        raise ValueError(f"mode={mode!r}: 'exact-pk' or 'newton'")
    _check_nn(q, db, q_pops, db_pops, n_tile)
    keys = _nn_keys(q, db, q_pops, db_pops, epilogue, n_tile, plain,
                    nn_epilogue_probe)
    return keys.to(torch.int32) if mode == "exact-pk" else _decode_min(
        keys)[0]


def nn_epilogue_probe(q: torch.Tensor, db: torch.Tensor, n_tile: int,
                      mode: str, q_pops: torch.Tensor | None = None,
                      db_pops: torch.Tensor | None = None) -> torch.Tensor:
    """The epilogue probes of ``benchmarks/bench_kernel_variants.py``
    (``make_epilogue_probe``), per query: ``"exact-pk"`` — the exact
    divide with the fast epilogue's packed-key max, ``int32 [Q]`` keys;
    ``"newton"`` — the approximate reciprocal refined by one Newton step,
    then min, ``f32 [Q]`` distances. Counts
    ``nn_epilogue_probe.launches``."""
    return _epilogue_probe(q, db, n_tile, mode, q_pops, db_pops,
                           plain=False)


nn_epilogue_probe.launches = 0


def nn_epilogue_probe_plain(q: torch.Tensor, db: torch.Tensor, n_tile: int,
                            mode: str, q_pops: torch.Tensor | None = None,
                            db_pops: torch.Tensor | None = None
                            ) -> torch.Tensor:
    """Plain-torch twin of :func:`nn_epilogue_probe` (the Newton step
    starts from the f32 ``torch.reciprocal``)."""
    return _epilogue_probe(q, db, n_tile, mode, q_pops, db_pops, plain=True)
