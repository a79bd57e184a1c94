"""Per-candidate kernels of the traversal step: CUDA on the card, plain
torch on the CPU.

Two fused candidate kernels, both in ``csrc/candidates.cu`` (see its
header for the design and what bounds it on an H100), behind the
``fused_candidates`` flag of
:func:`~rad_tpu_torch.traverse.device.expand` /
:func:`~rad_tpu_torch.traverse.device.integrate`:

* :func:`candidate_filter` (K1) — the expand-side scored test, in-batch
  dedup and front compaction producing ``to_score``; replaces
  ``rad_tpu.traverse.pallas_ops.candidate_filter_pallas``;
* :func:`integrate_candidates` (K2) — the integrate-side chain: scored
  insert-if-absent and score writes, then the enqueued check-and-set and
  the push-score lookup, tables updated in place; replaces
  ``rad_tpu.traverse.pallas_ops.integrate_candidates_pallas``.

And the three probes of the scalar-loop microbenchmark
(``csrc/scalar_probe.cu``; :mod:`rad_tpu_torch.bench_scalar_probe` times
them), which price the step's per-candidate primitives inside one kernel
and replace the ``gather`` / ``checkset`` / ``chain`` kernels of
``benchmarks/bench_scalar_probe.py``: :func:`scalar_gather` (a random
table read), :func:`scalar_checkset` (a bitmap test-and-set) and
:func:`scalar_chain` (scored test, compacted emit, enqueue test-and-set,
score lookup). They take and return the reference's column shapes
(``[k, 1]``, ``[n, 1]``, ``[1, 1]``).

The TPU kernels are serial loops whose order is the semantics: a later
duplicate of an id (or row) sees the mark its first occurrence set. Both
the CUDA kernels and the ``*_plain`` twins reproduce that result with
"first position of the value" masks. The CUDA kernels find it in a hash
table sized by the candidates, not by the library (in shared memory up
to 8,192 candidates, else a per-call buffer: :func:`_dedup_table`), and
keep no state between calls. The probes ``checkset`` and ``chain`` need
only the distinct ids, which they find in a set of the same hash (keys
only): :func:`_probe_set`. All three probes spread the candidates over a
thread-block cluster of 8 CTAs from :data:`_CLUSTER_MIN_K` candidates:
:func:`_probe_cluster`.

Each public wrapper runs its ``*_plain`` twin for CPU tensors only; for a
CUDA tensor it launches the kernel or raises. ``<wrapper>.launches``
counts kernel launches (the twin never counts);
``integrate_candidates.narrow_launches`` counts the launches with fewer
to-score ids than candidates (``fused_run``'s ``narrow_width`` branch).

Tables are passed at their logical sizes (``state.scored[:n]`` etc.), so
the engine's trailing sentinel slots are never written. Boolean tables are
``torch.bool`` (one byte per entry).
"""

from __future__ import annotations

import functools

import torch

__all__ = ["candidate_filter", "candidate_filter_plain",
           "integrate_candidates", "integrate_candidates_plain",
           "scalar_gather", "scalar_gather_plain", "scalar_checkset",
           "scalar_checkset_plain", "scalar_chain", "scalar_chain_plain"]

INF = float("inf")


def _first_occurrence(values: torch.Tensor, sentinel: int) -> torch.Tensor:
    """Mask of first occurrences of each value (sentinel excluded), in the
    original order: stable argsort + inverse scatter. O(K log K), no
    value-range scratch."""
    perm = torch.sort(values, stable=True).indices
    sorted_vals = values[perm]
    prev = torch.cat([torch.full((1,), -1, dtype=values.dtype,
                                 device=values.device), sorted_vals[:-1]])
    first_sorted = (sorted_vals != prev) & (sorted_vals != sentinel)
    first = torch.zeros_like(first_sorted)
    first[perm] = first_sorted
    return first


def candidate_filter_plain(cand_flat: torch.Tensor,
                           scored: torch.Tensor) -> torch.Tensor:
    """Plain-torch twin of :func:`candidate_filter`: the engine's default
    chain (unscored & first occurrence, cumsum compaction)."""
    n = scored.shape[0]
    k = cand_flat.shape[0]
    ok = (cand_flat >= 0) & (cand_flat < n)
    unscored = ok & ~scored[torch.where(ok, cand_flat, 0).long()]
    mask = _first_occurrence(torch.where(unscored, cand_flat, n), n)
    pos = torch.cumsum(mask, 0) - 1
    out = torch.full((k + 1,), -1, dtype=torch.int32, device=cand_flat.device)
    out[torch.where(mask, pos, k)] = cand_flat.to(torch.int32)
    return out[:k]


def integrate_candidates_plain(to_score: torch.Tensor,
                               new_scores: torch.Tensor,
                               cand_flat: torch.Tensor,
                               row_flat: torch.Tensor,
                               scored: torch.Tensor, scores: torch.Tensor,
                               enqueued: torch.Tensor):
    """Plain-torch twin of :func:`integrate_candidates`, with the TPU
    kernel's serial semantics: a duplicate inside ``to_score`` is fresh at
    its first position only. Updates the tables in place."""
    n = scored.shape[0]
    r_rows = enqueued.shape[0]
    # phase A: scored insert-if-absent + score writes
    ts_ok = (to_score >= 0) & (to_score < n)
    unscored = ts_ok & ~scored[torch.where(ts_ok, to_score, 0).long()]
    fresh = _first_occurrence(torch.where(unscored, to_score, n), n)
    idx = to_score[fresh].long()
    scores[idx] = new_scores[fresh]
    scored[idx] = True
    # phase B: enqueue check-and-set, push scores from the updated table
    c_ok = (cand_flat >= 0) & (cand_flat < n) & (row_flat >= 0) \
        & (row_flat < r_rows)
    not_enq = c_ok & ~enqueued[torch.where(c_ok, row_flat, 0).long()]
    push = not_enq & _first_occurrence(
        torch.where(c_ok, row_flat, r_rows), r_rows)
    enqueued[row_flat[push].long()] = True
    cand_score = scores[torch.where(c_ok, cand_flat, 0).long()] \
        .masked_fill(~push, INF)
    return scored, scores, enqueued, fresh, push, cand_score


def _check_1d(name: str, t: torch.Tensor, dtype, device) -> None:
    if t.dtype != dtype or t.dim() != 1 or not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous 1-D {dtype} tensor, "
                         f"got {t.dtype} {tuple(t.shape)}")
    if t.device != device:
        raise ValueError(f"{name} on {t.device}, expected {device}")


# dynamic shared memory a block may take: the card's 227 KB less 1 KB for
# the kernels' static arrays (K1/K2's scan sums, the probes' partials)
_SMEM_BYTES = 227 * 1024 - 1024


def _dedup_table(k: int) -> tuple[int, bool]:
    """The K1/K2 dedup table for ``k`` candidates: ``(log2 of its slots,
    whether it lies in shared memory)``. Slots are 8 bytes, at least
    ``2 * max(k, 1)`` of them in a power of two (the table is at most half
    full); up to ``k = 8,192`` they fit a block's shared memory, above it
    the kernel takes a global buffer that the wrapper allocates."""
    log2 = (2 * max(k, 1) - 1).bit_length()
    return log2, (8 << log2) <= _SMEM_BYTES


# the probes' cluster: 8 CTAs (the portable maximum) from this many
# candidates, one CTA below (see _probe_cluster). On an NVIDIA H100 80GB HBM3
# at 700.00 W (python -m rad_tpu_torch.bench_scalar_probe --clusters) one
# CTA is faster at 1,024 candidates and eight from 2,048 on
_PROBE_CLUSTER = 8
_CLUSTER_MIN_K = 2048


def _probe_cluster(k: int, cluster: int | None = None) -> int:
    """The CTAs of a probe's launch for ``k`` candidates: ``cluster`` (1 or
    8), by default 8 from ``_CLUSTER_MIN_K`` candidates and 1 below."""
    if cluster is None:
        return _PROBE_CLUSTER if k >= _CLUSTER_MIN_K else 1
    if cluster not in (1, _PROBE_CLUSTER):
        raise ValueError(f"cluster = {cluster}: 1 or {_PROBE_CLUSTER} CTAs")
    return cluster


def _probe_set(k: int, cluster: int | None = None) -> tuple[int, int, bool]:
    """The ``checkset`` / ``chain`` set of distinct ids for ``k``
    candidates: ``(CTAs, log2 of its slots, whether it lies in shared
    memory)``, the CTAs by :func:`_probe_cluster`. Slots are 4-byte keys,
    at least ``4 * max(k, 1)`` of them in a power of two (the set is at
    most a quarter full: fewer second probes than at half) and at least 32
    a CTA;
    the CTAs share them in their shared memory up to 8,192 candidates on
    one CTA and 65,536 on eight, above that the kernel takes a global
    buffer that the wrapper allocates."""
    cluster = _probe_cluster(k, cluster)
    log2 = max((4 * max(k, 1) - 1).bit_length(), cluster.bit_length() + 4)
    return cluster, log2, (4 << log2) // cluster <= _SMEM_BYTES


def _table_buffer(k: int, device):
    """``(log2 slots, None or the per-call global table)``."""
    log2, shared = _dedup_table(k)
    if shared:
        return log2, None
    return log2, torch.empty((2 << log2,), dtype=torch.int32, device=device)


def _ptr(t: torch.Tensor | None):
    return None if t is None else t.data_ptr()


@functools.cache
def _entry(name: str):
    """C entry point ``name`` of the kernel library (built on first use)."""
    from rad_tpu_torch import _cuda

    return getattr(_cuda.load_library(), name)


def _launch(name: str, device: torch.device, *args) -> None:
    """Call entry point ``name`` with ``args`` (ints and device pointers
    as ints; ``None`` for a null pointer) and ``device``'s current stream;
    raise on a CUDA error. Enters ``device`` only when it is not the
    current one."""
    fn = _entry(name)
    index = device.index
    if index == torch.cuda.current_device():
        code = fn(*args, torch._C._cuda_getCurrentRawStream(index))
    else:
        with torch.cuda.device(index):
            code = fn(*args, torch._C._cuda_getCurrentRawStream(index))
    if code:
        from rad_tpu_torch import _cuda

        _cuda.check(code, name)


def candidate_filter(cand_flat: torch.Tensor,
                     scored: torch.Tensor) -> torch.Tensor:
    """Expand-side candidate filter (K1).

    cand_flat: [K] int32 neighbor ids, -1 invalid.
    scored:    [N] bool — the scored set (not modified).
    Returns [K] int32: the unique unscored ids compacted to the front in
    candidate order, -1 padded.
    """
    dev = cand_flat.device
    _check_1d("cand_flat", cand_flat, torch.int32, dev)
    _check_1d("scored", scored, torch.bool, dev)
    if dev.type == "cpu":
        return candidate_filter_plain(cand_flat, scored)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    k = cand_flat.shape[0]
    out = torch.empty((k,), dtype=torch.int32, device=dev)
    log2, table = _table_buffer(k, dev)
    _launch("rad_candidate_filter", dev, cand_flat.data_ptr(), k,
            scored.data_ptr(), scored.shape[0], _ptr(table), log2,
            out.data_ptr())
    candidate_filter.launches += 1
    return out


candidate_filter.launches = 0


def integrate_candidates(to_score: torch.Tensor, new_scores: torch.Tensor,
                         cand_flat: torch.Tensor, row_flat: torch.Tensor,
                         scored: torch.Tensor, scores: torch.Tensor,
                         enqueued: torch.Tensor):
    """Integrate-side fused chain (K2), tables updated in place.

    to_score:   [kt] int32 (-1 pads); new_scores [kt] f32 aligned with it.
    cand_flat:  [kc] int32 raw candidates (-1 invalid), kc >= kt.
    row_flat:   [kc] int32 enqueue row per candidate (ignored where the
                candidate is invalid).
    scored [N] bool / scores [N] f32 / enqueued [R] bool: state tables.

    Returns ``(scored, scores, enqueued, fresh [kt] bool, push [kc] bool,
    cand_score [kc] f32)``: ``fresh`` marks the first occurrence of each
    id unscored before the call; ``push = ok & ~enqueued_before & (first
    occurrence of the row)``; ``cand_score = push ? scores_after[cand] :
    inf``.
    """
    dev = to_score.device
    for name, t, dtype in (("to_score", to_score, torch.int32),
                           ("new_scores", new_scores, torch.float32),
                           ("cand_flat", cand_flat, torch.int32),
                           ("row_flat", row_flat, torch.int32),
                           ("scored", scored, torch.bool),
                           ("scores", scores, torch.float32),
                           ("enqueued", enqueued, torch.bool)):
        _check_1d(name, t, dtype, dev)
    kt, kc, n = to_score.shape[0], cand_flat.shape[0], scored.shape[0]
    if new_scores.shape[0] != kt or row_flat.shape[0] != kc \
            or scores.shape[0] != n:
        raise ValueError("to_score/new_scores, cand_flat/row_flat and "
                         "scored/scores must pair up in length")
    if dev.type == "cpu":
        return integrate_candidates_plain(to_score, new_scores, cand_flat,
                                          row_flat, scored, scores, enqueued)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    # three allocations: one buffer cut into three dtype views costs the
    # host more (six tensor operations for three)
    fresh = torch.empty((kt,), dtype=torch.bool, device=dev)
    push = torch.empty((kc,), dtype=torch.bool, device=dev)
    cand_score = torch.empty((kc,), dtype=torch.float32, device=dev)
    log2, table = _table_buffer(max(kt, kc), dev)
    _launch("rad_integrate_candidates", dev, to_score.data_ptr(),
            new_scores.data_ptr(), kt, cand_flat.data_ptr(),
            row_flat.data_ptr(), kc, scored.data_ptr(), scores.data_ptr(), n,
            enqueued.data_ptr(), enqueued.shape[0], _ptr(table), log2,
            fresh.data_ptr(), push.data_ptr(), cand_score.data_ptr())
    integrate_candidates.launches += 1
    if kt < kc:
        integrate_candidates.narrow_launches += 1
    return scored, scores, enqueued, fresh, push, cand_score


integrate_candidates.launches = 0
integrate_candidates.narrow_launches = 0


# --------------------------------------------------------------------------
# The scalar-loop probes. Bitmaps are int32 words, bit b of word w is id
# 32*w + b (the sign bit included); ids outside [0, n) are skipped.

def _probe_ids(idx: torch.Tensor, n: int):
    """``(valid, safe ids int64)`` of a ``[k, 1]`` / ``[k]`` id column."""
    j = idx.reshape(-1).long()
    ok = (j >= 0) & (j < n)
    return ok, torch.where(ok, j, 0)


def _bit_clear(bitmap: torch.Tensor, j: torch.Tensor) -> torch.Tensor:
    """Whether bit ``j`` of the int32-word bitmap is 0."""
    return ((bitmap.reshape(-1)[j >> 5].long() >> (j & 31)) & 1) == 0


def scalar_gather_plain(idx: torch.Tensor, tab: torch.Tensor) -> torch.Tensor:
    """Plain-torch twin of :func:`scalar_gather`."""
    ok, j = _probe_ids(idx, tab.numel())
    total = torch.where(ok, tab.reshape(-1)[j].long(), 0).sum()
    wrapped = (total + (1 << 31)) % (1 << 32) - (1 << 31)  # int32 overflow
    return wrapped.to(torch.int32).reshape(1, 1)


def scalar_checkset_plain(idx: torch.Tensor, bm: torch.Tensor) -> torch.Tensor:
    """Plain-torch twin of :func:`scalar_checkset`: the serial loop counts
    an id once however often it repeats, so the count is the number of
    distinct ids whose bit is clear."""
    n = bm.numel() * 32
    ok, j = _probe_ids(idx, n)
    clear = ok & _bit_clear(bm, j)
    first = _first_occurrence(torch.where(clear, j, n), n)
    return first.sum().to(torch.int32).reshape(1, 1)


def scalar_chain_plain(idx: torch.Tensor, scored: torch.Tensor,
                       enq: torch.Tensor, scores: torch.Tensor):
    """Plain-torch twin of :func:`scalar_chain` (same returns). The score
    sum is taken in float64 and rounded once, as the kernel does."""
    n = scores.numel()
    k = idx.numel()
    ok, j = _probe_ids(idx, n)
    unscored = ok & _bit_clear(scored, j)
    n_new = unscored.sum().to(torch.int32)
    pos = torch.cumsum(unscored, 0) - 1
    emit = torch.full((k + 1,), -1, dtype=torch.int32, device=idx.device)
    emit[torch.where(unscored, pos, k)] = j.to(torch.int32)
    not_enq = ok & _bit_clear(enq, j)
    first = _first_occurrence(torch.where(not_enq, j, n), n)
    ssum = torch.where(first, scores.reshape(-1)[j].double(), 0.0) \
        .sum().float()
    out = (ssum + n_new.float()).reshape(1, 1)
    return out, emit[:k].reshape(k, 1), n_new, ssum


def _check_column(name: str, t: torch.Tensor, dtype, rows: int | None,
                  device) -> None:
    if (t.dim() not in (1, 2) or (t.dim() == 2 and t.shape[1] != 1)
            or not t.is_contiguous() or t.dtype != dtype
            or (rows is not None and t.shape[0] != rows)):
        raise ValueError(
            f"{name} must be a contiguous {dtype} column"
            + (f" of {rows} rows" if rows is not None else "")
            + f", got {t.dtype} {tuple(t.shape)}")
    if t.device != device:
        raise ValueError(f"{name} on {t.device}, expected {device}")


def scalar_gather(idx: torch.Tensor, tab: torch.Tensor) -> torch.Tensor:
    """Load-only probe: ``[1, 1]`` int32 sum of ``tab[idx[i]]``, wrapping
    as int32 addition does.

    idx: [k, 1] int32 ids; tab: [n, 1] int32.
    """
    dev = idx.device
    _check_column("idx", idx, torch.int32, None, dev)
    _check_column("tab", tab, torch.int32, None, dev)
    if dev.type == "cpu":
        return scalar_gather_plain(idx, tab)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    return _gather_cuda(idx, tab, None)


def _gather_cuda(idx, tab, cluster):
    """:func:`scalar_gather`'s launch on ``cluster`` CTAs (None: by
    :func:`_probe_cluster`)."""
    dev = idx.device
    k = idx.shape[0]
    out = torch.empty((1, 1), dtype=torch.int32, device=dev)
    _launch("rad_scalar_gather", dev, idx.data_ptr(), k, tab.data_ptr(),
            tab.shape[0], _probe_cluster(k, cluster), out.data_ptr())
    scalar_gather.launches += 1
    return out


scalar_gather.launches = 0


def scalar_checkset(idx: torch.Tensor, bm: torch.Tensor) -> torch.Tensor:
    """The enqueue primitive: ``[1, 1]`` int32 count of the ``idx[i]``
    that find their bit of ``bm`` clear at their turn, each setting it in
    a scratch copy (``bm`` is not modified), so a repeated id counts once.

    idx: [k, 1] int32 ids; bm: [n / 32, 1] int32 bitmap words.
    """
    dev = idx.device
    _check_column("idx", idx, torch.int32, None, dev)
    _check_column("bm", bm, torch.int32, None, dev)
    if dev.type == "cpu":
        return scalar_checkset_plain(idx, bm)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    return _checkset_cuda(idx, bm, None)


def _checkset_cuda(idx, bm, cluster):
    """:func:`scalar_checkset`'s launch on ``cluster`` CTAs (None: by
    :func:`_probe_set`)."""
    dev = idx.device
    k = idx.shape[0]
    cluster, log2, shared = _probe_set(k, cluster)
    out = torch.empty((1, 1), dtype=torch.int32, device=dev)
    table = None if shared else torch.empty((1 << log2,), dtype=torch.int32,
                                            device=dev)
    _launch("rad_scalar_checkset", dev, idx.data_ptr(), k, bm.data_ptr(),
            bm.shape[0] * 32, _ptr(table), log2, cluster, out.data_ptr())
    scalar_checkset.launches += 1
    return out


scalar_checkset.launches = 0


def scalar_chain(idx: torch.Tensor, scored: torch.Tensor, enq: torch.Tensor,
                 scores: torch.Tensor):
    """The whole per-candidate chain of one traversal step.

    idx: [k, 1] int32 ids; scored / enq: [n / 32, 1] int32 bitmaps (not
    modified); scores: [n, 1] f32.

    Returns ``(out, emit, n_new, ssum)``:
      n_new: 0-d int32, the candidates whose ``scored`` bit is clear (a
             repeated id counts every time: that bitmap is only read);
      emit:  [k, 1] int32, those ids in candidate order, then -1;
      ssum:  0-d f32, ``scores[j]`` summed over the distinct ids ``j``
             whose ``enq`` bit is clear (the TPU loop's test-and-set on a
             scratch copy; ``enq`` is not modified), added in float64
             and rounded once: within one f32 ulp of the twin's, within
             ``k * 2**-24 * ssum`` of an f32 sum in candidate order;
      out:   [1, 1] f32 = ``ssum + n_new``, the reference kernel's output.
    """
    dev = idx.device
    _check_column("idx", idx, torch.int32, None, dev)
    _check_column("scores", scores, torch.float32, None, dev)
    n = scores.shape[0]
    if n % 32:
        raise ValueError(f"n = {n} must be a multiple of 32")
    _check_column("scored", scored, torch.int32, n // 32, dev)
    _check_column("enq", enq, torch.int32, n // 32, dev)
    if dev.type == "cpu":
        return scalar_chain_plain(idx, scored, enq, scores)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    return _chain_cuda(idx, scored, enq, scores, None)


def _chain_cuda(idx, scored, enq, scores, cluster):
    """:func:`scalar_chain`'s launch on ``cluster`` CTAs (None: by
    :func:`_probe_set`)."""
    dev = idx.device
    k = idx.shape[0]
    cluster, log2, shared = _probe_set(k, cluster)
    # four allocations and no views: the outputs as the caller gets them
    # (bench_scalar_probe --split times both layouts)
    out = torch.empty((1, 1), dtype=torch.float32, device=dev)
    ssum = torch.empty((), dtype=torch.float32, device=dev)
    n_new = torch.empty((), dtype=torch.int32, device=dev)
    emit = torch.empty((k, 1), dtype=torch.int32, device=dev)
    table = None if shared else torch.empty((1 << log2,), dtype=torch.int32,
                                            device=dev)
    _launch("rad_scalar_chain", dev, idx.data_ptr(), k, scored.data_ptr(),
            enq.data_ptr(), scores.data_ptr(), scores.shape[0], _ptr(table),
            log2, cluster, out.data_ptr(), ssum.data_ptr(), n_new.data_ptr(),
            emit.data_ptr())
    scalar_chain.launches += 1
    return out, emit, n_new, ssum


scalar_chain.launches = 0
