"""Fused candidate kernels of the traversal step: CUDA on the card, plain
torch on the CPU.

Two kernels, both in ``csrc/candidates.cu`` (see its header for the
design and what bounds it on an H100), behind the ``fused_candidates``
flag of :func:`~rad_tpu_torch.traverse.device.expand` /
:func:`~rad_tpu_torch.traverse.device.integrate`:

* :func:`candidate_filter` (K1) — the expand-side scored test, in-batch
  dedup and front compaction producing ``to_score``; replaces
  ``rad_tpu.traverse.pallas_ops.candidate_filter_pallas``;
* :func:`integrate_candidates` (K2) — the integrate-side chain: scored
  insert-if-absent and score writes, then the enqueued check-and-set and
  the push-score lookup, tables updated in place; replaces
  ``rad_tpu.traverse.pallas_ops.integrate_candidates_pallas``.

The TPU kernels are serial loops whose order is the semantics: a later
duplicate of an id (or row) sees the mark its first occurrence set. Both
the CUDA kernels and the ``*_plain`` twins reproduce that result with
"first position of the value" masks.

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

import ctypes

import torch

__all__ = ["candidate_filter", "candidate_filter_plain",
           "integrate_candidates", "integrate_candidates_plain"]

INF = float("inf")
_INT_MAX = 2 ** 31 - 1
_scratch: dict = {}


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


def _check_1d(name: str, t: torch.Tensor, dtypes, device) -> None:
    if t.dim() != 1 or not t.is_contiguous() or t.dtype not in dtypes:
        raise ValueError(f"{name} must be a contiguous 1-D tensor of "
                         f"{[str(d) for d in dtypes]}, got {t.dtype} "
                         f"{tuple(t.shape)}")
    if t.device != device:
        raise ValueError(f"{name} on {t.device}, expected {device}")


def _first_scratch(role: str, size: int, device) -> torch.Tensor:
    """Per-device int32 first-position table, INT_MAX between calls (the
    kernels put back every slot they lower)."""
    key = (role, size, device)
    t = _scratch.get(key)
    if t is None:
        t = torch.full((max(size, 1),), _INT_MAX, dtype=torch.int32,
                       device=device)
        _scratch[key] = t
    return t


def _call(entry: str, *args, device) -> None:
    from rad_tpu_torch import _cuda

    lib = _cuda.load_library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        code = getattr(lib, entry)(
            *[ctypes.c_void_p(a.data_ptr()) if isinstance(a, torch.Tensor)
              else a for a in args], ctypes.c_void_p(stream))
    _cuda.check(code, entry)


def candidate_filter(cand_flat: torch.Tensor,
                     scored: torch.Tensor) -> torch.Tensor:
    """Expand-side candidate filter (K1).

    cand_flat: [K] int32 neighbor ids, -1 invalid.
    scored:    [N] bool — the scored set (not modified).
    Returns [K] int32: the unique unscored ids compacted to the front in
    candidate order, -1 padded.
    """
    dev = cand_flat.device
    _check_1d("cand_flat", cand_flat, (torch.int32,), dev)
    _check_1d("scored", scored, (torch.bool,), dev)
    if dev.type == "cpu":
        return candidate_filter_plain(cand_flat, scored)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    k, n = cand_flat.shape[0], scored.shape[0]
    out = torch.empty((k,), dtype=torch.int32, device=dev)
    _call("rad_candidate_filter", cand_flat, k, scored, n,
          _first_scratch("ids", n, dev), out, device=dev)
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
    kt, kc = to_score.shape[0], cand_flat.shape[0]
    for name, t, dtypes in (("to_score", to_score, (torch.int32,)),
                            ("new_scores", new_scores, (torch.float32,)),
                            ("cand_flat", cand_flat, (torch.int32,)),
                            ("row_flat", row_flat, (torch.int32,)),
                            ("scored", scored, (torch.bool,)),
                            ("scores", scores, (torch.float32,)),
                            ("enqueued", enqueued, (torch.bool,))):
        _check_1d(name, t, dtypes, dev)
    if new_scores.shape[0] != kt or row_flat.shape[0] != kc \
            or scores.shape[0] != scored.shape[0]:
        raise ValueError("to_score/new_scores, cand_flat/row_flat and "
                         "scored/scores must pair up in length")
    if dev.type == "cpu":
        return integrate_candidates_plain(to_score, new_scores, cand_flat,
                                          row_flat, scored, scores, enqueued)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    n, r_rows = scored.shape[0], enqueued.shape[0]
    fresh = torch.empty((kt,), dtype=torch.bool, device=dev)
    push = torch.empty((kc,), dtype=torch.bool, device=dev)
    cand_score = torch.empty((kc,), dtype=torch.float32, device=dev)
    _call("rad_integrate_candidates", to_score, new_scores, kt, cand_flat,
          row_flat, kc, scored, scores, n, enqueued, r_rows,
          _first_scratch("ids", n, dev), _first_scratch("rows", r_rows, dev),
          fresh, push, cand_score, device=dev)
    integrate_candidates.launches += 1
    if kt < kc:
        integrate_candidates.narrow_launches += 1
    return scored, scores, enqueued, fresh, push, cand_score


integrate_candidates.launches = 0
integrate_candidates.narrow_launches = 0
