"""Device-resident best-first traversal engine (torch).

The engine of :mod:`rad_tpu.traverse.device` with the same semantics:
pop the global minimum; expand its neighbors at its level; score each
neighbor at most once globally; enqueue each (neighbor, level) at most
once; descend the expanded node to level-1 with its own score; lower score
is better. The step is split at the host scoring boundary into
:func:`expand` (pop + gather + unique unscored candidate ids) and
:func:`integrate` (scores in, visited/enqueued updates, frontier push).
With an on-device scorer the whole step runs without a host scoring
round trip: :func:`fused_step`, :func:`fused_run` (Tanimoto to a target)
and :func:`make_device_run` (any torch scorer). ``fused_candidates=True``
routes the candidate chains through the kernels of
:mod:`~rad_tpu_torch.traverse.candidate_ops`. States checkpoint to
``.npz`` files in ``rad_tpu``'s layout (:func:`save_state` /
:func:`load_state`), so checkpoints cross between the two packages.

Row trick: node ids are level-sorted, so layer ``l`` is the id range
``[0, N_l)`` and (node, level) is the single row ``offsets[l] + node`` of
the flat ``[R, M0]`` adjacency.

Tie rules follow the reference as it runs on the CPU: every selection is a
stable ascending sort (``lax.top_k`` and ``lax.sort`` order ties by
position there), never ``torch.topk``, whose tie order is unspecified on
CUDA.

State is a dataclass of tensors that the functions **update in place**
and return (JAX rebuilds the state functionally and donates the old
buffers instead). Every table that takes dropped writes — JAX's
``.at[idx].set(..., mode="drop")`` with sentinel indices — carries one
trailing sentinel slot that absorbs them: its logical contents are
``t[:-1]``. Only sentinel writes may repeat an index.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, fields, replace

import numpy as np
import torch

from rad_tpu_torch.devices import resolve_device
from rad_tpu_torch.fp.tanimoto import tanimoto_rows_to_target
from rad_tpu_torch.graph.adjpack import (adj_bits_for, pack_adjacency_numpy,
                                         pack_adjacency_rows,
                                         packed_adj_words,
                                         unpack_adjacency_rows)
from rad_tpu_torch.graph.storage import HNSWGraph
from rad_tpu_torch.traverse import candidate_ops
from rad_tpu_torch.traverse.candidate_ops import _first_occurrence
from rad_tpu_torch.utils.profiling import _read_back, count, span

__all__ = ["DeviceGraph", "TraversalState", "DenseStateOps",
           "flatten_adjacency_host", "prepare_device_graph",
           "pack_device_graph", "adjacency_rows", "init_state",
           "auto_frontier_capacity", "expand", "integrate", "prime",
           "read_order_log", "gather_scores", "frontier_size",
           "frontier_empty", "frontier_live", "frontier_live_scan",
           "fused_step", "fused_run", "make_device_run", "save_state",
           "save_state_atomic", "load_state", "state_to_reference_arrays",
           "read_order_log_since", "AUTO_HEAD_CAPACITY",
           "AUTO_HEAD_THRESHOLD"]

INF = float("inf")


@dataclass
class DeviceGraph:
    """Traversal view of an HNSWGraph: one flat padded adjacency table.

    adj:     [R, M0] int32 — neighbor node ids, -1 padded; row r encodes
             (node, level) by the row trick. With ``adj_bits < 32`` the
             table is ``[R, ceil(M0*adj_bits/32)]`` bit-packed words
             (:mod:`rad_tpu_torch.graph.adjpack`) that
             :func:`adjacency_rows` decodes for each popped batch.
    offsets: [L+2] int32 — layer_offset[l] = Σ_{l' < l} N_{l'}, then R,
             then a trailing R sentinel; ``offsets_host`` is its numpy copy.
    """

    adj: torch.Tensor
    offsets: torch.Tensor
    offsets_host: np.ndarray
    n_nodes: int
    n_rows: int
    m0: int
    max_level: int
    adj_bits: int = 32

    @property
    def device(self) -> torch.device:
        return self.adj.device


def flatten_adjacency_host(graph: HNSWGraph):
    """Flatten per-layer neighbor tables into the ``[R, M0]`` traversal
    layout → ``(adj int32 [R, M0], offsets int32 [L+2], m0, r)``."""
    if any(np.dtype(t.dtype) == np.uint32 for t in graph.neighbors):
        raise ValueError(
            "uint32 adjacency (>2**31-id serving-format tables) cannot be "
            "flattened into the int32 traversal table")
    m0 = max(int(t.shape[1]) for t in graph.neighbors)
    sizes = graph.layer_sizes
    offsets = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int32)
    r = int(offsets[-1])
    adj = np.full((r, m0), -1, dtype=np.int32)
    for l, t in enumerate(graph.neighbors):
        t = np.asarray(t)
        adj[offsets[l]:offsets[l] + t.shape[0], : t.shape[1]] = t
    # trailing sentinel: searchsorted(side='right') - 1 maps any row in
    # [offsets[L], R) to level L
    offsets_arr = np.concatenate([offsets, [r]]).astype(np.int32)
    return adj, offsets_arr, m0, r


def prepare_device_graph(graph: HNSWGraph, device,
                         packed_adjacency: bool | int = False
                         ) -> DeviceGraph:
    """Flatten the graph's tables on the host and upload them to
    ``device``.

    ``packed_adjacency=True`` (or an explicit field width) packs the table
    to bit fields on the host before the upload, so the int32 table never
    reaches the device; a width of 32 or more leaves it unpacked."""
    adj, offsets_arr, m0, r = flatten_adjacency_host(graph)
    bits = 32
    if packed_adjacency:
        bits = (adj_bits_for(len(graph)) if packed_adjacency is True
                else int(packed_adjacency))
        if bits < 32:
            out = np.zeros((r, packed_adj_words(m0, bits)), np.uint32)
            step = 1 << 20  # bounds the packer's int64 temporaries
            for lo in range(0, r, step):
                out[lo:lo + step] = pack_adjacency_numpy(adj[lo:lo + step],
                                                         bits)
            adj = out.view(np.int32)
        else:
            bits = 32
    return DeviceGraph(
        adj=torch.from_numpy(adj).to(device),
        offsets=torch.from_numpy(offsets_arr).to(device),
        offsets_host=offsets_arr,
        n_nodes=len(graph),
        n_rows=r,
        m0=m0,
        max_level=graph.max_level,
        adj_bits=bits,
    )


def pack_device_graph(dg: DeviceGraph, bits: int | None = None,
                      chunk: int = 1 << 22) -> DeviceGraph:
    """Re-encode a DeviceGraph's int32 adjacency as ``bits``-wide packed
    fields on its device (``None``: :func:`adj_bits_for` of its node
    count), ``chunk`` rows at a time. The int32 source must be resident;
    :func:`prepare_device_graph` packs on the host instead."""
    if bits is None:
        bits = adj_bits_for(dg.n_nodes)
    if dg.adj_bits < 32 or bits >= 32:
        return dg
    out = torch.empty((dg.n_rows, packed_adj_words(dg.m0, bits)),
                      dtype=torch.int32, device=dg.device)
    for lo in range(0, dg.n_rows, chunk):
        out[lo:lo + chunk] = pack_adjacency_rows(dg.adj[lo:lo + chunk], bits)
    return replace(dg, adj=out, adj_bits=bits)


def adjacency_rows(dg: DeviceGraph, rows: torch.Tensor) -> torch.Tensor:
    """``[..., M0]`` int32 neighbor ids of table rows ``rows`` (decoded
    when the table is bit-packed)."""
    got = dg.adj[rows.long()]
    if dg.adj_bits < 32:
        got = unpack_adjacency_rows(got, dg.m0, dg.adj_bits)
    return got


@dataclass
class TraversalState:
    """Device-resident traversal state, updated in place.

    f_score/f_row: [C] sorted frontier head (+inf = empty); entries before
                   ``f_cursor`` are already popped.
    f_buf_score/f_buf_row: [P+1] unsorted append buffer; ``f_buf_n``
                   appended so far.
    f_live:        live frontier entries across head + buffer + cold.
    cold_score/cold_row: [CC+1] the optional second frontier level
                   (CC = 0: single level); ``cold_n`` entries, all
                   ``>= watermark >=`` every live head/buffer entry.
    enqueued:      [R+1] bool — (node, level) ever pushed.
    scored/scores: [N+1] — the global once-only scoring record.
    order_log:     [cap+1] int32 — node ids in scoring order (a ring).
    n_scored, n_dropped, n_steps: counters.

    Scalars are 0-d tensors on the state's device. The last slot of each
    ``[X+1]`` table is the dropped-write sentinel.
    """

    f_score: torch.Tensor
    f_row: torch.Tensor
    f_cursor: torch.Tensor
    f_buf_score: torch.Tensor
    f_buf_row: torch.Tensor
    f_buf_n: torch.Tensor
    f_live: torch.Tensor
    cold_score: torch.Tensor
    cold_row: torch.Tensor
    cold_n: torch.Tensor
    watermark: torch.Tensor
    enqueued: torch.Tensor
    scored: torch.Tensor
    scores: torch.Tensor
    order_log: torch.Tensor
    n_scored: torch.Tensor
    n_dropped: torch.Tensor
    n_steps: torch.Tensor


# head_capacity="auto" switches init_state to the two-level frontier at
# this head size once the frontier capacity reaches the threshold.
# Module-level so tests can shrink them and drive the auto path at test
# scale.
AUTO_HEAD_CAPACITY = 1 << 16
AUTO_HEAD_THRESHOLD = 1 << 18


def auto_frontier_capacity(n_rows: int, cap_max: int = 1 << 22) -> int:
    """Lossless frontier capacity when affordable: every (node, level)
    row enters the frontier at most once, so capacity >= n_rows can never
    drop a finite entry (capped at ``cap_max``; rounded up to a power of
    two)."""
    want = min(max(n_rows, 1 << 12), cap_max)
    return 1 << (want - 1).bit_length()


def init_state(dg: DeviceGraph, frontier_capacity: int | None = None,
               log_capacity: int | None = None,
               buffer_capacity: int = 1 << 15,
               head_capacity: int | None | str = "auto",
               score_table: bool = True) -> TraversalState:
    """Empty traversal state on ``dg``'s device.

    The frontier is a sorted head plus an append buffer (merged by one
    sort when the buffer fills). ``head_capacity`` below
    ``frontier_capacity`` adds the two-level layout: a small sorted head
    and a ``frontier_capacity``-slot unsorted cold store for entries at or
    above the watermark. ``"auto"`` enables it (head =
    :data:`AUTO_HEAD_CAPACITY`) once the capacity reaches
    :data:`AUTO_HEAD_THRESHOLD`; ``None`` forces a single level.
    ``frontier_capacity=None`` auto-sizes (:func:`auto_frontier_capacity`).

    ``score_table=False`` allocates a one-slot ``scores`` dummy (plus its
    sentinel) in place of the ``[N]`` f32 table, which is never allocated:
    for state ops whose ``gather_scores`` computes a candidate's score
    instead of reading it (an id-mode scorer). :func:`integrate` refuses
    such a state under the dense ops and under ``fused_candidates``.
    """
    if frontier_capacity is None:
        frontier_capacity = auto_frontier_capacity(dg.n_rows)
    if head_capacity == "auto":
        head_capacity = (AUTO_HEAD_CAPACITY
                         if frontier_capacity >= AUTO_HEAD_THRESHOLD
                         else None)
    if head_capacity is not None and head_capacity < frontier_capacity:
        head, cold_cap = head_capacity, frontier_capacity
    else:
        head, cold_cap = frontier_capacity, 0
    cap = log_capacity if log_capacity is not None else dg.n_nodes
    dev = dg.device

    def full(n, value, dtype):
        return torch.full((n,), value, dtype=dtype, device=dev)

    def scalar(value, dtype=torch.int32):
        return torch.tensor(value, dtype=dtype, device=dev)

    return TraversalState(
        f_score=full(head, INF, torch.float32),
        f_row=full(head, 0, torch.int32),
        f_cursor=scalar(0),
        f_buf_score=full(buffer_capacity + 1, INF, torch.float32),
        f_buf_row=full(buffer_capacity + 1, 0, torch.int32),
        f_buf_n=scalar(0),
        f_live=scalar(0),
        cold_score=full(cold_cap + 1, INF, torch.float32),
        cold_row=full(cold_cap + 1, 0, torch.int32),
        cold_n=scalar(0),
        watermark=scalar(INF, torch.float32),
        enqueued=full(dg.n_rows + 1, False, torch.bool),
        scored=full(dg.n_nodes + 1, False, torch.bool),
        scores=(full(dg.n_nodes + 1, INF, torch.float32) if score_table
                else torch.zeros((2,), dtype=torch.float32, device=dev)),
        order_log=full(cap + 1, -1, torch.int32),
        n_scored=scalar(0),
        n_dropped=scalar(0),
        n_steps=scalar(0),
    )


def _set_drop_(arr: torch.Tensor, idx: torch.Tensor, vals) -> None:
    """``arr[idx] = vals`` in place; out-of-range indices write the
    trailing sentinel slot of ``arr`` instead (JAX ``mode="drop"``)."""
    size = arr.shape[0] - 1
    idx = torch.where((idx >= 0) & (idx < size), idx, size).long()
    if torch.is_tensor(vals):
        arr[idx] = vals
    else:
        # a Python scalar assigned through an index is first copied to
        # the device, which synchronises; index_fill_ takes it as is
        arr.index_fill_(0, idx, vals)


def _sorted(scores: torch.Tensor, rows: torch.Tensor):
    """Stable ascending sort of (score, row) pairs by score."""
    ss, order = torch.sort(scores, stable=True)
    return ss, rows[order]


def _level_of_row(dg: DeviceGraph, row: torch.Tensor) -> torch.Tensor:
    lev = torch.searchsorted(dg.offsets[: dg.max_level + 2], row,
                             right=True) - 1
    return torch.clamp(lev, 0, dg.max_level).to(torch.int32)


def _first_occurrence_scatter(values: torch.Tensor,
                              sentinel: int) -> torch.Tensor:
    """Same mask via scatter-min of batch positions over a
    ``[sentinel+1]`` scratch (``values`` in ``[0, sentinel]``): a position
    is a first occurrence iff it is its value's minimum position."""
    k = values.shape[0]
    pos = torch.arange(k, dtype=torch.int64, device=values.device)
    scratch = torch.full((sentinel + 1,), k, dtype=torch.int64,
                         device=values.device)
    v = values.long()
    scratch.scatter_reduce_(0, v, pos, reduce="amin", include_self=True)
    return (scratch[v] == pos) & (values != sentinel)


class DenseStateOps:
    """Access layer for the big per-node/per-row state tables (dense,
    device-resident). Gathers take pre-clamped indices; scatters send
    out-of-range indices to the sentinel slot.

    ``gather_scores`` / ``scatter_scores`` are the score table's own pair
    (the dense gather and scatter here): an override that computes a
    candidate's score from its id, with a no-op scatter, lets a state
    made with ``init_state(score_table=False)`` run without the ``[N]``
    table."""

    @staticmethod
    def gather(arr: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
        return arr[idx.long()]

    @staticmethod
    def scatter_(arr: torch.Tensor, idx: torch.Tensor, vals) -> None:
        _set_drop_(arr, idx, vals)

    @staticmethod
    def gather_scores(arr: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
        return arr[idx.long()]

    @staticmethod
    def scatter_scores(arr: torch.Tensor, idx: torch.Tensor, vals) -> None:
        _set_drop_(arr, idx, vals)

    @staticmethod
    def first_occurrence(values: torch.Tensor,
                         sentinel: int) -> torch.Tensor:
        # sort-free scatter form while its [sentinel+1] scratch is cheap;
        # the argsort form past ~8M values
        if sentinel + 1 > (1 << 23):
            return _first_occurrence(values, sentinel)
        return _first_occurrence_scatter(values, sentinel)


DENSE_OPS = DenseStateOps()


def _check_score_table(state: TraversalState, n: int, ops,
                       fused_candidates: bool) -> None:
    """Refuse a one-slot score dummy (``init_state(score_table=False)``)
    where the ``[N]`` table would be indexed past the slot (a device
    assert on CUDA): under K2, which reads and writes the table in its
    body, whatever the ops, and under ops that do not override
    ``gather_scores``."""
    if state.scores.shape[0] - 1 >= n:
        return
    if fused_candidates:
        raise ValueError(
            "the state holds a one-slot score dummy "
            "(init_state(score_table=False)); fused_candidates=True needs "
            "the [N] score table")
    if type(ops).gather_scores is DenseStateOps.gather_scores:
        raise ValueError(
            "the state holds a one-slot score dummy "
            "(init_state(score_table=False)); integrate it with state ops "
            "that override gather_scores")


def _refill_two_level(state: TraversalState) -> None:
    """Rebuild the head from head-residual + buffer + cold (one sort).

    The best H entries become the sorted head, the next CC the (now
    sorted) cold store; anything past total capacity drops (counted). The
    watermark becomes the head's max."""
    with span("step.refill"):
        h = state.f_score.shape[0]
        cc = state.cold_score.shape[0] - 1
        p = state.f_buf_score.shape[0] - 1
        dev = state.f_score.device
        live = torch.arange(h, device=dev) >= state.f_cursor
        ss, sr = _sorted(
            torch.cat([state.f_score.masked_fill(~live, INF),
                       state.f_buf_score[:p], state.cold_score[:cc]]),
            torch.cat([state.f_row, state.f_buf_row[:p], state.cold_row[:cc]]))
        n_cold = torch.isfinite(ss[h:h + cc]).sum()
        dropped = torch.isfinite(ss[h + cc:]).sum()
        state.f_score.copy_(ss[:h])
        state.f_row.copy_(sr[:h])
        state.cold_score[:cc] = ss[h:h + cc]
        state.cold_row[:cc] = sr[h:h + cc]
        state.watermark = torch.where(n_cold > 0, ss[h - 1],
                                      torch.full_like(state.watermark, INF))
        state.f_cursor = torch.zeros_like(state.f_cursor)
        state.f_buf_score.fill_(INF)
        state.f_buf_row.zero_()
        state.f_buf_n = torch.zeros_like(state.f_buf_n)
        state.f_live = state.f_live - dropped
        state.cold_n = n_cold.to(torch.int32)
        state.n_dropped = state.n_dropped + dropped


def expand(state: TraversalState, dg: DeviceGraph, batch: int,
           gather_adj=None, ops: DenseStateOps = DENSE_OPS,
           fused_candidates: bool = False):
    """Pop the ``batch`` best frontier entries and gather their neighbors.

    ``gather_adj(rows) -> [B, M0]`` int32 overrides the adjacency row
    gather: the hook the graph-sharded pod engine uses to fetch rows from
    whichever shard owns them (:mod:`rad_tpu_torch.parallel.sharded`).
    ``fused_candidates=True`` computes ``to_score`` with the K1 kernel
    (:func:`~rad_tpu_torch.traverse.candidate_ops.candidate_filter`; its
    plain twin for a CPU state) instead of the chain below — same result.

    Returns ``(state, out)`` with ``out`` a dict of device tensors:
      exp_node/exp_level/exp_score/exp_valid: [B] — the popped expansions;
      cand:     [B, M0] neighbor node ids (-1 invalid);
      to_score: [B*M0] unique unscored node ids, compacted to the front in
                adjacency order, -1 padded — the batch for host scoring.
    """
    with span("step.expand"):
        count("step")
        b = batch
        c = state.f_score.shape[0]
        p = state.f_buf_score.shape[0] - 1
        if c < b:
            raise ValueError(f"frontier head capacity {c} < batch {b}")
        if state.cold_score.shape[0] > 1:
            # two-level: refill when head + buffer cannot fill this batch and
            # the cold store holds entries (pops never touch cold — the
            # watermark keeps the global minimum in head + buffer)
            need = ((state.f_live - state.cold_n) < b) & (state.cold_n > 0)
            with _read_back("refill_check"):
                refill = bool(need)
            if refill:
                _refill_two_level(state)
        dev = state.f_score.device
        # main candidates: the next B entries at the sorted head's cursor
        start = torch.clamp(state.f_cursor, max=c - b)
        offs = (start + torch.arange(b, dtype=torch.int32, device=dev)).long()
        main_s = state.f_score[offs].masked_fill(offs < state.f_cursor, INF)
        main_r = state.f_row[offs]
        # buffer candidates: its best B (ties to the smaller slot)
        buf_s, bidx = torch.sort(state.f_buf_score[:p], stable=True)
        buf_s, bidx = buf_s[:b], bidx[:b]
        cat_s = torch.cat([main_s, buf_s])
        cat_r = torch.cat([main_r, state.f_buf_row[bidx]])
        sel = torch.sort(cat_s, stable=True).indices[:b]
        pop_score = cat_s[sel]
        pop_row = cat_r[sel]
        valid = torch.isfinite(pop_score)
        state.f_cursor = state.f_cursor + ((sel < b) & valid).sum()
        from_buf = (sel >= b) & valid
        buf_slot = torch.where(from_buf, bidx[torch.clamp(sel - b, min=0)], p)
        _set_drop_(state.f_buf_score, buf_slot, INF)

        level = _level_of_row(dg, pop_row)
        node = pop_row - dg.offsets[level.long()]
        safe_row = torch.where(valid, pop_row, 0)
        adj_rows = (adjacency_rows(dg, safe_row) if gather_adj is None
                    else gather_adj(safe_row))
        cand = adj_rows.masked_fill(~valid[:, None], -1)

        n = dg.n_nodes
        cand_flat = cand.reshape(-1)
        k = cand_flat.shape[0]
        if fused_candidates:
            to_score = candidate_ops.candidate_filter(cand_flat,
                                                      state.scored[:n])
        else:
            cand_ok = cand_flat >= 0
            safe_cand = torch.where(cand_ok, cand_flat, 0)
            unscored = cand_ok & ~ops.gather(state.scored, safe_cand)
            ids = torch.where(unscored, cand_flat, n)
            # unique unscored ids compacted to the front, preserving adjacency
            # order (the scoring order of the reference's work items)
            mask = unscored & ops.first_occurrence(ids, n)
            pos = torch.cumsum(mask, 0) - 1
            to_score = torch.full((k + 1,), -1, dtype=torch.int32, device=dev)
            to_score[torch.where(mask, pos, k)] = cand_flat
            to_score = to_score[:k]
        state.f_live = state.f_live - valid.sum()
        state.n_steps = state.n_steps + 1
        return state, {
            "exp_node": node,
            "exp_level": level,
            "exp_score": pop_score,
            "exp_valid": valid,
            "cand": cand,
            "to_score": to_score,
        }


def integrate(state: TraversalState, dg: DeviceGraph,
              exp_node: torch.Tensor, exp_level: torch.Tensor,
              exp_score: torch.Tensor, exp_valid: torch.Tensor,
              cand: torch.Tensor, to_score: torch.Tensor,
              new_scores: torch.Tensor,
              ops: DenseStateOps = DENSE_OPS,
              fused_candidates: bool = False) -> TraversalState:
    """Integrate host scores and complete the traversal step: scored-set
    insert-if-absent + order-log append; per-(node, level) enqueued
    check-and-set; frontier push of new candidates; level descent of the
    expanded nodes; buffer append, or a merge when the buffer would
    overflow (worst entries spill to cold, or drop, counted).

    ``to_score``/``new_scores`` may be narrower than the ``[B*M0]``
    candidates (a prefix, as ``narrow_width`` passes them).
    ``fused_candidates=True`` runs the scored insert and the enqueue
    check-and-set as the K2 kernel
    (:func:`~rad_tpu_torch.traverse.candidate_ops.integrate_candidates`;
    its plain twin for a CPU state) — the same masks whenever
    ``to_score`` holds no duplicate id, which the engine guarantees. K2
    reads and writes the ``[N]`` score table, so on a state with a
    one-slot dummy (``init_state(score_table=False)``) it raises
    ``ValueError``, whatever the ops; unfused, such a state needs ops
    that override ``gather_scores``, else ``ValueError`` too."""
    with span("step.integrate"):
        n = dg.n_nodes
        cap = state.order_log.shape[0] - 1
        dev = state.f_score.device
        b, m0 = cand.shape
        cand_flat = cand.reshape(-1)
        cand_ok = cand_flat >= 0
        safe_cand = torch.where(cand_ok, cand_flat, 0)
        lev_flat = exp_level.repeat_interleave(m0)
        row_flat = dg.offsets[lev_flat.long()] + safe_cand

        _check_score_table(state, n, ops, fused_candidates)
        if fused_candidates:
            *_, fresh, push, cand_score = candidate_ops.integrate_candidates(
                to_score, new_scores, cand_flat, row_flat, state.scored[:n],
                state.scores[:n], state.enqueued[:dg.n_rows])
        else:
            # -- scored set: insert-if-absent (a pipelined driver can deliver
            # an id in two in-flight batches; the first integration wins)
            ts_ok = to_score >= 0
            fresh = ts_ok & ~ops.gather(state.scored,
                                        torch.where(ts_ok, to_score, 0))
            ts_idx = torch.where(fresh, to_score, n)
            ops.scatter_scores(state.scores, ts_idx, new_scores)
            ops.scatter_(state.scored, ts_idx, True)

            # -- candidate enqueue: check-and-set at the expansion level
            first = ops.first_occurrence(
                torch.where(cand_ok, row_flat, dg.n_rows), dg.n_rows)
            not_enq = ~ops.gather(state.enqueued,
                                  torch.where(cand_ok, row_flat, 0))
            push = cand_ok & not_enq & first
            ops.scatter_(state.enqueued,
                         torch.where(push, row_flat, dg.n_rows), True)
            cand_score = ops.gather_scores(state.scores,
                                           safe_cand).masked_fill(~push, INF)

        pos_in_batch = torch.cumsum(fresh, 0) - 1
        log_pos = torch.where(fresh, (state.n_scored + pos_in_batch) % cap,
                              cap)
        _set_drop_(state.order_log, log_pos, to_score)
        state.n_scored = state.n_scored + fresh.sum()
        cand_row_entry = torch.where(push, row_flat, 0)

        # -- descent: re-enqueue the expanded node at level-1
        can_desc = exp_valid & (exp_level > 0)
        down_row = (dg.offsets[torch.clamp(exp_level - 1, min=0).long()]
                    + exp_node)
        down_ok = can_desc & ~ops.gather(state.enqueued,
                                         torch.where(can_desc, down_row, 0))
        down_ok &= _first_occurrence(
            torch.where(down_ok, down_row, dg.n_rows), dg.n_rows)
        ops.scatter_(state.enqueued, torch.where(down_ok, down_row, dg.n_rows),
                     True)
        desc_score = exp_score.masked_fill(~down_ok, INF)
        desc_row = torch.where(down_ok, down_row, 0)

        # -- frontier push: append to the buffer; merge-sort only when full.
        # Pushes stay in candidate order (cumsum compaction), so equal scores
        # keep slot order through every later stable selection.
        new_s = torch.cat([cand_score, desc_score])
        new_r = torch.cat([cand_row_entry, desc_row])
        p_new = new_s.shape[0]
        c = state.f_score.shape[0]
        p = state.f_buf_score.shape[0] - 1
        cc = state.cold_score.shape[0] - 1
        finite = torch.isfinite(new_s)
        if cc > 0:
            # two-level routing: scores below the watermark take the head /
            # buffer path; the rest append unsorted to the cold store
            qual = finite & (new_s < state.watermark)
            n_push = qual.sum()
            to_cold = finite & ~qual
            n_cold_new = to_cold.sum()
            pos_cold = torch.where(
                to_cold, state.cold_n + torch.cumsum(to_cold, 0) - 1, cc)
            _set_drop_(state.cold_score, pos_cold, new_s)
            _set_drop_(state.cold_row, pos_cold, new_r)
            kept_cold = torch.clamp(state.cold_n + n_cold_new, max=cc) \
                - state.cold_n
            state.cold_n = state.cold_n + kept_cold
            state.f_live = state.f_live + kept_cold
            state.n_dropped = state.n_dropped + (n_cold_new - kept_cold)
            buf_new = new_s.masked_fill(~qual, INF)
        else:
            n_push = finite.sum()
            buf_new = new_s

        merge = p_new > p
        if not merge:
            with _read_back("merge_check"):
                merge = bool(state.f_buf_n + n_push > p)
        if merge:
            _merge(state, buf_new, new_r, n_push, c, p, cc, dev)
        else:
            fin = torch.isfinite(buf_new)
            pos = torch.where(fin, state.f_buf_n + torch.cumsum(fin, 0) - 1, p)
            _set_drop_(state.f_buf_score, pos, buf_new)
            _set_drop_(state.f_buf_row, pos, new_r)
            state.f_buf_n = state.f_buf_n + n_push
            state.f_live = state.f_live + n_push
        return state


def _merge(state: TraversalState, buf_new, new_r, n_push, c: int, p: int,
           cc: int, dev) -> None:
    """Sort head-residual + buffer + this step's pushes into a new head;
    overflow spills to cold (two-level) or drops (counted)."""
    with span("step.merge"):
        live = torch.arange(c, device=dev) >= state.f_cursor
        ss, sr = _sorted(
            torch.cat([state.f_score.masked_fill(~live, INF),
                       state.f_buf_score[:p], buf_new]),
            torch.cat([state.f_row, state.f_buf_row[:p], new_r]))
        spill_s, spill_r = ss[c:], sr[c:]
        spill_fin = torch.isfinite(spill_s)
        spill_n = spill_fin.sum()
        if cc > 0:
            sp_pos = torch.where(
                spill_fin,
                state.cold_n + torch.arange(spill_s.shape[0], device=dev), cc)
            _set_drop_(state.cold_score, sp_pos, spill_s)
            _set_drop_(state.cold_row, sp_pos, spill_r)
            kept = torch.clamp(state.cold_n + spill_n, max=cc) - state.cold_n
            state.cold_n = state.cold_n + kept
            state.watermark = torch.where(spill_n > 0, ss[c - 1],
                                          state.watermark)
            dropped_now = spill_n - kept
        else:
            dropped_now = spill_n
        state.f_score.copy_(ss[:c])
        state.f_row.copy_(sr[:c])
        state.f_cursor = torch.zeros_like(state.f_cursor)
        state.f_buf_score.fill_(INF)
        state.f_buf_row.zero_()
        state.f_buf_n = torch.zeros_like(state.f_buf_n)
        state.f_live = state.f_live + n_push - dropped_now
        state.n_dropped = state.n_dropped + dropped_now


def prime(state: TraversalState, dg: DeviceGraph, node_ids: torch.Tensor,
          node_scores: torch.Tensor) -> TraversalState:
    """Seed the traversal from scored top-layer nodes: insert each into
    the scored set, mark it enqueued at ``max(0, max_level - 1)``, and
    push it at that level with its score. ``node_ids`` may be -1 padded.

    Insert-if-absent: in-batch duplicates and ids already scored or
    enqueued are skipped, so a re-prime cannot double-count. The append
    buffer is folded into the re-sort (and reset), so the two-level
    invariant survives a mid-run prime."""
    n = dg.n_nodes
    cap = state.order_log.shape[0] - 1
    dev = state.f_score.device
    ok = node_ids >= 0
    safe_ids = torch.where(ok, node_ids, 0)
    start_level = max(0, dg.max_level - 1)
    row = int(dg.offsets_host[start_level]) + safe_ids
    already = state.scored[safe_ids.long()] | ~ok
    already_enq = state.enqueued[row.long()] | ~ok
    first = _first_occurrence(torch.where(ok, row, dg.n_rows), dg.n_rows)
    fresh = ok & first & ~already & ~already_enq

    idx = torch.where(fresh, node_ids, n)
    _set_drop_(state.scores, idx, node_scores)
    _set_drop_(state.scored, idx, True)
    pos_in_batch = torch.cumsum(fresh, 0) - 1
    log_pos = torch.where(fresh, (state.n_scored + pos_in_batch) % cap, cap)
    _set_drop_(state.order_log, log_pos, node_ids)
    state.n_scored = state.n_scored + fresh.sum()
    _set_drop_(state.enqueued, torch.where(fresh, row, dg.n_rows), True)

    entry_score = node_scores.to(torch.float32).masked_fill(~fresh, INF)
    entry_row = torch.where(fresh, row, 0).to(torch.int32)
    c = state.f_score.shape[0]
    p = state.f_buf_score.shape[0] - 1
    cc = state.cold_score.shape[0] - 1
    live = torch.arange(c, device=dev) >= state.f_cursor
    ss, sr = _sorted(
        torch.cat([state.f_score.masked_fill(~live, INF),
                   state.f_buf_score[:p], entry_score]),
        torch.cat([state.f_row, state.f_buf_row[:p], entry_row]))
    spill_fin = torch.isfinite(ss[c:]).sum()
    if cc > 0:
        # head overflow spills to the cold store
        spill_s, spill_r = ss[c:], sr[c:]
        fin = torch.isfinite(spill_s)
        sp_pos = torch.where(
            fin, state.cold_n + torch.arange(spill_s.shape[0], device=dev),
            cc)
        _set_drop_(state.cold_score, sp_pos, spill_s)
        _set_drop_(state.cold_row, sp_pos, spill_r)
        kept = torch.clamp(state.cold_n + spill_fin, max=cc) - state.cold_n
        state.cold_n = state.cold_n + kept
        state.watermark = torch.where(spill_fin > 0, ss[c - 1],
                                      state.watermark)
        lost = spill_fin - kept
        state.n_dropped = state.n_dropped + lost
    else:
        lost = spill_fin  # not counted in n_dropped, as in the reference
    state.f_live = state.f_live + torch.isfinite(entry_score).sum() - lost
    state.f_score.copy_(ss[:c])
    state.f_row.copy_(sr[:c])
    state.f_cursor = torch.zeros_like(state.f_cursor)
    state.f_buf_score.fill_(INF)
    state.f_buf_row.zero_()
    state.f_buf_n = torch.zeros_like(state.f_buf_n)
    return state


def read_order_log(state: TraversalState) -> np.ndarray:
    """Scored node ids in traversal order (host). Past the ring capacity
    only the most recent ``cap`` ids remain, returned oldest first."""
    cap = state.order_log.shape[0] - 1
    n = int(state.n_scored)
    log = state.order_log[:cap].cpu().numpy()
    if n <= cap:
        return log[:n]
    head = n % cap
    return np.concatenate([log[head:], log[:head]])


def gather_scores(state: TraversalState, ids) -> np.ndarray:
    """Host float array of ``state.scores[ids]`` (gathered on device); a
    state without the score table raises ``ValueError``."""
    if state.scores.shape[0] - 1 < state.scored.shape[0] - 1:
        raise ValueError("the state holds no score table "
                         "(init_state(score_table=False))")
    ids = np.asarray(ids)
    if ids.size == 0:
        return np.zeros((0,), np.float32)
    idx = torch.from_numpy(ids.astype(np.int64)).to(state.scores.device)
    return state.scores[idx].cpu().numpy()


def frontier_live_scan(state: TraversalState) -> int:
    """O(C) recount of live frontier entries — the oracle for the
    incrementally maintained ``f_live``."""
    c = state.f_score.shape[0]
    live = torch.arange(c, device=state.f_score.device) >= state.f_cursor
    total = ((live & torch.isfinite(state.f_score)).sum()
             + torch.isfinite(state.f_buf_score[:-1]).sum()
             + torch.isfinite(state.cold_score[:-1]).sum())
    return int(total)


def frontier_size(state: TraversalState) -> int:
    """Host-side: live frontier entries (head + buffer + cold)."""
    return int(state.f_live)


def frontier_empty(state: TraversalState) -> bool:
    return frontier_size(state) == 0


def frontier_live(state: TraversalState) -> torch.Tensor:
    """Live frontier entries (head past the cursor + buffer + cold): the
    incrementally maintained 0-d tensor, O(1)."""
    return state.f_live


# --------------------------------------------------------------------------
# Device-scored traversal: pop -> score on the device -> integrate, with no
# host scoring round trip. JAX's ``lax.while_loop`` is a host loop here that
# reads the loop condition before every step, so it stops on exactly the
# step where the reference's loop stops. With a two-level frontier a step
# reads the device twice more (the refill and merge checks); each read is a
# ``sync.<site>`` span and counter (rad_tpu_torch.utils.profiling).


def _target_scorer(packed, pops, target_packed, target_pop):
    """``to_score`` → Tanimoto distance to the target (+inf on padding)."""
    def score(ts: torch.Tensor) -> torch.Tensor:
        ok = ts >= 0
        safe = torch.where(ok, ts, 0).long()
        return tanimoto_rows_to_target(packed[safe], pops[safe],
                                       target_packed, target_pop, valid=ok)
    return score


def _device_loop(state: TraversalState, dg: DeviceGraph, score,
                 n_to_score, batch: int, max_steps: int,
                 narrow_width: int | None,
                 fused_candidates: bool) -> TraversalState:
    n_to_score = int(n_to_score)
    steps = 0
    while steps < int(max_steps):
        with span("step"):
            with _read_back("loop"):
                n_scored, live = torch.stack(
                    [state.n_scored.long(),
                     frontier_live(state).long()]).tolist()
            if n_scored >= n_to_score or live <= 0:
                break
            state, out = expand(state, dg, batch,
                                fused_candidates=fused_candidates)
            ts = out["to_score"]
            # narrow_width: a step that discovers few ids scores and
            # integrates only the front of to_score (the rest is -1 padding)
            if narrow_width is not None and narrow_width < ts.shape[0]:
                with _read_back("narrow"):
                    n_ids = int((ts >= 0).sum())
                if n_ids <= narrow_width:
                    ts = ts[:narrow_width]
            with span("step.score"):
                scores = score(ts)
            state = integrate(state, dg, out["exp_node"], out["exp_level"],
                              out["exp_score"], out["exp_valid"],
                              out["cand"], ts, scores,
                              fused_candidates=fused_candidates)
            # freed before the next step, as a call's argument would be
            del scores
        steps += 1
    return state


def fused_step(state: TraversalState, dg: DeviceGraph, packed: torch.Tensor,
               pops: torch.Tensor, target_packed: torch.Tensor, target_pop,
               batch: int) -> TraversalState:
    """One device-resident step with the Tanimoto-to-target scorer:
    expand, score ``to_score`` against ``target_packed`` on the device,
    integrate. ``packed`` is the ``[N, W]`` int32 bit-view library by node
    id, ``pops`` its ``[N]`` popcounts."""
    state, out = expand(state, dg, batch)
    ts = out["to_score"]
    scores = _target_scorer(packed, pops, target_packed, target_pop)(ts)
    return integrate(state, dg, out["exp_node"], out["exp_level"],
                     out["exp_score"], out["exp_valid"], out["cand"], ts,
                     scores)


def fused_run(state: TraversalState, dg: DeviceGraph, packed: torch.Tensor,
              pops: torch.Tensor, target_packed: torch.Tensor, target_pop,
              n_to_score, batch: int, max_steps: int = 1 << 20,
              narrow_width: int | None = None,
              fused_candidates: bool = False) -> TraversalState:
    """Repeat :func:`fused_step` while ``n_scored < n_to_score``, fewer
    than ``max_steps`` steps ran and the frontier is live.

    ``narrow_width`` (< batch*M0): when a step discovers at most this many
    ids, score and integrate run on ``to_score[:narrow_width]`` — the same
    scored set, order and drops, fewer padded slots. ``fused_candidates``
    routes the candidate chains through the K1/K2 kernels."""
    return _device_loop(
        state, dg, _target_scorer(packed, pops, target_packed, target_pop),
        n_to_score, batch, max_steps, narrow_width, fused_candidates)


def make_device_run(dg: DeviceGraph, packed: torch.Tensor,
                    pops: torch.Tensor, scorer, batch: int,
                    max_steps: int = 1 << 20,
                    narrow_width: int | None = None,
                    fused_candidates: bool = False):
    """A traversal loop around any torch scorer.

    ``scorer(packed_rows, pop_rows) -> [K]`` receives ``packed[ids]`` and
    ``pops[ids]`` for the step's ``to_score`` ids (padding gathers row 0),
    whatever their dtype: an MLP over fingerprint bits, a similarity, or a
    score table passed as ``pops``. Its output is cast to f32 and padding
    slots become +inf. ``narrow_width`` and ``fused_candidates`` (an
    option the reference's ``make_device_run`` does not have) as in
    :func:`fused_run`.

    Returns ``run(state, n_to_score, step_budget=None) -> state``; the
    step budget defaults to ``max_steps``."""
    def score(ts: torch.Tensor) -> torch.Tensor:
        ok = ts >= 0
        safe = torch.where(ok, ts, 0).long()
        raw = scorer(packed[safe], pops[safe])
        return torch.where(ok, raw.to(torch.float32), INF)

    def run(state: TraversalState, n_to_score,
            step_budget=None) -> TraversalState:
        budget = max_steps if step_budget is None else step_budget
        return _device_loop(state, dg, score, n_to_score, batch, budget,
                            narrow_width, fused_candidates)

    return run


# --------------------------------------------------------------------------
# Checkpoints: one .npz in rad_tpu's layout (no sentinel slots), so a file
# written by either package loads in the other.

# tables with a trailing sentinel slot, and the value it is created with
_SENTINEL_FILL = {"f_buf_score": INF, "f_buf_row": 0, "cold_score": INF,
                  "cold_row": 0, "enqueued": False, "scored": False,
                  "scores": INF, "order_log": -1}


def state_to_reference_arrays(state: TraversalState) -> dict:
    """Host numpy arrays of ``state`` in ``rad_tpu``'s layout: sentinel
    slots dropped, integers as int32."""
    out = {}
    for f in fields(TraversalState):
        t = getattr(state, f.name).detach().cpu()
        if f.name in _SENTINEL_FILL:
            t = t[:-1]
        a = t.numpy()
        if a.dtype == np.int64:
            a = a.astype(np.int32)
        out[f.name] = a
    return out


def save_state(state: TraversalState, path: str) -> None:
    """Checkpoint a traversal to one ``.npz`` (``np.savez`` appends the
    suffix to other paths; :func:`save_state_atomic` does not)."""
    np.savez(path, **state_to_reference_arrays(state))


def save_state_atomic(state: TraversalState, path: str) -> None:
    """Write-then-rename :func:`save_state`: a crash mid-save never
    corrupts the last good checkpoint, and the file lands at exactly
    ``path`` whatever its suffix."""
    tmp = f"{path}.tmp.{os.getpid()}"
    save_state(state, tmp)
    if not os.path.exists(tmp) and os.path.exists(tmp + ".npz"):
        tmp = tmp + ".npz"
    os.replace(tmp, path)


def load_state(path: str, device=None) -> TraversalState:
    """Restore a checkpoint written by :func:`save_state` or by
    ``rad_tpu``'s ``save_state`` (including its pre-``f_live`` and
    single-level forms) onto ``device``, adding the sentinel slots."""
    if not os.path.exists(path) and os.path.exists(path + ".npz"):
        path = path + ".npz"   # a bare save_state() output for this path
    names = [f.name for f in fields(TraversalState)]
    with np.load(path) as data:
        arrays = {k: np.asarray(data[k]) for k in names if k in data}
    if "f_live" not in arrays:  # oldest form: recount head + buffer
        c = arrays["f_score"].shape[0]
        live = np.arange(c) >= arrays["f_cursor"]
        arrays["f_live"] = np.asarray(
            np.sum(live & np.isfinite(arrays["f_score"]))
            + np.sum(np.isfinite(arrays["f_buf_score"])), np.int32)
    if "cold_score" not in arrays:  # single-level form
        arrays["cold_score"] = np.zeros((0,), np.float32)
        arrays["cold_row"] = np.zeros((0,), np.int32)
        arrays["cold_n"] = np.asarray(0, np.int32)
        arrays["watermark"] = np.asarray(INF, np.float32)
    device = resolve_device(device)
    tensors = {}
    for k in names:
        a = arrays[k]
        if k in _SENTINEL_FILL:
            a = np.concatenate([a, np.asarray([_SENTINEL_FILL[k]], a.dtype)])
        tensors[k] = torch.from_numpy(a.copy()).to(device)
    return TraversalState(**tensors)


def read_order_log_since(state: TraversalState, start: int) -> np.ndarray:
    """Scored node ids in positions ``[start, n_scored)`` — the
    incremental drain for runs that outgrow the ring. Raises if more than
    the ring's capacity accumulated since ``start``."""
    cap = state.order_log.shape[0] - 1
    n = int(state.n_scored)
    if n - start > cap:
        raise RuntimeError(
            f"order log overran: {n - start} new entries > ring capacity "
            f"{cap}; drain more frequently or raise log_capacity")
    idx = torch.arange(start, n, device=state.order_log.device) % cap
    return state.order_log[idx].cpu().numpy()
