"""Device-resident best-first traversal engine (torch).

The engine of :mod:`rad_tpu.traverse.device` with the same semantics:
pop the global minimum; expand its neighbors at its level; score each
neighbor at most once globally; enqueue each (neighbor, level) at most
once; descend the expanded node to level-1 with its own score; lower score
is better. The step is split at the host scoring boundary into
:func:`expand` (pop + gather + unique unscored candidate ids) and
:func:`integrate` (scores in, visited/enqueued updates, frontier push).

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

from dataclasses import dataclass

import numpy as np
import torch

from rad_tpu_torch.graph.storage import HNSWGraph

__all__ = ["DeviceGraph", "TraversalState", "DenseStateOps",
           "flatten_adjacency_host", "prepare_device_graph", "init_state",
           "auto_frontier_capacity", "expand", "integrate", "prime",
           "read_order_log", "gather_scores", "frontier_size",
           "frontier_empty", "frontier_live_scan", "AUTO_HEAD_CAPACITY",
           "AUTO_HEAD_THRESHOLD"]

INF = float("inf")


@dataclass
class DeviceGraph:
    """Traversal view of an HNSWGraph: one flat padded adjacency table.

    adj:     [R, M0] int32 — neighbor node ids, -1 padded; row r encodes
             (node, level) by the row trick.
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


def prepare_device_graph(graph: HNSWGraph, device) -> DeviceGraph:
    """Flatten the graph's tables on the host and upload them to
    ``device`` (int32 adjacency)."""
    adj, offsets_arr, m0, r = flatten_adjacency_host(graph)
    return DeviceGraph(
        adj=torch.from_numpy(adj).to(device),
        offsets=torch.from_numpy(offsets_arr).to(device),
        offsets_host=offsets_arr,
        n_nodes=len(graph),
        n_rows=r,
        m0=m0,
        max_level=graph.max_level,
    )


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
               head_capacity: int | None | str = "auto") -> TraversalState:
    """Empty traversal state on ``dg``'s device.

    The frontier is a sorted head plus an append buffer (merged by one
    sort when the buffer fills). ``head_capacity`` below
    ``frontier_capacity`` adds the two-level layout: a small sorted head
    and a ``frontier_capacity``-slot unsorted cold store for entries at or
    above the watermark. ``"auto"`` enables it (head =
    :data:`AUTO_HEAD_CAPACITY`) once the capacity reaches
    :data:`AUTO_HEAD_THRESHOLD`; ``None`` forces a single level.
    ``frontier_capacity=None`` auto-sizes (:func:`auto_frontier_capacity`).
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
        scores=full(dg.n_nodes + 1, INF, torch.float32),
        order_log=full(cap + 1, -1, torch.int32),
        n_scored=scalar(0),
        n_dropped=scalar(0),
        n_steps=scalar(0),
    )


def _set_drop_(arr: torch.Tensor, idx: torch.Tensor, vals) -> None:
    """``arr[idx] = vals`` in place; out-of-range indices write the
    trailing sentinel slot of ``arr`` instead (JAX ``mode="drop"``)."""
    size = arr.shape[0] - 1
    arr[torch.where((idx >= 0) & (idx < size), idx, size).long()] = vals


def _sorted(scores: torch.Tensor, rows: torch.Tensor):
    """Stable ascending sort of (score, row) pairs by score."""
    ss, order = torch.sort(scores, stable=True)
    return ss, rows[order]


def _level_of_row(dg: DeviceGraph, row: torch.Tensor) -> torch.Tensor:
    lev = torch.searchsorted(dg.offsets[: dg.max_level + 2], row,
                             right=True) - 1
    return torch.clamp(lev, 0, dg.max_level).to(torch.int32)


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
    out-of-range indices to the sentinel slot."""

    @staticmethod
    def gather(arr: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
        return arr[idx.long()]

    @staticmethod
    def scatter_(arr: torch.Tensor, idx: torch.Tensor, vals) -> None:
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


def _refill_two_level(state: TraversalState) -> None:
    """Rebuild the head from head-residual + buffer + cold (one sort).

    The best H entries become the sorted head, the next CC the (now
    sorted) cold store; anything past total capacity drops (counted). The
    watermark becomes the head's max."""
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
           ops: DenseStateOps = DENSE_OPS):
    """Pop the ``batch`` best frontier entries and gather their neighbors.

    Returns ``(state, out)`` with ``out`` a dict of device tensors:
      exp_node/exp_level/exp_score/exp_valid: [B] — the popped expansions;
      cand:     [B, M0] neighbor node ids (-1 invalid);
      to_score: [B*M0] unique unscored node ids, compacted to the front in
                adjacency order, -1 padded — the batch for host scoring.
    """
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
        if bool(need):
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
    cand = dg.adj[safe_row.long()].masked_fill(~valid[:, None], -1)

    n = dg.n_nodes
    cand_flat = cand.reshape(-1)
    cand_ok = cand_flat >= 0
    safe_cand = torch.where(cand_ok, cand_flat, 0)
    unscored = cand_ok & ~ops.gather(state.scored, safe_cand)
    ids = torch.where(unscored, cand_flat, n)
    # unique unscored ids compacted to the front, preserving adjacency
    # order (the scoring order of the reference's work items)
    mask = unscored & ops.first_occurrence(ids, n)
    k = ids.shape[0]
    pos = torch.cumsum(mask, 0) - 1
    to_score = torch.full((k + 1,), -1, dtype=torch.int32, device=dev)
    to_score[torch.where(mask, pos, k)] = cand_flat
    state.f_live = state.f_live - valid.sum()
    state.n_steps = state.n_steps + 1
    return state, {
        "exp_node": node,
        "exp_level": level,
        "exp_score": pop_score,
        "exp_valid": valid,
        "cand": cand,
        "to_score": to_score[:k],
    }


def integrate(state: TraversalState, dg: DeviceGraph,
              exp_node: torch.Tensor, exp_level: torch.Tensor,
              exp_score: torch.Tensor, exp_valid: torch.Tensor,
              cand: torch.Tensor, to_score: torch.Tensor,
              new_scores: torch.Tensor,
              ops: DenseStateOps = DENSE_OPS) -> TraversalState:
    """Integrate host scores and complete the traversal step: scored-set
    insert-if-absent + order-log append; per-(node, level) enqueued
    check-and-set; frontier push of new candidates; level descent of the
    expanded nodes; buffer append, or a merge when the buffer would
    overflow (worst entries spill to cold, or drop, counted)."""
    n = dg.n_nodes
    cap = state.order_log.shape[0] - 1
    dev = state.f_score.device
    b, m0 = cand.shape
    cand_flat = cand.reshape(-1)
    cand_ok = cand_flat >= 0
    safe_cand = torch.where(cand_ok, cand_flat, 0)
    lev_flat = exp_level.repeat_interleave(m0)
    row_flat = dg.offsets[lev_flat.long()] + safe_cand

    # -- scored set: insert-if-absent (a pipelined driver can deliver an
    # id in two in-flight batches; the first integration wins)
    ts_ok = to_score >= 0
    fresh = ts_ok & ~ops.gather(state.scored, torch.where(ts_ok, to_score, 0))
    ts_idx = torch.where(fresh, to_score, n)
    ops.scatter_(state.scores, ts_idx, new_scores)
    ops.scatter_(state.scored, ts_idx, True)

    # -- candidate enqueue: check-and-set at the expansion level
    first = ops.first_occurrence(torch.where(cand_ok, row_flat, dg.n_rows),
                                 dg.n_rows)
    not_enq = ~ops.gather(state.enqueued, torch.where(cand_ok, row_flat, 0))
    push = cand_ok & not_enq & first
    ops.scatter_(state.enqueued, torch.where(push, row_flat, dg.n_rows), True)
    cand_score = ops.gather(state.scores, safe_cand).masked_fill(~push, INF)

    pos_in_batch = torch.cumsum(fresh, 0) - 1
    log_pos = torch.where(fresh, (state.n_scored + pos_in_batch) % cap, cap)
    _set_drop_(state.order_log, log_pos, to_score)
    state.n_scored = state.n_scored + fresh.sum()
    cand_row_entry = torch.where(push, row_flat, 0)

    # -- descent: re-enqueue the expanded node at level-1
    can_desc = exp_valid & (exp_level > 0)
    down_row = dg.offsets[torch.clamp(exp_level - 1, min=0).long()] + exp_node
    down_ok = can_desc & ~ops.gather(state.enqueued,
                                     torch.where(can_desc, down_row, 0))
    down_ok &= _first_occurrence(torch.where(down_ok, down_row, dg.n_rows),
                                 dg.n_rows)
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

    if p_new > p or bool(state.f_buf_n + n_push > p):
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
    """Host float array of ``state.scores[ids]`` (gathered on device)."""
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
