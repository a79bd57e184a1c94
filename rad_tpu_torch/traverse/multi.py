"""Multi-campaign traversal: T independent screenings in one sweep.

Screening a receptor panel (DUDE-Z has 43 receptors) means T campaigns
over one library. The traversal step on a CUDA card is bound by the host's
kernel launches, not by the device's work, so T solo steps cost T times
the launches of one. Here the campaigns' states are stacked on a leading
T axis and ONE step's chain of operations serves them all: the launches
of a step do not depend on T, and aggregate scored molecules per second
grows with T while the step stays launch-bound. The graph and the
fingerprints are shared and read-only; only the per-campaign state
replicates.

This is ``rad_tpu.traverse.multi`` with the same semantics and the same
final states (array-equal through
:func:`~rad_tpu_torch.traverse.device.state_to_reference_arrays`). Where
JAX vmaps the solo step, the body below is written over the leading axis:
stable sorts and cumulative sums along the last dimension, and gathers
and scatters into the ``[T, X + 1]`` tables through their flat views with
one base per campaign, so every campaign keeps its own dropped-write
sentinel slot (the last column of its row) and a dropped write never lands
in the next campaign's row. The solo step
(:func:`~rad_tpu_torch.traverse.device.expand` /
:func:`~rad_tpu_torch.traverse.device.integrate`) stays beside it
unchanged; ``fused_candidates`` (K1/K2) is solo-only, as in the reference.

The host decisions of the solo step are lifted to one read for all
campaigns per step (:func:`_decide`): which campaigns are still active,
whether to merge (``any(active & (f_buf_n + p_new > P))``, the
conservative pre-step check of the reference: pop order does not depend
on merge timing) and whether to refill the two-level frontier
(refill every active campaign when any needs it: an exact rebuild, after
which only the pop order of equal scores can differ from a solo run).

Finished campaigns are frozen by leaving them out: a step runs over the
rows of the active campaigns only (an index list), so a frozen campaign's
tables are neither read nor written and its final state is what a solo
run to the same budget leaves. A ``where(active)`` over whole ``[T, N]``
tables, the reference's way, would move every table through memory every
step; the index list moves nothing and shrinks the step as campaigns
finish.

Not carried over from the reference: its batch and sort-width guards
(``_check_multi_batch``, ``MULTI_MAX_SORT_KEYS``), which work around a
program deadline and a compiler fault of the TPU path. ``allow_hazard``
is accepted and does nothing. One consequence: with an auto-sized
frontier on a graph of a million rows or more the reference clamps each
campaign's frontier below 2**20 entries and this module does not, so
drop counts can differ there. Torch indexes in int64, so the reference's
refusal of score tables with ``T * N >= 2**31`` entries is not needed
either.
"""

from __future__ import annotations

from dataclasses import fields

import numpy as np
import torch

from rad_tpu_torch.fp.pack import popcount
from rad_tpu_torch.fp.tanimoto import similarity_from_counts
from rad_tpu_torch.traverse import device as dev
from rad_tpu_torch.traverse.device import (INF, DeviceGraph, TraversalState,
                                           adjacency_rows)

__all__ = ["init_multi", "prime_multi", "multi_active_mask", "multi_step",
           "fused_run_multi", "fused_run_multi_tables", "campaign_state"]

# 0-d fields of a solo state ([T] when stacked)
_SCALARS = ("f_cursor", "f_buf_n", "f_live", "cold_n", "watermark",
            "n_scored", "n_dropped", "n_steps")


def init_multi(dg: DeviceGraph, n_campaigns: int,
               frontier_capacity: int | None = None,
               log_capacity: int | None = None,
               buffer_capacity: int = 1 << 15,
               head_capacity: int | None | str = None,
               allow_hazard: bool = False) -> TraversalState:
    """T stacked fresh states: one :class:`TraversalState` whose every
    field has a leading campaign axis. ``head_capacity`` enables the
    two-level frontier per campaign (``None``: one level)."""
    one = dev.init_state(dg, frontier_capacity, log_capacity,
                         buffer_capacity, head_capacity=head_capacity)
    return TraversalState(**{
        f.name: getattr(one, f.name).unsqueeze(0).repeat(
            n_campaigns, *([1] * getattr(one, f.name).dim()))
        for f in fields(TraversalState)})


def campaign_state(states: TraversalState, i: int) -> TraversalState:
    """Campaign ``i``'s state, as the single-campaign functions take it
    (``read_order_log``, ``save_state``, ``state_to_reference_arrays``).
    Its tensors are views of the stacked state."""
    return TraversalState(**{f.name: getattr(states, f.name)[i]
                             for f in fields(TraversalState)})


def prime_multi(states: TraversalState, dg: DeviceGraph,
                node_ids: torch.Tensor,
                node_scores: torch.Tensor) -> TraversalState:
    """Seed every campaign from the same top-layer nodes with its own
    scores (``node_ids [K]`` shared, ``node_scores [T, K]``). Runs once, so
    it is the solo :func:`~rad_tpu_torch.traverse.device.prime` on each
    campaign's views in turn."""
    for i in range(states.n_scored.shape[0]):
        solo = dev.prime(campaign_state(states, i), dg, node_ids,
                         node_scores[i])
        # tables were updated through the views; scalars were rebound
        for name in _SCALARS:
            getattr(states, name)[i] = getattr(solo, name)
    return states


def multi_active_mask(states: TraversalState, budgets) -> torch.Tensor:
    """``[T]`` bool: campaigns below their budget with a live frontier."""
    budgets = torch.as_tensor(budgets, device=states.n_scored.device)
    return (states.n_scored < budgets) & (states.f_live > 0)


# --------------------------------------------------------------------------
# Table access through flat views: entry (lane, i) of a [T, X + 1] table is
# element lane * (X + 1) + i, and i = X is that lane's sentinel slot.


def _get(table: torch.Tensor, lanes: torch.Tensor,
         idx: torch.Tensor) -> torch.Tensor:
    """``table[lanes[a], idx[a, j]]`` for pre-clamped ``idx`` [A, K]."""
    return table.view(-1)[lanes[:, None] * table.shape[1] + idx.long()]


def _put_drop_(table: torch.Tensor, lanes: torch.Tensor, idx: torch.Tensor,
               vals) -> None:
    """``table[lanes[a], idx[a, j]] = vals[a, j]`` in place; an index
    outside the logical ``[0, X)`` writes the lane's own sentinel slot.
    Only sentinel writes may repeat an index."""
    size = table.shape[1] - 1
    idx = torch.where((idx >= 0) & (idx < size), idx, size)
    flat = lanes[:, None] * table.shape[1] + idx.long()
    if torch.is_tensor(vals):
        table.view(-1)[flat] = vals
    else:
        # a Python scalar assigned through an index is first copied to
        # the device, which synchronises; index_fill_ takes it as is
        table.view(-1).index_fill_(0, flat.reshape(-1), vals)


def _first_occurrence_rows(values: torch.Tensor,
                           sentinel: int) -> torch.Tensor:
    """Per row, the mask of first occurrences of each value (sentinel
    excluded) in the original order: the solo engine's mask, one stable
    sort along the last dimension."""
    sv, perm = torch.sort(values, dim=1, stable=True)
    prev = torch.cat([torch.full_like(sv[:, :1], -1), sv[:, :-1]], 1)
    first = torch.zeros_like(values, dtype=torch.bool)
    first.scatter_(1, perm, (sv != prev) & (sv != sentinel))
    return first


def _sorted_rows(scores: torch.Tensor, rows: torch.Tensor):
    ss, order = torch.sort(scores, dim=1, stable=True)
    return ss, rows.gather(1, order)


def _reset_buffer_(st: TraversalState, lanes: torch.Tensor) -> None:
    st.f_cursor.index_fill_(0, lanes, 0)
    st.f_buf_score.index_fill_(0, lanes, INF)
    st.f_buf_row.index_fill_(0, lanes, 0)
    st.f_buf_n.index_fill_(0, lanes, 0)


def _live_head(st: TraversalState, lanes: torch.Tensor) -> torch.Tensor:
    """The lanes' sorted heads with the popped prefix masked to +inf."""
    c = st.f_score.shape[1]
    popped = torch.arange(c, device=lanes.device)[None, :] \
        < st.f_cursor[lanes][:, None]
    return st.f_score[lanes].masked_fill(popped, INF)


def _refill_(st: TraversalState, lanes: torch.Tensor) -> None:
    """The two-level refill of every lane: head-residual + buffer + cold
    through one sort; the best H entries become the head, the next CC the
    cold store, the rest drop (counted)."""
    h = st.f_score.shape[1]
    cc = st.cold_score.shape[1] - 1
    p = st.f_buf_score.shape[1] - 1
    ss, sr = _sorted_rows(
        torch.cat([_live_head(st, lanes), st.f_buf_score[lanes, :p],
                   st.cold_score[lanes, :cc]], 1),
        torch.cat([st.f_row[lanes], st.f_buf_row[lanes, :p],
                   st.cold_row[lanes, :cc]], 1))
    n_cold = torch.isfinite(ss[:, h:h + cc]).sum(1)
    dropped = torch.isfinite(ss[:, h + cc:]).sum(1)
    st.f_score[lanes] = ss[:, :h]
    st.f_row[lanes] = sr[:, :h]
    st.cold_score[lanes, :cc] = ss[:, h:h + cc]
    st.cold_row[lanes, :cc] = sr[:, h:h + cc]
    st.watermark[lanes] = torch.where(n_cold > 0, ss[:, h - 1], INF)
    _reset_buffer_(st, lanes)
    st.f_live[lanes] -= dropped.to(torch.int32)
    st.cold_n[lanes] = n_cold.to(torch.int32)
    st.n_dropped[lanes] += dropped.to(torch.int32)


def _expand_(st: TraversalState, dg: DeviceGraph, lanes: torch.Tensor,
             batch: int) -> dict:
    """:func:`~rad_tpu_torch.traverse.device.expand` for the campaigns
    ``lanes`` [A]: every output has a leading A axis."""
    b = batch
    c = st.f_score.shape[1]
    p = st.f_buf_score.shape[1] - 1
    if c < b:
        raise ValueError(f"frontier head capacity {c} < batch {b}")
    device = lanes.device
    col = lanes[:, None]
    cursor = st.f_cursor[lanes]
    # main candidates: the next B entries at the sorted head's cursor
    start = torch.clamp(cursor, max=c - b)
    offs = (start[:, None] + torch.arange(b, device=device)).long()
    main_s = st.f_score[col, offs].masked_fill(offs < cursor[:, None], INF)
    main_r = st.f_row[col, offs]
    # buffer candidates: its best B (ties to the smaller slot)
    buf_s, bidx = torch.sort(st.f_buf_score[lanes, :p], dim=1, stable=True)
    buf_s, bidx = buf_s[:, :b], bidx[:, :b]
    cat_s = torch.cat([main_s, buf_s], 1)
    cat_r = torch.cat([main_r, st.f_buf_row[col, bidx]], 1)
    sel = torch.sort(cat_s, dim=1, stable=True).indices[:, :b]
    pop_score = cat_s.gather(1, sel)
    pop_row = cat_r.gather(1, sel)
    valid = torch.isfinite(pop_score)
    st.f_cursor[lanes] = cursor + ((sel < b) & valid).sum(1).to(torch.int32)
    from_buf = (sel >= b) & valid
    buf_slot = torch.where(from_buf,
                           bidx.gather(1, torch.clamp(sel - b, min=0)), p)
    _put_drop_(st.f_buf_score, lanes, buf_slot, INF)  # slot p: sentinel

    level = dev._level_of_row(dg, pop_row)
    node = pop_row - dg.offsets[level.long()]
    safe_row = torch.where(valid, pop_row, 0)
    cand = adjacency_rows(dg, safe_row).masked_fill(~valid[:, :, None], -1)

    n = dg.n_nodes
    cand_flat = cand.reshape(cand.shape[0], -1)
    k = cand_flat.shape[1]
    cand_ok = cand_flat >= 0
    unscored = cand_ok & ~_get(st.scored, lanes,
                               torch.where(cand_ok, cand_flat, 0))
    # unique unscored ids compacted to the front, in adjacency order
    mask = unscored & _first_occurrence_rows(
        torch.where(unscored, cand_flat, n), n)
    pos = torch.cumsum(mask, 1) - 1
    to_score = torch.full((cand.shape[0], k + 1), -1, dtype=torch.int32,
                          device=device)
    to_score.scatter_(1, torch.where(mask, pos, k), cand_flat)
    st.f_live[lanes] -= valid.sum(1).to(torch.int32)
    st.n_steps[lanes] += 1
    return {"exp_node": node, "exp_level": level, "exp_score": pop_score,
            "exp_valid": valid, "cand": cand, "to_score": to_score[:, :k]}


def _integrate_(st: TraversalState, dg: DeviceGraph, lanes: torch.Tensor,
                out: dict, new_scores: torch.Tensor, merge: bool) -> None:
    """:func:`~rad_tpu_torch.traverse.device.integrate` for the campaigns
    ``lanes``, with the commit decided by the caller: ``merge`` sorts
    head-residual + buffer + pushes into a new head for every lane, else
    every lane appends (sound only when no lane's buffer can overflow)."""
    n, r_rows = dg.n_nodes, dg.n_rows
    cap = st.order_log.shape[1] - 1
    device = lanes.device
    exp_node, exp_level = out["exp_node"], out["exp_level"]
    exp_score, exp_valid = out["exp_score"], out["exp_valid"]
    cand, to_score = out["cand"], out["to_score"]
    a, b, m0 = cand.shape
    cand_flat = cand.reshape(a, -1)
    cand_ok = cand_flat >= 0
    safe_cand = torch.where(cand_ok, cand_flat, 0)
    row_flat = dg.offsets[exp_level.repeat_interleave(m0, dim=1).long()] \
        + safe_cand

    # -- scored set: insert-if-absent
    ts_ok = to_score >= 0
    fresh = ts_ok & ~_get(st.scored, lanes, torch.where(ts_ok, to_score, 0))
    ts_idx = torch.where(fresh, to_score, n)
    _put_drop_(st.scores, lanes, ts_idx, new_scores)
    _put_drop_(st.scored, lanes, ts_idx, True)

    # -- candidate enqueue: check-and-set at the expansion level
    first = _first_occurrence_rows(torch.where(cand_ok, row_flat, r_rows),
                                   r_rows)
    not_enq = ~_get(st.enqueued, lanes, torch.where(cand_ok, row_flat, 0))
    push = cand_ok & not_enq & first
    _put_drop_(st.enqueued, lanes, torch.where(push, row_flat, r_rows), True)
    cand_score = _get(st.scores, lanes, safe_cand).masked_fill(~push, INF)

    n_scored = st.n_scored[lanes]
    log_pos = torch.where(
        fresh, (n_scored[:, None] + torch.cumsum(fresh, 1) - 1) % cap, cap)
    _put_drop_(st.order_log, lanes, log_pos, to_score)
    st.n_scored[lanes] = n_scored + fresh.sum(1).to(torch.int32)
    cand_row_entry = torch.where(push, row_flat, 0)

    # -- descent: re-enqueue the expanded node at level-1
    can_desc = exp_valid & (exp_level > 0)
    down_row = dg.offsets[torch.clamp(exp_level - 1, min=0).long()] + exp_node
    down_ok = can_desc & ~_get(st.enqueued, lanes,
                               torch.where(can_desc, down_row, 0))
    down_ok &= _first_occurrence_rows(
        torch.where(down_ok, down_row, r_rows), r_rows)
    _put_drop_(st.enqueued, lanes, torch.where(down_ok, down_row, r_rows),
               True)
    desc_score = exp_score.masked_fill(~down_ok, INF)
    desc_row = torch.where(down_ok, down_row, 0)

    # -- frontier push, in candidate order
    new_s = torch.cat([cand_score, desc_score], 1)
    new_r = torch.cat([cand_row_entry, desc_row], 1)
    c = st.f_score.shape[1]
    p = st.f_buf_score.shape[1] - 1
    cc = st.cold_score.shape[1] - 1
    finite = torch.isfinite(new_s)
    cold_n = st.cold_n[lanes]
    if cc > 0:
        # two-level routing: scores below the watermark take the head /
        # buffer path; the rest append unsorted to the cold store
        qual = finite & (new_s < st.watermark[lanes][:, None])
        to_cold = finite & ~qual
        n_cold_new = to_cold.sum(1).to(torch.int32)
        pos_cold = torch.where(
            to_cold, cold_n[:, None] + torch.cumsum(to_cold, 1) - 1, cc)
        _put_drop_(st.cold_score, lanes, pos_cold, new_s)
        _put_drop_(st.cold_row, lanes, pos_cold, new_r)
        kept_cold = torch.clamp(cold_n + n_cold_new, max=cc) - cold_n
        cold_n = cold_n + kept_cold
        st.cold_n[lanes] = cold_n
        st.f_live[lanes] += kept_cold
        st.n_dropped[lanes] += n_cold_new - kept_cold
        buf_new = new_s.masked_fill(~qual, INF)
    else:
        buf_new = new_s
    fin = torch.isfinite(buf_new)
    n_push = fin.sum(1).to(torch.int32)

    if not merge and new_s.shape[1] <= p:
        pos = torch.where(
            fin, st.f_buf_n[lanes][:, None] + torch.cumsum(fin, 1) - 1, p)
        _put_drop_(st.f_buf_score, lanes, pos, buf_new)
        _put_drop_(st.f_buf_row, lanes, pos, new_r)
        st.f_buf_n[lanes] += n_push
        st.f_live[lanes] += n_push
        return
    # merge: overflow past the head spills to cold (two-level) or drops
    ss, sr = _sorted_rows(
        torch.cat([_live_head(st, lanes), st.f_buf_score[lanes, :p],
                   buf_new], 1),
        torch.cat([st.f_row[lanes], st.f_buf_row[lanes, :p], new_r], 1))
    spill_s, spill_r = ss[:, c:], sr[:, c:]
    spill_fin = torch.isfinite(spill_s)
    spill_n = spill_fin.sum(1).to(torch.int32)
    if cc > 0:
        sp_pos = torch.where(
            spill_fin,
            cold_n[:, None] + torch.arange(spill_s.shape[1], device=device),
            cc)
        _put_drop_(st.cold_score, lanes, sp_pos, spill_s)
        _put_drop_(st.cold_row, lanes, sp_pos, spill_r)
        kept = torch.clamp(cold_n + spill_n, max=cc) - cold_n
        st.cold_n[lanes] = cold_n + kept
        st.watermark[lanes] = torch.where(spill_n > 0, ss[:, c - 1],
                                          st.watermark[lanes])
        dropped_now = spill_n - kept
    else:
        dropped_now = spill_n
    st.f_score[lanes] = ss[:, :c]
    st.f_row[lanes] = sr[:, :c]
    _reset_buffer_(st, lanes)
    st.f_live[lanes] += n_push - dropped_now
    st.n_dropped[lanes] += dropped_now


# --------------------------------------------------------------------------
# The step and the loop.


def _decide(states: TraversalState, budgets: np.ndarray, batch: int,
            m0: int):
    """One host read of the campaigns' counters → ``(active [T] numpy
    bool, merge, refill)``, the scalar decisions of the coming step over
    the active campaigns only (a frozen campaign's near-full buffer or
    drained head must not force work for ever)."""
    n_scored, f_live, f_buf_n, cold_n = torch.stack(
        [states.n_scored, states.f_live, states.f_buf_n,
         states.cold_n]).cpu().numpy()
    active = (n_scored < budgets) & (f_live > 0)
    p = states.f_buf_score.shape[1] - 1
    p_new = batch * m0 + batch  # the most pushes a step can produce
    merge = bool(np.any(active & (f_buf_n + p_new > p)))
    refill = states.cold_score.shape[1] > 1 and bool(np.any(
        active & (f_live - cold_n < batch) & (cold_n > 0)))
    return active, merge, refill


def _step_(states: TraversalState, dg: DeviceGraph, lanes: torch.Tensor,
           batch: int, score, merge: bool, refill: bool) -> None:
    if refill:
        _refill_(states, lanes)
    out = _expand_(states, dg, lanes, batch)
    _integrate_(states, dg, lanes, out, score(lanes, out["to_score"]),
                merge)


def _lanes(active: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(np.flatnonzero(active)).to(device)


def multi_step(states: TraversalState, dg: DeviceGraph, budgets, batch: int,
               score) -> TraversalState:
    """One multi-campaign step: the lifted refill and commit decisions
    around expand → score → integrate over the active campaigns; finished
    campaigns are untouched. ``score(lanes [A], to_score [A, K]) -> [A, K]``
    f32 scores the step's ids, campaign ``lanes[a]`` scoring row ``a``
    (+inf on the -1 padding)."""
    budgets = np.broadcast_to(np.asarray(budgets, np.int64),
                              states.n_scored.shape)
    active, merge, refill = _decide(states, budgets, batch, dg.m0)
    if active.any():
        _step_(states, dg, _lanes(active, states.n_scored.device), batch,
               score, merge, refill)
    return states


def _multi_loop(states: TraversalState, dg: DeviceGraph, n_to_score,
                batch: int, max_steps: int, score) -> TraversalState:
    """Step while any campaign is active and fewer than ``max_steps``
    steps ran: the reference's ``while_loop`` as a host loop with one
    synchronisation a step (:func:`_decide`)."""
    t = states.n_scored.shape[0]
    if torch.is_tensor(n_to_score):
        n_to_score = n_to_score.cpu().numpy()
    budgets = np.broadcast_to(np.asarray(n_to_score, np.int64), (t,))
    device = states.n_scored.device
    key, lanes = None, None
    for _ in range(int(max_steps)):
        active, merge, refill = _decide(states, budgets, batch, dg.m0)
        if not active.any():
            break
        if key is None or not np.array_equal(active, key):
            key, lanes = active, _lanes(active, device)
        _step_(states, dg, lanes, batch, score, merge, refill)
    return states


def fused_run_multi(states: TraversalState, dg: DeviceGraph,
                    packed: torch.Tensor, pops: torch.Tensor,
                    targets: torch.Tensor, t_pops: torch.Tensor, n_to_score,
                    batch: int, max_steps: int = 1 << 20,
                    allow_hazard: bool = False) -> TraversalState:
    """Run all campaigns to their budgets (``n_to_score`` a scalar or
    ``[T]``), campaign t scoring by Tanimoto distance to ``targets[t]``
    (``[T, W]`` int32 bit views, ``t_pops [T]`` their popcounts).
    ``packed`` / ``pops`` as in
    :func:`~rad_tpu_torch.traverse.device.fused_run`. ``states`` is
    updated in place and returned."""
    def score(lanes, ts):
        ok = ts >= 0
        safe = torch.where(ok, ts, 0).long()
        inter = popcount(packed[safe] & targets[lanes][:, None, :]).sum(-1)
        union = t_pops[lanes][:, None] + pops[safe] - inter
        d = 1.0 - similarity_from_counts(inter, union)
        return torch.where(ok, d, INF)

    return _multi_loop(states, dg, n_to_score, batch, max_steps, score)


def fused_run_multi_tables(states: TraversalState, dg: DeviceGraph,
                           score_tables: torch.Tensor, n_to_score,
                           batch: int, max_steps: int = 1 << 20,
                           allow_hazard: bool = False) -> TraversalState:
    """The receptor-panel sweep: campaign t's score for node i is
    ``score_tables[t, i]`` (``[T, N]`` f32, one lookup-table scorer per
    receptor). Otherwise as :func:`fused_run_multi`."""
    n = score_tables.shape[1]
    flat = score_tables.reshape(-1)

    def score(lanes, ts):
        ok = ts >= 0
        safe = torch.where(ok, ts, 0).long()
        return torch.where(ok, flat[lanes[:, None] * n + safe], INF)

    return _multi_loop(states, dg, n_to_score, batch, max_steps, score)
