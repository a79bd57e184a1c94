"""The best-first traversal, written out plainly: the reference for every
traversal cell.

A frozen statement of the engine's semantics, in plain torch, that imports
nothing of the program. Pop the ``batch`` best (score, row) entries of the
frontier; gather each popped row's neighbours at its level; score each
neighbour at most once globally (in adjacency order, first occurrence
first); push each (neighbour, level) at most once with its score; push the
popped node one level down with its own score; lower is better. Row
``offsets[l] + node`` is ``(node, l)``.

The frontier is the one whose drops and tie order the cells measure: a
sorted head of ``head`` entries read at a cursor, an unsorted append
buffer of ``buffer`` entries merged by one stable sort when it would
overflow, and, when ``head < frontier``, an unsorted cold store of
``frontier`` entries at or above a watermark, refilled into the head by a
stable sort when head and buffer cannot fill a batch. Entries past the
capacity drop and are counted. Every selection is a stable ascending sort,
so ties keep their slot order.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

INF = float("inf")


def first_occurrence(values: torch.Tensor, sentinel: int) -> torch.Tensor:
    """True at each position that holds the first occurrence of its value,
    except where the value is ``sentinel``."""
    v = values.long()
    order = torch.sort(v, stable=True).indices
    sv = v[order]
    first_sorted = torch.ones_like(sv, dtype=torch.bool)
    first_sorted[1:] = sv[1:] != sv[:-1]
    mask = torch.empty_like(first_sorted)
    mask[order] = first_sorted
    return mask & (values != sentinel)


def put(arr: torch.Tensor, idx: torch.Tensor, vals) -> None:
    """``arr[idx] = vals``; indices outside ``[0, len - 1)`` write the last
    slot, which holds nothing."""
    size = arr.shape[0] - 1
    idx = torch.where((idx >= 0) & (idx < size), idx, size).long()
    if torch.is_tensor(vals):
        arr[idx] = vals.to(arr.dtype)
    else:
        arr.index_fill_(0, idx, vals)


def stable_sorted(scores: torch.Tensor, rows: torch.Tensor):
    ss, order = torch.sort(scores, stable=True)
    return ss, rows[order]


@dataclass
class Graph:
    """``adj [R, M0]`` int32 neighbour ids (-1 padded), ``offsets [L+2]``
    (layer starts, then R twice), ``n_nodes``."""

    adj: torch.Tensor
    offsets: np.ndarray
    n_nodes: int

    def __post_init__(self):
        self.n_rows = int(self.adj.shape[0])
        self.m0 = int(self.adj.shape[1])
        self.max_level = len(self.offsets) - 3
        self.offs = torch.as_tensor(np.asarray(self.offsets, np.int64),
                                    device=self.adj.device)

    def level_of_row(self, row: torch.Tensor) -> torch.Tensor:
        lev = torch.searchsorted(self.offs[: self.max_level + 2], row.long(),
                                 right=True) - 1
        return torch.clamp(lev, 0, self.max_level)


class Campaign:
    """One traversal's state on ``graph``'s device."""

    def __init__(self, g: Graph, frontier: int, head: int, buffer: int,
                 log: int | None = None):
        dev = g.adj.device
        self.g = g
        if head < frontier:
            h, cc = head, frontier
        else:
            h, cc = frontier, 0
        cap = g.n_nodes if log is None else log

        def full(n, value, dtype):
            return torch.full((n,), value, dtype=dtype, device=dev)

        self.f_score = full(h, INF, torch.float32)
        self.f_row = full(h, 0, torch.int64)
        self.cursor = 0
        self.b_score = full(buffer + 1, INF, torch.float32)
        self.b_row = full(buffer + 1, 0, torch.int64)
        self.b_n = 0
        self.live = 0
        self.c_score = full(cc + 1, INF, torch.float32)
        self.c_row = full(cc + 1, 0, torch.int64)
        self.c_n = 0
        self.watermark = INF
        self.enqueued = full(g.n_rows + 1, False, torch.bool)
        self.scored = full(g.n_nodes + 1, False, torch.bool)
        self.scores = full(g.n_nodes + 1, INF, torch.float32)
        self.log = full(cap + 1, -1, torch.int64)
        self.n_scored = 0
        self.n_dropped = 0
        self.n_steps = 0

    # -- the frontier -------------------------------------------------------
    def _resort(self, extra_s, extra_r):
        """Head residual + buffer + ``extra`` → one stable sort; the head
        takes the best, the rest spill to cold (counted drops past it)."""
        h = self.f_score.shape[0]
        p = self.b_score.shape[0] - 1
        cc = self.c_score.shape[0] - 1
        dev = self.f_score.device
        live = torch.arange(h, device=dev) >= self.cursor
        ss, sr = stable_sorted(
            torch.cat([self.f_score.masked_fill(~live, INF),
                       self.b_score[:p], extra_s]),
            torch.cat([self.f_row, self.b_row[:p], extra_r]))
        spill_s, spill_r = ss[h:], sr[h:]
        spill_n = int(torch.isfinite(spill_s).sum())
        if cc > 0:
            pos = torch.where(torch.isfinite(spill_s),
                              self.c_n + torch.arange(spill_s.shape[0],
                                                      device=dev), cc)
            put(self.c_score, pos, spill_s)
            put(self.c_row, pos, spill_r)
            kept = min(self.c_n + spill_n, cc) - self.c_n
            self.c_n += kept
            if spill_n > 0:
                self.watermark = float(ss[h - 1])
            lost = spill_n - kept
        else:
            lost = spill_n
        self.f_score.copy_(ss[:h])
        self.f_row.copy_(sr[:h])
        self.cursor = 0
        self.b_score.fill_(INF)
        self.b_row.zero_()
        self.b_n = 0
        return lost

    def _refill(self):
        """Head residual + buffer + cold → a new head and a sorted cold."""
        h = self.f_score.shape[0]
        cc = self.c_score.shape[0] - 1
        p = self.b_score.shape[0] - 1
        dev = self.f_score.device
        live = torch.arange(h, device=dev) >= self.cursor
        ss, sr = stable_sorted(
            torch.cat([self.f_score.masked_fill(~live, INF),
                       self.b_score[:p], self.c_score[:cc]]),
            torch.cat([self.f_row, self.b_row[:p], self.c_row[:cc]]))
        n_cold = int(torch.isfinite(ss[h:h + cc]).sum())
        dropped = int(torch.isfinite(ss[h + cc:]).sum())
        self.f_score.copy_(ss[:h])
        self.f_row.copy_(sr[:h])
        self.c_score[:cc] = ss[h:h + cc]
        self.c_row[:cc] = sr[h:h + cc]
        self.watermark = float(ss[h - 1]) if n_cold > 0 else INF
        self.cursor = 0
        self.b_score.fill_(INF)
        self.b_row.zero_()
        self.b_n = 0
        self.live -= dropped
        self.c_n = n_cold
        self.n_dropped += dropped

    # -- the steps ------------------------------------------------------------
    def _log_fresh(self, ids: torch.Tensor, fresh: torch.Tensor) -> None:
        cap = self.log.shape[0] - 1
        pos = torch.cumsum(fresh.long(), 0) - 1
        put(self.log, torch.where(fresh, (self.n_scored + pos) % cap, cap),
            ids.long())
        self.n_scored += int(fresh.sum())

    def prime(self, ids: torch.Tensor, scores: torch.Tensor) -> None:
        """Score ``ids`` (top-layer nodes) and push them at level
        ``max(0, L - 1)``."""
        g = self.g
        ids = ids.long()
        ok = ids >= 0
        safe = torch.where(ok, ids, 0)
        row = int(g.offsets[max(0, g.max_level - 1)]) + safe
        fresh = (ok & first_occurrence(torch.where(ok, row, g.n_rows),
                                       g.n_rows)
                 & ~(self.scored[safe] | ~ok) & ~(self.enqueued[row] | ~ok))
        idx = torch.where(fresh, ids, g.n_nodes)
        put(self.scores, idx, scores.float())
        put(self.scored, idx, True)
        self._log_fresh(ids, fresh)
        put(self.enqueued, torch.where(fresh, row, g.n_rows), True)
        entry_s = scores.float().masked_fill(~fresh, INF)
        entry_r = torch.where(fresh, row, 0)
        lost = self._resort(entry_s, entry_r)
        if self.c_score.shape[0] > 1:
            self.n_dropped += lost
        self.live += int(torch.isfinite(entry_s).sum()) - lost

    def step(self, batch: int, score_fn) -> None:
        """One step: pop, gather, score ``to_score`` with ``score_fn(ids
        [K] int64, -1 padded) -> [K] f32``, integrate."""
        g = self.g
        dev = self.f_score.device
        h = self.f_score.shape[0]
        p = self.b_score.shape[0] - 1
        cc = self.c_score.shape[0] - 1
        n = g.n_nodes
        if cc > 0 and self.live - self.c_n < batch and self.c_n > 0:
            self._refill()
        # pop: the next `batch` head entries and the buffer's best `batch`
        start = min(self.cursor, h - batch)
        offs = start + torch.arange(batch, device=dev)
        main_s = self.f_score[offs].masked_fill(offs < self.cursor, INF)
        main_r = self.f_row[offs]
        buf_s, bidx = torch.sort(self.b_score[:p], stable=True)
        buf_s, bidx = buf_s[:batch], bidx[:batch]
        cat_s = torch.cat([main_s, buf_s])
        cat_r = torch.cat([main_r, self.b_row[bidx]])
        sel = torch.sort(cat_s, stable=True).indices[:batch]
        pop_s, pop_r = cat_s[sel], cat_r[sel]
        valid = torch.isfinite(pop_s)
        self.cursor += int(((sel < batch) & valid).sum())
        from_buf = (sel >= batch) & valid
        put(self.b_score, torch.where(from_buf,
                                      bidx[torch.clamp(sel - batch, min=0)],
                                      p), INF)
        level = g.level_of_row(pop_r)
        node = pop_r - g.offs[level]
        cand = g.adj[torch.where(valid, pop_r, 0)].long().masked_fill(
            ~valid[:, None], -1)
        flat = cand.reshape(-1)
        k = flat.shape[0]
        ok = flat >= 0
        unscored = ok & ~self.scored[torch.where(ok, flat, 0)]
        mask = unscored & first_occurrence(torch.where(unscored, flat, n), n)
        to_score = torch.full((k + 1,), -1, dtype=torch.int64, device=dev)
        to_score[torch.where(mask, torch.cumsum(mask.long(), 0) - 1, k)] = flat
        to_score = to_score[:k]
        self.live -= int(valid.sum())
        self.n_steps += 1
        new_scores = score_fn(to_score).float()

        # integrate: the scored set, first writer wins
        ts_ok = to_score >= 0
        fresh = ts_ok & ~self.scored[torch.where(ts_ok, to_score, 0)]
        idx = torch.where(fresh, to_score, n)
        put(self.scores, idx, new_scores)
        put(self.scored, idx, True)
        m0 = cand.shape[1]
        row = g.offs[level.repeat_interleave(m0)] + torch.where(ok, flat, 0)
        first = first_occurrence(torch.where(ok, row, g.n_rows), g.n_rows)
        push = ok & ~self.enqueued[torch.where(ok, row, 0)] & first
        put(self.enqueued, torch.where(push, row, g.n_rows), True)
        cand_s = self.scores[torch.where(ok, flat, 0)].masked_fill(~push, INF)
        self._log_fresh(to_score, fresh)
        cand_r = torch.where(push, row, 0)
        # descent: the popped node one level down, with its own score
        can = valid & (level > 0)
        down = g.offs[torch.clamp(level - 1, min=0)] + node
        down_ok = can & ~self.enqueued[torch.where(can, down, 0)]
        down_ok &= first_occurrence(torch.where(down_ok, down, g.n_rows),
                                    g.n_rows)
        put(self.enqueued, torch.where(down_ok, down, g.n_rows), True)
        new_s = torch.cat([cand_s, pop_s.masked_fill(~down_ok, INF)])
        new_r = torch.cat([cand_r, torch.where(down_ok, down, 0)])
        finite = torch.isfinite(new_s)
        if cc > 0:
            qual = finite & (new_s < self.watermark)
            n_push = int(qual.sum())
            to_cold = finite & ~qual
            n_cold_new = int(to_cold.sum())
            pos = torch.where(to_cold,
                              self.c_n + torch.cumsum(to_cold.long(), 0) - 1,
                              cc)
            put(self.c_score, pos, new_s)
            put(self.c_row, pos, new_r)
            kept = min(self.c_n + n_cold_new, cc) - self.c_n
            self.c_n += kept
            self.live += kept
            self.n_dropped += n_cold_new - kept
            buf_new = new_s.masked_fill(~qual, INF)
        else:
            n_push = int(finite.sum())
            buf_new = new_s
        if new_s.shape[0] > p or self.b_n + n_push > p:
            lost = self._resort(buf_new, new_r)
            self.live += n_push - lost
            self.n_dropped += lost
        else:
            fin = torch.isfinite(buf_new)
            pos = torch.where(fin, self.b_n + torch.cumsum(fin.long(), 0) - 1,
                              p)
            put(self.b_score, pos, buf_new)
            put(self.b_row, pos, new_r)
            self.b_n += n_push
            self.live += n_push

    def run(self, batch: int, score_fn, n_to_score: int,
            max_steps: int = 1 << 20) -> None:
        """Step while fewer than ``n_to_score`` are scored, fewer than
        ``max_steps`` steps ran and the frontier holds an entry."""
        steps = 0
        while steps < max_steps:
            if self.n_scored >= n_to_score or self.live <= 0:
                break
            self.step(batch, score_fn)
            steps += 1

    def order(self) -> np.ndarray:
        """Scored ids in scoring order (the log holds them all)."""
        return self.log[: self.n_scored].cpu().numpy()

    def scores_of(self, ids: np.ndarray) -> np.ndarray:
        idx = torch.from_numpy(np.asarray(ids, np.int64)).to(
            self.scores.device)
        return self.scores[idx].cpu().numpy()
