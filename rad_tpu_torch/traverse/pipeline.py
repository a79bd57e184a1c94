"""Pipelined host-scoring traversal loop, engine-agnostic.

Drives any engine whose step splits at the scoring boundary into
``expand`` (pop + gather + emit candidate ids) and ``integrate`` (write
scores + frontier merge). ``pipeline_depth > 1`` keeps that many expansion
batches in flight: the device expands batch k+1 while the host scores
batch k. Every once-only invariant holds at any depth, because integrate's
insert-if-absent drops ids scored by an earlier in-flight batch.
"""

from __future__ import annotations

import collections
import logging
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Optional, Tuple

import numpy as np

from rad_tpu_torch.utils.profiling import _read_back

logger = logging.getLogger(__name__)

__all__ = ["pipelined_traverse", "HostScoringBridge"]


class HostScoringBridge:
    """id batch → SMILES lookup → threaded ``scoring_fn`` calls → scores.

    Maps node ids through the key table to SMILES (store optional: without
    one the SMILES is the key as a string), fans the per-molecule calls
    over a thread pool (docking programs are subprocess- or IO-bound), and
    records a failing call as ``failed_score`` instead of ending the
    sweep."""

    def __init__(self, keys: np.ndarray, scoring_fn, smiles_store=None,
                 n_score_threads: int = 8,
                 failed_score: float = float("inf"),
                 stats: Optional[dict] = None):
        from rad_tpu_torch.graph.storage import host_keys_view
        self.keys = host_keys_view(keys)
        self.scoring_fn = scoring_fn
        self.smiles_store = smiles_store
        self.failed_score = failed_score
        self.stats = stats if stats is not None else {}
        self.stats.setdefault("scoring_errors", 0)
        self._pool = (ThreadPoolExecutor(max_workers=n_score_threads,
                                         thread_name_prefix="rad-score")
                      if n_score_threads > 1 else None)

    def smiles_for_ids(self, ids: np.ndarray):
        keys = self.keys[ids]
        if self.smiles_store is None:
            return [str(int(k)) for k in keys]
        return self.smiles_store.get_smiles_list(keys.tolist())

    def score_smiles(self, smiles) -> np.ndarray:
        def one(s: str) -> float:
            try:
                return float(self.scoring_fn(s))
            except Exception:  # a failed docking call scores as failed
                self.stats["scoring_errors"] += 1
                logger.exception("scoring_fn failed for %r", s)
                return self.failed_score

        if self._pool is not None and len(smiles) > 1:
            out = list(self._pool.map(one, smiles))
        else:
            out = [one(s) for s in smiles]
        return np.asarray(out, dtype=np.float32)

    def score_batch(self, to_score: np.ndarray) -> np.ndarray:
        """Score a -1-padded id batch; padding positions get 0 (ignored by
        integrate's insert-if-absent mask)."""
        ids = to_score[to_score >= 0]
        new_scores = np.zeros(to_score.shape, np.float32)
        if ids.size:
            new_scores[: ids.size] = self.score_smiles(
                self.smiles_for_ids(ids))
        return new_scores

    def shutdown(self):
        if self._pool is not None:
            self._pool.shutdown(wait=False)
            self._pool = None


def pipelined_traverse(
    state,
    expand: Callable,
    integrate: Callable,
    score_batch: Callable[[np.ndarray], np.ndarray],
    *,
    n_scored_of: Callable,
    n_to_score: Optional[int] = None,
    timeout: Optional[float] = None,
    pipeline_depth: int = 1,
    stats: Optional[dict] = None,
    after_integrate: Optional[Callable] = None,
) -> Tuple[object, str]:
    """Run expand → host-score → integrate until a stop condition.

    expand(state) -> (state, out)   out: dict with "to_score" [K] int32
                                    (-1 padded) and "exp_valid" [B] bool
    integrate(state, out, new_scores np [K] f32) -> state
    score_batch(to_score np [K]) -> np [K] f32
    after_integrate(state) — optional host hook after every integrate

    Termination reasons: ``n_to_score``, ``timeout``, ``queue_empty``.
    Returns (state, reason).
    """
    if n_to_score is None and timeout is None:
        raise ValueError("provide n_to_score and/or timeout")
    if stats is None:
        stats = {}
    stats.setdefault("steps", 0)
    stats.setdefault("scoring_time", 0.0)
    stats.setdefault("device_time", 0.0)

    score_pool = (
        ThreadPoolExecutor(max_workers=max(pipeline_depth, 1),
                           thread_name_prefix="rad-batch")
        if pipeline_depth > 1 else None)
    start = time.monotonic()
    stats["started_at"] = start
    reason = None
    inflight = collections.deque()

    def _timed_score(to_score: np.ndarray) -> np.ndarray:
        t0 = time.perf_counter()
        out = score_batch(to_score)
        stats["scoring_time"] += time.perf_counter() - t0
        return out

    def _integrate(state, out, to_score, fut):
        new_scores = fut.result() if fut is not None \
            else _timed_score(to_score)
        t0 = time.perf_counter()
        state = integrate(state, out, new_scores)
        stats["device_time"] += time.perf_counter() - t0
        stats["steps"] += 1
        if after_integrate is not None:
            after_integrate(state)
        return state

    try:
        while True:
            if timeout is not None and time.monotonic() - start > timeout:
                reason = "timeout"
                break
            if n_to_score is not None and n_scored_of(state) >= n_to_score:
                reason = "n_to_score"
                break
            expanded_empty = False
            while len(inflight) < max(pipeline_depth, 1):
                t0 = time.perf_counter()
                state, out = expand(state)
                with _read_back("download"):
                    to_score = out["to_score"].cpu().numpy()
                with _read_back("download"):
                    exp_valid = out["exp_valid"].cpu().numpy()
                stats["device_time"] += time.perf_counter() - t0
                if not exp_valid.any():
                    expanded_empty = True
                    break
                fut = (score_pool.submit(_timed_score, to_score)
                       if score_pool is not None else None)
                inflight.append((out, to_score, fut))
            if not inflight:
                if expanded_empty:
                    reason = "queue_empty"
                    break
                continue
            state = _integrate(state, *inflight.popleft())
        # drain in-flight batches so their pops aren't lost
        while inflight:
            state = _integrate(state, *inflight.popleft())
    finally:
        if score_pool is not None:
            score_pool.shutdown(wait=False)
    stats["termination_reason"] = reason
    stats["runtime_seconds"] = time.monotonic() - start
    return state, reason
