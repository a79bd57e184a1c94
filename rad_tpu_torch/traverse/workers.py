"""Scoring workers: pull work items, score unscored neighbors, submit results.

As in ``rad_tpu.traverse.workers`` (copied: that package loads jax): each
worker runs a heartbeat thread and a work-loop thread in the caller's
process; workers on other machines point at a server's coordination
endpoints through :class:`rad_tpu_torch.service.remote.RemoteCoordinationClient`.
A worker needs only a coordination handle and its scored set — it never
touches the graph (the coordinator pre-fetches neighbors).
"""

from __future__ import annotations

import collections
import logging
import threading
import time
import uuid
from typing import Callable, List, Optional

from rad_tpu_torch.traverse.coordinator import CoordinationService

logger = logging.getLogger(__name__)

__all__ = ["ScoringWorker", "WorkerPool", "create_worker_pool"]


class ScoringWorker:
    """One scoring executor."""

    def __init__(
        self,
        coordination_service: CoordinationService,
        scoring_fn: Callable[[str], float],
        worker_id: str | None = None,
        poll_interval: float = 0.05,
        max_errors_kept: int = 50,
    ) -> None:
        self.coordination_service = coordination_service
        self.scoring_fn = scoring_fn
        self.worker_id = worker_id or f"worker-{uuid.uuid4().hex[:8]}"
        self.poll_interval = poll_interval

        self._stop_event = threading.Event()
        self._work_thread: Optional[threading.Thread] = None
        self._heartbeat_thread: Optional[threading.Thread] = None
        self._running = False
        self._started_at: Optional[float] = None

        self.items_processed = 0
        self.molecules_scored = 0
        self.scoring_time = 0.0
        self.errors: collections.deque = collections.deque(
            maxlen=max_errors_kept)

    # ----------------------------------------------------------- lifecycle
    def start(self) -> None:
        if self._running:
            return
        self.coordination_service.register_worker(self.worker_id)
        self._stop_event.clear()
        self._running = True
        self._started_at = time.time()
        self._heartbeat_thread = threading.Thread(
            target=self._heartbeat_loop, name=f"{self.worker_id}-hb",
            daemon=True)
        self._work_thread = threading.Thread(
            target=self._work_loop, name=f"{self.worker_id}-work", daemon=True)
        self._heartbeat_thread.start()
        self._work_thread.start()

    def stop(self, timeout: float = 5.0) -> None:
        if not self._running:
            return
        self._stop_event.set()
        for t in (self._work_thread, self._heartbeat_thread):
            if t is not None:
                t.join(timeout=timeout)
        self._work_thread = None
        self._heartbeat_thread = None
        self._running = False
        self.coordination_service.unregister_worker(self.worker_id)

    @property
    def is_running(self) -> bool:
        return self._running

    # ---------------------------------------------------------------- loops
    def _heartbeat_loop(self) -> None:
        interval = self.coordination_service.heartbeat_interval
        while not self._stop_event.wait(interval):
            try:
                self.coordination_service.worker_heartbeat(self.worker_id)
            except Exception:
                logger.exception("%s heartbeat failed", self.worker_id)

    def _work_loop(self) -> None:
        while not self._stop_event.is_set():
            try:
                item = self.coordination_service.request_work(self.worker_id)
            except Exception as e:
                self._record_error(f"request_work: {e}")
                self._stop_event.wait(self.poll_interval)
                continue
            if item is None:
                self._stop_event.wait(self.poll_interval)
                continue
            try:
                results = self._process_work_item(item)
                self.coordination_service.submit_work_results(
                    self.worker_id, item.work_id, results)
                self.items_processed += 1
            except Exception as e:
                self._record_error(f"process {item.work_id}: {e}")
                logger.exception("%s failed processing %s", self.worker_id,
                                 item.work_id)
                # release the item for immediate requeue — without this a
                # transient scoring_fn failure strands the frontier entry
                # until the 2x-worker_timeout stale GC
                try:
                    self.coordination_service.fail_work(self.worker_id,
                                                        item.work_id)
                except Exception:
                    logger.exception("%s fail_work(%s) failed",
                                     self.worker_id, item.work_id)

    def _process_work_item(self, item) -> List[tuple]:
        """Score every neighbor not yet in the scored set; a scored one
        keeps its score. Pre-scored neighbors are looked up in one batched
        call when the scored set supports it — one round trip per work
        item instead of one per neighbor."""
        scored_set = self.coordination_service.scored_set
        existing: dict = {}
        if hasattr(scored_set, "get_scores_batch"):
            try:
                existing = scored_set.get_scores_batch(
                    [nid for nid, _ in item.neighbors])
            except Exception:
                existing = {}
        results = []
        for neighbor_id, smiles in item.neighbors:
            prior = existing.get(neighbor_id, Ellipsis)
            if prior is Ellipsis:
                prior = scored_set.getScore(neighbor_id)
            if prior is not None:
                results.append((neighbor_id, prior, smiles))
                continue
            t0 = time.perf_counter()
            score = float(self.scoring_fn(smiles))
            self.scoring_time += time.perf_counter() - t0
            self.molecules_scored += 1
            results.append((neighbor_id, score, smiles))
        return results

    def _record_error(self, msg: str) -> None:
        self.errors.append((time.time(), msg))
        try:
            self.coordination_service.report_worker_error(self.worker_id, msg)
        except Exception:
            pass

    # --------------------------------------------------------------- stats
    def get_worker_stats(self) -> dict:
        uptime = (time.time() - self._started_at) if self._started_at else 0.0
        return {
            "worker_id": self.worker_id,
            "running": self._running,
            "uptime_seconds": uptime,
            "items_processed": self.items_processed,
            "molecules_scored": self.molecules_scored,
            "total_scoring_time": self.scoring_time,
            "avg_scoring_ms": (1000.0 * self.scoring_time /
                               max(self.molecules_scored, 1)),
            "recent_errors": list(self.errors),
        }


class WorkerPool:
    """N workers on one node."""

    def __init__(
        self,
        coordination_service: CoordinationService,
        scoring_fn: Callable[[str], float],
        n_workers: int = 4,
        worker_id_prefix: str = "pool",
    ) -> None:
        self.workers = [
            ScoringWorker(
                coordination_service, scoring_fn,
                worker_id=f"{worker_id_prefix}-{i}-{uuid.uuid4().hex[:6]}",
            )
            for i in range(n_workers)
        ]

    def start_all(self) -> None:
        for w in self.workers:
            w.start()

    def stop_all(self, timeout: float = 5.0) -> None:
        for w in self.workers:
            w._stop_event.set()
        for w in self.workers:
            w.stop(timeout=timeout)

    def get_pool_stats(self) -> dict:
        stats = [w.get_worker_stats() for w in self.workers]
        return {
            "n_workers": len(self.workers),
            "running_workers": sum(1 for s in stats if s["running"]),
            "total_items_processed": sum(s["items_processed"] for s in stats),
            "total_molecules_scored": sum(s["molecules_scored"] for s in stats),
            "workers": stats,
        }


def create_worker_pool(coordination_service, scoring_fn, n_workers=4,
                       **kwargs) -> WorkerPool:
    """Factory, as ``rad_tpu``'s."""
    return WorkerPool(coordination_service, scoring_fn, n_workers, **kwargs)
