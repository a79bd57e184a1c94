"""Coordination service: work distribution, liveness, termination.

The host engine's coordinator, as in ``rad_tpu.traverse.coordinator``
(copied: that package loads jax):

  * workers never touch the graph: ``request_work`` pops the best
    (node, level, score) from the frontier and pre-fetches that node's
    neighbors, so a work item carries everything a scorer needs;
  * ``submit_work_results`` performs the traversal step: per-neighbor
    visited check-and-insert at the work item's level, scored-set
    insert-if-absent, frontier push, then the level descent — re-enqueue
    the expanded node at level-1 with its own score;
  * heartbeats and dead-worker detection with in-flight work
    reassignment; results for reassigned work are dropped;
  * termination on timeout / n_to_score / empty-frontier-and-idle.

No molecule is scored twice under concurrent workers:
``ScoredSet.insert`` is insert-if-absent.
"""

from __future__ import annotations

import logging
import threading
import time
import uuid
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from rad_tpu_torch.traverse.structures import (
    HostPriorityQueue,
    HostScoredSet,
    HostVisitedSet,
    PriorityQueue,
    ScoredSet,
    VisitedSet,
)

logger = logging.getLogger(__name__)

__all__ = ["WorkItem", "WorkerInfo", "CoordinationService",
           "create_coordination_service"]


@dataclass
class WorkItem:
    """A unit of traversal work: one (node, level) expansion with pre-fetched
    neighbors."""

    node_id: int
    level: int
    score: float
    neighbors: List[Tuple[int, str]]  # (neighbor_id, smiles)
    work_id: str = field(default_factory=lambda: str(uuid.uuid4()))
    assigned_to: Optional[str] = None
    assigned_at: Optional[float] = None

    def to_dict(self) -> dict:
        return {
            "work_id": self.work_id,
            "node_id": self.node_id,
            "level": self.level,
            "score": self.score,
            "neighbors": [[i, s] for i, s in self.neighbors],
            "assigned_to": self.assigned_to,
            "assigned_at": self.assigned_at,
        }

    @classmethod
    def from_dict(cls, d: dict) -> "WorkItem":
        return cls(
            node_id=int(d["node_id"]),
            level=int(d["level"]),
            score=float(d["score"]),
            neighbors=[(int(i), s) for i, s in d.get("neighbors", [])],
            work_id=d.get("work_id") or str(uuid.uuid4()),
            assigned_to=d.get("assigned_to"),
            assigned_at=d.get("assigned_at"),
        )


@dataclass
class WorkerInfo:
    """Worker registration record."""

    worker_id: str
    registered_at: float = field(default_factory=time.time)
    last_heartbeat: float = field(default_factory=time.time)
    assigned_work: set = field(default_factory=set)
    completed_count: int = 0
    error_count: int = 0
    status: str = "active"  # active | dead | shutdown

    def to_dict(self) -> dict:
        return {
            "worker_id": self.worker_id,
            "registered_at": self.registered_at,
            "last_heartbeat": self.last_heartbeat,
            "assigned_work": sorted(self.assigned_work),
            "completed_count": self.completed_count,
            "error_count": self.error_count,
            "status": self.status,
        }


class CoordinationService:
    """Distributes traversal work to scoring workers and owns shared state."""

    def __init__(
        self,
        hnsw_service,
        priority_queue: PriorityQueue | None = None,
        visited_set: VisitedSet | None = None,
        scored_set: ScoredSet | None = None,
        worker_timeout: float = 60.0,
        heartbeat_interval: float = 10.0,
        namespace: str = "rad",
        monitor_interval: float = 1.0,
    ) -> None:
        self.hnsw_service = hnsw_service
        self.priority_queue = priority_queue or HostPriorityQueue()
        self.visited_set = visited_set or HostVisitedSet()
        self.scored_set = scored_set or HostScoredSet()
        self.worker_timeout = worker_timeout
        self.heartbeat_interval = heartbeat_interval
        self.namespace = namespace
        self.monitor_interval = monitor_interval

        self._workers: Dict[str, WorkerInfo] = {}
        self._outstanding: Dict[str, WorkItem] = {}
        # requests between queue-pop and assignment registration; counted as
        # outstanding so the termination probe can't fire in the window
        self._inflight = 0
        self._lock = threading.RLock()
        self._running = False
        self._start_time: Optional[float] = None
        self._monitor_thread: Optional[threading.Thread] = None
        self._stop_event = threading.Event()
        self._termination: Optional[str] = None
        # neighbor-prefetch timing stats
        self._neighbor_fetch_time = 0.0
        self._neighbor_fetch_count = 0
        self._reassigned_count = 0

    # ----------------------------------------------------------- lifecycle
    def start(self) -> None:
        with self._lock:
            if self._running:
                return
            self._running = True
            self._start_time = time.time()
            self._stop_event.clear()
            self._monitor_thread = threading.Thread(
                target=self._monitor_loop, name="coord-monitor", daemon=True
            )
            self._monitor_thread.start()
        logger.info("coordination service started (namespace=%s)",
                    self.namespace)

    def shutdown(self) -> None:
        with self._lock:
            if not self._running:
                return
            self._running = False
        self._stop_event.set()
        if self._monitor_thread is not None:
            self._monitor_thread.join(timeout=5.0)
            self._monitor_thread = None
        logger.info("coordination service shut down")

    @property
    def is_running(self) -> bool:
        return self._running

    # ------------------------------------------------------------- workers
    def register_worker(self, worker_id: str) -> dict:
        with self._lock:
            info = self._workers.get(worker_id)
            if info is not None:
                # re-registration (retried POST after a lost response, or a
                # worker process restart): keep the record — replacing it
                # would empty assigned_work and strand that worker's
                # in-flight items until the 2x-timeout stale GC instead of
                # requeueing them the moment the worker dies/unregisters
                info.last_heartbeat = time.time()
                info.status = "active"
            else:
                self._workers[worker_id] = WorkerInfo(worker_id=worker_id)
        return {
            "worker_id": worker_id,
            "heartbeat_interval": self.heartbeat_interval,
            "worker_timeout": self.worker_timeout,
        }

    def worker_heartbeat(self, worker_id: str) -> bool:
        with self._lock:
            info = self._workers.get(worker_id)
            if info is None:
                return False
            info.last_heartbeat = time.time()
            if info.status == "dead":
                info.status = "active"
            return True

    def unregister_worker(self, worker_id: str) -> None:
        with self._lock:
            info = self._workers.get(worker_id)
            if info is not None:
                info.status = "shutdown"
                self._reassign_worker_assignments(worker_id)

    # ---------------------------------------------------------------- work
    def request_work(self, worker_id: str) -> Optional[WorkItem]:
        """Pop the globally best frontier entry and pre-fetch its neighbors."""
        with self._lock:
            self._inflight += 1
        try:
            popped = self.priority_queue.pop()
            if popped is None:
                return None
            node_id, level, score = popped
            t0 = time.perf_counter()
            try:
                flat = self.hnsw_service.get_neighbors(node_id, level)
            except Exception:
                logger.exception("neighbor prefetch failed; re-enqueueing "
                                 "(%s, %s)", node_id, level)
                self.priority_queue.insert(node_id, level, score)
                return None
            self._neighbor_fetch_time += time.perf_counter() - t0
            self._neighbor_fetch_count += 1
            # service layer returns flat [id, smiles, id, smiles, ...] pairs
            neighbors = list(zip(flat[0::2], flat[1::2]))
            item = WorkItem(
                node_id=node_id, level=level, score=score,
                neighbors=[(int(i), str(s)) for i, s in neighbors],
                assigned_to=worker_id, assigned_at=time.time(),
            )
            with self._lock:
                self._outstanding[item.work_id] = item
                info = self._workers.get(worker_id)
                if info is not None:
                    info.assigned_work.add(item.work_id)
            return item
        finally:
            with self._lock:
                self._inflight -= 1

    def submit_work_results(
        self,
        worker_id: str,
        work_id: str,
        results: List[Tuple[int, float, str]],
    ) -> bool:
        """Integrate scored neighbors — the traversal step (SURVEY.md §0).

        The assignment record is cleared only *after* results are pushed into
        the frontier, so the termination probe never observes an empty queue
        with the results still in flight.
        """
        with self._lock:
            item = self._outstanding.get(work_id)
        if item is None:
            # Stale submission for reassigned/expired work — the item was
            # re-enqueued and will be (or was) re-processed; dropping the
            # stale results is safe because state inserts are idempotent.
            logger.warning("submission for unknown work_id %s", work_id)
            return False
        for neighbor_id, score, smiles in results:
            if self.visited_set.checkAndInsert(neighbor_id, item.level):
                continue
            self.scored_set.insert(neighbor_id, score, smiles)
            self.priority_queue.insert(neighbor_id, item.level, score)
        # Level descent: drain the expanded node through lower layers.
        if item.level > 0:
            if not self.visited_set.checkAndInsert(item.node_id, item.level - 1):
                self.priority_queue.insert(item.node_id, item.level - 1,
                                           item.score)
        with self._lock:
            self._outstanding.pop(work_id, None)
            info = self._workers.get(worker_id)
            if info is not None:
                info.assigned_work.discard(work_id)
                info.completed_count += 1
        return True

    def report_worker_error(self, worker_id: str, error: str) -> None:
        with self._lock:
            info = self._workers.get(worker_id)
            if info is not None:
                info.error_count += 1

    def fail_work(self, worker_id: str, work_id: str) -> bool:
        """Release a work item whose processing failed so it is requeued
        NOW instead of stranding until the 2x-worker_timeout stale GC (a
        transient scoring_fn exception must not stall the frontier entry
        for minutes). Returns True if the item was outstanding."""
        with self._lock:
            item = self._outstanding.pop(work_id, None)
            info = self._workers.get(worker_id)
            if info is not None:
                info.assigned_work.discard(work_id)
            if item is None:
                return False
            self._requeue_item(item)
            return True

    # ---------------------------------------------------------- monitoring
    def _monitor_loop(self) -> None:
        while not self._stop_event.wait(self.monitor_interval):
            now = time.time()
            with self._lock:
                for worker_id, info in self._workers.items():
                    if info.status != "active":
                        continue
                    if now - info.last_heartbeat > self.worker_timeout:
                        logger.warning("worker %s timed out; reassigning %d "
                                       "work items", worker_id,
                                       len(info.assigned_work))
                        info.status = "dead"
                        self._reassign_worker_assignments(worker_id)
                # stale-assignment GC
                stale = [
                    wid for wid, item in self._outstanding.items()
                    if item.assigned_at is not None
                    and now - item.assigned_at > 2 * self.worker_timeout
                ]
                for wid in stale:
                    self._requeue_item(self._outstanding.pop(wid))

    def _reassign_worker_assignments(self, worker_id: str) -> None:
        """Re-enqueue a lost worker's in-flight work (requires _lock held)."""
        info = self._workers.get(worker_id)
        if info is None:
            return
        for wid in list(info.assigned_work):
            item = self._outstanding.pop(wid, None)
            if item is not None:
                self._requeue_item(item)
        info.assigned_work.clear()

    def _requeue_item(self, item: WorkItem) -> None:
        self.priority_queue.insert(item.node_id, item.level, item.score)
        self._reassigned_count += 1

    # --------------------------------------------------------- termination
    def reset_termination(self) -> None:
        """Clear the sticky termination verdict and restart the timeout
        epoch. Call at the start of each traverse() round: without this, a
        second traverse() on the same service instantly returns the FIRST
        round's reason ('n_to_score' from a smaller budget), and its
        ``timeout`` is measured from the first round's start."""
        with self._lock:
            self._termination = None
            self._start_time = time.time()

    def check_termination(
        self,
        n_to_score: Optional[int] = None,
        timeout: Optional[float] = None,
    ) -> Tuple[bool, Optional[str]]:
        """Evaluate the three stop conditions."""
        if self._termination is not None:
            return True, self._termination
        if timeout is not None and self._start_time is not None:
            if time.time() - self._start_time > timeout:
                self._termination = "timeout"
                return True, self._termination
        if n_to_score is not None and len(self.scored_set) >= n_to_score:
            self._termination = "n_to_score"
            return True, self._termination
        with self._lock:
            # queue length must be read in the SAME critical section as the
            # outstanding count: request_work increments _inflight under
            # _lock BEFORE popping, so inflight==0 here means no pop can be
            # in progress — reading the queue after releasing the lock
            # allowed a pop in the gap to fake a 'queue_empty' termination
            # while the last item was mid-assignment.
            outstanding = len(self._outstanding) + self._inflight
            queue_len = len(self.priority_queue)
        if outstanding == 0 and queue_len == 0:
            self._termination = "queue_empty"
            return True, self._termination
        return False, None

    # --------------------------------------------------------------- stats
    def get_coordination_stats(self) -> dict:
        with self._lock:
            workers = {wid: info.to_dict()
                       for wid, info in self._workers.items()}
            active = sum(1 for i in self._workers.values()
                         if i.status == "active")
            outstanding = len(self._outstanding)
        runtime = (time.time() - self._start_time) if self._start_time else 0.0
        fetches = max(self._neighbor_fetch_count, 1)
        return {
            "running": self._running,
            "runtime_seconds": runtime,
            "total_scored": len(self.scored_set),
            "pending_work": len(self.priority_queue),
            "outstanding_assignments": outstanding,
            "active_workers": active,
            "total_workers": len(workers),
            "workers": workers,
            "neighbor_fetches": self._neighbor_fetch_count,
            "avg_neighbor_fetch_ms": 1000.0 * self._neighbor_fetch_time / fetches,
            "reassigned_work_items": self._reassigned_count,
            "termination_reason": self._termination,
            "namespace": self.namespace,
        }


def create_coordination_service(hnsw_service, **kwargs) -> CoordinationService:
    """Factory, as ``rad_tpu``'s."""
    return CoordinationService(hnsw_service, **kwargs)
