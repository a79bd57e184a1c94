"""Traversal state structures: frontier queue, visited set, scored set.

The host engine's thread-safe structures, as in
``rad_tpu.traverse.structures`` (copied: that package loads jax). The ABCs
keep the original rad's camelCase method names, so user code written
against it ports directly; atomicity comes from in-process locks.

Semantics:
  * priority queue: global min-queue keyed by composite (node_id, level);
    re-inserting an existing (node, level) overwrites its score (ZADD
    semantics); pop returns the minimum-score entry or None, ties broken
    by insertion order (the device engine's order at batch 1 depends on
    that tie-break);
  * visited set: once per (node_id, level) — ``checkAndInsert`` returns
    True iff already present;
  * scored set: once per node_id globally, insertion order preserved;
    ``get_molecules`` returns ``(node_id, score, smiles)`` tuples in
    traversal order, ``get_best_molecules`` sorted ascending by score
    (lower = better).
"""

from __future__ import annotations

import heapq
import itertools
import threading
from abc import ABC, abstractmethod
from typing import Dict, List, Optional, Tuple

__all__ = [
    "PriorityQueue",
    "VisitedSet",
    "ScoredSet",
    "HostPriorityQueue",
    "HostVisitedSet",
    "HostScoredSet",
]


class PriorityQueue(ABC):
    """Global min-priority frontier of (node_id, level) → score."""

    @abstractmethod
    def pop(self) -> Optional[Tuple[int, int, float]]:
        """Atomically remove and return the best (node_id, level, score)."""

    @abstractmethod
    def insert(self, node_id: int, level: int, score: float) -> None:
        """Insert or update (node_id, level) with ``score``."""


class VisitedSet(ABC):
    """Per-(node, level) expansion dedup."""

    @abstractmethod
    def checkAndInsert(self, node_id: int, level: int) -> bool:
        """Atomically insert; return True iff it was already present."""

    # snake_case alias
    def check_and_insert(self, node_id: int, level: int) -> bool:
        return self.checkAndInsert(node_id, level)


class ScoredSet(ABC):
    """Global once-only scoring record with insertion order."""

    @abstractmethod
    def getScore(self, node_id: int) -> Optional[float]:
        ...

    @abstractmethod
    def insert(self, node_id: int, score: float, smiles: str = "") -> None:
        ...

    @abstractmethod
    def get_molecules(self, n: int | None = None) -> List[Tuple[int, float, str]]:
        """Molecules in traversal/insertion order."""

    @abstractmethod
    def get_best_molecules(self, n: int | None = None) -> List[Tuple[int, float, str]]:
        """Molecules sorted by score (lowest first)."""

    @abstractmethod
    def __len__(self) -> int:
        ...

    def get_score(self, node_id: int) -> Optional[float]:
        return self.getScore(node_id)

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            for key, score in self:
                f.write(f"{key} {score}\n")


class HostPriorityQueue(PriorityQueue):
    """Lock-arbitrated binary heap with lazy deletion.

    Matches Redis-ZSET semantics: one live entry per (node, level); insert
    overwrites; pop is atomic under the lock.
    """

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._heap: List[Tuple[float, int, int, int]] = []
        self._live: Dict[Tuple[int, int], float] = {}
        self._counter = itertools.count()

    def insert(self, node_id: int, level: int, score: float) -> None:
        key = (int(node_id), int(level))
        with self._lock:
            self._live[key] = float(score)
            heapq.heappush(
                self._heap, (float(score), next(self._counter), key[0], key[1])
            )

    def pop(self) -> Optional[Tuple[int, int, float]]:
        with self._lock:
            while self._heap:
                score, _, node_id, level = heapq.heappop(self._heap)
                key = (node_id, level)
                if self._live.get(key) == score:
                    del self._live[key]
                    return node_id, level, score
                # stale entry (overwritten or already popped) — skip
            return None

    def __len__(self) -> int:
        with self._lock:
            return len(self._live)

    def peek_score(self) -> Optional[float]:
        with self._lock:
            return min(self._live.values()) if self._live else None


class HostVisitedSet(VisitedSet):
    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._seen: set = set()

    def checkAndInsert(self, node_id: int, level: int) -> bool:
        key = (int(node_id), int(level))
        with self._lock:
            if key in self._seen:
                return True
            self._seen.add(key)
            return False

    def __contains__(self, key: Tuple[int, int]) -> bool:
        with self._lock:
            return (int(key[0]), int(key[1])) in self._seen

    def __len__(self) -> int:
        with self._lock:
            return len(self._seen)


class HostScoredSet(ScoredSet):
    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._scores: Dict[int, float] = {}
        self._smiles: Dict[int, str] = {}
        self._order: List[int] = []

    def getScore(self, node_id: int) -> Optional[float]:
        with self._lock:
            return self._scores.get(int(node_id))

    def get_scores_batch(self, node_ids) -> Dict[int, Optional[float]]:
        """One-shot lookup for many ids (cuts per-neighbor round trips on
        the remote-worker path)."""
        with self._lock:
            return {int(i): self._scores.get(int(i)) for i in node_ids}

    def insert(self, node_id: int, score: float, smiles: str = "") -> None:
        node_id = int(node_id)
        with self._lock:
            if node_id in self._scores:
                return  # once-only, insert-if-absent
            self._scores[node_id] = float(score)
            self._smiles[node_id] = smiles
            self._order.append(node_id)

    def get_molecules(self, n: int | None = None) -> List[Tuple[int, float, str]]:
        with self._lock:
            ids = self._order[:n] if n is not None else list(self._order)
            return [(i, self._scores[i], self._smiles.get(i, "")) for i in ids]

    def get_best_molecules(self, n: int | None = None) -> List[Tuple[int, float, str]]:
        mols = self.get_molecules()
        mols.sort(key=lambda x: x[1])
        return mols[:n] if n is not None else mols

    def __iter__(self):
        with self._lock:
            order = list(self._order)
        for i in order:
            yield (i, self._scores[i])

    def __len__(self) -> int:
        with self._lock:
            return len(self._order)
