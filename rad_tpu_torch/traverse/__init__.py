"""Score-prioritized best-first HNSW traversal.

Two engines with the same semantics, as in ``rad_tpu.traverse``:

* :mod:`rad_tpu_torch.traverse.device` — the device engine: frontier,
  per-level visited bitmap and scored log live on the card, and one step
  performs pop → expand → dedupe → integrate;
* :mod:`rad_tpu_torch.traverse.coordinator` + worker threads — the host
  engine (work items, heartbeats, reassignment) for deployments where the
  graph is remote (HTTP) or scoring is distributed across machines.
"""

from rad_tpu_torch.traverse.structures import (
    PriorityQueue,
    VisitedSet,
    ScoredSet,
    HostPriorityQueue,
    HostVisitedSet,
    HostScoredSet,
)
from rad_tpu_torch.traverse.coordinator import (
    WorkItem,
    WorkerInfo,
    CoordinationService,
    create_coordination_service,
)
from rad_tpu_torch.traverse.workers import (
    ScoringWorker,
    WorkerPool,
    create_worker_pool,
)
from rad_tpu_torch.traverse.driver import DeviceTraverser

__all__ = [
    "PriorityQueue",
    "VisitedSet",
    "ScoredSet",
    "HostPriorityQueue",
    "HostVisitedSet",
    "HostScoredSet",
    "WorkItem",
    "WorkerInfo",
    "CoordinationService",
    "create_coordination_service",
    "ScoringWorker",
    "WorkerPool",
    "create_worker_pool",
    "DeviceTraverser",
]
