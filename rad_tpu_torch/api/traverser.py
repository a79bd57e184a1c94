"""RADTraverser: the top-level lifecycle facade.

``__init__ → prime() → traverse(n_workers, timeout | n_to_score) →
get_molecules()/get_best_molecules() → shutdown()``, as in
``rad_tpu.api.traverser``, with its deployment modes:

* ``local`` — graph and traversal state on the card; the device engine
  (:mod:`rad_tpu_torch.traverse.device`) runs the sweep;
* ``distributed`` (``hybrid`` is its other name) — the host coordination
  engine with N scoring workers (threads here; other machines join
  through the HTTP coordination endpoints of :mod:`rad_tpu_torch.server`);
* ``remote`` — the graph lives behind an HTTP service, scoring stays
  local; the host engine, since adjacency is only reachable over the
  network;
* ``pod`` (``engine="pod"``) — the graph split by rows over a device mesh
  (:class:`~rad_tpu_torch.parallel.pod.PodTraverser`: ``mesh=`` or
  ``n_devices=`` CUDA devices, ``shard_state=``), host scoring pipelined
  through the sharded expand/integrate halves.

The host engine runs on the host alone: it reads the graph through an
:class:`~rad_tpu_torch.service.base.HNSWService` and puts nothing on the
card. The ``scored_set`` / ``priority_queue`` / ``visited_set``
properties expose live state views in every mode.
"""

from __future__ import annotations

import inspect
import logging
import time
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from rad_tpu_torch.service.base import HNSWService
from rad_tpu_torch.service.local import LocalHNSWService
from rad_tpu_torch.traverse import device as dev
from rad_tpu_torch.traverse.coordinator import CoordinationService
from rad_tpu_torch.traverse.driver import DeviceTraverser
from rad_tpu_torch.traverse.structures import (
    HostPriorityQueue,
    HostScoredSet,
    HostVisitedSet,
    PriorityQueue,
    ScoredSet,
    VisitedSet,
)
from rad_tpu_torch.traverse.workers import WorkerPool

logger = logging.getLogger(__name__)

__all__ = ["RADTraverser"]


def _read_only(*args, **kwargs):
    raise RuntimeError("the device engine's state is written by the "
                       "engine; use the traverser API")


class _DeviceScoredView(ScoredSet):
    """Read view over the engine's scored tables."""

    def __init__(self, engine: DeviceTraverser) -> None:
        self._e = engine

    def getScore(self, node_id: int) -> Optional[float]:
        node_id = int(node_id)
        if not bool(self._e.state.scored[node_id]):
            return None
        return float(self._e.state.scores[node_id])

    insert = _read_only

    def get_molecules(self, n: int | None = None):
        return self._e.get_molecules(n)

    def get_best_molecules(self, n: int | None = None):
        return self._e.get_best_molecules(n)

    def __iter__(self):
        for nid, score, _ in self.get_molecules():
            yield (nid, score)

    def __len__(self) -> int:
        return self._e.n_scored


class _DeviceFrontierView(PriorityQueue):
    """Read view over the device frontier."""

    def __init__(self, engine: DeviceTraverser) -> None:
        self._e = engine

    pop = insert = _read_only

    def __len__(self) -> int:
        return dev.frontier_size(self._e.state)

    def peek_score(self) -> Optional[float]:
        """Best live score in head + buffer (cold entries are never
        better than the head)."""
        st = self._e.state
        c = st.f_score.shape[0]
        live = torch.arange(c, device=st.f_score.device) >= st.f_cursor
        m = float(torch.minimum(
            st.f_score.masked_fill(~live, float("inf")).min(),
            st.f_buf_score[:-1].min()))
        return None if not np.isfinite(m) else m


class _DeviceVisitedView(VisitedSet):
    """Read view over the enqueued (node, level) bitmap."""

    def __init__(self, engine: DeviceTraverser) -> None:
        self._e = engine

    checkAndInsert = _read_only

    def __len__(self) -> int:
        return int(self._e.state.enqueued[:-1].sum())

    def __contains__(self, key) -> bool:
        node_id, level = key
        row = int(self._e.dg.offsets_host[int(level)]) + int(node_id)
        return bool(self._e.state.enqueued[row])


class RADTraverser:
    """Score-guided traversal of an HNSW graph; see the module docstring
    for the lifecycle and the deployment modes.

    ``engine="auto"`` is the device engine for a local deployment over a
    local graph, the pod engine for ``deployment_mode="pod"``, and the
    host engine otherwise. The device engine runs on
    ``device`` (``None``: the first CUDA device; raises when torch sees
    none); the host engine ignores ``device``.

    Frontier-order caveat (as in the reference): once the frontier
    capacity reaches 2**18 the device engine uses the two-level frontier,
    and molecules with EQUAL scores may then pop in another order than the
    host engine or a single-level run; ``head_capacity=None`` forces one
    level.
    """

    def __init__(
        self,
        hnsw_service: Optional[HNSWService] = None,
        scoring_fn: Callable[[str], float] | None = None,
        deployment_mode: str = "local",
        graph=None,
        smiles_store=None,
        namespace: str = "rad",
        engine: str = "auto",
        batch_size: int = 32,
        frontier_capacity: int | None = None,
        log_capacity: int | None = None,
        buffer_capacity: int = 1 << 15,
        n_score_threads: int = 8,
        worker_timeout: float = 60.0,
        heartbeat_interval: float = 10.0,
        n_workers: int | None = None,
        head_capacity: int | None | str = "auto",
        order_log_spill: bool | str = False,
        packed_adjacency: bool | int = False,
        device=None,
        **kwargs,
    ) -> None:
        """``namespace``, ``worker_timeout`` and ``heartbeat_interval``
        configure the host engine's coordination service, ``n_workers``
        its default pool size; ``batch_size`` through ``packed_adjacency``
        and ``device`` configure the device engine. Each engine accepts
        the other's parameters and leaves them unused, as in the
        reference. ``redis_host`` / ``redis_port`` / ``redis_password``
        (the original rad's constructor) are dropped with a warning; any
        other keyword raises ``TypeError``."""
        if scoring_fn is None:
            raise ValueError("scoring_fn is required")
        if deployment_mode == "hybrid":
            # the original rad's "hybrid" mode (local index + external
            # workers) is the distributed engine
            deployment_mode = "distributed"
        if deployment_mode not in ("local", "distributed", "remote",
                                   "pod"):
            raise ValueError(f"unknown deployment_mode {deployment_mode!r}")
        self.scoring_fn = scoring_fn
        self.deployment_mode = deployment_mode
        self.namespace = namespace
        # host-engine pool size used when traverse() is not given one
        # (create_distributed_traverser(n_workers=...) lands here)
        self._default_n_workers = int(n_workers) if n_workers else 1
        self._primed = False
        self._shutdown = False
        self._monitor_stats: dict = {}

        if hnsw_service is None:
            if graph is None:
                raise ValueError("provide hnsw_service or graph")
            hnsw_service = LocalHNSWService(graph, smiles_store)
        self.hnsw_service = hnsw_service
        if not self.hnsw_service.is_healthy():
            raise RuntimeError("Provided HNSW service is not healthy")

        local_graph = getattr(hnsw_service, "graph", None)
        if engine == "auto":
            if deployment_mode == "pod":
                engine = "pod"
            else:
                engine = ("device" if deployment_mode == "local"
                          and local_graph is not None else "host")
        if engine not in ("device", "host", "pod"):
            raise ValueError(f"unknown engine {engine!r}")
        if engine in ("device", "pod") and local_graph is None:
            raise ValueError(f"{engine} engine requires a local graph")
        self.engine = engine
        self.graph = local_graph

        pod_options = {k: kwargs.pop(k) for k in ("mesh", "n_devices",
                                                  "shard_state")
                       if k in kwargs and engine == "pod"}
        for k in ("redis_host", "redis_port", "redis_password"):
            if k in kwargs:
                kwargs.pop(k)
                logger.warning(
                    "%s ignored: rad-tpu has no Redis — traversal state is "
                    "device-resident (see docs/MIGRATION.md)", k)
        if kwargs:
            raise TypeError(
                f"unsupported RADTraverser kwargs for engine {engine!r}: "
                f"{sorted(kwargs)}")

        self._device_engine = None
        self._coord: Optional[CoordinationService] = None
        self._pool: Optional[WorkerPool] = None
        if engine == "pod":
            # the graph split over a device mesh, host scoring pipelined
            # through the sharded expand/integrate halves
            from rad_tpu_torch.parallel.pod import PodTraverser
            self._device_engine = PodTraverser(
                local_graph, scoring_fn=scoring_fn,
                smiles_store=getattr(hnsw_service, "smiles_store", None)
                or smiles_store,
                batch_size=batch_size, frontier_capacity=frontier_capacity,
                log_capacity=log_capacity, buffer_capacity=buffer_capacity,
                head_capacity=head_capacity, n_score_threads=n_score_threads,
                order_log_spill=order_log_spill,
                packed_adjacency=packed_adjacency, **pod_options)
        elif engine == "device":
            self._device_engine = DeviceTraverser(
                local_graph, scoring_fn,
                smiles_store=getattr(hnsw_service, "smiles_store", None)
                or smiles_store,
                batch_size=batch_size, frontier_capacity=frontier_capacity,
                log_capacity=log_capacity, buffer_capacity=buffer_capacity,
                head_capacity=head_capacity, n_score_threads=n_score_threads,
                order_log_spill=order_log_spill,
                packed_adjacency=packed_adjacency, device=device)
        else:
            self._coord = CoordinationService(
                hnsw_service,
                priority_queue=HostPriorityQueue(),
                visited_set=HostVisitedSet(),
                scored_set=HostScoredSet(),
                worker_timeout=worker_timeout,
                heartbeat_interval=heartbeat_interval,
                namespace=namespace,
            )
        logger.info("RADTraverser initialized (mode=%s engine=%s)",
                    deployment_mode, engine)

    # ------------------------------------------------------------ lifecycle
    def prime(self, **kwargs) -> None:
        """Score all top-layer nodes and seed the frontier (keyword
        arguments are accepted and unused, as in the reference)."""
        self._check_alive()
        if self._primed:
            return
        if self._device_engine is not None:
            self._device_engine.prime()
        else:
            top = self.hnsw_service.get_top_level_nodes()
            info = self.hnsw_service.get_hnsw_info()
            start_level = max(0, int(info["max_level"]) - 1)
            coord = self._coord
            for nid, smi in zip(top[0::2], top[1::2]):
                score = float(self.scoring_fn(smi))
                coord.scored_set.insert(nid, score, smi)
                if not coord.visited_set.checkAndInsert(nid, start_level):
                    coord.priority_queue.insert(nid, start_level, score)
        self._primed = True

    def traverse(self, n_workers: Optional[int] = None,
                 timeout: Optional[float] = None,
                 n_to_score: Optional[int] = None,
                 poll_interval: float = 0.2, **kwargs) -> dict:
        """Run the sweep until timeout / n_to_score / frontier exhaustion.

        The host engine starts ``n_workers`` scoring workers (default: the
        constructor's ``n_workers``, else 1) and checks termination every
        ``poll_interval`` seconds; the device engine takes its options
        (``pipeline_depth``, ``checkpoint_path``, ...) as keywords and
        leaves ``n_workers`` and ``poll_interval`` unused, and the host
        engine the device engine's options, as in the reference."""
        self._check_alive()
        if not self._primed:
            raise RuntimeError("prime() must be called before traverse()")
        if timeout is None and n_to_score is None:
            raise ValueError("Must provide either timeout or n_to_score")
        start = time.time()
        if self._device_engine is not None:
            params = inspect.signature(
                self._device_engine.traverse).parameters
            bad = sorted(k for k in kwargs if k not in params)
            if bad:
                raise ValueError(
                    f"traverse() does not accept {bad}; supported: "
                    f"{sorted(k for k in params if k != 'self')}")
            stats = self._device_engine.traverse(n_to_score=n_to_score,
                                                 timeout=timeout, **kwargs)
            stats["runtime_seconds"] = time.time() - start
            self._monitor_stats = stats
            return stats
        self._coord.start()
        # each round evaluates termination afresh: clear the previous
        # round's sticky reason and restart the timeout epoch
        self._coord.reset_termination()
        if n_workers is None:
            n_workers = self._default_n_workers
        self._pool = WorkerPool(self._coord, self.scoring_fn,
                                n_workers=n_workers)
        self._pool.start_all()
        reason = None
        try:
            while True:
                done, reason = self._coord.check_termination(
                    n_to_score=n_to_score, timeout=timeout)
                if done:
                    break
                time.sleep(poll_interval)
        finally:
            self._pool.stop_all()
        stats = {
            "termination_reason": reason,
            "runtime_seconds": time.time() - start,
            "n_scored": len(self._coord.scored_set),
        }
        self._monitor_stats = stats
        return stats

    def shutdown(self, **kwargs) -> None:
        """Tear down in order: workers → coordination → engine → HNSW
        service (which closes its SMILES store)."""
        if self._shutdown:
            return
        self._shutdown = True
        if self._pool is not None:
            self._pool.stop_all()
            self._pool = None
        if self._coord is not None:
            self._coord.shutdown()
        if self._device_engine is not None:
            self._device_engine.shutdown()
        try:
            self.hnsw_service.shutdown()
        except Exception:
            logger.exception("hnsw service shutdown failed")

    def _check_alive(self) -> None:
        if self._shutdown:
            raise RuntimeError("traverser has been shut down")

    # ------------------------------------------------------ state properties
    @property
    def scored_set(self) -> ScoredSet:
        if self._device_engine is not None:
            return _DeviceScoredView(self._device_engine)
        return self._coord.scored_set

    @property
    def priority_queue(self) -> PriorityQueue:
        if self._device_engine is not None:
            return _DeviceFrontierView(self._device_engine)
        return self._coord.priority_queue

    @property
    def visited_set(self) -> VisitedSet:
        if self._device_engine is not None:
            return _DeviceVisitedView(self._device_engine)
        return self._coord.visited_set

    # --------------------------------------------------------------- results
    def get_molecules(self, n: int | None = None
                      ) -> List[Tuple[int, float, str]]:
        return self.scored_set.get_molecules(n)

    def get_best_molecules(self, n: int | None = None
                           ) -> List[Tuple[int, float, str]]:
        return self.scored_set.get_best_molecules(n)

    def get_traversal_stats(self) -> dict:
        stats = {
            "deployment_mode": self.deployment_mode,
            "engine": self.engine,
            "namespace": self.namespace,
            "primed": self._primed,
            "n_scored": len(self.scored_set),
            "service": self.hnsw_service.get_service_info(),
        }
        if self._device_engine is not None:
            stats["device"] = self._device_engine.get_stats()
        else:
            stats["coordination"] = self._coord.get_coordination_stats()
        stats.update(self._monitor_stats)
        return stats
