"""RADTraverser: the lifecycle facade, local deployment with the device
engine.

``__init__ → prime() → traverse(n_to_score | timeout) →
get_molecules()/get_best_molecules() → shutdown()``, as in
``rad_tpu.api.traverser``. Only ``deployment_mode="local"`` with the
device engine is ported; the ``scored_set`` / ``priority_queue`` /
``visited_set`` properties are read views over the engine's state.
"""

from __future__ import annotations

import inspect
import logging
import time
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from rad_tpu_torch.traverse import device as dev
from rad_tpu_torch.traverse.driver import DeviceTraverser

logger = logging.getLogger(__name__)

__all__ = ["RADTraverser"]


class _DeviceScoredView:
    """Read view over the engine's scored tables (ScoredSet parity)."""

    def __init__(self, engine: DeviceTraverser) -> None:
        self._e = engine

    def getScore(self, node_id: int) -> Optional[float]:
        node_id = int(node_id)
        if not bool(self._e.state.scored[node_id]):
            return None
        return float(self._e.state.scores[node_id])

    def get_molecules(self, n: int | None = None):
        return self._e.get_molecules(n)

    def get_best_molecules(self, n: int | None = None):
        return self._e.get_best_molecules(n)

    def __iter__(self):
        for nid, score, _ in self.get_molecules():
            yield (nid, score)

    def __len__(self) -> int:
        return self._e.n_scored


class _DeviceFrontierView:
    """Read view over the device frontier (PriorityQueue-len parity)."""

    def __init__(self, engine: DeviceTraverser) -> None:
        self._e = engine

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


class _DeviceVisitedView:
    """Read view over the enqueued (node, level) bitmap."""

    def __init__(self, engine: DeviceTraverser) -> None:
        self._e = engine

    def __len__(self) -> int:
        return int(self._e.state.enqueued[:-1].sum())

    def __contains__(self, key) -> bool:
        node_id, level = key
        row = int(self._e.dg.offsets_host[int(level)]) + int(node_id)
        return bool(self._e.state.enqueued[row])


class RADTraverser:
    """Score-guided traversal of a local graph on ``device`` (``None``:
    the first CUDA device; raises when torch sees none).

    Frontier-order caveat (as in the reference): once the frontier
    capacity reaches 2**18 the engine uses the two-level frontier, and
    molecules with EQUAL scores may then pop in another order than a
    single-level run; ``head_capacity=None`` forces one level.
    """

    def __init__(
        self,
        graph=None,
        scoring_fn: Callable[[str], float] | None = None,
        deployment_mode: str = "local",
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
        """``namespace``, ``worker_timeout``, ``heartbeat_interval`` and
        ``n_workers`` are the reference's host-engine parameters: accepted
        in every mode, as there, and unused until that engine is ported.
        ``redis_host`` / ``redis_port`` / ``redis_password`` (the original
        rad's constructor) are dropped with a warning; any other keyword
        raises ``TypeError``."""
        if scoring_fn is None:
            raise ValueError("scoring_fn is required")
        if deployment_mode != "local" or engine not in ("auto", "device"):
            raise NotImplementedError(
                f"deployment_mode={deployment_mode!r} engine={engine!r}: "
                f"only the local device engine is ported")
        if graph is None:
            raise ValueError("provide graph")
        for k in ("redis_host", "redis_port", "redis_password"):
            if k in kwargs:
                kwargs.pop(k)
                logger.warning(
                    "%s ignored: rad-tpu has no Redis — traversal state is "
                    "device-resident (see docs/MIGRATION.md)", k)
        if kwargs:
            raise TypeError(
                f"unsupported RADTraverser kwargs for engine 'device': "
                f"{sorted(kwargs)}")
        self.scoring_fn = scoring_fn
        self.deployment_mode = deployment_mode
        self.namespace = namespace
        self.engine = "device"
        self.graph = graph
        self._primed = False
        self._shutdown = False
        self._monitor_stats: dict = {}
        self._device_engine = DeviceTraverser(
            graph, scoring_fn, smiles_store=smiles_store,
            batch_size=batch_size, frontier_capacity=frontier_capacity,
            log_capacity=log_capacity, buffer_capacity=buffer_capacity,
            head_capacity=head_capacity, n_score_threads=n_score_threads,
            order_log_spill=order_log_spill,
            packed_adjacency=packed_adjacency, device=device)
        logger.info("RADTraverser initialized (mode=local engine=device "
                    "device=%s)", self._device_engine.device)

    # ------------------------------------------------------------ lifecycle
    def prime(self, **kwargs) -> None:
        """Score all top-layer nodes and seed the frontier (keyword
        arguments are accepted and unused, as in the reference)."""
        self._check_alive()
        if self._primed:
            return
        self._device_engine.prime()
        self._primed = True

    def traverse(self, n_workers: Optional[int] = None,
                 timeout: Optional[float] = None,
                 n_to_score: Optional[int] = None,
                 poll_interval: float = 0.2, **kwargs) -> dict:
        """Run the sweep until timeout / n_to_score / frontier exhaustion;
        engine options (``pipeline_depth``) pass through. The signature is
        the reference's: ``n_workers`` and ``poll_interval`` steer its host
        worker pool and are accepted and unused by the device engine."""
        self._check_alive()
        if not self._primed:
            raise RuntimeError("prime() must be called before traverse()")
        if timeout is None and n_to_score is None:
            raise ValueError("Must provide either timeout or n_to_score")
        params = inspect.signature(self._device_engine.traverse).parameters
        bad = sorted(k for k in kwargs if k not in params)
        if bad:
            raise ValueError(
                f"traverse() does not accept {bad}; supported: "
                f"{sorted(k for k in params if k != 'self')}")
        start = time.time()
        stats = self._device_engine.traverse(n_to_score=n_to_score,
                                             timeout=timeout, **kwargs)
        stats["runtime_seconds"] = time.time() - start
        self._monitor_stats = stats
        return stats

    def shutdown(self, **kwargs) -> None:
        if self._shutdown:
            return
        self._shutdown = True
        self._device_engine.shutdown()

    def _check_alive(self) -> None:
        if self._shutdown:
            raise RuntimeError("traverser has been shut down")

    # ------------------------------------------------------ state properties
    @property
    def scored_set(self) -> _DeviceScoredView:
        return _DeviceScoredView(self._device_engine)

    @property
    def priority_queue(self) -> _DeviceFrontierView:
        return _DeviceFrontierView(self._device_engine)

    @property
    def visited_set(self) -> _DeviceVisitedView:
        return _DeviceVisitedView(self._device_engine)

    # --------------------------------------------------------------- results
    def get_molecules(self, n: int | None = None
                      ) -> List[Tuple[int, float, str]]:
        return self._device_engine.get_molecules(n)

    def get_best_molecules(self, n: int | None = None
                           ) -> List[Tuple[int, float, str]]:
        return self._device_engine.get_best_molecules(n)

    def get_traversal_stats(self) -> dict:
        stats = {
            "deployment_mode": self.deployment_mode,
            "engine": self.engine,
            "primed": self._primed,
            "n_scored": self._device_engine.n_scored,
            "graph": self.graph.info(),
            "device": self._device_engine.get_stats(),
        }
        stats.update(self._monitor_stats)
        return stats
