"""DeviceTraverser: host driver around the device traversal step.

Runs :func:`~rad_tpu_torch.traverse.device.expand` /
:func:`~rad_tpu_torch.traverse.device.integrate` and bridges the scoring
boundary: candidate node ids → user keys → SMILES (store lookup) → the
user's ``scoring_fn`` → scores back to the device. A thread pool runs the
per-molecule scoring calls of a batch in parallel, and with
``pipeline_depth > 1`` the device expands the next batch while the host
scores the current one. ``traverse(checkpoint_path=...)`` persists the
state periodically; :meth:`DeviceTraverser.load_checkpoint` resumes it
(files in ``rad_tpu``'s layout, so either package resumes the other's).
"""

from __future__ import annotations

import logging
import time
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from rad_tpu_torch.devices import resolve_device
from rad_tpu_torch.graph.storage import HNSWGraph
from rad_tpu_torch.store.smiles_store import SmilesStore
from rad_tpu_torch.traverse import device as dev
from rad_tpu_torch.traverse.pipeline import (HostScoringBridge,
                                             pipelined_traverse)

logger = logging.getLogger(__name__)

__all__ = ["DeviceTraverser"]


class DeviceTraverser:
    """Device-resident best-first traversal over one HNSW graph on
    ``device``."""

    def __init__(
        self,
        graph: HNSWGraph,
        scoring_fn: Callable[[str], float],
        smiles_store: Optional[SmilesStore] = None,
        batch_size: int = 32,
        frontier_capacity: int | None = None,
        log_capacity: int | None = None,
        buffer_capacity: int = 1 << 15,
        head_capacity: int | None | str = "auto",
        n_score_threads: int = 8,
        failed_score: float = float("inf"),
        order_log_spill: bool | str = False,
        packed_adjacency: bool = False,
        device=None,
    ) -> None:
        if order_log_spill or packed_adjacency:
            raise NotImplementedError(
                "order_log_spill / packed_adjacency are not ported yet "
                "(ROADMAP Queue 1 items 4 and 10)")
        self.graph = graph
        self.batch_size = batch_size
        self.device = resolve_device(device)
        self.dg = dev.prepare_device_graph(graph, self.device)
        self.state = dev.init_state(self.dg, frontier_capacity, log_capacity,
                                    buffer_capacity, head_capacity)
        self._primed = False
        self.stats = {
            "steps": 0,
            "scoring_time": 0.0,
            "device_time": 0.0,
            "scoring_errors": 0,
            "started_at": None,
            "termination_reason": None,
        }
        self._bridge = HostScoringBridge(
            graph.keys, scoring_fn, smiles_store=smiles_store,
            n_score_threads=n_score_threads, failed_score=failed_score,
            stats=self.stats)

    # ------------------------------------------------------------ lifecycle
    def prime(self) -> int:
        """Score all top-layer nodes and seed the frontier. Returns the
        number of nodes primed."""
        n_top = self.graph.layer_sizes[self.graph.max_level]
        ids = np.arange(n_top, dtype=np.int32)
        smiles = self._bridge.smiles_for_ids(ids)
        t0 = time.perf_counter()
        scores = self._bridge.score_smiles(smiles)
        self.stats["scoring_time"] += time.perf_counter() - t0
        self.state = dev.prime(self.state, self.dg,
                               torch.from_numpy(ids).to(self.device),
                               torch.from_numpy(scores).to(self.device))
        self._primed = True
        return n_top

    def traverse(
        self,
        n_to_score: Optional[int] = None,
        timeout: Optional[float] = None,
        pipeline_depth: int = 1,
        checkpoint_path: Optional[str] = None,
        checkpoint_interval: int = 100,
    ) -> dict:
        """Run the best-first sweep until ``n_to_score`` molecules are
        scored, ``timeout`` seconds pass, or the frontier empties.

        ``checkpoint_path``: the state is written there atomically every
        ``checkpoint_interval`` integrated batches and at the end, so a
        killed campaign resumes with :meth:`load_checkpoint` and another
        ``traverse()``, losing at most one interval of scoring work."""
        if not self._primed:
            raise RuntimeError("prime() must be called before traverse()")
        if n_to_score is not None:
            # batched best-first trades sequential decision depth for
            # throughput: a budget that fits in a handful of steps floods
            # the entry neighborhood before score guidance can steer
            depth = n_to_score / max(self.batch_size * self.dg.m0, 1)
            if depth < 8:
                logger.warning(
                    "batch_size=%d gives only ~%.1f best-first rounds for "
                    "n_to_score=%d (each step can score up to batch*M0=%d)"
                    " — enrichment quality needs tens of rounds; consider "
                    "batch_size<=%d", self.batch_size, depth, n_to_score,
                    self.batch_size * self.dg.m0,
                    max(1, n_to_score // (self.dg.m0 * 32)))

        n_since_ckpt = [0]

        def after_integrate(state):
            n_since_ckpt[0] += 1
            if n_since_ckpt[0] >= checkpoint_interval:
                n_since_ckpt[0] = 0
                dev.save_state_atomic(state, checkpoint_path)

        self.state, _ = pipelined_traverse(
            self.state, self._expand, self._integrate,
            self._bridge.score_batch,
            n_scored_of=lambda st: int(st.n_scored),
            n_to_score=n_to_score, timeout=timeout,
            pipeline_depth=pipeline_depth, stats=self.stats,
            after_integrate=(after_integrate if checkpoint_path is not None
                             else None))
        if checkpoint_path is not None:
            dev.save_state_atomic(self.state, checkpoint_path)
        return dict(self.stats, n_scored=self.n_scored)

    def _expand(self, state):
        return dev.expand(state, self.dg, self.batch_size)

    def _integrate(self, state, out, new_scores: np.ndarray):
        return dev.integrate(
            state, self.dg, out["exp_node"], out["exp_level"],
            out["exp_score"], out["exp_valid"], out["cand"], out["to_score"],
            torch.from_numpy(new_scores).to(self.device))

    def shutdown(self) -> None:
        self._bridge.shutdown()

    # ----------------------------------------------------------- checkpoint
    def save_checkpoint(self, path: str) -> None:
        """Persist the traversal state at exactly ``path``; a new
        DeviceTraverser over the same graph resumes with
        :meth:`load_checkpoint`."""
        dev.save_state_atomic(self.state, path)

    def load_checkpoint(self, path: str) -> None:
        """Restore a checkpoint of this graph (this package's or
        ``rad_tpu``'s) onto this traverser's device."""
        state = dev.load_state(path, self.device)
        if state.scored.shape[0] - 1 != self.dg.n_nodes:
            raise ValueError("checkpoint is for a different graph size")
        self.state = state
        self._primed = bool(int(state.n_scored) > 0)

    # -------------------------------------------------------------- results
    @property
    def n_scored(self) -> int:
        return int(self.state.n_scored)

    def get_molecules(self, n: int | None = None
                      ) -> List[Tuple[int, float, str]]:
        """(node_id, score, smiles) in traversal order."""
        ids = dev.read_order_log(self.state)
        if n is not None:
            ids = ids[:n]
        scores = dev.gather_scores(self.state, ids)
        smiles = self._bridge.smiles_for_ids(ids) if len(ids) else []
        return [(int(i), float(s), sm)
                for i, s, sm in zip(ids, scores, smiles)]

    def get_best_molecules(self, n: int | None = None
                           ) -> List[Tuple[int, float, str]]:
        """Best-scoring molecules, ties broken by traversal order; selects
        the top ``n`` before any SMILES lookup."""
        ids = np.asarray(dev.read_order_log(self.state))
        scores = dev.gather_scores(self.state, ids)
        order = np.argsort(scores, kind="stable")
        if n is not None:
            order = order[:n]
        ids, scores = ids[order], scores[order]
        smiles = self._bridge.smiles_for_ids(ids) if len(ids) else []
        return [(int(i), float(s), sm)
                for i, s, sm in zip(ids, scores, smiles)]

    def get_stats(self) -> dict:
        return dict(
            self.stats,
            n_scored=self.n_scored,
            frontier_size=dev.frontier_size(self.state),
            frontier_dropped=int(self.state.n_dropped),
            device_steps=int(self.state.n_steps),
        )
