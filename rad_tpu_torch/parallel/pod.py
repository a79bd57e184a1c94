"""PodTraverser: the RADTraverser lifecycle over a graph-sharded mesh.

The port of :mod:`rad_tpu.parallel.pod`, the engine of BASELINE config 5
(a graph sharded over many devices): the prime / traverse /
get_best_molecules surface of the single-device engine, with fingerprints
and adjacency split by rows over the mesh and the traversal state
replicated (or split by rows too, ``shard_state=True``).

Two scoring modes:

* **on the device** (``target_packed`` / a torch ``scorer``): every step is
  :func:`~rad_tpu_torch.parallel.sharded.make_sharded_step` (or its
  ``_full`` form) — similarity to a target, or a surrogate model;
* **on the host** (``scoring_fn``): an external docking program scores
  SMILES while the graph lives across the mesh. The step splits at the
  scoring boundary
  (:func:`~rad_tpu_torch.parallel.sharded.make_sharded_expand_integrate`)
  and :func:`~rad_tpu_torch.traverse.pipeline.pipelined_traverse` overlaps
  host scoring of batch k with the sharded expansion of batch k+1. At
  ``pipeline_depth=1`` the scored set, order and scores are the
  single-device host-scored engine's (:class:`~rad_tpu_torch.traverse.
  driver.DeviceTraverser`).
"""

from __future__ import annotations

import os
import time
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from rad_tpu_torch.fp.pack import popcount_rows
from rad_tpu_torch.graph.storage import HNSWGraph
from rad_tpu_torch.parallel.mesh import make_mesh
from rad_tpu_torch.parallel.sharded import (ShardedGraph, _as_torch,
                                            _meta_graph, init_state_sharded,
                                            make_sharded_expand_integrate,
                                            make_sharded_step,
                                            make_sharded_step_full,
                                            shard_graph, shard_state_tables,
                                            sharded_state_to_reference_arrays)
from rad_tpu_torch.traverse import device as dev
from rad_tpu_torch.traverse.pipeline import (HostScoringBridge,
                                             pipelined_traverse)

__all__ = ["PodTraverser"]


def _padded_device_graph(sg: ShardedGraph):
    """DeviceGraph view with padded sizes (sentinels outside every
    shard): the view a sharded state is primed and stepped on."""
    return _meta_graph(sg, padded=True)


# the reference's older name of the same view
dataclasses_replace_padded = _padded_device_graph


class PodTraverser:
    """Best-first traversal with the graph sharded over a device mesh
    (``mesh``, or ``make_mesh(n_devices)`` over the CUDA devices).

    Exactly one of:
      ``target_packed`` — on-device scoring target (default scorer: the
      Tanimoto distance to it, lower is better; any torch ``scorer(
      fp_rows, pop_rows, target_packed, target_pop) -> scores`` instead);
      ``scoring_fn`` — a host SMILES → float function (a docking
      program), with ``smiles_store`` for the key → SMILES lookup and
      ``pipeline_depth`` in :meth:`traverse` to hide host latency.
    """

    def __init__(
        self,
        graph: HNSWGraph,
        target_packed: np.ndarray | None = None,
        mesh=None,
        n_devices: int | None = None,
        batch_size: int = 64,
        frontier_capacity: int | None = None,
        log_capacity: int | None = None,
        buffer_capacity: int = 1 << 15,
        head_capacity: int | None | str = "auto",
        scorer=None,
        shard_state: bool = False,
        scoring_fn: Optional[Callable[[str], float]] = None,
        smiles_store=None,
        n_score_threads: int = 8,
        failed_score: float = float("inf"),
        order_log_spill: bool | str = False,
        packed_adjacency: bool | int = False,
    ) -> None:
        if (target_packed is None) == (scoring_fn is None):
            raise ValueError(
                "provide exactly one of target_packed (on-device scoring; "
                "optionally with a custom torch `scorer`) or scoring_fn "
                "(host scoring)")
        self.graph = graph
        self.mesh = mesh if mesh is not None else make_mesh(
            n_devices, axis_names=("graph",))
        self.sg: ShardedGraph = shard_graph(
            graph, self.mesh, packed_adjacency=packed_adjacency)
        self.lead = self.sg.lead
        self.batch_size = batch_size
        self.shard_state = shard_state
        self.stats = {"steps": 0}
        self._host_mode = scoring_fn is not None
        self._bridge = None
        # host-spilled order log: the complete insertion order accumulates
        # on the host (RAM or file) past the device ring's capacity
        self._spill = None
        if order_log_spill:
            from rad_tpu_torch.traverse.spill import SpilledOrderLog
            self._spill = SpilledOrderLog(
                order_log_spill if isinstance(order_log_spill, str)
                else None)

        if shard_state:
            # scored/scores/enqueued split by rows too; padded sizes put
            # the dropped-write sentinels outside every shard
            self.dg = _padded_device_graph(self.sg)
            self.state = init_state_sharded(
                self.sg, self.mesh, frontier_capacity,
                log_capacity if log_capacity is not None else len(graph),
                buffer_capacity)
        else:
            self.dg = self.sg.device_graph()
            self.state = dev.init_state(self.dg, frontier_capacity,
                                        log_capacity, buffer_capacity,
                                        head_capacity)

        if self._host_mode:
            self._bridge = HostScoringBridge(
                graph.keys, scoring_fn, smiles_store=smiles_store,
                n_score_threads=n_score_threads, failed_score=failed_score,
                stats=self.stats)
            self._expand, self._integrate = make_sharded_expand_integrate(
                self.sg, self.mesh, batch_size, shard_state=shard_state)
            self._target = None
            self._target_pop = None
        else:
            step_factory = (make_sharded_step_full if shard_state
                            else make_sharded_step)
            self._step = step_factory(self.sg, self.mesh, batch_size,
                                      scorer=scorer)
            self._target = _as_torch(
                np.asarray(target_packed, np.uint32)).to(self.lead)
            self._target_pop = popcount_rows(self._target[None, :])[0]
        self._primed = False

    def prime(self) -> int:
        """Score every top-layer node and seed the frontier; returns the
        number of nodes primed."""
        n_top = self.graph.layer_sizes[self.graph.max_level]
        ids = torch.arange(n_top, dtype=torch.int32, device=self.lead)
        if self._host_mode:
            smiles = self._bridge.smiles_for_ids(np.arange(n_top))
            seed_scores = torch.from_numpy(
                self._bridge.score_smiles(smiles)).to(self.lead)
        else:
            from rad_tpu_torch.fp.tanimoto import tanimoto_matrix
            # only the top layer's rows leave the host
            top = _as_torch(np.asarray(self.graph.packed[:n_top],
                                       np.uint32)).to(self.lead)
            seed_scores = tanimoto_matrix(self._target[None, :], top)[0]
        self.state = dev.prime(self.state, self.dg, ids, seed_scores)
        self._primed = True
        if self._spill is not None:
            self._spill.drain(self.state)
        return n_top

    def traverse(self, n_to_score: Optional[int] = None,
                 timeout: Optional[float] = None,
                 pipeline_depth: int = 1) -> dict:
        if not self._primed:
            raise RuntimeError("prime() must be called before traverse()")
        if n_to_score is None and timeout is None:
            raise ValueError("provide n_to_score and/or timeout")
        if self._host_mode:
            self.state, _ = pipelined_traverse(
                self.state, self._expand, self._integrate,
                self._bridge.score_batch,
                n_scored_of=lambda st: int(st.n_scored),
                n_to_score=n_to_score, timeout=timeout,
                pipeline_depth=pipeline_depth, stats=self.stats,
                after_integrate=(self._spill.drain
                                 if self._spill is not None else None))
            return dict(self.stats, n_scored=self.n_scored)

        start = time.monotonic()
        reason = None
        while True:
            if timeout is not None and time.monotonic() - start > timeout:
                reason = "timeout"
                break
            # one read of both counters a step
            scored, live = torch.stack(
                [self.state.n_scored, self.state.f_live]).tolist()
            if n_to_score is not None and scored >= n_to_score:
                reason = "n_to_score"
                break
            if live <= 0:
                reason = "queue_empty"
                break
            self.state = self._step(self.state, self._target,
                                    self._target_pop)
            self.stats["steps"] += 1
            if self._spill is not None:
                self._spill.drain(self.state)
        self.stats.update(termination_reason=reason,
                          runtime_seconds=time.monotonic() - start,
                          n_scored=self.n_scored)
        return dict(self.stats)

    def shutdown(self) -> None:
        if self._bridge is not None:
            self._bridge.shutdown()

    def get_stats(self) -> dict:
        return dict(
            self.stats,
            n_scored=self.n_scored,
            frontier_size=dev.frontier_size(self.state),
            frontier_dropped=int(self.state.n_dropped),
            device_steps=int(self.state.n_steps),
            n_devices=int(self.mesh.size),
            shard_state=self.shard_state,
        )

    # ----------------------------------------------------------- checkpoint
    def save_checkpoint(self, path: str) -> None:
        """Persist the traversal state at exactly ``path`` (the shards
        assembled, in ``rad_tpu``'s layout); a new PodTraverser over the
        same graph and mesh resumes with :meth:`load_checkpoint`. Atomic
        write-then-rename."""
        tmp = f"{path}.tmp.{os.getpid()}.npz"
        np.savez(tmp, **sharded_state_to_reference_arrays(self.state))
        os.replace(tmp, path)

    def load_checkpoint(self, path: str) -> None:
        state = dev.load_state(path, self.lead)
        if state.scored.shape[0] != self.state.scored.shape[0]:
            raise ValueError("checkpoint is for a different graph size")
        if self.shard_state:
            state = shard_state_tables(state, self.sg, self.mesh)
        self.state = state
        self._primed = bool(int(self.state.n_scored) > 0)
        # drop spill-log entries a pre-crash run wrote past this
        # checkpoint, as DeviceTraverser.load_checkpoint does
        if self._spill is not None and len(self._spill) > self.n_scored:
            self._spill.truncate(self.n_scored)

    @property
    def n_scored(self) -> int:
        return int(self.state.n_scored)

    def _order(self) -> np.ndarray:
        if self._spill is not None:
            self._spill.drain(self.state)
            return np.asarray(self._spill.read())
        return np.asarray(dev.read_order_log(self.state))

    def _rows(self, ids, scores) -> List[Tuple]:
        if self._host_mode:
            smiles = self._bridge.smiles_for_ids(ids) if len(ids) else []
            return [(int(i), float(s), sm)
                    for i, s, sm in zip(ids, scores, smiles)]
        return [(int(i), float(s)) for i, s in zip(ids, scores)]

    def get_molecules(self, n: int | None = None) -> List[Tuple]:
        """(node_id, score[, smiles]) in traversal order; SMILES in host
        mode. With ``order_log_spill`` the complete order comes from the
        host log, past the device ring's capacity."""
        ids = self._order()
        if n is not None:
            ids = ids[:n]
        return self._rows(ids, dev.gather_scores(self.state, ids))

    def get_best_molecules(self, n: int | None = None):
        """Best-scoring rows, ties broken by traversal order; the top
        ``n`` are chosen before any SMILES lookup."""
        ids = self._order()
        scores = dev.gather_scores(self.state, ids)
        order = np.argsort(scores, kind="stable")
        if n is not None:
            order = order[:n]
        return self._rows(ids[order], scores[order])
