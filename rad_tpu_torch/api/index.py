"""HNSWIndex: the usearch-style index facade.

The surface of ``rad_tpu.api.index.HNSWIndex`` (``add``/``build``/
``search``/``save``/``load`` and the usearch-like properties):

    index = HNSWIndex(ndim=1024, connectivity=16)
    index.add(keys, packed_fps)
    index.build()                      # exact all-pairs builder
    d, keys = index.search(queries, k=10)   # graph beam search
    index.save("library.rad.npz"); HNSWIndex.load(path)

``device`` picks where the build runs; ``None`` means the first CUDA
device, and raises when torch sees none (pass ``device="cpu"`` to run the
kernels' plain twins on the CPU). ``backend="exact"`` runs
:func:`~rad_tpu_torch.build.exact.build_hnsw_exact`, ``"device"`` the
batched beam builder :func:`~rad_tpu_torch.build.device.build_hnsw_device`
(both on the index's device), ``"native"`` the C++ builder on the host's
cores :func:`~rad_tpu_torch.native.build_hnsw_native` and ``"host"`` the
numpy builder :func:`~rad_tpu_torch.build.reference.build_hnsw`;
``"auto"`` is the exact builder on the index's device. That last is a
deliberate difference: the reference's ``"auto"`` picks its accelerator
builder only on a TPU and only up to 2M rows, and otherwise the native
builder, or the numpy one where the native library does not compile.
:meth:`HNSWIndex.insert` adds rows to the built graph in O(K)
(:func:`~rad_tpu_torch.build.incremental.insert_into_graph`).
"""

from __future__ import annotations

import logging
import time
from typing import List, Optional, Sequence

import numpy as np

from rad_tpu_torch.devices import resolve_device
from rad_tpu_torch.fp.pack import coerce_packed
from rad_tpu_torch.graph.storage import HNSWGraph, LayerStats, host_keys_view

logger = logging.getLogger(__name__)

__all__ = ["HNSWIndex", "resolve_device"]


class HNSWIndex:
    def __init__(
        self,
        ndim: int = 1024,
        dtype: str = "b1",
        metric: str = "tanimoto",
        connectivity: int = 16,
        expansion_add: int = 200,
        expansion_search: int = 64,
        backend: str = "auto",
        seed: int = 0,
        device=None,
    ) -> None:
        if dtype != "b1":
            raise ValueError("only packed-bit 'b1' storage is supported")
        if metric != "tanimoto":
            raise ValueError("only the 'tanimoto' metric is supported")
        self.ndim = ndim
        self.metric = metric
        self.connectivity = connectivity
        self.expansion_add = expansion_add
        self.expansion_search = expansion_search
        self.backend = backend
        self.seed = seed
        self.device = resolve_device(device)
        self._pending_keys: List[np.ndarray] = []
        self._pending_fps: List[np.ndarray] = []
        self._graph: Optional[HNSWGraph] = None

    # ------------------------------------------------------------------ add
    def add(self, keys, vectors, log: bool | str = False) -> None:
        """Queue fingerprints for graph construction: ``[N, ndim/32]``
        uint32 packed rows, ``[N, ndim]`` 0/1 bits, or ``[N, ndim/8]``
        uint8 ``np.packbits`` rows, with int64 user keys. Adding to a built
        or loaded graph folds its rows back in and rebuilds on the next
        ``build()``. ``log`` (a flag or usearch's progress label) only
        logs what was queued, as in the reference."""
        if self._graph is not None and not self._pending_fps:
            self._pending_fps.append(
                np.ascontiguousarray(np.asarray(self._graph.packed)))
            self._pending_keys.append(np.asarray(self._graph.keys))
        vectors = coerce_packed(vectors, self.ndim)
        keys = np.atleast_1d(np.asarray(keys, dtype=np.int64))
        if keys.shape[0] != vectors.shape[0]:
            raise ValueError("keys and vectors length mismatch")
        self._pending_keys.append(keys)
        self._pending_fps.append(vectors)
        self._graph = None
        if log:
            logger.info("queued %d vectors (total pending %d)",
                        len(keys), sum(len(k) for k in self._pending_keys))

    def insert(self, keys, vectors, **kwargs) -> None:
        """True incremental insertion into the BUILT graph, on the index's
        device: O(K) insert work instead of ``add``'s O(N + K) rebuild.
        Builds first if needed; extra ``kwargs`` go to
        :func:`~rad_tpu_torch.build.incremental.insert_into_graph`. Node
        ids are renumbered (the level-sorted invariant) and keys are
        stable: re-resolve ids through :meth:`get_node_ids_from_keys`."""
        from rad_tpu_torch.build.incremental import insert_into_graph

        vectors = coerce_packed(vectors, self.ndim)
        keys = np.atleast_1d(np.asarray(keys, dtype=np.int64))
        g = self.graph  # builds pending rows if necessary
        self._graph = insert_into_graph(
            g, vectors, new_keys=keys, expansion_add=self.expansion_add,
            seed=self.seed, device=self.device, **kwargs)
        # a later add() folds rows back from the graph (no pending copies)
        self._pending_keys = []
        self._pending_fps = []

    # ---------------------------------------------------------------- build
    def build(self, backend: str | None = None, **kwargs) -> HNSWGraph:
        """Construct the graph from all added vectors (extra ``kwargs``
        go to the exact, the batched beam or the native builder, such as
        the native one's ``n_threads``; the host builder takes none, as in
        the reference)."""
        backend = backend or self.backend
        if backend not in ("auto", "exact", "host", "device", "native"):
            raise ValueError(f"unknown build backend {backend!r}")
        if self._graph is not None:
            return self._graph
        if not self._pending_fps:
            raise RuntimeError("no vectors added")
        fps = np.concatenate(self._pending_fps, axis=0)
        keys = np.concatenate(self._pending_keys, axis=0)
        if len(np.unique(keys)) != len(keys):
            raise ValueError("duplicate keys (multi-key indexes unsupported)")
        common = dict(keys=keys, connectivity=self.connectivity,
                      expansion_add=self.expansion_add, ndim=self.ndim,
                      seed=self.seed)
        t0 = time.perf_counter()
        if backend == "host":
            from rad_tpu_torch.build.reference import build_hnsw

            self._graph = build_hnsw(fps, **common)
        elif backend == "native":
            from rad_tpu_torch.native import build_hnsw_native

            self._graph = build_hnsw_native(fps, **common, **kwargs)
        elif backend == "device":
            from rad_tpu_torch.build.device import build_hnsw_device

            self._graph = build_hnsw_device(fps, device=self.device,
                                            **common, **kwargs)
        else:
            from rad_tpu_torch.build.exact import build_hnsw_exact

            self._graph = build_hnsw_exact(fps, device=self.device, **common,
                                           **kwargs)
        logger.info("built HNSW over %d vectors in %.2fs (%s, %s)",
                    len(keys), time.perf_counter() - t0, backend,
                    self.device)
        return self._graph

    @property
    def graph(self) -> HNSWGraph:
        if self._graph is None:
            self.build()
        return self._graph

    # --------------------------------------------------------------- search
    def search(self, queries, k: int = 10,
               expansion_search: int | None = None, exact: bool = False,
               backend: str | None = None,
               prefix_filter: int | None = None,
               prefix_keep: int | None = None):
        """Batched k-NN by Tanimoto distance → ``(dists [B, k], keys [B,
        k])`` numpy arrays: brute force with ``exact=True``, else the graph
        beam search (:func:`rad_tpu_torch.search.knn.search_device`) with
        ``expansion_search`` (default: the index's) on the index's device,
        with the two-stage prefix screen when ``prefix_filter`` is given.
        The brute force scans the library in blocks of 2**14 rows once
        ``len(graph) * B`` passes 2**26, as the reference does. With
        ``backend="native"`` the beam search runs on the host's cores
        instead (:func:`rad_tpu_torch.native.search_knn_native`), for a
        host that serves a graph without a card."""
        queries = coerce_packed(queries, self.ndim)
        g = self.graph
        ef = expansion_search or self.expansion_search
        if exact:
            from rad_tpu_torch.fp.pack import to_torch_packed
            from rad_tpu_torch.fp.tanimoto import (bruteforce_topk,
                                                   bruteforce_topk_blocked)

            q = to_torch_packed(queries, self.device)
            db = to_torch_packed(np.asarray(g.packed), self.device)
            if len(g) * queries.shape[0] > (1 << 26):
                d, ids = bruteforce_topk_blocked(q, db, k, block=1 << 14)
            else:
                d, ids = bruteforce_topk(q, db, k)
            d, ids = d.cpu().numpy(), ids.cpu().numpy()
        elif backend == "native":
            from rad_tpu_torch.native import search_knn_native

            d, ids = search_knn_native(g, queries, k=k, expansion_search=ef)
        else:
            from rad_tpu_torch.search.knn import search_device

            d, ids = search_device(
                g, queries, k=k, expansion_search=ef,
                prefix_filter=prefix_filter, prefix_keep=prefix_keep,
                device=self.device)
            d, ids = d.cpu().numpy(), ids.cpu().numpy()
        kv = host_keys_view(g.keys)
        keys = np.where(ids >= 0, np.asarray(kv[np.maximum(ids, 0)]), -1)
        return d, keys

    # ---------------------------------------------------- usearch-like API
    def __len__(self) -> int:
        if self._graph is not None:
            return len(self._graph)
        return int(sum(len(k) for k in self._pending_keys))

    @property
    def size(self) -> int:
        return len(self)

    @property
    def max_level(self) -> int:
        return self.graph.max_level

    @property
    def dtype(self) -> str:
        return "b1"

    @property
    def multi(self) -> bool:
        return False

    @property
    def capacity(self) -> int:
        return len(self)

    @property
    def memory_usage(self) -> int:
        return self.graph.memory_usage

    @property
    def levels_stats(self) -> List[LayerStats]:
        return self.graph.levels_stats()

    def get_neighbors(self, node_id: int, level: int) -> List[int]:
        return self.graph.get_neighbors(node_id, level)

    def get_top_level_nodes(self) -> List[int]:
        return self.graph.get_top_level_nodes()

    def get_node_ids_from_keys(self, keys: Sequence[int]) -> List[int]:
        return self.graph.get_node_ids_from_keys(keys)

    # -------------------------------------------------------------- persist
    def save(self, path: str) -> None:
        self.graph.save(path)

    @classmethod
    def load(cls, path: str, view: bool = True,
             exclude_vectors: bool = False, **kwargs) -> "HNSWIndex":
        """Load a persisted index; ``view=True`` memory-maps the arrays
        (usearch ``Index(path=..., view=True)``). ``exclude_vectors`` is
        accepted and unused, as in the reference: the memory map already
        reads lazily."""
        graph = HNSWGraph.load(path, mmap=view)
        return cls.from_graph(graph, **kwargs)

    @classmethod
    def from_graph(cls, graph: HNSWGraph, **kwargs) -> "HNSWIndex":
        idx = cls(ndim=graph.ndim, connectivity=graph.connectivity, **kwargs)
        idx._graph = graph
        return idx
