"""LocalHNSWService: in-process service over a host-resident graph.

As ``rad_tpu.service.local``'s: a thin, lock-free adapter over the graph's
host arrays (``HNSWGraph.get_neighbors`` / ``get_top_level_nodes`` and
its key map). It never reads a device tensor, so a traversal through it
neither synchronises with nor allocates on the card. The request/metrics
surface (request counters, ``get_service_info``) keeps local and remote
services interchangeable.
"""

from __future__ import annotations

import threading
import time
from typing import List, Optional

from rad_tpu_torch.graph.storage import HNSWGraph, host_keys_view
from rad_tpu_torch.service.base import HNSWService
from rad_tpu_torch.store.smiles_store import SmilesStore

__all__ = ["LocalHNSWService"]


class LocalHNSWService(HNSWService):
    def __init__(
        self,
        graph: HNSWGraph,
        smiles_store: Optional[SmilesStore] = None,
        service_name: str = "local",
    ) -> None:
        self.graph = graph
        self.smiles_store = smiles_store
        self.service_name = service_name
        self._started_at = time.time()
        self._shutdown = False
        self._lock = threading.Lock()
        self._request_count = 0
        self._error_count = 0
        self._request_time = 0.0
        # the host key map: every answer is read from host arrays
        self._keys = host_keys_view(graph.keys)

    # ----------------------------------------------------------- internals
    def _check_alive(self) -> None:
        if self._shutdown:
            raise RuntimeError("service has been shut down")

    def _record(self, dt: float, error: bool = False) -> None:
        with self._lock:
            self._request_count += 1
            self._request_time += dt
            if error:
                self._error_count += 1

    def _to_smiles_pairs(self, ids: List[int]) -> List:
        """[id, ...] → flat [id, smiles, ...]; empty SMILES when unknown."""
        keys = [int(self._keys[i]) for i in ids]
        if self.smiles_store is not None:
            found = self.smiles_store.get_smiles_batch(keys)
        else:
            found = {}
        out: List = []
        for i, k in zip(ids, keys):
            out.extend((int(i), found.get(k, "")))
        return out

    # ------------------------------------------------------------ contract
    def get_neighbors(self, node_id: int, level: int) -> List:
        self._check_alive()
        t0 = time.perf_counter()
        try:
            flat = self.graph.get_neighbors(int(node_id), int(level))
            ids = flat[0::2]
            result = self._to_smiles_pairs(ids)
            self._record(time.perf_counter() - t0)
            return result
        except Exception:
            self._record(time.perf_counter() - t0, error=True)
            raise

    def get_top_level_nodes(self) -> List:
        self._check_alive()
        t0 = time.perf_counter()
        try:
            flat = self.graph.get_top_level_nodes()
            ids = flat[0::2]
            result = self._to_smiles_pairs(ids)
            self._record(time.perf_counter() - t0)
            return result
        except Exception:
            self._record(time.perf_counter() - t0, error=True)
            raise

    def is_healthy(self) -> bool:
        return not self._shutdown

    def shutdown(self) -> None:
        self._shutdown = True
        if self.smiles_store is not None:
            self.smiles_store.close()

    def get_service_info(self) -> dict:
        with self._lock:
            reqs = self._request_count
            errs = self._error_count
            total_t = self._request_time
        return {
            "service_type": "local",
            "service_name": self.service_name,
            "healthy": self.is_healthy(),
            "uptime_seconds": time.time() - self._started_at,
            "request_count": reqs,
            "error_count": errs,
            "avg_request_ms": 1000.0 * total_t / max(reqs, 1),
            "has_smiles_store": self.smiles_store is not None,
        }

    def get_hnsw_info(self) -> dict:
        self._check_alive()
        return self.graph.info()
