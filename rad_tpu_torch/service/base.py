"""HNSWService contract, as ``rad_tpu.service.base``'s.

The seam that makes a local in-process graph and a remote HTTP-served graph
interchangeable under the traverser. All neighbor/top-node queries return the
service-layer format: flat alternating ``[node_id, smiles, node_id, smiles,
...]`` lists (the graph's own ``[id, key, ...]`` pairs with each key's
SMILES in place of the key).
"""

from __future__ import annotations

from abc import ABC, abstractmethod
from typing import List


class HNSWService(ABC):
    @abstractmethod
    def get_neighbors(self, node_id: int, level: int) -> List:
        """Neighbors of ``node_id`` at ``level`` as ``[id, smiles, ...]``."""

    @abstractmethod
    def get_top_level_nodes(self) -> List:
        """All top-layer nodes as ``[id, smiles, ...]``."""

    @abstractmethod
    def is_healthy(self) -> bool:
        ...

    @abstractmethod
    def shutdown(self) -> None:
        ...

    @abstractmethod
    def get_service_info(self) -> dict:
        ...

    @abstractmethod
    def get_hnsw_info(self) -> dict:
        """Graph metadata: max_level, size, connectivity, ndim, ..."""
