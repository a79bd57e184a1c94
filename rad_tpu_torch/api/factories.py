"""Traverser factories."""

from __future__ import annotations

from typing import Callable

from rad_tpu_torch.api.traverser import RADTraverser

__all__ = ["create_local_traverser"]


def create_local_traverser(hnsw, scoring_fn: Callable[[str], float],
                           **kwargs) -> RADTraverser:
    """Local graph + device traversal engine. ``hnsw`` is an HNSWIndex
    (its ``device`` is the default) or an HNSWGraph."""
    from rad_tpu_torch.api.index import HNSWIndex
    from rad_tpu_torch.graph.storage import HNSWGraph

    if isinstance(hnsw, HNSWIndex):
        kwargs.setdefault("device", hnsw.device)
        return RADTraverser(graph=hnsw.graph, scoring_fn=scoring_fn,
                            deployment_mode="local", **kwargs)
    if isinstance(hnsw, HNSWGraph):
        return RADTraverser(graph=hnsw, scoring_fn=scoring_fn,
                            deployment_mode="local", **kwargs)
    raise TypeError(f"unsupported hnsw argument {type(hnsw)!r}")
