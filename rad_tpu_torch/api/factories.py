"""Traverser factories, as ``rad_tpu.api.factories``'."""

from __future__ import annotations

from typing import Callable

from rad_tpu_torch.api.traverser import RADTraverser

__all__ = [
    "create_local_traverser",
    "create_distributed_traverser",
    "create_remote_traverser",
    "create_pod_traverser",
]


def create_local_traverser(hnsw, scoring_fn: Callable[[str], float],
                           **kwargs) -> RADTraverser:
    """Local graph + device traversal engine. ``hnsw`` is an HNSWIndex
    (its ``device`` is the default), an HNSWGraph or a local
    HNSWService."""
    from rad_tpu_torch.api.index import HNSWIndex
    from rad_tpu_torch.graph.storage import HNSWGraph
    from rad_tpu_torch.service.base import HNSWService

    if isinstance(hnsw, HNSWIndex):
        kwargs.setdefault("device", hnsw.device)
        return RADTraverser(graph=hnsw.graph, scoring_fn=scoring_fn,
                            deployment_mode="local", **kwargs)
    if isinstance(hnsw, HNSWGraph):
        return RADTraverser(graph=hnsw, scoring_fn=scoring_fn,
                            deployment_mode="local", **kwargs)
    if isinstance(hnsw, HNSWService):
        return RADTraverser(hnsw_service=hnsw, scoring_fn=scoring_fn,
                            deployment_mode="local", **kwargs)
    raise TypeError(f"unsupported hnsw argument {type(hnsw)!r}")


def create_distributed_traverser(hnsw, scoring_fn: Callable[[str], float],
                                 n_workers: int | None = None,
                                 **kwargs) -> RADTraverser:
    """Host coordination engine with a scoring worker pool; workers on
    other machines attach through the HTTP coordination endpoints of
    :mod:`rad_tpu_torch.server`. ``hnsw`` is an HNSWIndex, an HNSWGraph
    (both served from their host arrays) or an HNSWService."""
    from rad_tpu_torch.api.index import HNSWIndex
    from rad_tpu_torch.graph.storage import HNSWGraph
    from rad_tpu_torch.service.local import LocalHNSWService

    if isinstance(hnsw, HNSWIndex):
        hnsw = LocalHNSWService(hnsw.graph, kwargs.pop("smiles_store", None))
    elif isinstance(hnsw, HNSWGraph):
        hnsw = LocalHNSWService(hnsw, kwargs.pop("smiles_store", None))
    return RADTraverser(hnsw_service=hnsw, scoring_fn=scoring_fn,
                        deployment_mode="distributed",
                        n_workers=n_workers, **kwargs)


def create_remote_traverser(hnsw_service_url: str,
                            scoring_fn: Callable[[str], float],
                            api_key: str | None = None,
                            **kwargs) -> RADTraverser:
    """Traverse a graph served over HTTP; scoring stays local."""
    from rad_tpu_torch.service.registry import create_remote_hnsw_service

    service = create_remote_hnsw_service(hnsw_service_url, api_key=api_key,
                                         register=False)
    return RADTraverser(hnsw_service=service, scoring_fn=scoring_fn,
                        deployment_mode="remote", **kwargs)


def create_pod_traverser(hnsw, scoring_fn: Callable[[str], float],
                         mesh=None, n_devices: int | None = None,
                         **kwargs) -> RADTraverser:
    """The graph split over a device mesh (``mesh``, or ``n_devices``
    CUDA devices), host scoring pipelined through the sharded
    expand/integrate halves: :class:`~rad_tpu_torch.parallel.pod.
    PodTraverser` under the RADTraverser lifecycle. ``hnsw`` is an
    HNSWIndex or an HNSWGraph."""
    from rad_tpu_torch.api.index import HNSWIndex
    from rad_tpu_torch.graph.storage import HNSWGraph

    if isinstance(hnsw, HNSWIndex):
        hnsw = hnsw.graph
    if not isinstance(hnsw, HNSWGraph):
        raise TypeError("pod mode shards a local graph; pass an HNSWIndex "
                        f"or HNSWGraph, got {type(hnsw)!r}")
    return RADTraverser(graph=hnsw, scoring_fn=scoring_fn,
                        deployment_mode="pod", mesh=mesh,
                        n_devices=n_devices, **kwargs)
