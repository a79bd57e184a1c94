"""Named registry of HNSW services + convenience factories, as
``rad_tpu.service.registry``'s: a ``ServiceRegistry``, one module-global
instance, and factories that register on creation.
"""

from __future__ import annotations

import threading
from typing import Dict, Optional

from rad_tpu_torch.service.base import HNSWService
from rad_tpu_torch.service.local import LocalHNSWService

__all__ = [
    "ServiceRegistry",
    "get_default_registry",
    "create_local_hnsw_service",
    "create_remote_hnsw_service",
]


class ServiceRegistry:
    def __init__(self) -> None:
        self._services: Dict[str, HNSWService] = {}
        self._default: Optional[str] = None
        self._lock = threading.Lock()

    def register_service(self, name: str, service: HNSWService,
                         set_default: bool = False) -> None:
        with self._lock:
            self._services[name] = service
            if set_default or self._default is None:
                self._default = name

    def get_service(self, name: str | None = None) -> HNSWService:
        with self._lock:
            key = name if name is not None else self._default
            if key is None or key not in self._services:
                raise KeyError(f"no service registered under {key!r}")
            return self._services[key]

    def unregister_service(self, name: str) -> None:
        with self._lock:
            self._services.pop(name, None)
            if self._default == name:
                self._default = next(iter(self._services), None)

    def list_services(self) -> list:
        with self._lock:
            return sorted(self._services)

    def shutdown_all(self) -> None:
        with self._lock:
            services = list(self._services.values())
            self._services.clear()
            self._default = None
        for s in services:
            try:
                s.shutdown()
            except Exception:
                pass


_default_registry = ServiceRegistry()


def get_default_registry() -> ServiceRegistry:
    return _default_registry


def create_local_hnsw_service(
    graph,
    smiles_store=None,
    service_name: str = "local",
    register: bool = True,
    database_path: str | None = None,
) -> LocalHNSWService:
    """Create (and by default register) a local service.

    ``graph`` may be an ``HNSWGraph`` or an ``HNSWIndex`` facade.
    ``database_path`` opens a SQLite SMILES store
    (``create_local_hnsw_service(hnsw, database_path=...)``, the original
    rad's call).
    """
    from rad_tpu_torch.api.index import HNSWIndex

    if isinstance(graph, HNSWIndex):
        graph = graph.graph
    if smiles_store is None and database_path is not None:
        from rad_tpu_torch.store.smiles_store import SQLiteSmilesStore
        smiles_store = SQLiteSmilesStore(database_path)
    service = LocalHNSWService(graph, smiles_store, service_name=service_name)
    if register:
        _default_registry.register_service(service_name, service)
    return service


def create_remote_hnsw_service(
    base_url: str,
    api_key: str | None = None,
    service_name: str = "remote",
    register: bool = True,
    **kwargs,
):
    """Create (and by default register) a remote HTTP client service."""
    from rad_tpu_torch.service.remote import RemoteHNSWService

    service = RemoteHNSWService(base_url, api_key=api_key,
                                service_name=service_name, **kwargs)
    if register:
        _default_registry.register_service(service_name, service)
    return service
