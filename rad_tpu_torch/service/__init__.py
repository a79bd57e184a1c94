"""HNSW service abstraction: local in-process vs remote HTTP, interchangeable."""

from rad_tpu_torch.service.base import HNSWService
from rad_tpu_torch.service.local import LocalHNSWService
from rad_tpu_torch.service.registry import (
    ServiceRegistry,
    get_default_registry,
    create_local_hnsw_service,
    create_remote_hnsw_service,
)

__all__ = [
    "HNSWService",
    "LocalHNSWService",
    "ServiceRegistry",
    "get_default_registry",
    "create_local_hnsw_service",
    "create_remote_hnsw_service",
]
