"""User-facing API: HNSWIndex builder facade + RADTraverser lifecycle."""

from rad_tpu_torch.api.factories import (
    create_distributed_traverser,
    create_local_traverser,
    create_pod_traverser,
    create_remote_traverser,
)
from rad_tpu_torch.api.index import HNSWIndex
from rad_tpu_torch.api.traverser import RADTraverser

__all__ = [
    "HNSWIndex",
    "RADTraverser",
    "create_local_traverser",
    "create_distributed_traverser",
    "create_remote_traverser",
    "create_pod_traverser",
]
