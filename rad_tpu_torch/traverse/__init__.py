"""Score-prioritized best-first HNSW traversal (the device engine)."""

from rad_tpu_torch.traverse.driver import DeviceTraverser

__all__ = ["DeviceTraverser"]
