"""HNSW construction: the exact all-pairs builder on the device and the
numpy host builder."""

from rad_tpu_torch.build.exact import build_hnsw_exact
from rad_tpu_torch.build.reference import build_hnsw

__all__ = ["build_hnsw", "build_hnsw_exact"]
