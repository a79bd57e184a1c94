"""HNSW construction: the exact all-pairs builder."""

from rad_tpu_torch.build.exact import build_hnsw_exact

__all__ = ["build_hnsw_exact"]
