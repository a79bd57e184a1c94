"""Batched HNSW k-NN search (greedy descent + layer-0 beam)."""

from rad_tpu_torch.search.knn import search_device

__all__ = ["search_device"]
