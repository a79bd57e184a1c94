"""HNSW graph storage model (host numpy, ``.npz`` compatible with
``rad_tpu``)."""

from rad_tpu_torch.graph.storage import HNSWGraph, LayerStats

__all__ = ["HNSWGraph", "LayerStats"]
