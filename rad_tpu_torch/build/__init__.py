"""HNSW construction: the exact all-pairs builder and the batched beam
builder on the device, the numpy host builder, incremental insertion and
the partition-and-stitch builder."""

from rad_tpu_torch.build.exact import build_hnsw_exact
from rad_tpu_torch.build.incremental import insert_into_graph
from rad_tpu_torch.build.partition import build_hnsw_partitioned
from rad_tpu_torch.build.reference import build_hnsw

__all__ = ["build_hnsw", "build_hnsw_exact", "build_hnsw_partitioned",
           "insert_into_graph"]
