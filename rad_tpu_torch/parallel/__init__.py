"""Multi-device scaling: the single-controller mesh and the graph-sharded
engine, search and build (:mod:`rad_tpu.parallel`'s counterpart)."""

from rad_tpu_torch.parallel.mesh import make_mesh
from rad_tpu_torch.parallel.sharded import (
    ShardedGraph,
    shard_graph,
    sharded_bruteforce_topk,
    sharded_fused_step,
    make_sharded_step,
    make_sharded_step_full,
    make_sharded_step_multi,
    TrafficMeter,
    make_sharded_search,
    init_state_sharded,
)
from rad_tpu_torch.parallel.pod import PodTraverser

__all__ = [
    "make_mesh",
    "ShardedGraph",
    "shard_graph",
    "sharded_bruteforce_topk",
    "sharded_fused_step",
    "make_sharded_step",
    "make_sharded_step_full",
    "make_sharded_step_multi",
    "TrafficMeter",
    "make_sharded_search",
    "init_state_sharded",
    "PodTraverser",
]
