"""Multi-process initialization for meshes that span hosts.

The port of :mod:`rad_tpu.parallel.multihost`. A mesh on one host needs
nothing beyond :func:`rad_tpu_torch.parallel.make_mesh` (one process
drives every device). Across processes, ``torch.distributed`` must be
initialized first: :func:`initialize_multihost` does that, and
:func:`global_mesh` builds the mesh over every process's devices, in
which each process drives its own contiguous run of shards. The sharded
engine then works unchanged: each collective combines the local shards'
contributions and finishes with one collective on the process group
(:mod:`rad_tpu_torch.parallel.collectives`), while the HTTP coordination
layer (:mod:`rad_tpu_torch.server`) stays the scoring-worker fan-out
channel, as on one host.

Each process drives its ``torch.cuda.device_count()`` cards with NCCL
(one process per host); a CPU mesh over gloo names its devices
(``local_devices``), as the tests do. NCCL refuses two processes on one
card, so on a one-card host the NCCL group has one process.
"""

from __future__ import annotations

import logging
from typing import Optional, Sequence

import numpy as np
import torch

logger = logging.getLogger(__name__)

__all__ = ["initialize_multihost", "global_mesh"]


def initialize_multihost(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> None:
    """Initialize ``torch.distributed`` (idempotent): NCCL when CUDA is
    present, gloo otherwise, rendezvous at ``tcp://{coordinator_address}``
    (``host:port``), or through the ``MASTER_ADDR`` / ``MASTER_PORT`` /
    ``WORLD_SIZE`` / ``RANK`` environment (``env://``) when it is
    ``None``."""
    import torch.distributed as dist

    if dist.is_initialized():
        logger.debug("torch.distributed already initialized")
        return
    backend = "nccl" if torch.cuda.is_available() else "gloo"
    init = ("env://" if coordinator_address is None
            else f"tcp://{coordinator_address}")
    kwargs = {}
    if num_processes is not None:
        kwargs["world_size"] = int(num_processes)
    if process_id is not None:
        kwargs["rank"] = int(process_id)
    dist.init_process_group(backend, init_method=init, **kwargs)
    logger.info("torch.distributed initialized (%s): process %d/%d",
                backend, dist.get_rank(), dist.get_world_size())


def global_mesh(axis_names: Sequence[str] = ("graph",),
                local_devices=None):
    """A 1-D mesh over every device of every connected process: process
    ``p``'s devices (``local_devices``, default: its CUDA cards; with
    none visible and none given this raises, as ``make_mesh`` does) are
    shards ``[p * L, (p + 1) * L)``. Every process must pass the same
    number of local devices."""
    import torch.distributed as dist

    from rad_tpu_torch.parallel.mesh import Mesh

    if len(axis_names) != 1:
        raise ValueError("global_mesh builds a 1-D mesh")
    if local_devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "global_mesh: no CUDA device visible and no local_devices "
                "given; pass local_devices=[\"cpu\", ...] for a CPU mesh")
        local_devices = [torch.device(f"cuda:{i}")
                         for i in range(torch.cuda.device_count())]
    local = [torch.device(d) for d in local_devices]
    world, rank = dist.get_world_size(), dist.get_rank()
    grid = np.empty(world * len(local), dtype=object)
    owners = np.repeat(np.arange(world), len(local))
    for p in range(world):
        # another process's devices are named as this process names its
        # own; only their owner drives them
        grid[p * len(local):(p + 1) * len(local)] = local
    return Mesh(grid, axis_names, owners=owners, group=dist.group.WORLD,
                rank=rank)
