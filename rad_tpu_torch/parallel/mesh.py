"""Device mesh construction for graph-sharded screening.

The counterpart of :mod:`rad_tpu.parallel.mesh`: the *graph* is the
partitioned dimension. Fingerprints and adjacency rows are split by rows
over the mesh's ``graph`` axis; the (small) frontier and counters are
replicated.

The port is single-controller, as the reference is: one process drives
every device of the mesh (JAX's ``shard_map`` does the same). A
:class:`Mesh` is a named grid of ``torch.device``\\ s. Replicated state and
replicated math run once, on the lead device ``devices.flat[0]``; sharded
operands live on their shard's device, and the collectives of
:mod:`rad_tpu_torch.parallel.collectives` move each shard's contribution
to the lead device and combine it there. A device may repeat in the grid:
``make_mesh(4, devices=[torch.device("cuda:0")] * 4)`` gives four shards
on one card, which then share that card's memory and its stream (nothing
is copied between them). A mesh that spans processes
(:func:`rad_tpu_torch.parallel.multihost.global_mesh`) carries the
process group the collectives finish on.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

__all__ = ["Mesh", "make_mesh"]


class Mesh:
    """A named grid of devices.

    ``devices``: numpy object array of ``torch.device``; ``axis_names``:
    one name per grid dimension; ``shape``: ``{axis name: size}``.
    ``owners`` (same shape as ``devices``) names the process that drives
    each position and ``group`` the ``torch.distributed`` process group
    the collectives finish on; both are ``None`` for a mesh of one
    process."""

    def __init__(self, devices: np.ndarray, axis_names: Sequence[str],
                 owners: np.ndarray | None = None, group=None,
                 rank: int = 0) -> None:
        self.devices = devices
        self.axis_names = tuple(axis_names)
        self.owners = owners
        self.group = group
        self.rank = rank

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    @property
    def lead(self) -> torch.device:
        """Where replicated state and replicated math run: the first
        device of the grid this process drives."""
        for i, d in enumerate(self.devices.flat):
            if self.owners is None or int(self.owners.flat[i]) == self.rank:
                return d
        raise ValueError("this process drives no device of the mesh")

    def local(self, index) -> bool:
        """Whether this process drives the device at grid ``index``."""
        return self.owners is None or int(self.owners[index]) == self.rank

    def axis_devices(self, axis: str):
        """``[(device, local?)]`` along ``axis``, the other axes at 0."""
        dim = self.axis_names.index(axis)
        index = [0] * self.devices.ndim
        out = []
        for i in range(self.devices.shape[dim]):
            index[dim] = i
            out.append((self.devices[tuple(index)], self.local(tuple(index))))
        return out

    def __repr__(self) -> str:
        return (f"Mesh(shape={self.shape}, lead={self.lead}, "
                f"processes={1 if self.owners is None else 'many'})")


def make_mesh(n_devices: int | None = None,
              axis_names: Sequence[str] = ("graph",),
              devices=None) -> Mesh:
    """A 1-D (default) or N-D mesh over the first ``n_devices`` devices.

    With one axis name the mesh is 1-D over the graph axis; pass two
    names (e.g. ``("data", "graph")``) with ``n_devices`` a tuple to get a
    2-D mesh for batched-query × sharded-graph search.

    ``devices`` defaults to every CUDA device; with none visible and no
    ``devices`` given this raises (the port never falls back to the CPU:
    tests pass ``[torch.device("cpu")] * 8``). A device may repeat, and
    repeated devices share one card's memory and stream."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "make_mesh: no CUDA device visible and no devices given; "
                "pass devices=[torch.device(\"cpu\")] * n for a CPU mesh")
        devs = [torch.device(f"cuda:{i}")
                for i in range(torch.cuda.device_count())]
    else:
        devs = [torch.device(d) for d in devices]
    if n_devices is None:
        shape = (len(devs),) if len(axis_names) == 1 else None
        if shape is None:
            raise ValueError("give n_devices as a tuple for N-D meshes")
    elif isinstance(n_devices, int):
        if len(axis_names) != 1:
            raise ValueError("int n_devices requires a single axis name")
        shape = (n_devices,)
    else:
        shape = tuple(n_devices)
    if len(shape) != len(axis_names):
        raise ValueError(
            f"a mesh of shape {shape} needs {len(shape)} axis names, got "
            f"{tuple(axis_names)}")
    total = int(np.prod(shape))
    if total > len(devs):
        raise ValueError(f"need {total} devices, have {len(devs)}")
    grid = np.empty(total, dtype=object)
    grid[:] = devs[:total]
    return Mesh(grid.reshape(shape), axis_names)
