"""The collectives ``shard_map`` gives the reference, written once.

The port's mesh is single-controller (:mod:`rad_tpu_torch.parallel.mesh`):
one process drives every shard, so a collective is a loop over the shards
that moves each shard's contribution to the lead device and combines it
there, in shard order. On a multi-card host a contribution moves with
``.to(lead, non_blocking=True)``; with repeated devices nothing is copied.
When the mesh spans processes (``group`` given), the local combination is
followed by the matching ``torch.distributed`` collective on that group —
the only place ``torch.distributed`` appears.

Only integers are summed. Booleans travel as int32 and f32 values as
their int32 bits (``tensor.view(torch.int32)``), as the reference's
``psum`` of bitcast scores does; with exactly one owner per index every
summation order gives the same bits.

:class:`ShardedRows` is the row-sharded global array these build: shard
``s`` holds rows ``[s * shard_size, (s + 1) * shard_size)`` on its device,
and indexing it with a tensor is the owned gather.
"""

from __future__ import annotations

import torch

__all__ = ["owned_gather", "all_gather", "all_to_all", "ShardedRows"]


def _to_int(t: torch.Tensor) -> torch.Tensor:
    if t.dtype == torch.bool:
        return t.to(torch.int32)
    if t.dtype == torch.float32:
        return t.view(torch.int32)
    return t


def _from_int(t: torch.Tensor, dtype) -> torch.Tensor:
    if dtype == torch.bool:
        return t != 0
    if dtype == torch.float32:
        return t.view(torch.float32)
    return t.to(dtype)


def owned_gather(shards, global_idx: torch.Tensor, shard_size: int,
                 fill_shift: int = 0, lead=None, group=None) -> torch.Tensor:
    """Rows ``global_idx`` (any shape, int) of a row-sharded array.

    ``shards[s]`` holds global rows ``[s * shard_size, (s + 1) *
    shard_size)`` (``None``: a shard another process drives). Every shard
    contributes ``value + fill_shift`` for the indices it owns and 0
    elsewhere; the contributions are summed as integers, in shard order,
    on ``lead`` (default: ``global_idx``'s device), then across the
    process ``group``, and the shift is removed. An index no shard owns
    reads ``-fill_shift``: ``fill_shift=1`` makes it the -1 sentinel of
    adjacency rows. The reference's ``_owned_gather``."""
    lead = global_idx.device if lead is None else torch.device(lead)
    local = [(s, t) for s, t in enumerate(shards) if t is not None]
    dtype = local[0][1].dtype
    split = {}
    total = None
    for s, t in local:
        key = t.device
        if key not in split:
            idx = global_idx.to(key, non_blocking=True).long()
            # floor division: loc is in range for any index, and an
            # index outside every shard matches no s
            split[key] = (torch.div(idx, shard_size, rounding_mode="floor"),
                          torch.remainder(idx, shard_size))
        sid, loc = split[key]
        vals = _to_int(t[loc])
        if fill_shift:
            vals = vals + fill_shift
        own = sid == s
        contrib = vals.masked_fill(
            ~own.reshape(own.shape + (1,) * (vals.dim() - own.dim())), 0)
        contrib = contrib.to(lead, non_blocking=True)
        total = contrib if total is None else total + contrib
    if group is not None:
        import torch.distributed as dist
        dist.all_reduce(total, group=group)
    if fill_shift:
        total = total - fill_shift
    return _from_int(total, dtype)


def all_gather(parts, lead, dim: int = 0, group=None) -> torch.Tensor:
    """Every shard's ``parts[s]`` concatenated along ``dim`` in shard
    order, on ``lead``. With a process ``group`` each process holds the
    parts of its own contiguous run of shards (``None`` elsewhere), and
    the runs are gathered in rank order."""
    mine = torch.cat([p.to(lead, non_blocking=True) for p in parts
                      if p is not None], dim)
    if group is None:
        return mine
    import torch.distributed as dist
    out = [torch.empty_like(mine) for _ in range(dist.get_world_size(group))]
    dist.all_gather(out, mine.contiguous(), group=group)
    return torch.cat(out, dim)


def all_to_all(blocks, devices, group=None):
    """``blocks[i][j]`` is what shard ``i`` sends shard ``j``; returns
    ``recv`` with ``recv[j][i] = blocks[i][j]`` on ``devices[j]`` (the
    ``all_to_all`` of ``lax`` with ``split_axis=concat_axis=0``). With a
    process ``group``, ``blocks[i]`` is ``None`` for the shards another
    process drives; each process's sends travel in one ``all_gather``
    (so any backend serves), and ``recv[j]`` is filled for its own
    shards only."""
    d = len(devices)
    if group is None:
        return [[blocks[i][j].to(devices[j], non_blocking=True)
                 for i in range(d)] for j in range(d)]
    import torch.distributed as dist
    mine = [i for i in range(d) if blocks[i] is not None]
    send = torch.stack([torch.stack(list(blocks[i])) for i in mine])
    world = dist.get_world_size(group)
    got = [torch.empty_like(send) for _ in range(world)]
    dist.all_gather(got, send.contiguous(), group=group)
    rows = torch.cat(got)                      # [d, d, ...] in shard order
    return [[rows[i, j].to(devices[j]) for i in range(d)]
            if blocks[j] is not None else None for j in range(d)]


class ShardedRows:
    """A row-sharded array: ``shards[s]`` (on its own device; ``None``
    when another process drives it) holds rows ``[s * shard_size, (s + 1)
    * shard_size)``.

    Indexing with an integer tensor is :func:`owned_gather` (result on
    ``lead``); with an int or a slice it reads the assembled array
    (:meth:`full`). With ``sentinel=True`` every shard carries one
    trailing dropped-write slot of its own, as the device engine's state
    tables do, and the array reads as ``D * shard_size + 1`` rows whose
    last is the sentinel: ``arr[idx] = vals`` and ``index_fill_`` write
    only the indices a shard owns and send the rest to that shard's
    sentinel slot, so the write path has no collective."""

    def __init__(self, shards, shard_size: int, lead, fill_shift: int = 0,
                 sentinel: bool = False, group=None) -> None:
        self.shards = list(shards)
        self.shard_size = int(shard_size)
        self.lead = torch.device(lead)
        self.fill_shift = fill_shift
        self.sentinel = sentinel
        self.group = group
        first = next(t for t in self.shards if t is not None)
        self.dtype = first.dtype
        self._row_shape = tuple(first.shape[1:])

    @property
    def device(self) -> torch.device:
        return self.lead

    @property
    def shape(self):
        n = len(self.shards) * self.shard_size + int(self.sentinel)
        return (n, *self._row_shape)

    @property
    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size() for t in self.shards
                   if t is not None)

    def __getitem__(self, key):
        if torch.is_tensor(key):
            return owned_gather(self.shards, key, self.shard_size,
                                self.fill_shift, self.lead, self.group)
        return self.full()[key]

    def _owned(self, s: int, idx: torch.Tensor, device) -> torch.Tensor:
        """Shard ``s``'s slots of ``idx``: its local row, or its sentinel
        slot for an index it does not own."""
        loc = idx.to(device, non_blocking=True).long() - s * self.shard_size
        own = (loc >= 0) & (loc < self.shard_size)
        return torch.where(own, loc, self.shard_size)

    def __setitem__(self, idx: torch.Tensor, vals) -> None:
        assert self.sentinel, "only tables with sentinel slots take writes"
        for s, t in enumerate(self.shards):
            if t is None:
                continue
            v = vals.to(t.device, non_blocking=True) \
                if torch.is_tensor(vals) else vals
            t[self._owned(s, idx, t.device)] = v

    def index_fill_(self, dim: int, idx: torch.Tensor, value):
        assert self.sentinel and dim == 0
        for s, t in enumerate(self.shards):
            if t is not None:
                t.index_fill_(0, self._owned(s, idx.reshape(-1), t.device),
                              value)
        return self

    def full(self) -> torch.Tensor:
        """The assembled array on ``lead`` (with one trailing sentinel
        element, zero, for a sentinel table). Across processes, each
        contributes its own rows to one integer all-reduce."""
        n = self.shard_size
        parts = [None if t is None else t[:n] for t in self.shards]
        if self.group is None:
            out = torch.cat([p.to(self.lead) for p in parts])
        else:
            import torch.distributed as dist
            first = next(p for p in parts if p is not None)
            acc = torch.zeros((len(parts) * n, *self._row_shape),
                              dtype=_to_int(first).dtype, device=self.lead)
            for s, p in enumerate(parts):
                if p is not None:
                    acc[s * n:(s + 1) * n] = _to_int(p).to(self.lead)
            dist.all_reduce(acc, group=self.group)
            out = _from_int(acc, self.dtype)
        if self.sentinel:
            out = torch.cat([out, torch.zeros((1, *self._row_shape),
                                              dtype=self.dtype,
                                              device=self.lead)])
        return out
