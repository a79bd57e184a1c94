"""Graph-sharded kernels: the pod-scale engine over a device mesh.

The port of :mod:`rad_tpu.parallel.sharded`. The *graph* is the long axis:
fingerprints ``[N, W]`` and the flat adjacency ``[R, M0]`` are split by
rows over the mesh's ``graph`` axis (:class:`ShardedGraph`, each array a
:class:`~rad_tpu_torch.parallel.collectives.ShardedRows`), while the
traversal state (frontier, visited/scored tables, counters) is replicated
— tiny next to the fingerprint matrix. Each step:

1. pops the replicated frontier batch, once, on the lead device;
2. gathers the popped rows' adjacency and the candidates' fingerprints
   from the shards that own them: every shard contributes the rows it
   owns and one integer sum combines them (each row has exactly one
   owner, so the sum *is* the gather,
   :func:`~rad_tpu_torch.parallel.collectives.owned_gather`);
3. runs the single-device integrate/merge on the replicated state.

The step *is* the single-device step
(:func:`~rad_tpu_torch.traverse.device.expand` /
:func:`~rad_tpu_torch.traverse.device.integrate`) with its two hooks: the
adjacency gather (``gather_adj``) and, with the state sharded too
(:func:`init_state_sharded`, :func:`make_sharded_step_full`), the state
ops (:class:`_ShardStateOps`). So the pod engine's orders, scored sets,
scores and drops are the single-device engine's.

Where the reference's ``shard_map`` runs one program per device, the
port's mesh is single-controller (:mod:`rad_tpu_torch.parallel.mesh`):
replicated work runs once on the lead device, and only the gathers visit
the shards. Not carried over: the pytree hooks of :class:`ShardedGraph`
(a torch program needs none), the grouped packed-adjacency layout
(``adj_group``: the port always stores ``[R, W]``,
:mod:`rad_tpu_torch.graph.adjpack`) and the multi-campaign step's TPU
guard ``_check_multi_batch`` (``allow_hazard`` is accepted and inert, as
in :mod:`rad_tpu_torch.traverse.multi`).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Tuple

import numpy as np
import torch

from rad_tpu_torch.fp.pack import popcount_rows
from rad_tpu_torch.graph.adjpack import (adj_bits_for, pack_adjacency_numpy,
                                         packed_adj_words,
                                         unpack_adjacency_rows)
from rad_tpu_torch.graph.storage import HNSWGraph
from rad_tpu_torch.parallel.collectives import ShardedRows, all_gather
from rad_tpu_torch.parallel.mesh import Mesh
from rad_tpu_torch.traverse import device as dev
from rad_tpu_torch.traverse.candidate_ops import _first_occurrence
from rad_tpu_torch.traverse.device import (INF, DeviceGraph, TraversalState,
                                           flatten_adjacency_host)

__all__ = [
    "ShardedGraph",
    "shard_graph",
    "shard_graph_streamed",
    "put_sharded_rows",
    "sharded_bruteforce_topk",
    "sharded_fused_step",
    "make_sharded_step",
    "make_sharded_step_full",
    "make_sharded_step_multi",
    "TrafficMeter",
    "make_sharded_expand_integrate",
    "make_sharded_search",
    "make_sharded_search_2d",
    "init_state_sharded",
    "tanimoto_to_target_scorer",
    "sharded_state_to_reference_arrays",
]


@dataclass
class ShardedGraph:
    """A DeviceGraph + fingerprints laid out over a mesh's graph axis.

    ``packed`` ([N_pad, W] int32 bit views), ``pops`` ([N_pad]) and
    ``adj`` ([R_pad, M0] int32, or packed words when ``adj_bits < 32``)
    are :class:`ShardedRows`, padded to a multiple of the axis size;
    ``offsets`` lives on the lead device. ``n_nodes``/``n_rows`` are the
    true sizes, ``n_pad_nodes``/``n_pad_rows`` the padded ones."""

    packed: ShardedRows
    pops: ShardedRows
    adj: ShardedRows
    offsets: torch.Tensor
    n_nodes: int
    n_rows: int
    n_pad_nodes: int
    n_pad_rows: int
    m0: int
    max_level: int
    axis: str
    adj_bits: int = 32
    offsets_host: np.ndarray = field(init=False, repr=False)

    def __post_init__(self) -> None:
        self.offsets_host = self.offsets.cpu().numpy()

    @property
    def lead(self) -> torch.device:
        return self.offsets.device

    def device_graph(self) -> DeviceGraph:
        """The traversal view: a DeviceGraph whose adjacency reads go
        through the owned gather."""
        return _meta_graph(self, padded=False)

    def nbytes(self) -> int:
        """Bytes of the shards this process holds."""
        return (self.packed.nbytes + self.pops.nbytes + self.adj.nbytes
                + self.offsets.numel() * self.offsets.element_size())


def _meta_graph(sg: ShardedGraph, padded: bool) -> DeviceGraph:
    """DeviceGraph over the sharded adjacency; ``padded`` sizes put the
    dropped-write sentinels outside every shard (sharded state)."""
    return DeviceGraph(
        adj=sg.adj, offsets=sg.offsets, offsets_host=sg.offsets_host,
        n_nodes=sg.n_pad_nodes if padded else sg.n_nodes,
        n_rows=sg.n_pad_rows if padded else sg.n_rows,
        m0=sg.m0, max_level=sg.max_level, adj_bits=sg.adj_bits)


def _pad_rows(arr: np.ndarray, mult: int, fill) -> np.ndarray:
    pad = (-arr.shape[0]) % mult
    if pad == 0:
        return arr
    return np.concatenate(
        [arr, np.full((pad, *arr.shape[1:]), fill, arr.dtype)], axis=0)


def _as_torch(chunk: np.ndarray) -> torch.Tensor:
    """Host rows as a tensor (uint32 words as their int32 bit view)."""
    chunk = np.ascontiguousarray(chunk)
    if chunk.dtype == np.uint32:
        chunk = chunk.view(np.int32)
    return torch.from_numpy(chunk)


def _adj_bits(n_nodes: int, packed_adjacency) -> int:
    if not packed_adjacency:
        return 32
    bits = (adj_bits_for(n_nodes) if packed_adjacency is True
            else int(packed_adjacency))
    return min(bits, 32)  # >=32-bit fields cannot shrink; keep unpacked


def _pack_host(adj: np.ndarray, bits: int) -> np.ndarray:
    out = np.empty((adj.shape[0], packed_adj_words(adj.shape[1], bits)),
                   np.uint32)
    step = 1 << 20  # bounds the packer's int64 temporaries
    for lo in range(0, adj.shape[0], step):
        out[lo:lo + step] = pack_adjacency_numpy(adj[lo:lo + step], bits)
    return out


def shard_graph(graph: HNSWGraph, mesh: Mesh, axis: str = "graph",
                packed_adjacency: bool | int = False) -> ShardedGraph:
    """Lay a built graph out over the mesh's ``axis`` (split by rows).

    The adjacency is flattened on the host and each shard uploaded to its
    own device, so the whole table never passes through one device.
    ``packed_adjacency=True`` (or a field width) stores each shard's rows
    as bit-packed fields (:mod:`rad_tpu_torch.graph.adjpack`), gathered as
    packed words and decoded on the lead device."""
    adj_host, offsets_np, m0, r = flatten_adjacency_host(graph)
    n_nodes = len(graph)
    nd = mesh.shape[axis]
    packed = _pad_rows(np.asarray(graph.packed, np.uint32), nd, 0)
    pops = _pad_rows(np.asarray(graph.popcounts).astype(np.int32), nd, 0)
    bits = _adj_bits(n_nodes, packed_adjacency)
    adj = _pad_rows(adj_host, nd, -1)
    if bits < 32:
        adj = _pack_host(adj, bits)

    def rows_of(arr):
        return lambda start, stop: arr[start:stop]

    adj_sh = put_sharded_rows(mesh, axis, adj.shape, adj.dtype, rows_of(adj))
    adj_sh.fill_shift = 1 if bits >= 32 else 0
    return ShardedGraph(
        packed=put_sharded_rows(mesh, axis, packed.shape, np.uint32,
                                rows_of(packed)),
        pops=put_sharded_rows(mesh, axis, pops.shape, np.int32,
                              rows_of(pops)),
        adj=adj_sh,
        offsets=torch.from_numpy(offsets_np).to(mesh.lead),
        n_nodes=n_nodes, n_rows=r, n_pad_nodes=packed.shape[0],
        n_pad_rows=adj.shape[0], m0=m0, max_level=graph.max_level,
        axis=axis, adj_bits=bits)


def put_sharded_rows(mesh: Mesh, axis: str, global_shape, dtype,
                     make_shard) -> ShardedRows:
    """A row-sharded array from per-shard host callbacks.

    ``make_shard(start, stop) -> np.ndarray [stop-start, ...]`` is called
    once per shard this process drives, with the global row range that
    shard owns; each chunk goes straight to its device and is freed
    before the next is built, so the host holds one shard at a time.
    ``global_shape[0]`` must divide by the axis size."""
    global_shape = tuple(int(s) for s in global_shape)
    nd = mesh.shape[axis]
    if global_shape[0] % nd:
        raise ValueError(
            f"global row count {global_shape[0]} is not divisible by the "
            f"{nd}-device '{axis}' mesh axis — pad rows first")
    size = global_shape[0] // nd
    shards = []
    for s, (device, local) in enumerate(mesh.axis_devices(axis)):
        if not local:
            shards.append(None)
            continue
        start, stop = s * size, (s + 1) * size
        chunk = np.ascontiguousarray(make_shard(start, stop),
                                     dtype=np.dtype(dtype))
        expect = (stop - start, *global_shape[1:])
        if chunk.shape != expect:
            raise ValueError(f"make_shard({start}, {stop}) returned shape "
                             f"{chunk.shape}; expected {expect}")
        shards.append(_as_torch(chunk).to(device))
        del chunk
    return ShardedRows(shards, size, mesh.lead, group=mesh.group)


def _pad_range_fn(fn, n_real: int, ncols: int, fill, dtype):
    """Wrap a ``[0, n_real)`` row-range callback so rows past ``n_real``
    read as ``fill`` (the shard padding)."""
    def wrapped(start, stop):
        if start >= n_real:
            return np.full((stop - start, ncols), fill, dtype)
        real = np.ascontiguousarray(fn(start, min(stop, n_real)),
                                    dtype=dtype)
        if stop <= n_real:
            return real
        return np.concatenate(
            [real, np.full((stop - n_real, ncols), fill, dtype)])
    return wrapped


def shard_graph_streamed(mesh: Mesh, *, n_nodes: int, layer_sizes,
                         m0: int, make_adj_rows, make_packed_rows,
                         make_pops_rows=None, fp_words: int = 32,
                         axis: str = "graph",
                         packed_adjacency: bool | int = False
                         ) -> ShardedGraph:
    """Build a :class:`ShardedGraph` shard by shard from host callbacks,
    so no table ever exists whole on the host or on one device:

    - ``make_adj_rows(start, stop) -> [stop-start, m0] int32`` flat
      traversal-table rows (``row = offsets[level] + node``, level 0
      first, -1 padded);
    - ``make_packed_rows(start, stop) -> [stop-start, fp_words] uint32``
      packed fingerprints by node id;
    - ``make_pops_rows(start, stop) -> [stop-start] int32`` popcounts
      (counted from the fingerprint chunks when omitted, so the
      fingerprint producer runs once per shard).

    ``layer_sizes`` is ``[N_0, N_1, ...]``; rows are padded to mesh
    multiples here (callbacks see only real rows). ``packed_adjacency``
    packs each adjacency shard before it is placed."""
    layer_sizes = [int(s) for s in layer_sizes]
    offsets = np.concatenate([[0], np.cumsum(layer_sizes)]).astype(np.int32)
    r = int(offsets[-1])
    offsets_arr = np.concatenate([offsets, [r]]).astype(np.int32)
    nd = mesh.shape[axis]
    bits = _adj_bits(n_nodes, packed_adjacency)
    n_pad_nodes = -(-n_nodes // nd) * nd
    n_pad_rows = -(-r // nd) * nd

    adj_rows = _pad_range_fn(make_adj_rows, r, m0, -1, np.int32)
    fp_rows_raw = _pad_range_fn(make_packed_rows, n_nodes, fp_words, 0,
                                np.uint32)
    fp_rows = fp_rows_raw
    if make_pops_rows is None:
        # pops come from the fingerprint placement pass: the producer is
        # consulted once per shard
        pops_cache: dict = {}

        def fp_rows(start, stop):
            chunk = fp_rows_raw(start, stop)
            pops_cache[(start, stop)] = np.bitwise_count(chunk).sum(
                axis=1).astype(np.int32)
            return chunk

        def pops_fn(start, stop):
            got = pops_cache.pop((start, stop), None)
            if got is not None:
                return got
            return np.bitwise_count(fp_rows_raw(start, stop)).sum(
                axis=1).astype(np.int32)
    else:
        def pops_fn(start, stop):
            if start >= n_nodes:
                return np.zeros(stop - start, np.int32)
            real = np.ascontiguousarray(
                make_pops_rows(start, min(stop, n_nodes)), dtype=np.int32)
            if stop <= n_nodes:
                return real
            return np.concatenate(
                [real, np.zeros(stop - n_nodes, np.int32)])

    if bits < 32:
        adj = put_sharded_rows(
            mesh, axis, (n_pad_rows, packed_adj_words(m0, bits)), np.uint32,
            lambda s, e: _pack_host(adj_rows(s, e), bits))
    else:
        adj = put_sharded_rows(mesh, axis, (n_pad_rows, m0), np.int32,
                               adj_rows)
        adj.fill_shift = 1
    return ShardedGraph(
        packed=put_sharded_rows(mesh, axis, (n_pad_nodes, fp_words),
                                np.uint32, fp_rows),
        pops=put_sharded_rows(mesh, axis, (n_pad_nodes,), np.int32,
                              pops_fn),
        adj=adj,
        offsets=torch.from_numpy(offsets_arr).to(mesh.lead),
        n_nodes=n_nodes, n_rows=r, n_pad_nodes=n_pad_nodes,
        n_pad_rows=n_pad_rows, m0=m0, max_level=len(layer_sizes) - 1,
        axis=axis, adj_bits=bits)


def _adj_gatherer(sg: ShardedGraph):
    """``gather_adj(rows) -> [..., M0] int32``: int32 rows through the
    owned gather with ``fill_shift=1`` (rows no shard owns read as the -1
    sentinel); packed rows as words (``fill_shift=0``), decoded after the
    gather. Every in-range row has exactly one owner."""
    if sg.adj_bits >= 32:
        return lambda rows: sg.adj[rows]
    return lambda rows: unpack_adjacency_rows(sg.adj[rows], sg.m0,
                                              sg.adj_bits)


def sharded_bruteforce_topk(sg: ShardedGraph, queries, k: int,
                            mesh: Mesh) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact k-NN with the distance matrix sharded over the graph axis:
    ``([B, k] dists, [B, k] int64 ids)`` on the lead device.

    Each shard scans its own rows with the blocked distance path (the
    matrix kernel on CUDA, its twin on the CPU); padded rows get +inf.
    Then a stable top-k per shard, an all-gather in shard order and a
    stable merge: ties go to the smaller global id, as the reference's
    stable ``lax.sort`` gives."""
    from rad_tpu_torch.fp.kernels import tanimoto_matrix

    q_np = np.atleast_2d(np.asarray(queries, np.uint32))
    lead = sg.lead
    q_lead = _as_torch(q_np).to(lead)
    b = q_lead.shape[0]
    size = sg.packed.shard_size
    block = max(1, (1 << 22) // max(b, 1))
    best = []
    for s, (rows, pops) in enumerate(zip(sg.packed.shards, sg.pops.shards)):
        if rows is None:
            best.append(None)
            continue
        d_dev = rows.device
        q = q_lead.to(d_dev)
        q_pops = popcount_rows(q)
        bd = torch.full((b, 0), INF, device=d_dev)
        bi = torch.full((b, 0), -1, dtype=torch.int64, device=d_dev)
        for lo in range(0, size, block):
            d = tanimoto_matrix(q, rows[lo:lo + block], q_pops,
                                pops[lo:lo + block])
            gids = s * size + lo + torch.arange(d.shape[1], device=d_dev)
            d = d.masked_fill((gids >= sg.n_nodes)[None, :], INF)
            sd, order = torch.sort(torch.cat([bd, d], 1), dim=1,
                                   stable=True)
            bi = torch.cat([bi, gids.expand(b, -1)], 1).gather(
                1, order[:, :k])
            bd = sd[:, :k]
        best.append((bd, bi))
    all_d = all_gather([None if x is None else x[0] for x in best], lead, 1,
                       mesh.group)
    all_i = all_gather([None if x is None else x[1] for x in best], lead, 1,
                       mesh.group)
    gd, order = torch.sort(all_d, dim=1, stable=True)
    return gd[:, :k], all_i.gather(1, order[:, :k])


def _shard_traffic(nd, adj_shard, fp_shard, offsets, out):
    """Per-shard service counts for one step (the hub-imbalance probe):
    ``adj_rows[s]`` = adjacency rows shard ``s`` served (one per valid
    expansion), ``fp_rows[s]`` = candidate fingerprint rows it served.
    Computed from the replicated expand outputs on the lead device."""
    node, lvl, valid = out["exp_node"], out["exp_level"], out["exp_valid"]
    rows = offsets[torch.clamp(lvl, min=0).long()] + torch.clamp(node, min=0)
    lead = offsets.device

    def count(slot):
        ones = torch.ones_like(slot, dtype=torch.int32)
        counts = torch.zeros(nd + 1, dtype=torch.int32, device=lead)
        return counts.index_add_(0, slot.long(), ones)[:nd]

    ts = out["to_score"]
    return (count(torch.where(valid, rows // adj_shard, nd)),
            count(torch.where(ts >= 0, torch.clamp(ts, min=0) // fp_shard,
                              nd)))


def _score_rows(sg: ShardedGraph, scorer, ts, target_packed, target_pop):
    """The step's candidate scores: fingerprint rows gathered from their
    shards, scored on the lead device, +inf on the -1 padding."""
    ok = ts >= 0
    safe = torch.where(ok, ts, 0)
    raw = scorer(sg.packed[safe], sg.pops[safe], target_packed, target_pop)
    return torch.where(ok, raw.to(torch.float32), INF)


def _make_step(sg: ShardedGraph, mesh: Mesh, batch: int, scorer, traffic,
               padded: bool, ops):
    nd = mesh.shape[sg.axis]
    adj_shard = sg.n_pad_rows // nd
    fp_shard = sg.n_pad_nodes // nd
    dg = _meta_graph(sg, padded)
    gather_adj = _adj_gatherer(sg)
    if scorer is None:
        scorer = tanimoto_to_target_scorer

    def step(state: TraversalState, target_packed, target_pop):
        state, out = dev.expand(state, dg, batch, gather_adj=gather_adj,
                                ops=ops)
        ts = out["to_score"]
        scores = _score_rows(sg, scorer, ts, target_packed, target_pop)
        state = dev.integrate(state, dg, out["exp_node"], out["exp_level"],
                              out["exp_score"], out["exp_valid"],
                              out["cand"], ts, scores, ops=ops)
        if traffic:
            adj_c, fp_c = _shard_traffic(nd, adj_shard, fp_shard,
                                         sg.offsets, out)
            return state, {"adj_rows": adj_c, "fp_rows": fp_c}
        return state

    return step


def make_sharded_step(sg: ShardedGraph, mesh: Mesh, batch: int,
                      scorer=None, traffic: bool = False):
    """The pod traversal step: replicated state, sharded graph.

    Returns ``step(state, target_packed, target_pop) -> state`` — the
    mesh counterpart of :func:`rad_tpu_torch.traverse.device.fused_step`
    (create the state with ``init_state(sg.device_graph())``).
    ``scorer(fp_rows [K, W] int32, pop_rows [K] int32, target_packed,
    target_pop) -> [K]`` is any torch surrogate; the default is the
    Tanimoto distance to ``target_packed``. It runs once, on the lead
    device, over candidates gathered from their shards. ``traffic=True``
    makes the step return ``(state, {"adj_rows": [D], "fp_rows": [D]})``,
    the rows each shard served (see :class:`TrafficMeter`)."""
    return _make_step(sg, mesh, batch, scorer, traffic, False, dev.DENSE_OPS)


class TrafficMeter:
    """Accumulates per-shard service counts across steps and reports the
    hub-imbalance profile (high-degree hub nodes concentrate gather
    traffic on their owning shard). Feed it the dict a ``traffic=True``
    step returns::

        step = make_sharded_step(sg, mesh, batch=64, traffic=True)
        meter = TrafficMeter(n_devices)
        state, t = step(state, target, t_pop); meter.add(t)
        print(meter.stats())   # imbalance = max/mean rows per shard
    """

    def __init__(self, n_devices: int):
        self.n_devices = n_devices
        self.adj_rows = np.zeros((n_devices,), np.int64)
        self.fp_rows = np.zeros((n_devices,), np.int64)
        self.steps = 0

    def add(self, traffic: dict) -> None:
        for name in ("adj_rows", "fp_rows"):
            x = traffic[name]
            x = x.cpu().numpy() if torch.is_tensor(x) else np.asarray(x)
            getattr(self, name).__iadd__(x.astype(np.int64))
        self.steps += 1

    @staticmethod
    def _imbalance(counts: np.ndarray) -> float:
        mean = counts.mean()
        return float(counts.max() / mean) if mean > 0 else 1.0

    def stats(self) -> dict:
        return {
            "steps": self.steps,
            "adj_rows_per_shard": self.adj_rows.tolist(),
            "fp_rows_per_shard": self.fp_rows.tolist(),
            "adj_imbalance": self._imbalance(self.adj_rows),
            "fp_imbalance": self._imbalance(self.fp_rows),
        }


class _ShardStateOps(dev.DenseStateOps):
    """State ops for row-sharded ``scored``/``scores``/``enqueued``
    (:class:`ShardedRows` with their own sentinel slots): gathers are the
    owned gather, scatters write only the rows each shard owns (no
    collective on the write path), and ``first_occurrence`` takes the
    argsort form, since a ``[value range]`` scratch per step would undo
    the sharding of the state. The same ids either way."""

    @staticmethod
    def gather(arr, idx):
        return arr[idx]

    @staticmethod
    def scatter_(arr, idx, vals) -> None:
        if torch.is_tensor(vals):
            arr[idx] = vals
        else:
            arr.index_fill_(0, idx, vals)

    gather_scores = gather
    scatter_scores = scatter_

    @staticmethod
    def first_occurrence(values, sentinel):
        return _first_occurrence(values, sentinel)


SHARD_STATE_OPS = _ShardStateOps()

_STATE_TABLES = {"enqueued": (torch.bool, False),
                 "scored": (torch.bool, False),
                 "scores": (torch.float32, INF)}


def _shard_table(mesh: Mesh, axis: str, size: int, dtype, fill,
                 values: torch.Tensor | None = None) -> ShardedRows:
    """A sharded state table of ``size`` rows per shard, each shard with
    its own sentinel slot; ``values`` (the assembled table) fills it."""
    shards = []
    for s, (device, local) in enumerate(mesh.axis_devices(axis)):
        if not local:
            shards.append(None)
            continue
        t = torch.full((size + 1,), fill, dtype=dtype, device=device)
        if values is not None:
            t[:size] = values[s * size:(s + 1) * size].to(device)
        shards.append(t)
    return ShardedRows(shards, size, mesh.lead, sentinel=True,
                       group=mesh.group)


def init_state_sharded(sg: ShardedGraph, mesh: Mesh,
                       frontier_capacity: int | None = None,
                       log_capacity: int | None = None,
                       buffer_capacity: int = 1 << 15) -> TraversalState:
    """A TraversalState whose ``scored``/``scores``/``enqueued`` are split
    by rows over the mesh (padded sizes, one sentinel slot per shard)
    while the frontier, log and counters stay replicated on the lead
    device — the layout for libraries whose *state* no longer fits one
    device. Single-level frontier, as in the reference."""
    if frontier_capacity is None:
        frontier_capacity = dev.auto_frontier_capacity(sg.n_pad_rows)
    cap = log_capacity if log_capacity is not None else sg.n_nodes
    nd = mesh.shape[sg.axis]
    # the replicated fields from a table-free view; the tables are sharded
    meta = DeviceGraph(adj=sg.offsets, offsets=sg.offsets,
                       offsets_host=sg.offsets_host, n_nodes=0, n_rows=0,
                       m0=sg.m0, max_level=sg.max_level)
    state = dev.init_state(meta, frontier_capacity, cap, buffer_capacity,
                           head_capacity=None)
    sizes = {"enqueued": sg.n_pad_rows // nd, "scored": sg.n_pad_nodes // nd,
             "scores": sg.n_pad_nodes // nd}
    for name, (dtype, fill) in _STATE_TABLES.items():
        setattr(state, name, _shard_table(mesh, sg.axis, sizes[name], dtype,
                                          fill))
    return state


def shard_state_tables(state: TraversalState, sg: ShardedGraph,
                       mesh: Mesh) -> TraversalState:
    """``state`` (padded sizes, assembled tables, as :func:`~rad_tpu_torch.
    traverse.device.load_state` gives a sharded run's checkpoint) with its
    three big tables split over the mesh again."""
    nd = mesh.shape[sg.axis]
    for name, (dtype, fill) in _STATE_TABLES.items():
        full = getattr(state, name)
        size = (full.shape[0] - 1) // nd
        setattr(state, name, _shard_table(mesh, sg.axis, size, dtype, fill,
                                          full))
    return state


def sharded_state_to_reference_arrays(state: TraversalState) -> dict:
    """Host numpy arrays of a (possibly) sharded state in ``rad_tpu``'s
    global padded layout: the shards assembled in order, sentinel slots
    dropped, as :func:`~rad_tpu_torch.traverse.device.
    state_to_reference_arrays` gives for a replicated state."""
    from dataclasses import replace
    full = {name: getattr(state, name).full() for name in _STATE_TABLES
            if isinstance(getattr(state, name), ShardedRows)}
    return dev.state_to_reference_arrays(replace(state, **full))


def make_sharded_step_full(sg: ShardedGraph, mesh: Mesh, batch: int,
                           scorer=None, traffic: bool = False):
    """The pod step with BOTH graph and state sharded (the
    billion-molecule layout): like :func:`make_sharded_step`, with the
    state from :func:`init_state_sharded`. Per-device state memory drops
    from O(N) to O(N / D); each state read is one owned gather."""
    return _make_step(sg, mesh, batch, scorer, traffic, True,
                      SHARD_STATE_OPS)


def make_sharded_step_multi(sg: ShardedGraph, mesh: Mesh, batch: int,
                            allow_hazard: bool = False):
    """T campaigns over the graph-sharded step: per-campaign state stacks
    on a leading [T] axis (:func:`rad_tpu_torch.traverse.multi.init_multi`
    / ``prime_multi``, over ``sg.device_graph()``), replicated, while the
    adjacency and fingerprint reads ride the same owned gathers as the
    single-campaign pod step. The refill and commit decisions are lifted
    across campaigns as in :func:`rad_tpu_torch.traverse.multi.
    multi_step`, so each campaign's result equals its solo pod run at the
    same budget.

    Returns ``step(states, targets [T, W], t_pops [T], budgets [T])``.
    ``allow_hazard`` is accepted and does nothing (the reference's TPU
    guard is not carried over)."""
    from rad_tpu_torch.traverse import multi

    dg = sg.device_graph()
    gather_adj = _adj_gatherer(sg)

    def step(states: TraversalState, targets, t_pops, budgets):
        if torch.is_tensor(budgets):
            budgets = budgets.cpu().numpy()
        score = multi._tanimoto_lanes(sg.packed, sg.pops, targets, t_pops)
        return multi.multi_step(states, dg, budgets, batch, score,
                                gather_adj=gather_adj)

    return step


_OUT_KEYS = ("exp_node", "exp_level", "exp_score", "exp_valid", "cand",
             "to_score")


def make_sharded_expand_integrate(sg: ShardedGraph, mesh: Mesh, batch: int,
                                  shard_state: bool = False):
    """The pod engine split at the scoring boundary: ``(expand,
    integrate)``, what lets a *host* scoring function (an external docking
    program) drive a graph no single device holds:

        expand(state) -> (state, out)    out: dict of _OUT_KEYS tensors
        integrate(state, out, new_scores [B*M0] f32) -> state

    ``expand`` pops the replicated frontier and gathers adjacency rows
    from their shards; ``integrate`` writes the host's scores (numpy or a
    tensor) and completes the step. ``shard_state=True`` splits
    scored/scores/enqueued by rows too (create the state with
    :func:`init_state_sharded`). Drive with
    :func:`rad_tpu_torch.traverse.pipeline.pipelined_traverse`."""
    dg = _meta_graph(sg, shard_state)
    ops = SHARD_STATE_OPS if shard_state else dev.DENSE_OPS
    gather_adj = _adj_gatherer(sg)

    def expand(state: TraversalState):
        return dev.expand(state, dg, batch, gather_adj=gather_adj, ops=ops)

    def integrate(state: TraversalState, out: dict, new_scores):
        if not torch.is_tensor(new_scores):
            new_scores = torch.from_numpy(np.asarray(new_scores,
                                                     np.float32))
        return dev.integrate(state, dg, out["exp_node"], out["exp_level"],
                             out["exp_score"], out["exp_valid"], out["cand"],
                             out["to_score"], new_scores.to(sg.lead),
                             ops=ops)

    return expand, integrate


def tanimoto_to_target_scorer(fp_rows, pop_rows, target_packed, target_pop):
    """Default on-device scorer: Tanimoto distance to a target
    fingerprint."""
    from rad_tpu_torch.fp.tanimoto import tanimoto_rows_to_target
    return tanimoto_rows_to_target(fp_rows, pop_rows, target_packed,
                                   target_pop)


# The beam walks a graph no device holds whole: the single-device search
# (rad_tpu_torch.search.knn) with its fingerprint and adjacency reads going
# through the owned gathers, one expansion per iteration as the reference's
# sharded beam has it.
_SEARCH_EXPAND_WIDTH = 1


def _search_shard(sg: ShardedGraph, k: int, ef: int, queries: torch.Tensor):
    from rad_tpu_torch.search import knn
    return knn._search_batch(sg.packed, sg.pops, sg.device_graph(), queries,
                             k, max(ef, k), _SEARCH_EXPAND_WIDTH, None,
                             n_nodes=sg.n_nodes)


def _queries_on(queries, device) -> torch.Tensor:
    if torch.is_tensor(queries):
        return queries.to(device=device, dtype=torch.int32)
    return _as_torch(np.atleast_2d(np.asarray(queries, np.uint32))).to(device)


def make_sharded_search(sg: ShardedGraph, mesh: Mesh, k: int, ef: int,
                        batch: int):
    """Graph-sharded HNSW kNN: greedy descent and the layer-0 beam of
    :func:`rad_tpu_torch.search.knn.search_device` (one expansion per
    beam iteration, as the reference's sharded beam), every adjacency row
    and candidate fingerprint gathered from the shard that owns it. The
    ids and distances are ``search_device``'s with ``expand_width=1`` on
    the unsharded graph.

    Returns ``search(queries [B, W]) -> (dists [B, k], ids [B, k])`` on
    the lead device, with B == ``batch``."""
    def search(queries):
        q = _queries_on(queries, sg.lead)
        if q.shape[0] != batch:
            raise ValueError(
                f"search built for batch={batch} got {q.shape[0]} queries "
                f"— build one search per batch size, or pad the query "
                f"block")
        return _search_shard(sg, k, ef, q)

    return search


def _on_row(rows: ShardedRows, devices) -> ShardedRows:
    """``rows`` with shard ``j`` on ``devices[j]`` (no copy when it is
    there already)."""
    return ShardedRows([t.to(d) for t, d in zip(rows.shards, devices)],
                       rows.shard_size, devices[0], rows.fill_shift,
                       rows.sentinel, rows.group)


def make_sharded_search_2d(sg: ShardedGraph, mesh: Mesh, k: int, ef: int,
                           batch: int, data_axis: str = "data"):
    """Query-parallel × graph-parallel kNN over a 2-D ``(data, graph)``
    mesh: the batch is split over ``data_axis`` and each data row of the
    mesh runs the beam of :func:`make_sharded_search` over its query
    shard, against the graph split over the row's ``graph`` devices
    (copies of the shards :func:`shard_graph` placed on data row 0;
    none where a row repeats row 0's devices). ``batch`` is the global
    query count and must divide by the data-axis size. Results are
    gathered on the mesh's lead device."""
    from dataclasses import replace

    nd_data = mesh.shape[data_axis]
    if batch % nd_data:
        raise ValueError(f"batch={batch} does not split over the "
                         f"{nd_data}-row '{data_axis}' axis")
    per = batch // nd_data
    grid = mesh.devices
    if mesh.axis_names.index(data_axis) != 0:
        grid = grid.T
    rows = []
    for r in range(nd_data):
        devs = list(grid[r])
        rows.append(replace(
            sg, packed=_on_row(sg.packed, devs), pops=_on_row(sg.pops, devs),
            adj=_on_row(sg.adj, devs), offsets=sg.offsets.to(devs[0])))

    def search(queries):
        outs = []
        for r, sg_r in enumerate(rows):
            q = _queries_on(queries, sg_r.lead)[r * per:(r + 1) * per]
            outs.append(_search_shard(sg_r, k, ef, q))
        lead = mesh.lead
        return (torch.cat([o[0].to(lead) for o in outs]),
                torch.cat([o[1].to(lead) for o in outs]))

    return search


def sharded_fused_step(state: TraversalState, sg: ShardedGraph, mesh: Mesh,
                       target_packed, target_pop, batch: int):
    """One-shot convenience wrapper over :func:`make_sharded_step`: it
    builds the step anew on each call (building one only makes closures).
    Loops should call :func:`make_sharded_step` once and reuse the step."""
    return make_sharded_step(sg, mesh, batch)(state, target_packed,
                                              target_pop)
