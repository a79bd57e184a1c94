"""HNSW graph storage: fixed-degree padded adjacency over packed
fingerprints, host-resident numpy arrays.

The storage model of :mod:`rad_tpu.graph.storage`, without JAX:

* layer ``l`` is an ``[N_l, M_l] int32`` table, ``-1`` for absent edges;
  ``M_0 = 2 * connectivity``, ``M_l = connectivity`` above;
* node ids are level-sorted (non-increasing level), so layer ``l`` is
  exactly the id range ``[0, N_l)`` and the entry point is node 0;
* ``keys[node_id]`` is the user's int64 key.

Every array stays on the host; the traversal engine uploads what it needs
(:func:`rad_tpu_torch.traverse.device.prepare_device_graph`). Files are
the same ``.npz`` layout as ``rad_tpu`` writes, v1 and the v2 serving
format (identity keys and level-sorted levels derived instead of stored,
edge counts in the meta), so a graph written by either package loads in
the other. :class:`NpzStreamWriter` writes such a file member by member,
in row chunks, for graphs too large to hold in host memory at once.
"""

from __future__ import annotations

import dataclasses
import json
import logging
from dataclasses import dataclass
from typing import Dict, List, Sequence, Tuple

import numpy as np

# the fingerprint format version stamped into saved graphs: the in-tree
# Morgan fingerprinter's, equal to rad_tpu's, so neither package warns on
# loading the other's files
from rad_tpu_torch.chem.morgan import FP_FORMAT_VERSION

logger = logging.getLogger(__name__)

__all__ = ["HNSWGraph", "LayerStats", "NpzStreamWriter", "ArangeKeys",
           "DerivedLevels", "host_keys_view", "neighbor_valid_mask", "FP_FORMAT_VERSION",
           "ADJ_SENTINEL_U32"]

# uint32 adjacency sentinel (tables whose layer has > 2**31 rows)
ADJ_SENTINEL_U32 = np.uint32(0xFFFFFFFF)


def neighbor_valid_mask(row: np.ndarray) -> np.ndarray:
    """Edge-validity mask for an int32 (``-1`` padded) or uint32
    (``0xFFFFFFFF`` padded) adjacency row or table."""
    if row.dtype == np.uint32:
        return row != ADJ_SENTINEL_U32
    return row >= 0


class VirtualArray:
    """Lazy ``[N]`` host array that is a pure function of the index —
    never materialized unless ``np.asarray`` asks for it."""

    dtype: np.dtype
    shape: tuple

    @property
    def ndim(self) -> int:
        return len(self.shape)

    @property
    def size(self) -> int:
        n = 1
        for s in self.shape:
            n *= s
        return n

    def __len__(self) -> int:
        return self.shape[0]

    def _eval(self, ids: np.ndarray) -> np.ndarray:
        raise NotImplementedError

    def __getitem__(self, idx):
        n = self.shape[0]
        if isinstance(idx, slice):
            return self._eval(np.arange(*idx.indices(n), dtype=np.int64))
        if np.ndim(idx) == 0:
            i = int(idx)
            if i < 0:
                i += n
            if not 0 <= i < n:
                raise IndexError(i)
            return self._eval(np.asarray([i], np.int64))[0]
        return self._eval(np.asarray(idx, np.int64))

    def __array__(self, dtype=None, copy=None):
        out = self._eval(np.arange(self.shape[0], dtype=np.int64))
        return out if dtype is None else out.astype(dtype)


class ArangeKeys(VirtualArray):
    """Identity key map ``keys[i] == i`` (v2 files' ``identity_keys``)."""

    def __init__(self, n: int):
        self.shape = (int(n),)
        self.dtype = np.dtype(np.int64)

    def _eval(self, ids: np.ndarray) -> np.ndarray:
        return ids


class DerivedLevels(VirtualArray):
    """Per-node level from level-sorted ids: ``level(i) = #{l : i < N_l}
    - 1`` (v2 files' ``derived_levels``)."""

    def __init__(self, layer_sizes):
        self._sizes = np.asarray(layer_sizes, np.int64)
        self.shape = (int(self._sizes[0]),)
        self.dtype = np.dtype(np.int32)

    def _eval(self, ids: np.ndarray) -> np.ndarray:
        return (np.searchsorted(-self._sizes, -np.asarray(ids, np.int64),
                                side="left") - 1).astype(np.int32)


def host_keys_view(keys):
    """Host-indexable view of a graph's ``keys``: virtual keys pass
    through unmaterialized; anything else becomes numpy."""
    return keys if isinstance(keys, VirtualArray) else np.asarray(keys)


class NpzStreamWriter:
    """Write an uncompressed ``.npz`` member by member, each in row chunks
    (ZIP_STORED with zip64), which :meth:`HNSWGraph.load` maps in place:

        w = NpzStreamWriter(path)
        with w.member("neighbors_0", (n, 32), np.int32) as m:
            for chunk in chunks:          # [rows, 32] int32 pieces
                m.write(chunk)
        w.write_array("levels", levels)   # small members in one go
        w.close(meta)                     # meta_json, then the directory
    """

    def __init__(self, path: str):
        import zipfile

        self._zip = zipfile.ZipFile(path, "w", zipfile.ZIP_STORED,
                                    allowZip64=True)

    class _Member:
        def __init__(self, fp, shape, dtype):
            self._fp = fp
            self._rows = 0
            self._shape = shape
            self._dtype = np.dtype(dtype)

        def write(self, chunk: np.ndarray) -> None:
            chunk = np.ascontiguousarray(chunk, dtype=self._dtype)
            lead = chunk.shape[0] if chunk.ndim else 1
            if chunk.ndim != len(self._shape) or \
                    chunk.shape[1:] != tuple(self._shape[1:]):
                raise ValueError(f"chunk shape {chunk.shape} does not extend "
                                 f"member shape {self._shape}")
            self._fp.write(memoryview(chunk).cast("B"))
            self._rows += lead

        def __enter__(self):
            return self

        def __exit__(self, exc_type, exc, tb):
            if exc_type is None and self._rows != self._shape[0]:
                raise ValueError(
                    f"member closed after {self._rows} rows; "
                    f"declared {self._shape[0]}")
            self._fp.close()
            return False

    def member(self, name: str, shape, dtype) -> "NpzStreamWriter._Member":
        """Open member ``name`` for chunked writes (a context manager)."""
        import zipfile

        info = zipfile.ZipInfo(name + ".npy", date_time=(1980, 1, 1, 0, 0, 0))
        info.compress_type = zipfile.ZIP_STORED
        fp = self._zip.open(info, "w", force_zip64=True)
        np.lib.format.write_array_header_2_0(
            fp, {"descr": np.lib.format.dtype_to_descr(np.dtype(dtype)),
                 "fortran_order": False, "shape": tuple(shape)})
        return self._Member(fp, tuple(shape), dtype)

    def write_array(self, name: str, array: np.ndarray) -> None:
        array = np.asarray(array)
        with self.member(name, array.shape, array.dtype) as m:
            m.write(array)

    def close(self, meta: dict | None = None) -> None:
        """Write ``meta`` (with ``fp_format_version`` added when absent) as
        the ``meta_json`` member and finish the archive."""
        if meta is not None:
            if "fp_format_version" not in meta:
                meta = {**meta, "fp_format_version": FP_FORMAT_VERSION}
            self.write_array("meta_json", np.frombuffer(
                json.dumps(meta).encode(), dtype=np.uint8))
        self._zip.close()


def _mmap_npz_members(path: str):
    """Memory-map every member of an uncompressed ``.npz`` in place.

    ``np.savez`` stores members uncompressed, so each embedded ``.npy``
    sits contiguously in the file: parse its header at the zip-local
    offset and map the data region. Returns ``{name: memmap}``, or None
    when the archive cannot be mapped (compressed members, unexpected
    layout) and the caller loads eagerly instead."""
    import zipfile

    try:
        arrays = {}
        with zipfile.ZipFile(path) as z, open(path, "rb") as f:
            for info in z.infolist():
                if info.compress_type != zipfile.ZIP_STORED:
                    return None
                f.seek(info.header_offset)
                hdr = f.read(30)
                if hdr[:4] != b"PK\x03\x04":
                    return None
                name_len = int.from_bytes(hdr[26:28], "little")
                extra_len = int.from_bytes(hdr[28:30], "little")
                f.seek(info.header_offset + 30 + name_len + extra_len)
                version = np.lib.format.read_magic(f)
                read_header = {
                    (1, 0): np.lib.format.read_array_header_1_0,
                    (2, 0): np.lib.format.read_array_header_2_0,
                }.get(version)
                if read_header is None:
                    return None
                shape, fortran, dtype = read_header(f)
                name = info.filename
                name = name[:-4] if name.endswith(".npy") else name
                arrays[name] = np.memmap(
                    path, dtype=dtype, mode="r", offset=f.tell(),
                    shape=shape, order="F" if fortran else "C")
        return arrays
    except (OSError, ValueError, zipfile.BadZipFile):
        return None


@dataclass
class LayerStats:
    """Per-layer statistics (usearch ``levels_stats`` parity)."""

    nodes: int
    edges: int
    max_edges: int
    allocated_bytes: int


@dataclass
class HNSWGraph:
    """An HNSW graph over packed binary fingerprints (host numpy).

      packed:     [N, W] uint32 — packed fingerprints (W = ndim/32)
      popcounts:  [N] int32     — per-row set-bit counts
      keys:       [N] int64     — node_id -> user key
      levels:     [N] int32     — node_id -> max layer (non-increasing)
      neighbors:  tuple over layers l of [N_l, M_l] int32, -1-padded
    """

    packed: np.ndarray
    popcounts: np.ndarray
    keys: np.ndarray
    levels: np.ndarray
    neighbors: Tuple[np.ndarray, ...]
    ndim: int
    connectivity: int

    _key_to_id: Dict[int, int] | None = dataclasses.field(
        default=None, repr=False, compare=False)

    def __len__(self) -> int:
        return int(self.packed.shape[0])

    @property
    def size(self) -> int:
        return len(self)

    @property
    def max_level(self) -> int:
        return len(self.neighbors) - 1

    @property
    def dtype(self) -> str:
        return "b1"

    @property
    def multi(self) -> bool:
        return False

    @property
    def capacity(self) -> int:
        return len(self)

    @property
    def memory_usage(self) -> int:
        """Bytes across all array fields (usearch ``memory_usage``)."""
        total = 0
        for arr in (self.packed, self.popcounts, self.keys, self.levels,
                    *self.neighbors):
            total += arr.size * arr.dtype.itemsize
        return int(total)

    @property
    def layer_sizes(self) -> Tuple[int, ...]:
        return tuple(int(t.shape[0]) for t in self.neighbors)

    @property
    def has_vectors(self) -> bool:
        """False for graphs loaded from an ``exclude_vectors`` file."""
        return self.packed.shape[1] > 0

    def levels_stats(self) -> List[LayerStats]:
        """Per-layer node/edge stats, cached after the first call."""
        cache = getattr(self, "_levels_stats_cache", None)
        if cache is not None:
            return cache
        stats = []
        for table in self.neighbors:
            t = np.asarray(table)
            stats.append(LayerStats(
                nodes=int(t.shape[0]),
                edges=int(neighbor_valid_mask(t).sum()),
                max_edges=int(t.shape[0] * t.shape[1]),
                allocated_bytes=int(t.size * t.dtype.itemsize)))
        object.__setattr__(self, "_levels_stats_cache", stats)
        return stats

    # ----------------------------------------------------------- fork API
    def get_neighbors(self, node_id: int, level: int) -> List[int]:
        """Adjacency of ``node_id`` at ``level`` as ``[id, key, ...]``."""
        if not 0 <= node_id < len(self):
            raise ValueError(f"node_id {node_id} out of range [0, {len(self)})")
        if not 0 <= level <= self.max_level:
            raise ValueError(
                f"level {level} out of range [0, {self.max_level}]")
        if node_id >= self.layer_sizes[level]:
            raise ValueError(
                f"node {node_id} does not exist on level {level}")
        row = np.asarray(self.neighbors[level][node_id])
        ids = row[neighbor_valid_mask(row)].astype(np.int64)
        keys = np.asarray(self.keys[ids])
        out: List[int] = []
        for i, k in zip(ids.tolist(), keys.tolist()):
            out.extend((int(i), int(k)))
        return out

    def get_top_level_nodes(self) -> List[int]:
        """All nodes on the top layer as ``[id, key, ...]``."""
        n_top = self.layer_sizes[self.max_level]
        keys = np.asarray(self.keys[:n_top])
        out: List[int] = []
        for i in range(n_top):
            out.extend((i, int(keys[i])))
        return out

    def get_node_ids_from_keys(self, keys: Sequence[int]) -> List[int]:
        """Map user keys → internal node ids."""
        if isinstance(self.keys, ArangeKeys):
            n = len(self)
            for k in keys:
                if not 0 <= int(k) < n:
                    raise KeyError(int(k))
            return [int(k) for k in keys]
        if self._key_to_id is None:
            host_keys = np.asarray(self.keys)
            object.__setattr__(
                self, "_key_to_id",
                {int(k): i for i, k in enumerate(host_keys.tolist())})
        return [self._key_to_id[int(k)] for k in keys]

    # -------------------------------------------------------------- persist
    def save(self, path: str, exclude_vectors: bool = False,
             slim: bool = False) -> None:
        """Persist to an uncompressed ``.npz``: format v1, or v2 with
        ``slim``.

        ``exclude_vectors=True`` omits the fingerprint matrix (a graph
        loaded from such a file answers graph queries but cannot compute
        distances). ``slim=True`` writes the v2 serving file on top of
        that: no keys or levels members (the meta declares them derivable)
        and the per-layer edge counts in the meta, so ``levels_stats``
        never scans the adjacency. It requires ``exclude_vectors=True``,
        identity keys (``keys[i] == i``) and levels that the layer sizes
        give (the level-sorted ids), and raises ``ValueError`` otherwise.
        """
        if slim:
            if not exclude_vectors:
                raise ValueError(
                    "slim=True is a serving-file mode and requires "
                    "exclude_vectors=True")
            if not isinstance(self.keys, ArangeKeys):
                k = np.asarray(self.keys)
                if not np.array_equal(k, np.arange(len(self),
                                                   dtype=k.dtype)):
                    raise ValueError(
                        "slim=True requires identity keys (keys[i] == i); "
                        "this graph's keys are not an arange — save "
                        "without slim")
            if not isinstance(self.levels, DerivedLevels):
                expect = np.asarray(DerivedLevels(self.layer_sizes))
                if not np.array_equal(np.asarray(self.levels), expect):
                    raise ValueError(
                        "slim=True requires level-sorted derived levels; "
                        "this graph's levels member disagrees with its "
                        "layer sizes — save without slim")
        arrays = {}
        if not slim:
            arrays["keys"] = np.asarray(self.keys)
            arrays["levels"] = np.asarray(self.levels)
        if not exclude_vectors:
            arrays["packed"] = np.asarray(self.packed)
            arrays["popcounts"] = np.asarray(self.popcounts)
        for l, t in enumerate(self.neighbors):
            arrays[f"neighbors_{l}"] = np.asarray(t)
        meta = {
            "ndim": self.ndim,
            "connectivity": self.connectivity,
            "n_layers": len(self.neighbors),
            "exclude_vectors": bool(exclude_vectors),
            "version": 2 if slim else 1,
            "fp_format_version": FP_FORMAT_VERSION,
        }
        if slim:
            meta["identity_keys"] = True
            meta["derived_levels"] = True
            meta["edges_per_layer"] = [s.edges for s in self.levels_stats()]
        arrays["meta_json"] = np.frombuffer(json.dumps(meta).encode(),
                                            dtype=np.uint8)
        np.savez(path, **arrays)

    @classmethod
    def load(cls, path: str, mmap: bool = True) -> "HNSWGraph":
        """Load a v1 or v2 ``.npz``. ``mmap=True`` maps the members in
        place (usearch ``view=True``), falling back to an eager load when
        the archive cannot be mapped."""
        data = _mmap_npz_members(path) if mmap else None
        if data is None:
            data = dict(np.load(path))
        meta = json.loads(bytes(data["meta_json"]).decode())
        saved_fpv = meta.get("fp_format_version")
        if saved_fpv is not None and saved_fpv != FP_FORMAT_VERSION:
            logger.warning(
                "%s was saved under Morgan fingerprint format v%s but this "
                "package expects v%s — Morgan query fingerprints will NOT "
                "match this index; rebuild it", path, saved_fpv,
                FP_FORMAT_VERSION)
        neighbors = tuple(data[f"neighbors_{l}"]
                          for l in range(meta["n_layers"]))
        n = int(neighbors[0].shape[0])
        keys = ArangeKeys(n) if meta.get("identity_keys") else data["keys"]
        levels = (DerivedLevels([t.shape[0] for t in neighbors])
                  if meta.get("derived_levels") else data["levels"])
        if meta.get("exclude_vectors"):
            packed = np.zeros((n, 0), np.uint32)
            popcounts = np.zeros((n,), np.int32)
        else:
            packed = data["packed"]
            popcounts = data["popcounts"]
        graph = cls(packed=packed, popcounts=popcounts, keys=keys,
                    levels=levels, neighbors=neighbors, ndim=meta["ndim"],
                    connectivity=meta["connectivity"])
        if "edges_per_layer" in meta:
            object.__setattr__(graph, "_levels_stats_cache", [
                LayerStats(nodes=int(t.shape[0]), edges=int(e),
                           max_edges=int(t.shape[0] * t.shape[1]),
                           allocated_bytes=int(t.size * t.dtype.itemsize))
                for t, e in zip(neighbors, meta["edges_per_layer"])])
        return graph

    def info(self) -> dict:
        """Metadata dict (``get_hnsw_info`` parity)."""
        return {
            "max_level": self.max_level,
            "size": len(self),
            "connectivity": self.connectivity,
            "dtype": self.dtype,
            "ndim": self.ndim,
            "capacity": self.capacity,
            "memory_usage": self.memory_usage,
            "multi": self.multi,
            "layer_sizes": list(self.layer_sizes),
        }
