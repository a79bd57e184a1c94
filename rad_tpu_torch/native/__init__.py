"""The native host path: a C++ HNSW builder, k-NN search, exact brute
force and batch SMILES fingerprinter, run on the host's cores.

ctypes bindings over ``hnsw_builder.cpp``, a byte-for-byte copy of
``rad_tpu/native/hnsw_builder.cpp`` (a test compares the two files), so
the same source compiled twice is what makes the two packages agree. It
is compiled on first use with ``g++ -O3 -shared -fPIC -std=c++17 -pthread
-funroll-loops``, trying ``-march=native``, then ``-mpopcnt``, then
neither, into a library named by the source's digest in the package's
build directory (``.rad_tpu_torch_build/`` beside the package, or
``RAD_TPU_TORCH_BUILD_DIR``). A library there that another user owns is
refused. The compile writes to a unique temporary file and renames it
into place, so concurrent processes agree.

These are host functions on numpy arrays, like
:mod:`rad_tpu_torch.build.reference`'s, so they take no ``device``. If
every compile attempt fails, :func:`native_available` is False (the
compiler's message is logged) and each function raises ``RuntimeError``
with that message; nothing here falls back to another implementation.

With ``n_threads=1`` a build is deterministic and edge-identical to the
numpy builder :func:`rad_tpu_torch.build.reference.build_hnsw` (the
``(d, id)`` tie rules of the C++ heaps). With more threads, rows are
inserted concurrently and the graph depends on thread timing.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import subprocess
import tempfile
import threading
import time
from typing import Optional

import numpy as np

from rad_tpu_torch._cuda import _build_dir

logger = logging.getLogger(__name__)

__all__ = ["native_available", "build_hnsw_native", "search_knn_native",
           "smiles_fingerprints_native", "bruteforce_topk_native"]

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                    "hnsw_builder.cpp")
CXX_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17", "-pthread",
             "-funroll-loops"]
# the ISA flag tried first, then the next; the last attempt adds none
ISA_FLAGS = ("-march=native", "-mpopcnt", None)

_lock = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None
_LIB_ERR: Optional[str] = None
# where the loaded library came from: its path, whether this process
# compiled it, the ISA flag that took (None: none) and the compile's seconds
_INFO: dict = {}

_i32p = ctypes.POINTER(ctypes.c_int32)
_i64p = ctypes.POINTER(ctypes.c_int64)
_u32p = ctypes.POINTER(ctypes.c_uint32)
_f32p = ctypes.POINTER(ctypes.c_float)


def _lib_path() -> str:
    with open(_SRC, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    return os.path.join(str(_build_dir()), f"hnsw_builder_{digest}.so")


def _owned_by_us(path: str) -> bool:
    try:
        st = os.stat(path)
    except OSError:
        return False
    return st.st_uid == os.getuid() if hasattr(os, "getuid") else True


def _compile(path: str) -> Optional[str]:
    """Compile the source into ``path``; the ISA flag that took, or
    raises ``RuntimeError`` with the last attempt's message."""
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=os.path.dirname(path))
    os.close(fd)
    err = ""
    try:
        for isa in ISA_FLAGS:
            cmd = ["g++", *([isa] if isa else []), *CXX_FLAGS, "-o", tmp,
                   _SRC]
            try:
                subprocess.run(cmd, check=True, capture_output=True,
                               text=True)
            except subprocess.CalledProcessError as e:
                err = e.stderr or str(e)
                continue
            except OSError as e:
                err = str(e)
                continue
            os.replace(tmp, path)        # atomic: concurrent builds agree
            return isa
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    raise RuntimeError(err)


def _declare(lib: ctypes.CDLL) -> None:
    lib.rad_build_hnsw.restype = ctypes.c_int
    lib.rad_build_hnsw.argtypes = [
        _u32p, _i32p, ctypes.c_int64, ctypes.c_int32,   # packed pops n w
        _i32p, _i64p, ctypes.c_int32,                   # levels sizes L
        ctypes.POINTER(_i32p), _i32p,                   # tables caps
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,  # M efC threads
    ]
    lib.rad_search_knn.restype = ctypes.c_int
    lib.rad_search_knn.argtypes = [
        _u32p, _i32p, ctypes.c_int64, ctypes.c_int32,   # packed pops n w
        _i64p, ctypes.c_int32, ctypes.POINTER(_i32p), _i32p,
        _u32p, _i32p, ctypes.c_int64,                   # queries q_pops nq
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,  # k ef threads
        _f32p, _i64p,                                   # out_d out_i
    ]
    lib.rad_fingerprint_smiles.restype = ctypes.c_int
    lib.rad_fingerprint_smiles.argtypes = [
        ctypes.c_char_p, _i64p, ctypes.c_int64,         # buf offsets n
        ctypes.c_int32, ctypes.c_int32, _u32p,          # bits radius out
        ctypes.c_int32,                                 # threads
    ]
    lib.rad_bruteforce_topk.restype = None
    lib.rad_bruteforce_topk.argtypes = [
        _u32p, _i32p, ctypes.c_int64, ctypes.c_int32,
        _u32p, _i32p, ctypes.c_int64, ctypes.c_int32,
        _f32p, _i64p,
    ]


def _load() -> Optional[ctypes.CDLL]:
    global _LIB, _LIB_ERR
    with _lock:
        if _LIB is not None or _LIB_ERR is not None:
            return _LIB
        path = _lib_path()
        os.makedirs(os.path.dirname(path), exist_ok=True)
        if os.path.exists(path) and not _owned_by_us(path):
            _LIB_ERR = f"cached library {path} not owned by this user"
            logger.warning("native library unavailable: %s", _LIB_ERR)
            return None
        isa, seconds, compiled = None, 0.0, not os.path.exists(path)
        if compiled:
            t0 = time.perf_counter()
            try:
                isa = _compile(path)
            except RuntimeError as e:
                _LIB_ERR = f"g++ failed on {_SRC}:\n{e}"
                logger.warning("native library unavailable: %s", _LIB_ERR)
                return None
            seconds = time.perf_counter() - t0
            logger.info("compiled %s (%s) in %.1f s", path, isa or "no ISA "
                        "flag", seconds)
        lib = ctypes.CDLL(path)
        _declare(lib)
        _INFO.update(path=path, compiled=compiled, isa=isa, seconds=seconds)
        _LIB = lib
        return _LIB


def _require() -> ctypes.CDLL:
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native library unavailable: {_LIB_ERR}")
    return lib


def _ptr(a: np.ndarray, kind):
    return a.ctypes.data_as(kind)


def _tables_arg(tables):
    return (_i32p * len(tables))(*[_ptr(t, _i32p) for t in tables])


def native_available() -> bool:
    """Whether the library compiled (or was found) and loaded."""
    return _load() is not None


def build_hnsw_native(
    packed: np.ndarray,
    keys: np.ndarray | None = None,
    connectivity: int = 16,
    expansion_add: int = 200,
    ndim: int | None = None,
    seed: int = 0,
    n_threads: int = 0,
):
    """Build an HNSWGraph with the C++ core: the parameters of
    :func:`rad_tpu_torch.build.reference.build_hnsw`, plus ``n_threads``
    (0 = every core; 1 = deterministic, edge-identical to the numpy
    builder)."""
    from rad_tpu_torch.build.reference import sample_levels
    from rad_tpu_torch.fp.pack import popcount_rows_np
    from rad_tpu_torch.graph.storage import HNSWGraph

    lib = _require()
    packed = np.ascontiguousarray(packed, dtype=np.uint32)
    n, w = packed.shape
    ndim = ndim or w * 32
    m = connectivity
    if keys is None:
        keys = np.arange(n, dtype=np.int64)
    keys = np.asarray(keys, dtype=np.int64)

    levels_raw = sample_levels(n, m, seed)
    order = np.lexsort((np.arange(n), -levels_raw))
    packed = np.ascontiguousarray(packed[order])
    keys = keys[order]
    levels = np.ascontiguousarray(levels_raw[order].astype(np.int32))
    max_level = int(levels[0]) if n else 0
    layer_sizes = np.array([(levels >= l).sum()
                            for l in range(max_level + 1)], dtype=np.int64)
    caps = np.array([2 * m if l == 0 else m
                     for l in range(max_level + 1)], dtype=np.int32)
    pops = np.ascontiguousarray(popcount_rows_np(packed).astype(np.int32))
    tables = [np.full((int(layer_sizes[l]), int(caps[l])), -1, np.int32)
              for l in range(max_level + 1)]

    rc = lib.rad_build_hnsw(
        _ptr(packed, _u32p), _ptr(pops, _i32p), n, w, _ptr(levels, _i32p),
        _ptr(layer_sizes, _i64p), max_level, _tables_arg(tables),
        _ptr(caps, _i32p), m, expansion_add, n_threads)
    if rc != 0:
        raise RuntimeError(f"native build failed with code {rc}")
    return HNSWGraph(packed=packed, popcounts=popcount_rows_np(packed),
                     keys=keys, levels=levels, neighbors=tuple(tables),
                     ndim=ndim, connectivity=m)


def search_knn_native(graph, queries: np.ndarray, k: int = 10,
                      expansion_search: int = 64, n_threads: int = 0):
    """Batched k-NN beam search on the host's cores: ``(dists [B, k]
    float32, node ids [B, k] int64)``, numpy. Greedy descent through the
    upper layers from node 0, then an ``expansion_search``-wide beam on
    layer 0, as :func:`rad_tpu_torch.search.knn.search_device`; queries
    are independent, so the result does not depend on ``n_threads``
    (0 = every core). Map ids to keys through ``graph.keys``."""
    from rad_tpu_torch.fp.pack import popcount_rows_np

    lib = _require()
    packed = np.ascontiguousarray(np.asarray(graph.packed), dtype=np.uint32)
    n, w = packed.shape
    queries = np.ascontiguousarray(np.atleast_2d(queries), dtype=np.uint32)
    if queries.shape[1] != w:
        raise ValueError(
            f"query width {queries.shape[1]} != graph width {w}")
    nq = queries.shape[0]
    pops = np.ascontiguousarray(
        np.asarray(graph.popcounts).astype(np.int32))
    q_pops = np.ascontiguousarray(
        popcount_rows_np(queries).astype(np.int32))
    tables = [np.ascontiguousarray(np.asarray(t), dtype=np.int32)
              for t in graph.neighbors]
    layer_sizes = np.array([t.shape[0] for t in tables], dtype=np.int64)
    caps = np.array([t.shape[1] for t in tables], dtype=np.int32)
    out_d = np.empty((nq, k), np.float32)
    out_i = np.empty((nq, k), np.int64)
    rc = lib.rad_search_knn(
        _ptr(packed, _u32p), _ptr(pops, _i32p), n, w,
        _ptr(layer_sizes, _i64p), len(tables) - 1, _tables_arg(tables),
        _ptr(caps, _i32p), _ptr(queries, _u32p), _ptr(q_pops, _i32p), nq,
        k, expansion_search, n_threads, _ptr(out_d, _f32p),
        _ptr(out_i, _i64p))
    if rc != 0:
        raise RuntimeError(f"native search failed with code {rc}")
    return out_d, out_i


def smiles_fingerprints_native(smiles, n_bits: int = 1024, radius: int = 2,
                               n_threads: int = 0) -> np.ndarray:
    """Packed ``[N, W]`` uint32 fingerprints of a batch of SMILES strings
    on the host's cores, bit-identical to the pure-Python path
    (``rad_tpu_torch.fp.pack._hash_fingerprint_bits``: FNV-1a 64 over the
    UTF-8 byte substrings, LSB-first packing). ``n_threads=0`` = every
    core."""
    lib = _require()
    smiles = list(smiles)
    n = len(smiles)
    out = np.zeros((max(n, 1), (n_bits + 31) // 32), np.uint32)
    if n == 0:
        return out[:0]
    encoded = [s.encode("utf-8") for s in smiles]
    offsets = np.zeros(n + 1, np.int64)
    np.cumsum([len(e) for e in encoded], out=offsets[1:])
    rc = lib.rad_fingerprint_smiles(
        b"".join(encoded), _ptr(offsets, _i64p), n, n_bits, radius,
        _ptr(out, _u32p), n_threads)
    if rc != 0:
        raise RuntimeError(f"native fingerprinting failed with code {rc}")
    return out


def bruteforce_topk_native(packed: np.ndarray, queries: np.ndarray,
                           k: int = 10):
    """Exact top-k by Tanimoto distance, a popcount scan on the host:
    ``(dists [B, k] float32, row ids [B, k] int64)``, numpy."""
    from rad_tpu_torch.fp.pack import popcount_rows_np

    lib = _require()
    packed = np.ascontiguousarray(packed, dtype=np.uint32)
    queries = np.ascontiguousarray(np.atleast_2d(queries), dtype=np.uint32)
    n, w = packed.shape
    nq = queries.shape[0]
    pops = np.ascontiguousarray(popcount_rows_np(packed).astype(np.int32))
    q_pops = np.ascontiguousarray(
        popcount_rows_np(queries).astype(np.int32))
    out_d = np.empty((nq, k), np.float32)
    out_i = np.empty((nq, k), np.int64)
    lib.rad_bruteforce_topk(
        _ptr(packed, _u32p), _ptr(pops, _i32p), n, w, _ptr(queries, _u32p),
        _ptr(q_pops, _i32p), nq, k, _ptr(out_d, _f32p), _ptr(out_i, _i64p))
    return out_d, out_i
