"""Seeded synthetic screening data for smoke runs, profiles and sweeps.

The library recipes of ``examples/enrichment_example.py`` (the batched
``make_library_batched`` as :func:`make_library`, the sequential
``make_library`` as :func:`make_library_sequential`: the two draw different
numbers) and the receptor-panel score tables of
``examples/panel_screening.py``, copied so this package stays free of the
JAX one.
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from rad_tpu_torch.fp.pack import pack_fingerprints, popcount_rows_np

__all__ = ["make_library", "make_library_sequential", "make_receptor_scores",
           "make_receptor_tables"]


def make_library(n: int, n_bits: int = 1024, mutation: float = 0.06,
                 seed: int = 0, batch: int = 1 << 16):
    """Synthetic screening library: a mutation tree of fingerprints
    (density 0.12) and DOCK-like scores, a smooth function of Tanimoto
    distance to a target pharmacophore plus noise (lower is better).

    Returns (packed ``[n, n_bits/32]`` uint32, scores ``[n]`` float64).
    Children are generated ``batch`` rows at a time from a bounded parent
    pool, so host memory stays flat in ``n``.
    """
    rng = np.random.default_rng(seed)
    density = 0.12
    seed_n = min(n, 4096)
    bits = np.zeros((seed_n, n_bits), dtype=np.uint8)
    bits[0] = rng.random(n_bits) < density
    for i in range(1, seed_n):
        parent = rng.integers(0, i)
        child = bits[parent].copy()
        flip = rng.random(n_bits) < mutation
        child[flip] = rng.random(int(flip.sum())) < density
        if not child.any():
            child[rng.integers(0, n_bits)] = 1
        bits[i] = child
    parts = [pack_fingerprints(bits)]
    pool = bits
    done = seed_n
    while done < n:
        b = min(batch, n - done)
        parents = rng.integers(0, pool.shape[0], size=b)
        child = _mutate(rng, pool[parents], mutation, density)
        empty = np.flatnonzero(~child.any(axis=1))
        if empty.size:
            child[empty, rng.integers(0, n_bits, size=empty.size)] = 1
        parts.append(pack_fingerprints(child))
        keep = rng.choice(b, size=min(b, 8192), replace=False)
        pool = np.concatenate([pool, child[keep]])[-65536:]
        done += b
    packed = np.concatenate(parts)
    target = packed[rng.integers(n // 2, n)]
    pops = popcount_rows_np(packed).astype(np.float64)
    t_pop = float(popcount_rows_np(target[None])[0])
    inter = popcount_rows_np(packed & target[None]).astype(np.float64)
    tani_dist = 1.0 - inter / np.maximum(pops + t_pop - inter, 1)
    scores = 50.0 * tani_dist - 40.0 + rng.normal(0, 0.25, n)
    return packed, scores.astype(np.float64)


def _mutate(rng, child: np.ndarray, mutation: float, density: float,
            chunk_rows: int = 8192) -> np.ndarray:
    """``where(rng.random(shape) < mutation, rng.random(shape) < density,
    child)`` as uint8, and ``rng`` left where those two whole draws leave
    it: the same numbers, drawn a chunk of rows at a time on a pool of
    threads, without two float64 arrays of the batch's size.

    Each double of ``Generator.random`` is one 64-bit step of the PCG64
    stream, so a chunk's draws start at a known offset and a generator
    ``advance``d there draws them (and releases the GIL while it does);
    ``advance`` clears the generator's buffered 32-bit half, which the
    doubles never touch, so the caller's is put back."""
    b, n_bits = child.shape
    start = rng.bit_generator.state
    out = np.empty((b, n_bits), dtype=np.uint8)

    def draws_from(offset: int):
        g = np.random.Generator(np.random.PCG64())
        g.bit_generator.state = start
        g.bit_generator.advance(offset)
        return g

    def chunk(lo: int) -> None:
        hi = min(lo + chunk_rows, b)
        flip = draws_from(lo * n_bits).random((hi - lo, n_bits)) < mutation
        fresh = draws_from((b + lo) * n_bits).random((hi - lo, n_bits)) \
            < density
        out[lo:hi] = np.where(flip, fresh, child[lo:hi])

    with ThreadPoolExecutor(max_workers=os.cpu_count() or 1) as pool:
        list(pool.map(chunk, range(0, b, chunk_rows)))
    end = draws_from(2 * b * n_bits).bit_generator.state
    rng.bit_generator.state = {**end, "has_uint32": start["has_uint32"],
                               "uinteger": start["uinteger"]}
    return out


def make_library_sequential(n: int = 4000, n_bits: int = 512,
                            mutation: float = 0.06, seed: int = 0):
    """The sequential mutation-tree library of
    ``examples/enrichment_example.py:make_library``: each molecule a
    mutated copy of a uniformly drawn earlier one (one Python step a row,
    ~1 min per 100k rows), DOCK-like scores from the Tanimoto distance to
    a target drawn from the deeper half of the tree, plus noise.

    Returns (packed ``[n, n_bits/32]`` uint32, scores ``[n]`` float64,
    ``["MOL_0", ...]``): the same numbers as the reference's for every
    ``(n, n_bits, mutation, seed)``.
    """
    rng = np.random.default_rng(seed)
    density = 0.12
    bits = np.zeros((n, n_bits), dtype=np.uint8)
    bits[0] = rng.random(n_bits) < density
    for i in range(1, n):
        parent = rng.integers(0, i)
        child = bits[parent].copy()
        flip = rng.random(n_bits) < mutation
        child[flip] = rng.random(int(flip.sum())) < density
        if not child.any():
            child[rng.integers(0, n_bits)] = 1
        bits[i] = child
    packed = pack_fingerprints(bits)
    target = bits[rng.integers(n // 2, n)]
    inter = (bits & target).sum(1)
    union = (bits | target).sum(1)
    tani_dist = 1.0 - inter / np.maximum(union, 1)
    scores = 50.0 * tani_dist - 40.0 + rng.normal(0, 0.25, n)
    smiles = [f"MOL_{i}" for i in range(n)]
    return packed, scores.astype(np.float64), smiles


def make_receptor_scores(fps: np.ndarray, center: np.ndarray,
                         seed: int) -> np.ndarray:
    """Synthetic per-receptor DOCK scores ``[len(fps)]`` f32: molecules
    near the receptor's pharmacophore (the packed fingerprint ``center``)
    score best (lowest), plus noise."""
    rng = np.random.default_rng(seed)
    inter = popcount_rows_np(fps & center[None, :])
    pops = popcount_rows_np(fps)
    c_pop = int(popcount_rows_np(center[None, :])[0])
    sim = inter / np.maximum(pops + c_pop - inter, 1)
    return (-sim + rng.normal(0, 0.005, size=len(fps))).astype(np.float32)


def make_receptor_tables(node_fps: np.ndarray, library_fps: np.ndarray,
                         n_receptors: int, seed: int = 9) -> np.ndarray:
    """``[n_receptors, N]`` f32 score tables indexed by node id, one per
    receptor of a panel. ``node_fps`` are the graph's fingerprints (node
    order), ``library_fps`` the library in its original order: the
    pharmacophore centers are drawn from the deeper half of its mutation
    tree, so a similarity gradient exists across the manifold."""
    n = len(library_fps)
    rng = np.random.default_rng(seed)
    return np.stack([
        make_receptor_scores(node_fps, library_fps[rng.integers(n // 2, n)],
                             seed=100 + r)
        for r in range(n_receptors)])
