"""The synthetic screening library: a mutation tree of fingerprints and
DOCK-like scores, made on the host from a seed.

A copy of the program's ``synthetic.make_library`` (the numbers of
``examples/enrichment_example.py:make_library_batched``): a seed tree of
4,096 rows grown one mutated copy at a time, then batches of children of a
bounded parent pool, bits at density 0.12, each bit re-drawn with
probability ``mutation``; no row is empty. Scores are ``50 d - 40 +
N(0, 0.25)`` with ``d`` the Tanimoto distance to a target drawn from the
deeper half of the tree (lower is better).
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np


def pack_bits(bits: np.ndarray) -> np.ndarray:
    """``[N, d]`` 0/1 (d a multiple of 32) → ``[N, d/32]`` uint32, LSB
    first."""
    words = np.packbits(np.ascontiguousarray(bits.astype(np.uint8) & 1),
                        axis=1, bitorder="little").view("<u4")
    return np.ascontiguousarray(words, dtype=np.uint32)


def popcount_rows(packed: np.ndarray) -> np.ndarray:
    return np.bitwise_count(np.asarray(packed, np.uint32)).sum(
        axis=-1, dtype=np.int32)


def make_library(n: int, n_bits: int = 1024, mutation: float = 0.06,
                 density: float = 0.12, seed: int = 0, batch: int = 1 << 16):
    """Returns (packed ``[n, n_bits/32]`` uint32, scores ``[n]`` f64)."""
    rng = np.random.default_rng(seed)
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
    parts = [pack_bits(bits)]
    pool = bits
    done = seed_n
    while done < n:
        b = min(batch, n - done)
        parents = rng.integers(0, pool.shape[0], size=b)
        child = _mutate(rng, pool[parents], mutation, density)
        empty = np.flatnonzero(~child.any(axis=1))
        if empty.size:
            child[empty, rng.integers(0, n_bits, size=empty.size)] = 1
        parts.append(pack_bits(child))
        keep = rng.choice(b, size=min(b, 8192), replace=False)
        pool = np.concatenate([pool, child[keep]])[-65536:]
        done += b
    packed = np.concatenate(parts)
    target = packed[rng.integers(n // 2, n)]
    pops = popcount_rows(packed).astype(np.float64)
    t_pop = float(popcount_rows(target[None])[0])
    inter = popcount_rows(packed & target[None]).astype(np.float64)
    tani_dist = 1.0 - inter / np.maximum(pops + t_pop - inter, 1)
    scores = 50.0 * tani_dist - 40.0 + rng.normal(0, 0.25, n)
    return packed, scores.astype(np.float64)


def _mutate(rng, child: np.ndarray, mutation: float, density: float,
            chunk_rows: int = 8192) -> np.ndarray:
    """``where(rng.random(shape) < mutation, rng.random(shape) < density,
    child)``, drawn a chunk of rows at a time on a pool of threads from
    generators advanced to each chunk's offset of the PCG64 stream, and
    ``rng`` left where the two whole draws leave it."""
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

    with ThreadPoolExecutor(max_workers=min(os.cpu_count() or 1, 8)) as pool:
        list(pool.map(chunk, range(0, b, chunk_rows)))
    end = draws_from(2 * b * n_bits).bit_generator.state
    rng.bit_generator.state = {**end, "has_uint32": start["has_uint32"],
                               "uinteger": start["uinteger"]}
    return out
