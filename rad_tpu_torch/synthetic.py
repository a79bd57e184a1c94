"""Seeded synthetic screening library for smoke runs and profiles.

The recipe of ``examples/enrichment_example.py:make_library_batched``,
copied so this package stays free of the JAX one.
"""

from __future__ import annotations

import numpy as np

from rad_tpu_torch.fp.pack import pack_fingerprints, popcount_rows_np

__all__ = ["make_library"]


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
        child = pool[parents]
        flip = rng.random((b, n_bits)) < mutation
        child = np.where(flip, rng.random((b, n_bits)) < density,
                         child).astype(np.uint8)
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
