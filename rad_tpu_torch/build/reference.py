"""Level sampling shared by the builders.

Node levels are sampled for the whole library up front and ids are
assigned in descending-level order, so layer ``l`` is the id range
``[0, N_l)`` (see :mod:`rad_tpu_torch.graph.storage`).
"""

from __future__ import annotations

import math

import numpy as np

__all__ = ["sample_levels"]


def sample_levels(n: int, connectivity: int, seed: int = 0) -> np.ndarray:
    """Geometric level sampling with multiplier 1/ln(M) (HNSW paper).

    Draws exactly what ``rad_tpu.build.reference.sample_levels`` draws for
    equal arguments — the graphs of the two packages can only match if
    their levels do."""
    rng = np.random.default_rng(seed)
    mult = 1.0 / math.log(max(connectivity, 2))
    u = rng.random(n)
    return np.floor(-np.log(np.clip(u, 1e-300, 1.0)) * mult).astype(np.int32)
