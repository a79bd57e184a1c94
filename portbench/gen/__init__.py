"""Inputs made from the seed: graphs, fingerprints, score tables and the
synthetic screening library. Both the program and the reference get what
these make; neither makes its own."""

from __future__ import annotations

import numpy as np


def sub_seed(seed: int, *path: int) -> int:
    """A 63-bit seed for one use (``path``) of the run's ``--seed``: any
    whole number, negative or past 64 bits included."""
    words = [int(x) % (1 << 64) for x in (seed, *path)]
    return int(np.random.SeedSequence(words).generate_state(
        1, np.uint64)[0] >> np.uint64(1))
