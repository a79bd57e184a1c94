"""The least time of the cluster-probed candidate scan, against the peaks
of :mod:`portbench.roofline`."""

from __future__ import annotations

from portbench.roofline import B1_OPS_PER_S, HBM_BYTES_PER_S


def probed_scan(layer_sizes, probed, ndim: int, k: int, probes: int,
                csize: int, q_block: int) -> dict:
    """The probed scan's least work, counted from the layer sizes and the
    configuration, never from launches: every real q-block of a probed
    layer (``ceil(n_l / q_block)`` of ``q_block`` rows) against its
    ``probes`` clusters of ``csize`` rows, ``2 * ndim`` one-bit operations
    a pair (an AND and an add per bit); each member's words and popcount
    read once and its ``k`` candidates (an int32 id and an f32 distance
    each) written once. Returns ops, bytes, the two bounds and the least
    time."""
    sizes = [layer_sizes[l] for l in probed]
    pairs = sum(-(-n // q_block) * q_block * probes * csize for n in sizes)
    ops = 2.0 * ndim * pairs
    nbytes = sum(n * (ndim // 8 + 4 + 8 * k) for n in sizes)
    t_ops = ops / B1_OPS_PER_S
    t_bytes = nbytes / HBM_BYTES_PER_S
    return {"ops": ops, "bytes": nbytes, "ops_s": t_ops, "bytes_s": t_bytes,
            "least_s": max(t_ops, t_bytes),
            "bound": "operations" if t_ops >= t_bytes else "bytes"}
