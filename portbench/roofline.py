"""Peaks of the card and the least time of the work a stage needs.

Peaks of one NVIDIA H100 SXM at its 700 W limit: HBM3 at 3.35 TB/s (the
data sheet), and 1-bit AND-popcount products on the tensor cores at
15,832 TOP/s, which is 8 x the data sheet's dense int8 rate of 1,979 TOP/s
(one int8 multiply-add does the work of 8 one-bit ones; ``wgmma`` b1 was
measured at 15,727-15,798 TOP/s on such a card). A card set below 700 W
runs lower: the result line carries its limit.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
B1_OPS_PER_S = 8 * 1979e12


def candidate_scan(layer_sizes, ndim: int, k: int) -> dict:
    """The exact candidate scan's least work: every unordered pair of a
    layer's members compared once (``2 * ndim`` one-bit operations each:
    an AND and an add per bit), each member's words and popcount read
    once, and its ``k`` candidates (an int32 id and an f32 distance each)
    written once. Counted from the layer sizes, never from launches or
    tiles. Returns ops, bytes, the two bounds and the least time."""
    ops = sum(2.0 * ndim * n * (n - 1) / 2 for n in layer_sizes if n > 1)
    nbytes = sum(n * (ndim // 8 + 4 + 8 * min(k, n - 1))
                 for n in layer_sizes if n > 1)
    t_ops = ops / B1_OPS_PER_S
    t_bytes = nbytes / HBM_BYTES_PER_S
    return {"ops": ops, "bytes": nbytes, "ops_s": t_ops, "bytes_s": t_bytes,
            "least_s": max(t_ops, t_bytes),
            "bound": "operations" if t_ops >= t_bytes else "bytes"}
