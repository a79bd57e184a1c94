"""An HNSW-shaped layered random graph made on the device from a seed.

A copy, in plain torch, of ``make_device_graph`` of the program's scale
benchmark, so that the yardstick does not move with the program: layer
``l`` holds ``round(n * m**-l)`` nodes (ids ``[0, n_l)``), layer 0 rows
cap at ``2m`` neighbours and the rows above at ``m``, every id is drawn
uniformly from its own layer (a draw of the row's own node moves to the
next id), a layer of one node has no edges, and the flat ``[R, 2m]``
int32 table is ``-1`` padded. Row ``offsets[l] + node`` holds ``(node,
l)``. A random graph has almost no revisits: each step's neighbours are
nearly all new.
"""

from __future__ import annotations

import numpy as np
import torch


def layer_sizes(n: int, m: int) -> list[int]:
    """``n_l = round(n * m**-l)`` down to the first layer of one node."""
    sizes = []
    level = 0
    while True:
        nl = int(round(n * m ** (-level)))
        if nl < 1:
            break
        sizes.append(nl)
        if nl == 1:
            break
        level += 1
    return sizes


def make_graph(n: int, m: int, seed: int, device, n_chunks: int = 64):
    """Returns ``(adj [R, 2m] int32, offsets [L+2] int64 numpy, sizes)``;
    ``offsets`` ends with ``R`` twice (the row trick's sentinel)."""
    sizes = layer_sizes(n, m)
    offsets = np.concatenate([[0], np.cumsum(sizes), [sum(sizes)]]).astype(
        np.int64)
    r = int(offsets[-1])
    m0 = 2 * m
    max_level = len(sizes) - 1
    offs = torch.from_numpy(offsets).to(device)
    szs = torch.tensor(sizes + [1], dtype=torch.int64, device=device)
    adj = torch.empty((r, m0), dtype=torch.int32, device=device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    chunk = -(-r // n_chunks)
    cols = torch.arange(m0, device=device)[None, :]
    for lo in range(0, r, chunk):
        rows = torch.arange(lo, min(lo + chunk, r), device=device)
        lev = torch.clamp(torch.searchsorted(offs[: max_level + 2], rows,
                                             right=True) - 1, 0, max_level)
        nl = szs[lev][:, None]
        ids = torch.randint(0, 1 << 31, (rows.shape[0], m0), generator=gen,
                            device=device) % nl
        node = (rows - offs[lev])[:, None]
        ids = torch.where(ids == node, (ids + 1) % nl, ids)
        cap = torch.where(lev == 0, m0, m)[:, None]
        adj[lo:lo + rows.shape[0]] = torch.where(
            (cols < cap) & (nl > 1), ids, -1).to(torch.int32)
        del ids, rows, lev, nl, node, cap
    return adj, offsets, sizes


def top_ids(sizes: list[int]) -> int:
    """How many nodes a campaign primes with: the top layer, or the layer
    below it where the top holds one node."""
    if sizes[-1] > 1 or len(sizes) == 1:
        return sizes[-1]
    return sizes[-2]
