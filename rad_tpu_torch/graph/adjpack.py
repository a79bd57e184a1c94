"""Bit-packed adjacency rows.

The traversal engine's largest resident table is the flat ``[R, M0]``
int32 neighbor table (:class:`rad_tpu_torch.traverse.device.DeviceGraph`).
Node ids only need ``ceil(log2(N + 1))`` bits, so packing each row's
fields at that width shrinks the table to ``bits / 32`` of its size (20
bits at up to 1M nodes); the engine decodes each popped batch on the fly.

Encoding, the same as ``rad_tpu.graph.adjpack`` (packed words are
array-equal): each field stores ``id`` as an unsigned ``bits``-wide
integer; the all-ones value is the -1 (no neighbor) sentinel, so valid ids
satisfy ``n_nodes <= 2**bits - 1``. Fields lie little-endian across a row
of ``ceil(M0 * bits / 32)`` 32-bit words: field k occupies bits
``[k * bits, (k + 1) * bits)`` of the row's bit string, crossing word
boundaries where needed.

Two differences from the reference's storage, neither in the encoding.
Torch tensors hold the words as ``int32`` bit views (torch has no uint32
arithmetic); ``.numpy().view(np.uint32)`` gives the reference's array. And
the reference groups G packed rows into one table row
(``adj_group_for``) because XLA pads the minor dimension of a device array
to 8 elements; CUDA allocations have no such padding, so the port always
stores ``[R, W]``, the reference's group 1.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["adj_bits_for", "packed_adj_words", "pack_adjacency_rows",
           "unpack_adjacency_rows", "pack_adjacency_numpy"]

_WORD = 0xFFFFFFFF


def adj_bits_for(n_nodes: int) -> int:
    """Smallest field width whose all-ones sentinel stays distinct from
    every valid id: ``n_nodes <= 2**bits - 1``."""
    if n_nodes < 1:
        return 1
    return max(1, int(n_nodes).bit_length())


def packed_adj_words(m0: int, bits: int) -> int:
    """32-bit words per packed row."""
    return -(-(m0 * bits) // 32)


def _field_layout(m0: int, bits: int):
    """Static per-field (word, shift, crosses) decode plan."""
    plan = []
    for k in range(m0):
        word, shift = divmod(k * bits, 32)
        plan.append((word, shift, shift + bits > 32))
    return plan


def pack_adjacency_rows(adj_rows: torch.Tensor, bits: int) -> torch.Tensor:
    """``[..., M0]`` int32 neighbor ids (-1 padded) → ``[..., W]`` int32
    bit views of the packed words. Ids must be below ``2**bits - 1`` (not
    checked; see :func:`adj_bits_for`)."""
    m0 = adj_rows.shape[-1]
    w = packed_adj_words(m0, bits)
    mask = (1 << bits) - 1
    vals = torch.where(adj_rows < 0, -1, adj_rows).long() & mask
    words = torch.zeros(adj_rows.shape[:-1] + (w,), dtype=torch.int64,
                        device=adj_rows.device)
    for k, (word, shift, crosses) in enumerate(_field_layout(m0, bits)):
        v = vals[..., k]
        words[..., word] |= (v << shift) & _WORD
        if crosses:
            words[..., word + 1] |= v >> (32 - shift)
    return torch.where(words >= 1 << 31, words - (1 << 32),
                       words).to(torch.int32)


def unpack_adjacency_rows(packed_rows: torch.Tensor, m0: int,
                          bits: int) -> torch.Tensor:
    """``[..., W]`` packed words (int32 bit views) → ``[..., M0]`` int32
    ids, -1 padded. One gather of each field's low and high word and a
    shift/or/mask over all fields at once (the engine's per-batch
    decode)."""
    dev = packed_rows.device
    w = packed_rows.shape[-1]
    mask = (1 << bits) - 1
    lo_bit = torch.arange(m0, dtype=torch.int64, device=dev) * bits
    word, shift = lo_bit // 32, lo_bit % 32
    words = packed_rows.long() & _WORD
    lo = words[..., word] >> shift
    # the high word's bits land at positions >= 32 - shift: past the field
    # (and masked off) unless the field crosses into it. A field takes
    # fewer than `bits` bits of its high word, so masking first keeps the
    # shifted value inside int64
    hi = (words[..., torch.clamp(word + 1, max=w - 1)] & mask) \
        << (32 - shift)
    v = (lo | hi) & mask
    return torch.where(v == mask, -1, v).to(torch.int32)


def pack_adjacency_numpy(adj: np.ndarray, bits: int) -> np.ndarray:
    """Host-side packer → ``[..., W]`` uint32 (for host graph preparation
    and tests)."""
    adj = np.asarray(adj, dtype=np.int64)
    m0 = adj.shape[-1]
    if adj.size and int(adj.max()) >= (1 << bits) - 1:
        raise ValueError(
            f"ids up to {int(adj.max())} do not fit {bits}-bit fields "
            f"(max {(1 << bits) - 2}; all-ones is the -1 sentinel)")
    w = packed_adj_words(m0, bits)
    mask = np.uint64((1 << bits) - 1)
    vals = np.where(adj < 0, np.int64(-1), adj).astype(np.uint64) & mask
    words = np.zeros(adj.shape[:-1] + (w,), np.uint32)
    for k, (word, shift, crosses) in enumerate(_field_layout(m0, bits)):
        v = vals[..., k]
        words[..., word] |= (v << np.uint64(shift)).astype(np.uint32)
        if crosses:
            words[..., word + 1] |= (v >> np.uint64(32 - shift)).astype(
                np.uint32)
    return words
