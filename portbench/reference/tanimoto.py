"""Tanimoto distance over packed 1024-bit fingerprints, in plain torch.

Fingerprints are ``[N, W]`` int32 words (32 bits each, LSB first). The
distance is ``1 - inter / union`` in f32 with both counts exact integers,
and similarity 1 where the union is empty. ``sim_dtype`` rounds the
similarity to a lower precision: the control of the comparison.
"""

from __future__ import annotations

import torch

_M1, _M2, _M4, _H01 = 0x55555555, 0x33333333, 0x0F0F0F0F, 0x01010101


def popcount(words: torch.Tensor) -> torch.Tensor:
    """Set bits of each 32-bit word (SWAR), int32."""
    x = words.to(torch.int64) & 0xFFFFFFFF
    x = x - ((x >> 1) & _M1)
    x = (x & _M2) + ((x >> 2) & _M2)
    x = (x + (x >> 4)) & _M4
    return (((x * _H01) & 0xFFFFFFFF) >> 24).to(torch.int32)


def popcount_rows(words: torch.Tensor, step: int = 1 << 20) -> torch.Tensor:
    """Set bits of each row of ``[N, W]`` words, ``step`` rows at a time."""
    out = torch.empty(words.shape[:-1], dtype=torch.int32,
                      device=words.device)
    flat_in = words.reshape(-1, words.shape[-1])
    flat_out = out.reshape(-1)
    for lo in range(0, flat_in.shape[0], step):
        flat_out[lo:lo + step] = popcount(flat_in[lo:lo + step]).sum(
            -1, dtype=torch.int32)
    return out


def similarity(inter: torch.Tensor, union: torch.Tensor,
               sim_dtype=torch.float32) -> torch.Tensor:
    """f32 ``inter / max(union, 1)``, 1 where ``union == 0``."""
    inter = inter.to(torch.float32)
    union = union.to(torch.float32)
    sim = torch.where(union > 0, inter / torch.clamp(union, min=1.0),
                      torch.ones_like(inter))
    if sim_dtype != torch.float32:
        sim = sim.to(sim_dtype).to(torch.float32)
    return sim


def distance_to_target(rows: torch.Tensor, row_pops: torch.Tensor,
                       target: torch.Tensor, target_pop: int,
                       sim_dtype=torch.float32) -> torch.Tensor:
    """``1 - Tanimoto(rows[i], target)`` (f32) for ``[K, W]`` rows."""
    inter = popcount(rows & target[None, :]).sum(-1, dtype=torch.int32)
    union = row_pops + int(target_pop) - inter
    return 1.0 - similarity(inter, union, sim_dtype)


def unpack_bits(words: torch.Tensor, dtype) -> torch.Tensor:
    """``[..., W]`` words → ``[..., 32 W]`` 0/1 values of ``dtype``."""
    shifts = torch.arange(32, dtype=torch.int32, device=words.device)
    bits = (words[..., :, None] >> shifts) & 1
    return bits.reshape(*words.shape[:-1], words.shape[-1] * 32).to(dtype)


def matmul_dtype(device: torch.device):
    """A product dtype whose sums of 0/1 terms up to 1,024 are exact:
    fp16 on the card (integers to 2,048 are exact in fp16, so every partial
    sum is), f32 on the CPU."""
    return torch.float16 if device.type == "cuda" else torch.float32
