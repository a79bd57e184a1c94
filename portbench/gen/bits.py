"""Uniform random fingerprints and score tables, made on the device."""

from __future__ import annotations

import torch


def random_words(rows: int, w: int, seed: int, device,
                 step: int = 1 << 21) -> torch.Tensor:
    """``[rows, w]`` int32 of uniform random bits, ``step`` rows a draw."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    out = torch.empty((rows, w), dtype=torch.int32, device=device)
    for lo in range(0, rows, step):
        hi = min(lo + step, rows)
        draw = torch.randint(0, 1 << 32, (hi - lo, w), generator=gen,
                             device=device)
        out[lo:hi] = (draw - (1 << 31)).to(torch.int32)
        del draw
    return out


def uniform_table(n: int, seed: int, device) -> torch.Tensor:
    """``[n]`` f32 uniform scores in ``[0, 1)``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return torch.rand((n,), generator=gen, device=device)
