"""Bounded visited sets for beam search: a fixed-capacity id hash table.

The port of :mod:`rad_tpu.search.visited`. A dense ``[B, N]`` bool map per
query batch is exact but caps scale (512 queries over a 100M-node library
is ~51 GB); past :data:`DENSE_VISITED_BUDGET` the search keeps an
open-addressed table of the ids actually visited, ``[H]`` int32 per query
with H independent of N.

- A check-and-insert gathers ``probes`` slots from the Knuth
  multiplicative hash and scatters each inserted id into its first free
  slot. Colliding inserts of one call resolve by ``max``
  (``scatter_reduce(amax)``, order-independent, as the reference's
  ``.at[].max``); the loser stays unmarked.
- Membership compares full ids: no false positives. A failed insert only
  allows a revisit, which the beam's own mask makes harmless.

Tables carry one trailing sentinel slot (index ``H``) that absorbs the
writes of ids not inserted; the logical table is ``t[..., :-1]``.
Functions update the table in place and return it.
"""

from __future__ import annotations

import torch

from rad_tpu_torch.devices import resolve_device

__all__ = [
    "DENSE_VISITED_BUDGET",
    "visited_capacity_for",
    "use_dense_visited",
    "hashset_init",
    "hashset_check_insert",
    "hashset_check_insert_batch",
]

# Below this many B·N bool bytes the dense per-query bitmap is both exact
# and cheaper than hashing; larger searches switch to the hash table.
DENSE_VISITED_BUDGET = 1 << 28  # 256 MB


def use_dense_visited(batch: int, n: int,
                      budget: int | None = None) -> bool:
    """True when a [batch, n] bool visited map fits the dense budget.
    Reads the module-level DENSE_VISITED_BUDGET at call time so tests can
    force the hash path at small scales."""
    if budget is None:
        budget = DENSE_VISITED_BUDGET
    return batch * n <= budget


_KNUTH = 2654435761  # 2^32 / golden ratio; multiplicative hashing


def visited_capacity_for(ef: int, m0: int, n: int | None = None) -> int:
    """Power-of-two visited capacity for a beam of width ``ef`` over rows of
    degree ``m0``, ~4× the typical visit count; clamped to ≥ ``n`` ids'
    worth only when the library is tiny."""
    est = 4 * max(ef, 1) * max(m0, 1) * 4  # expansions≈4·ef, ×M0, ×4 slack
    cap = 1 << max(10, (est - 1).bit_length())
    if n is not None:
        cap = min(cap, 1 << max(10, (2 * n - 1).bit_length()))
    return cap


def hashset_init(capacity: int, batch: int | None = None,
                 device=None) -> torch.Tensor:
    """Empty table of -1: ``[H + 1]`` int32, or ``[batch, H + 1]`` (the
    last slot is the sentinel). ``capacity`` must be a power of 2."""
    assert capacity & (capacity - 1) == 0, "capacity must be a power of two"
    shape = (capacity + 1,) if batch is None else (batch, capacity + 1)
    return torch.full(shape, -1, dtype=torch.int32,
                      device=resolve_device(device))


def hashset_check_insert_batch(tables: torch.Tensor, ids: torch.Tensor,
                               valid: torch.Tensor, probes: int = 4):
    """Check-and-insert ``ids [B, K]`` into ``tables [B, H + 1]``. Returns
    ``(tables, seen)``; ``seen[b, k]`` is True iff ``ids[b, k]`` was present
    before this call. Valid, unseen ids go to their first free probe slot.
    Duplicate ids within one call all report unseen — callers dedup
    first."""
    h = tables.shape[-1] - 1
    shift = 32 - (h.bit_length() - 1)
    # the u32 product ids * _KNUTH mod 2^32, in int64 halves (no overflow)
    u = ids.long() & 0xFFFFFFFF
    uid = ((u & 0xFFFF) * _KNUTH + (((u >> 16) * _KNUTH & 0xFFFF) << 16)
           ) & 0xFFFFFFFF
    base = uid >> shift
    offs = torch.arange(probes, device=ids.device)
    slot_idx = (base[..., None] + offs) & (h - 1)                # [B, K, P]
    b, k = ids.shape
    slots = tables.gather(1, slot_idx.reshape(b, k * probes)).reshape(
        b, k, probes)
    seen = (slots == ids[..., None]).any(-1) & valid
    free = slots < 0
    any_free = free.any(-1)
    # first free probe: the smallest probe index among the free ones
    first_free = torch.where(free, offs, probes).amin(-1)
    do_insert = valid & ~seen & any_free
    ins = torch.where(
        do_insert,
        slot_idx.gather(-1, torch.clamp(first_free, max=probes - 1)[..., None]
                        )[..., 0], h)
    tables.scatter_reduce_(1, ins, ids.to(tables.dtype), reduce="amax")
    return tables, seen


def hashset_check_insert(table: torch.Tensor, ids: torch.Tensor,
                         valid: torch.Tensor, probes: int = 4):
    """:func:`hashset_check_insert_batch` for one table ``[H + 1]`` and
    ``ids/valid [K]``."""
    t, seen = hashset_check_insert_batch(table[None], ids[None], valid[None],
                                         probes)
    return t[0], seen[0]
