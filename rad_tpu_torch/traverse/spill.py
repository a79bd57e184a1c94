"""Host-spilled traversal order log.

The device keeps the scoring-order log as a fixed-capacity ring
(:attr:`rad_tpu_torch.traverse.device.TraversalState.order_log`), 4 bytes
of device memory per entry. For a campaign that scores more molecules than
the ring should hold (or whose ``log_capacity`` is kept small to save
device memory), ``DeviceTraverser`` drains the ring into this host-side
log between steps, so the complete insertion order survives while device
memory stays O(log_capacity). The order lives in host RAM, or in a file of raw
little-endian int32 appends that reads back as a memmap.
"""

from __future__ import annotations

import os
from typing import List, Optional

import numpy as np

__all__ = ["SpilledOrderLog"]


class SpilledOrderLog:
    """Append-only host order log fed by incremental device-ring drains.

    ``path=None`` keeps the order in host RAM (a chunk list); a path
    appends raw int32 ids to that file and reads them back via memmap. An
    existing file is resumed (appended to): pair it with the state
    checkpoint, the drain cursor re-syncs to ``len(log)``.
    """

    def __init__(self, path: Optional[str] = None):
        self.path = path
        self._chunks: List[np.ndarray] = []
        self._n = 0
        if path is not None and os.path.exists(path):
            self._n = os.path.getsize(path) // 4

    def __len__(self) -> int:
        return self._n

    @property
    def seen(self) -> int:
        """Drain cursor: entries [0, seen) of the traversal order are
        here."""
        return self._n

    def append(self, ids: np.ndarray) -> None:
        ids = np.ascontiguousarray(ids, dtype="<i4")
        if ids.size == 0:
            return
        if self.path is None:
            self._chunks.append(ids)
        else:
            with open(self.path, "ab") as f:
                f.write(ids.tobytes())
        self._n += ids.size

    def truncate(self, n: int) -> None:
        """Discard entries at positions >= ``n``.

        A file resumed after a crash may hold order the earlier run wrote
        after the restored checkpoint's ``n_scored``; if the resumed run
        diverges (another batch size), that tail is stale. Callers
        truncate to the checkpoint's ``n_scored`` on load so the log never
        leads the restored state."""
        n = max(0, min(int(n), self._n))
        if n == self._n:
            return
        if self.path is None:
            if len(self._chunks) > 1:
                self._chunks = [np.concatenate(self._chunks)]
            if self._chunks:
                self._chunks = [self._chunks[0][:n]]
        else:
            with open(self.path, "r+b") as f:
                f.truncate(n * 4)
        self._n = n

    def drain(self, state) -> int:
        """Pull order-log entries [seen, n_scored) off the device ring.

        Call between steps (``DeviceTraverser`` does after prime and
        after every integrate). Raises, like ``read_order_log_since``, if
        more than the ring's capacity accumulated since the last drain.
        Returns the number of new entries."""
        from rad_tpu_torch.traverse.device import read_order_log_since

        new = read_order_log_since(state, self._n)
        self.append(new)
        return int(new.size)

    def read(self, start: int = 0, n: Optional[int] = None) -> np.ndarray:
        """The traversal order as one int32 array (memmap-backed when
        spilled to a file; no copy until sliced)."""
        if self.path is None:
            if not self._chunks:
                return np.zeros((0,), np.int32)
            if len(self._chunks) > 1:  # consolidate lazily
                self._chunks = [np.concatenate(self._chunks)]
            full = self._chunks[0]
        else:
            if self._n == 0:
                return np.zeros((0,), np.int32)
            full = np.memmap(self.path, dtype="<i4", mode="r",
                             shape=(self._n,))
        stop = self._n if n is None else min(start + n, self._n)
        return np.asarray(full[start:stop])
