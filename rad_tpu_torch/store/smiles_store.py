"""node_key → SMILES stores (a copy of ``rad_tpu.store.smiles_store``).

Plain Python, duplicated rather than imported because importing any
``rad_tpu`` module loads jax. Parity with the reference's SQLite sidecar: table
``nodes(node_key INTEGER PRIMARY KEY, smi TEXT NOT NULL)`` plus index
``idx_nodes_node_key`` (schema documented at reference README.md:70-88,
consumed at rad/hnsw_service.py:147-193 and rad/hnsw_server.py:249-347).
SQLite connections are per-thread (sqlite3 objects are thread-affine), and
lookups are batched ``SELECT ... IN (...)`` chunks.
"""

from __future__ import annotations

import sqlite3
import threading
from abc import ABC, abstractmethod
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

__all__ = [
    "SmilesStore",
    "SQLiteSmilesStore",
    "InMemorySmilesStore",
    "create_smiles_db",
]

_SCHEMA = """
CREATE TABLE IF NOT EXISTS nodes (
    node_key INTEGER PRIMARY KEY,
    smi TEXT NOT NULL
);
CREATE INDEX IF NOT EXISTS idx_nodes_node_key ON nodes(node_key);
"""


class SmilesStore(ABC):
    """Lookup interface: user keys → SMILES strings."""

    @abstractmethod
    def get_smiles_batch(self, keys: Sequence[int]) -> Dict[int, str]:
        """Return {key: smiles} for every key present; absent keys omitted."""

    def get_smiles(self, key: int) -> Optional[str]:
        return self.get_smiles_batch([key]).get(int(key))

    def get_smiles_list(self, keys: Sequence[int], default: str = "") -> List[str]:
        found = self.get_smiles_batch(keys)
        return [found.get(int(k), default) for k in keys]

    @abstractmethod
    def __len__(self) -> int:
        ...

    def close(self) -> None:
        pass


class SQLiteSmilesStore(SmilesStore):
    """SQLite-backed store with per-thread connections and chunked IN()."""

    def __init__(self, path: str, read_only: bool = True,
                 chunk_size: int = 900) -> None:
        self.path = path
        self.read_only = read_only
        self.chunk_size = chunk_size  # SQLite parameter limit is 999
        self._local = threading.local()
        self._closed = False
        # every thread's connection, so close() can close them all (the
        # per-thread handle in self._local is only reachable from its
        # owning thread)
        self._all_conns: List[sqlite3.Connection] = []
        self._conns_lock = threading.Lock()
        # validate eagerly so a bad path fails at construction
        conn = self._conn()
        conn.execute("SELECT 1 FROM nodes LIMIT 1").fetchall()

    def _conn(self) -> sqlite3.Connection:
        if self._closed:
            raise RuntimeError("SmilesStore has been closed")
        conn = getattr(self._local, "conn", None)
        if conn is None:
            if self.read_only:
                conn = sqlite3.connect(
                    f"file:{self.path}?mode=ro", uri=True,
                    check_same_thread=False)
            else:
                conn = sqlite3.connect(self.path, check_same_thread=False)
            self._local.conn = conn
            with self._conns_lock:
                self._all_conns.append(conn)
        return conn

    def get_smiles_batch(self, keys: Sequence[int]) -> Dict[int, str]:
        if not keys or self._closed:
            return {}
        conn = self._conn()
        out: Dict[int, str] = {}
        keys = [int(k) for k in keys]
        for i in range(0, len(keys), self.chunk_size):
            chunk = keys[i:i + self.chunk_size]
            ph = ",".join("?" * len(chunk))
            rows = conn.execute(
                f"SELECT node_key, smi FROM nodes WHERE node_key IN ({ph})",
                chunk).fetchall()
            out.update({int(k): s for k, s in rows})
        return out

    def __len__(self) -> int:
        if self._closed:  # mirror get_smiles_batch's quiet after-close path
            return 0
        return int(self._conn().execute(
            "SELECT COUNT(*) FROM nodes").fetchone()[0])

    def close(self) -> None:
        """Close EVERY thread's connection (server handler threads each
        opened their own); safe to call from any thread — sqlite3 allows
        cross-thread close with check_same_thread=False as long as the
        connection is idle, which _closed guarantees for new calls."""
        self._closed = True
        with self._conns_lock:
            conns, self._all_conns = self._all_conns, []
        for conn in conns:
            try:
                conn.close()
            except sqlite3.ProgrammingError:  # racing in-flight query
                pass
        self._local = threading.local()


class InMemorySmilesStore(SmilesStore):
    """Dict-backed store for tests and fully device-resident runs."""

    def __init__(self, mapping: Dict[int, str] | None = None) -> None:
        self._map: Dict[int, str] = {int(k): v
                                     for k, v in (mapping or {}).items()}

    def get_smiles_batch(self, keys: Sequence[int]) -> Dict[int, str]:
        return {int(k): self._map[int(k)] for k in keys if int(k) in self._map}

    def insert(self, key: int, smiles: str) -> None:
        self._map[int(key)] = smiles

    def __len__(self) -> int:
        return len(self._map)


def create_smiles_db(
    path: str, items: Iterable[Tuple[int, str]], batch: int = 10000
) -> int:
    """Create/populate a SMILES database file; returns row count.

    ``items``: iterable of ``(node_key, smiles)``. Mirrors the DB-build recipe
    in reference README.md:70-88.
    """
    conn = sqlite3.connect(path)
    try:
        conn.executescript(_SCHEMA)
        n = 0
        buf: List[Tuple[int, str]] = []
        for key, smi in items:
            buf.append((int(key), smi))
            if len(buf) >= batch:
                conn.executemany(
                    "INSERT OR REPLACE INTO nodes(node_key, smi) VALUES (?,?)",
                    buf)
                n += len(buf)
                buf.clear()
        if buf:
            conn.executemany(
                "INSERT OR REPLACE INTO nodes(node_key, smi) VALUES (?,?)",
                buf)
            n += len(buf)
        conn.commit()
        return n
    finally:
        conn.close()
