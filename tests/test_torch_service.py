"""rad_tpu_torch's service layer against rad_tpu's.

The cases of ``tests/test_service_layer.py`` run against the port (the
``[id, smiles, ...]`` pair format with and without a store, metrics,
concurrency, the registry and its factories, a traverser over a stub
service), and the port's ``LocalHNSWService`` answering exactly as
rad_tpu's on the same graph read from a v1 file and from a v2 file with
virtual keys and levels.
"""

import dataclasses
import threading

import numpy as np
import pytest

from rad_tpu.build.reference import build_hnsw as ref_build_hnsw
from rad_tpu.fp import random_fingerprints
from rad_tpu.graph.storage import HNSWGraph as RefGraph
from rad_tpu.service.local import LocalHNSWService as RefLocalService
from rad_tpu.store.smiles_store import InMemorySmilesStore as RefStore
from rad_tpu_torch.api.traverser import RADTraverser
from rad_tpu_torch.build.reference import build_hnsw
from rad_tpu_torch.graph.storage import HNSWGraph
from rad_tpu_torch.service.base import HNSWService
from rad_tpu_torch.service.local import LocalHNSWService
from rad_tpu_torch.service.registry import (
    ServiceRegistry,
    create_local_hnsw_service,
    get_default_registry,
)
from rad_tpu_torch.store.smiles_store import InMemorySmilesStore


@pytest.fixture(scope="module")
def graph():
    fps = random_fingerprints(80, n_bits=64, density=0.3, seed=37)
    return build_hnsw(fps, connectivity=4, expansion_add=16, seed=2)


class MockHNSW(HNSWService):
    """Canned answers: a 4-node star graph on one level."""

    def __init__(self):
        self.calls = []

    def get_neighbors(self, node_id, level):
        self.calls.append(("neighbors", node_id, level))
        nbrs = {0: [1, "S1", 2, "S2", 3, "S3"],
                1: [0, "S0"], 2: [0, "S0"], 3: [0, "S0"]}
        return nbrs[node_id]

    def get_top_level_nodes(self):
        return [0, "S0"]

    def is_healthy(self):
        return True

    def shutdown(self):
        pass

    def get_service_info(self):
        return {"service_type": "mock"}

    def get_hnsw_info(self):
        return {"max_level": 1, "size": 4, "connectivity": 3, "ndim": 64}


def test_local_service_pair_format(graph):
    keys = np.asarray(graph.keys)
    store = InMemorySmilesStore({int(k): f"X_{int(k)}" for k in keys})
    svc = LocalHNSWService(graph, store)
    out = svc.get_neighbors(0, 0)
    assert all(out[i + 1] == f"X_{int(keys[out[i]])}"
               for i in range(0, len(out), 2))
    svc.shutdown()


def test_local_service_empty_smiles_without_db(graph):
    svc = LocalHNSWService(graph, None)
    assert all(s == "" for s in svc.get_neighbors(0, 0)[1::2])
    assert all(s == "" for s in svc.get_top_level_nodes()[1::2])
    svc.shutdown()


def test_service_post_shutdown_errors(graph):
    svc = LocalHNSWService(graph)
    svc.shutdown()
    assert not svc.is_healthy()
    with pytest.raises(RuntimeError):
        svc.get_neighbors(0, 0)
    with pytest.raises(RuntimeError):
        svc.get_hnsw_info()


def test_service_metrics_and_info(graph):
    svc = LocalHNSWService(graph)
    for _ in range(5):
        svc.get_top_level_nodes()
    info = svc.get_service_info()
    assert info["request_count"] == 5
    assert info["service_type"] == "local"
    assert svc.get_hnsw_info()["size"] == len(graph)
    svc.shutdown()


def test_concurrent_requests_single_service(graph):
    """5 threads x 10 requests through one service."""
    svc = LocalHNSWService(graph)
    errors = []

    def hammer():
        try:
            for _ in range(10):
                assert len(svc.get_neighbors(0, 0)) >= 2
        except Exception as e:  # pragma: no cover
            errors.append(e)

    threads = [threading.Thread(target=hammer) for _ in range(5)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors
    assert svc.get_service_info()["request_count"] == 50
    svc.shutdown()


def test_registry_default_and_named(graph):
    reg = ServiceRegistry()
    a, b = LocalHNSWService(graph), LocalHNSWService(graph)
    reg.register_service("a", a)
    reg.register_service("b", b)
    assert reg.get_service() is a
    assert reg.get_service("b") is b
    reg.unregister_service("a")
    assert reg.get_service() is b
    with pytest.raises(KeyError):
        reg.get_service("zzz")
    reg.shutdown_all()
    assert reg.list_services() == []


def test_factory_registers_in_default_registry(graph):
    svc = create_local_hnsw_service(graph, service_name="factory-test")
    assert get_default_registry().get_service("factory-test") is svc
    get_default_registry().unregister_service("factory-test")
    svc.shutdown()


def test_traverser_over_mock_service():
    """The whole lifecycle against the stub: no graph, no tensors."""
    mock = MockHNSW()
    scores = {"S0": 1.0, "S1": 0.5, "S2": 2.0, "S3": 3.0}
    t = RADTraverser(hnsw_service=mock, scoring_fn=lambda s: scores[s],
                     deployment_mode="distributed")
    assert t.engine == "host"
    t.prime()
    stats = t.traverse(n_workers=2, n_to_score=4, poll_interval=0.01)
    ids = [m[0] for m in t.get_molecules()]
    assert len(ids) == len(set(ids))
    assert set(ids) <= {0, 1, 2, 3}
    assert len(ids) == 4 or stats["termination_reason"] == "queue_empty"
    best = t.get_best_molecules(1)[0]
    assert best[1] == 0.5 and best[2] == "S1"
    t.shutdown()
    assert any(c[0] == "neighbors" for c in mock.calls)


def test_factory_reference_signature(graph, tmp_path):
    """create_local_hnsw_service(index, database_path=...) takes the index
    facade and a SQLite path."""
    from rad_tpu_torch.api.index import HNSWIndex
    from rad_tpu_torch.store.smiles_store import create_smiles_db

    keys = np.asarray(graph.keys)
    db = str(tmp_path / "mols.db")
    create_smiles_db(db, [(int(k), f"SMI_{int(k)}") for k in keys])
    idx = HNSWIndex.from_graph(graph, device="cpu")
    svc = create_local_hnsw_service(idx, database_path=db, register=False)
    pairs = svc.get_top_level_nodes()
    assert len(pairs) >= 2 and len(pairs) % 2 == 0
    assert pairs[1].startswith("SMI_")
    svc.shutdown()


def test_sqlite_store_close_closes_all_threads(tmp_path):
    """close() closes every thread's connection; use after it is quiet."""
    from rad_tpu_torch.store.smiles_store import (
        SQLiteSmilesStore,
        create_smiles_db,
    )

    db = str(tmp_path / "smiles.db")
    create_smiles_db(db, [(i, f"S_{i}") for i in range(20)])
    store = SQLiteSmilesStore(db)
    hits = {}

    def worker(tid):
        hits[tid] = store.get_smiles_batch([tid])

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert all(hits[i] == {i: f"S_{i}"} for i in range(3))
    assert len(store._all_conns) == 4
    store.close()
    assert store._all_conns == []
    assert store.get_smiles_batch([1]) == {}
    assert len(store) == 0
    with pytest.raises(RuntimeError):
        store._conn()


# ------------------------------------------------ answers vs rad_tpu's
@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    """A graph with identity keys (the v2 format requires them) saved by
    rad_tpu as a v1 file and as a v2 serving file (virtual keys and
    levels)."""
    fps = random_fingerprints(150, n_bits=64, density=0.3, seed=41)
    g = ref_build_hnsw(fps, connectivity=4, expansion_add=16, seed=5)
    g = dataclasses.replace(g, keys=np.arange(len(g), dtype=np.int64))
    d = tmp_path_factory.mktemp("svc")
    v1, v2 = str(d / "v1.npz"), str(d / "v2.npz")
    g.save(v1)
    g.save(v2, exclude_vectors=True, slim=True)
    return {"v1": v1, "v2": v2}


@pytest.mark.parametrize("with_store", [True, False])
@pytest.mark.parametrize("version", ["v1", "v2"])
def test_local_service_answers_as_reference(saved, version, with_store):
    ref_g = RefGraph.load(saved[version])
    port_g = HNSWGraph.load(saved[version])
    mapping = {i: f"C{i}O" for i in range(0, len(port_g), 2)}
    a = RefLocalService(ref_g, RefStore(mapping) if with_store else None)
    b = LocalHNSWService(port_g,
                         InMemorySmilesStore(mapping) if with_store
                         else None)
    assert b.get_top_level_nodes() == a.get_top_level_nodes()
    assert b.get_hnsw_info() == a.get_hnsw_info()
    for level, n_l in enumerate(port_g.layer_sizes):
        for nid in range(n_l):
            assert b.get_neighbors(nid, level) == a.get_neighbors(nid, level)
    with pytest.raises(ValueError):
        b.get_neighbors(len(port_g), 0)
    with pytest.raises(ValueError):
        a.get_neighbors(len(port_g), 0)
    info_a, info_b = a.get_service_info(), b.get_service_info()
    drop = ("uptime_seconds", "avg_request_ms")
    assert ({k: v for k, v in info_a.items() if k not in drop}
            == {k: v for k, v in info_b.items() if k not in drop})
    a.shutdown()
    b.shutdown()
