"""The README quick start on both packages, and the port's isolation
from JAX.

rad_tpu builds with its exact backend (what ``backend="auto"`` picks on an
accelerator); both graphs go through ``.npz`` save/load, then
``create_local_traverser`` → ``prime`` → ``traverse`` →
``get_best_molecules`` must return the same molecules.
"""

import logging
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

import rad_tpu
import rad_tpu_torch
from rad_tpu.fp import random_fingerprints
from rad_tpu.store import create_smiles_db

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def library(tmp_path_factory):
    n = 300
    keys = np.arange(n) + 5000
    fps = random_fingerprints(n, n_bits=1024, density=0.1, seed=0)
    db = str(tmp_path_factory.mktemp("smiles") / "smiles.db")
    create_smiles_db(db, ((int(k), f"SMILES_{int(k)}") for k in keys))
    rng = np.random.default_rng(0)
    table = {f"SMILES_{int(k)}": float(s)
             for k, s in zip(keys, rng.permutation(n))}
    return keys, fps, db, table


def _quickstart(pkg, store_cls, library, tmp_path, **build_kw):
    keys, fps, db, table = library
    on_cpu = {"device": "cpu"} if pkg is rad_tpu_torch else {}
    index = pkg.HNSWIndex(ndim=1024, dtype="b1", metric="tanimoto",
                          connectivity=16, expansion_add=400, **on_cpu)
    index.add(keys, fps)
    index.build(**build_kw)
    path = str(tmp_path / f"{pkg.__name__}.npz")
    index.save(path)
    loaded = pkg.HNSWIndex.load(path, **on_cpu)
    store = store_cls(db)
    t = pkg.create_local_traverser(loaded, table.__getitem__,
                                   smiles_store=store, n_score_threads=1,
                                   batch_size=4)
    t.prime()
    t.traverse(n_to_score=100)
    out = t.get_best_molecules(10), t.get_molecules()
    t.shutdown()
    return index, out


def test_quickstart_same_best_molecules(library, tmp_path):
    from rad_tpu.store import SQLiteSmilesStore as RefStore
    from rad_tpu_torch.store import SQLiteSmilesStore

    ref_index, (ref_best, ref_all) = _quickstart(
        rad_tpu, RefStore, library, tmp_path, backend="exact")
    index, (best, all_mols) = _quickstart(rad_tpu_torch, SQLiteSmilesStore,
                                          library, tmp_path)
    for a, b in zip(ref_index.graph.neighbors, index.graph.neighbors):
        np.testing.assert_array_equal(np.asarray(a), b)
    assert len(best) == 10 and best[0][2].startswith("SMILES_")
    assert best == ref_best
    assert all_mols == ref_all


def test_search_exact_matches_reference(library):
    keys, fps, _, _ = library
    ref = rad_tpu.HNSWIndex(ndim=1024, connectivity=8)
    port = rad_tpu_torch.HNSWIndex(ndim=1024, connectivity=8, device="cpu")
    for idx in (ref, port):
        idx.add(keys, fps)
    ref.build(backend="exact")
    rd, rk = ref.search(fps[:5], k=10, exact=True)
    d, k = port.search(fps[:5], k=10, exact=True)
    np.testing.assert_array_equal(d, rd)
    np.testing.assert_array_equal(k, rk)
    assert k[0, 0] == keys[0] and d[0, 0] == 0
    with pytest.raises(NotImplementedError, match="The native host path"):
        port.search(fps[:5], k=10, backend="native")
    with pytest.raises(NotImplementedError, match="The native host path"):
        rad_tpu_torch.HNSWIndex(device="cpu").build(backend="native")
    # the batched beam builder is ported: an empty index refuses it as
    # it refuses every backend, for want of vectors
    with pytest.raises(RuntimeError, match="no vectors added"):
        rad_tpu_torch.HNSWIndex(device="cpu").build(backend="device")


def test_traverser_views(library):
    keys, fps, _, table = library
    index = rad_tpu_torch.HNSWIndex(ndim=1024, connectivity=8, device="cpu")
    index.add(keys, fps)
    t = rad_tpu_torch.create_local_traverser(
        index, lambda s: table[f"SMILES_{s}"], n_score_threads=2,
        batch_size=4)
    assert t.engine == "device" and str(t._device_engine.device) == \
        str(index.device)
    t.prime()
    n_top = index.graph.layer_sizes[-1]
    assert len(t.scored_set) == n_top
    assert (0, max(0, index.max_level - 1)) in t.visited_set
    stats = t.traverse(n_to_score=50)
    assert stats["n_scored"] >= 50
    first = t.get_molecules(1)[0]
    assert t.scored_set.getScore(first[0]) == first[1]
    assert len(t.priority_queue) == t.get_traversal_stats()["device"][
        "frontier_size"]
    assert t.priority_queue.peek_score() is not None
    assert len(t.visited_set) >= len(t.scored_set) - n_top
    with pytest.raises(ValueError, match="does not accept"):
        t.traverse(n_to_score=60, bogus=1)
    t.shutdown()
    with pytest.raises(RuntimeError):
        t.prime()


def _built(pkg, library, log=False):
    keys, fps, _, _ = library
    on_cpu = {"device": "cpu"} if pkg is rad_tpu_torch else {}
    index = pkg.HNSWIndex(ndim=1024, connectivity=8, **on_cpu)
    index.add(keys, fps, log=log)
    index.build(**({} if pkg is rad_tpu_torch else {"backend": "exact"}))
    return index


@pytest.fixture(scope="module")
def indexes(library):
    return {pkg: _built(pkg, library) for pkg in (rad_tpu, rad_tpu_torch)}


@pytest.mark.parametrize("log", ["Building HNSW", True])
def test_add_takes_log_like_the_reference(library, indexes, log, caplog):
    """RAD's notebook call ``hnsw.add(keys, fps, log="Building HNSW")``:
    accepted by both packages, logs what was queued, and builds the graph
    that ``log=False`` builds."""
    for pkg in (rad_tpu, rad_tpu_torch):
        with caplog.at_level("INFO", logger=pkg.__name__ + ".api.index"):
            caplog.clear()
            logged = _built(pkg, library, log=log)
            assert any("queued 300 vectors" in r.getMessage()
                       for r in caplog.records), pkg.__name__
        for a, b in zip(logged.graph.neighbors, indexes[pkg].graph.neighbors):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    for a, b in zip(indexes[rad_tpu].graph.neighbors,
                    indexes[rad_tpu_torch].graph.neighbors):
        np.testing.assert_array_equal(np.asarray(a), b)


@pytest.mark.parametrize("call", ["keywords", "positional", "all-keywords"])
def test_traverse_takes_the_reference_signature(library, indexes, call):
    """``traverse(n_workers, timeout, n_to_score, poll_interval)`` in the
    reference's order (docs/MIGRATION.md calls ``traverse(n_workers=4,
    n_to_score=...)``), ``prime(**kwargs)`` and ``shutdown(**kwargs)``:
    both packages score the same molecules in the same order."""
    _, _, _, table = library

    def run(pkg):
        t = pkg.create_local_traverser(
            indexes[pkg], lambda s: table[f"SMILES_{s}"], n_score_threads=1,
            batch_size=4)
        t.prime(foo=1)
        if call == "keywords":
            stats = t.traverse(n_workers=4, n_to_score=80)
        elif call == "positional":
            stats = t.traverse(None, None, 80)
        else:
            stats = t.traverse(n_workers=2, timeout=60.0, n_to_score=80,
                               poll_interval=0.05)
        mols = t.get_molecules()
        t.shutdown(foo=1)
        t.shutdown()
        return stats["n_scored"], mols

    n_ref, ref = run(rad_tpu)
    n, mols = run(rad_tpu_torch)
    assert n >= 80 and n == n_ref
    assert mols == ref


def test_resolve_device_says_when_it_picks_the_cpu(monkeypatch):
    """The CPU runs only when named; with no card and no device the call
    raises and says how to ask for the CPU."""
    import torch
    from rad_tpu_torch.api.index import resolve_device
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert resolve_device("cpu").type == "cpu"
    with pytest.raises(RuntimeError, match='device="cpu"'):
        resolve_device(None)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert resolve_device(None) == torch.device("cuda:0")


def test_load_exclude_vectors(library, tmp_path):
    """``HNSWIndex.load(path, exclude_vectors=True)`` (docs/MIGRATION.md)
    returns an index on both packages: the keyword is accepted and
    unused."""
    keys, fps, _, _ = library
    port = rad_tpu_torch.HNSWIndex(ndim=1024, connectivity=8, device="cpu")
    port.add(keys, fps)
    path = str(tmp_path / "index.npz")
    port.save(path)
    ref = rad_tpu.HNSWIndex.load(path, view=True, exclude_vectors=True)
    got = rad_tpu_torch.HNSWIndex.load(path, view=True, exclude_vectors=True,
                                       device="cpu")
    assert isinstance(got, rad_tpu_torch.HNSWIndex) and len(got) == len(ref)
    assert got.connectivity == ref.connectivity == 8
    for a, b in zip(ref.graph.neighbors, got.graph.neighbors):
        np.testing.assert_array_equal(np.asarray(a), b)
    _, k = got.search(fps[:3], k=5)
    assert k[:, 0].tolist() == keys[:3].tolist()


def _index_graph(library):
    keys, fps, _, table = library
    index = rad_tpu_torch.HNSWIndex(ndim=1024, connectivity=8, device="cpu")
    index.add(keys, fps)
    return index.graph, (lambda s: table[s])


@pytest.mark.parametrize("kw", [
    {"namespace": "x"}, {"n_workers": 2}, {"worker_timeout": 5.0},
    {"heartbeat_interval": 1.0}], ids=lambda kw: next(iter(kw)))
def test_traverser_takes_the_reference_keywords(library, kw):
    """The reference's host-engine keywords build a local traverser on
    both packages (inert on the device engine)."""
    graph, score = _index_graph(library)
    ref = rad_tpu.RADTraverser(graph=graph, scoring_fn=score, **kw)
    t = rad_tpu_torch.RADTraverser(graph=graph, scoring_fn=score,
                                   device="cpu", **kw)
    assert t.engine == ref.engine == "device"
    assert t.namespace == ref.namespace
    t.shutdown()
    ref.shutdown()


def test_traverser_drops_redis_keywords_with_a_warning(library, caplog):
    graph, score = _index_graph(library)
    for pkg, on_cpu in ((rad_tpu, {}), (rad_tpu_torch, {"device": "cpu"})):
        caplog.clear()
        with caplog.at_level(logging.WARNING):
            t = pkg.RADTraverser(graph=graph, scoring_fn=score,
                                 redis_host="localhost", redis_port=6379,
                                 **on_cpu)
        warned = [r.getMessage() for r in caplog.records
                  if r.levelno == logging.WARNING]
        assert any("redis_host ignored" in m for m in warned), pkg
        assert any("redis_port ignored" in m for m in warned), pkg
        t.shutdown()


def test_traverser_rejects_unknown_keywords(library):
    graph, score = _index_graph(library)
    for pkg, on_cpu in ((rad_tpu, {}), (rad_tpu_torch, {"device": "cpu"})):
        with pytest.raises(TypeError, match="not_an_option"):
            pkg.RADTraverser(graph=graph, scoring_fn=score, not_an_option=1,
                             **on_cpu)


def test_entry_points_default_to_the_card(library, monkeypatch):
    """With no card visible, the entry points given no device raise
    instead of running on the CPU."""
    import torch
    from rad_tpu_torch.build.exact import build_hnsw_exact
    _, fps, _, _ = library
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        rad_tpu_torch.HNSWIndex()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_hnsw_exact(fps[:64])


def test_port_never_loads_jax():
    """A fresh interpreter runs a tiny quick start on the port, imports
    its benchmark and command-line entry points, runs a 30-scored
    distributed traversal and one neighbor fetch over loopback HTTP, and
    must not have imported jax, rad_tpu, the repo's benchmarks or
    requests."""
    code = textwrap.dedent("""
        import sys
        import numpy as np
        from rad_tpu_torch import HNSWIndex, create_local_traverser
        from rad_tpu_torch.fp import random_fingerprints
        from rad_tpu_torch.store import InMemorySmilesStore
        fps = random_fingerprints(120, n_bits=128, seed=1)
        index = HNSWIndex(ndim=128, connectivity=4, device="cpu")
        index.add(np.arange(120), fps)
        index.build()
        store = InMemorySmilesStore({i: f"M{i}" for i in range(120)})
        t = create_local_traverser(index, lambda s: float(s[1:]) % 7.5,
                                   smiles_store=store, n_score_threads=1)
        t.prime()
        t.traverse(n_to_score=30)
        assert len(t.get_best_molecules(5)) == 5
        t.shutdown()
        assert index.search(fps[:3], k=3)[1].shape == (3, 3)
        import rad_tpu_torch.bench, rad_tpu_torch.bench_kernel_variants
        import rad_tpu_torch.bench_scalar_probe, rad_tpu_torch.graph.adjpack
        import rad_tpu_torch.traverse.multi, rad_tpu_torch.traverse.spill
        import rad_tpu_torch.bench_mma_rate, rad_tpu_torch.bench_candidates
        import rad_tpu_torch.bench_prefix, rad_tpu_torch.utils.profiling
        import rad_tpu_torch.build.reference
        import rad_tpu_torch.scripts.build_index
        import rad_tpu_torch.scripts.start_hnsw_server
        import threading
        from rad_tpu_torch import create_distributed_traverser
        from rad_tpu_torch.server import create_hnsw_server
        from rad_tpu_torch.service import create_remote_hnsw_service
        from rad_tpu_torch.traverse import CoordinationService
        d = create_distributed_traverser(index, lambda s: float(s[1:]) % 7.5,
                                         smiles_store=store, n_workers=2)
        d.prime()
        d.traverse(n_to_score=30, poll_interval=0.01)
        assert len(d.get_best_molecules(5)) == 5
        d.shutdown()
        srv, app = create_hnsw_server(index.graph, port=0,
                                      smiles_store=store)
        threading.Thread(target=srv.serve_forever, daemon=True).start()
        remote = create_remote_hnsw_service(
            f"http://127.0.0.1:{srv.server_address[1]}", register=False)
        assert remote.get_neighbors(0, 0)[1].startswith("M")
        remote.shutdown()
        srv.shutdown()
        bad = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib", "rad_tpu",
                                            "bench", "benchmarks",
                                            "requests"))
        assert not bad, bad
        print("isolated")
    """)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "isolated" in proc.stdout


def test_package_data_ships_every_cuda_source():
    """An installed (non-editable) rad_tpu_torch builds its kernels from the
    package's own files: every file under ``csrc/`` and ``probes/`` (the
    ``.cu`` sources and the ``.cuh`` headers they include) matches a
    package-data glob of ``pyproject.toml``."""
    import fnmatch
    import tomllib
    from pathlib import Path

    with open(os.path.join(REPO, "pyproject.toml"), "rb") as f:
        globs = tomllib.load(f)["tool"]["setuptools"]["package-data"][
            "rad_tpu_torch"]
    pkg = Path(REPO) / "rad_tpu_torch"
    files = [p.relative_to(pkg).as_posix() for d in ("csrc", "probes")
             for p in sorted((pkg / d).iterdir()) if p.is_file()]
    assert any(f.endswith(".cuh") for f in files)
    assert [f for f in files
            if not any(fnmatch.fnmatch(f, g) for g in globs)] == []
