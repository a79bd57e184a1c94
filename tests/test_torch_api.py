"""The README quick start on both packages, and the port's isolation
from JAX.

rad_tpu builds with its exact backend (what ``backend="auto"`` picks on an
accelerator); both graphs go through ``.npz`` save/load, then
``create_local_traverser`` → ``prime`` → ``traverse`` →
``get_best_molecules`` must return the same molecules.
"""

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
    with pytest.raises(NotImplementedError, match="Queue 1 item 8"):
        port.search(fps[:5], k=10, backend="native")
    with pytest.raises(NotImplementedError):
        rad_tpu_torch.HNSWIndex(device="cpu").build(backend="native")


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
    """A fresh interpreter runs a tiny quick start on the port and imports
    its benchmark entry points, and must not have imported jax, rad_tpu or
    the repo's benchmarks."""
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
        bad = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib", "rad_tpu",
                                            "bench", "benchmarks"))
        assert not bad, bad
        print("isolated")
    """)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "isolated" in proc.stdout
