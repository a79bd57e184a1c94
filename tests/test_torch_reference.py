"""rad_tpu_torch's host (numpy) builder and search against rad_tpu's.

``build_hnsw`` must give edge-identical graphs (keys, levels and every
layer) on the cases of tests/test_graph.py, with the paper's candidate
extension on and off; ``search_hnsw`` array-equal results on
tests/test_search.py's fixture; the neighbor heuristic the same picks by
its one-matrix path and by a distance call per candidate; and
``HNSWIndex.build(backend="host")`` the reference's graph. The port's
beam search on that graph agrees with the host search within the
reference's own bar (mean top-5 distance within 0.02).
"""

import numpy as np
import pytest

import rad_tpu
import rad_tpu_torch
from rad_tpu.build import reference as ref_reference
from rad_tpu.fp import random_fingerprints
from rad_tpu_torch.build import reference
from rad_tpu_torch.search.knn import search_device


def _assert_same_graph(ref, port, what):
    assert ref.layer_sizes == port.layer_sizes, what
    for name in ("keys", "levels", "packed", "popcounts"):
        np.testing.assert_array_equal(np.asarray(getattr(ref, name)),
                                      getattr(port, name),
                                      err_msg=f"{what}: {name}")
    for l, (a, b) in enumerate(zip(ref.neighbors, port.neighbors)):
        np.testing.assert_array_equal(np.asarray(a), b,
                                      err_msg=f"{what}: layer {l}")
    assert (ref.ndim, ref.connectivity) == (port.ndim, port.connectivity)


@pytest.fixture(scope="module")
def search_case():
    """tests/test_search.py's fixture, built by both packages."""
    fps = random_fingerprints(400, n_bits=256, density=0.2, seed=21)
    kw = dict(connectivity=8, expansion_add=60, seed=3)
    ref = ref_reference.build_hnsw(fps, **kw)
    port = reference.build_hnsw(fps, **kw)
    queries = random_fingerprints(16, n_bits=256, density=0.2, seed=77)
    return ref, port, queries


@pytest.mark.parametrize("extend", [False, True])
def test_build_hnsw_edge_identical(extend):
    """tests/test_graph.py's small graph (200 x 64 bits, M 8, efC 40)."""
    fps = random_fingerprints(200, n_bits=64, density=0.3, seed=42)
    kw = dict(connectivity=8, expansion_add=40, seed=0,
              extend_candidates=extend)
    _assert_same_graph(ref_reference.build_hnsw(fps, **kw),
                       reference.build_hnsw(fps, **kw), f"extend={extend}")


def test_build_hnsw_keys_and_ndim_edge_identical():
    """User keys, ndim, a small beam and M 6 (the storage tests' case)."""
    fps = random_fingerprints(300, n_bits=128, density=0.2, seed=12)
    keys = np.arange(300, dtype=np.int64) * 3 + (1 << 35)
    kw = dict(keys=keys, connectivity=6, expansion_add=24, seed=4, ndim=120)
    _assert_same_graph(ref_reference.build_hnsw(fps, **kw),
                       reference.build_hnsw(fps, **kw), "keys")


def test_search_fixture_edge_identical(search_case):
    ref, port, _ = search_case
    _assert_same_graph(ref, port, "search fixture")


@pytest.mark.parametrize("k,ef", [(10, 64), (5, 16), (1, 32)])
def test_search_hnsw_array_equal(search_case, k, ef):
    ref, port, queries = search_case
    rd, ri = ref_reference.search_hnsw(ref, queries, k=k,
                                       expansion_search=ef)
    d, i = reference.search_hnsw(port, queries, k=k, expansion_search=ef)
    np.testing.assert_array_equal(d, rd)
    np.testing.assert_array_equal(i, ri)
    assert d.dtype == np.float32 and i.dtype == np.int64


def test_device_search_agrees_with_host_search(search_case):
    """tests/test_search.py's quality bar, on the port's two searches."""
    _, port, queries = search_case
    d_dev, _ = search_device(port, queries, k=5, expansion_search=64,
                             device="cpu")
    d_host, _ = reference.search_hnsw(port, queries, k=5,
                                      expansion_search=64)
    assert abs(float(d_dev.mean()) - float(np.mean(d_host))) < 0.02


@pytest.mark.parametrize("n_cand,m", [(33, 32), (40, 8), (300, 16)])
def test_select_neighbors_heuristic_same_picks(n_cand, m, monkeypatch):
    """Both of the port's routes (blocks of candidate distances for a
    _TanimotoDist, at the default block and at 7 rows a block; a call per
    candidate for any other distance) pick what the reference picks,
    with quantized distances that tie."""
    fps = random_fingerprints(400, n_bits=64, density=0.3, seed=n_cand)
    rng = np.random.default_rng(m)
    ids = rng.choice(np.arange(1, 400), n_cand, replace=False)
    ref_dist = ref_reference._TanimotoDist(fps)
    dist = reference._TanimotoDist(fps)
    cand = list(zip(dist(0, ids).tolist(), ids.tolist()))
    want = ref_reference.select_neighbors_heuristic(ref_dist, 0, cand, m)
    assert reference.select_neighbors_heuristic(dist, 0, cand, m) == want
    # a plain callable takes the call-per-candidate route
    assert reference.select_neighbors_heuristic(
        lambda q, i: dist(q, i), 0, cand, m) == want
    assert reference.select_neighbors_heuristic(
        dist, 0, cand, m, keep_pruned=False) == \
        ref_reference.select_neighbors_heuristic(ref_dist, 0, cand, m,
                                                 keep_pruned=False)
    monkeypatch.setattr(reference, "_PAIRWISE_ROWS", 7)
    assert reference.select_neighbors_heuristic(dist, 0, cand, m) == want
    np.testing.assert_array_equal(dist(int(ids[3]), ids[:20]),
                                  ref_dist(int(ids[3]), ids[:20]))
    np.testing.assert_array_equal(dist.pairwise(ids[:20], ids[:20])[3],
                                  dist(int(ids[3]), ids[:20]))


def test_index_build_host_equals_reference():
    fps = random_fingerprints(250, n_bits=128, density=0.25, seed=5)
    keys = np.arange(250, dtype=np.int64) + 900
    ref = rad_tpu.HNSWIndex(ndim=128, connectivity=6, expansion_add=32,
                            seed=2)
    port = rad_tpu_torch.HNSWIndex(ndim=128, connectivity=6,
                                   expansion_add=32, seed=2, device="cpu")
    for idx in (ref, port):
        idx.add(keys, fps)
    _assert_same_graph(ref.build(backend="host"),
                       port.build(backend="host"), "HNSWIndex host")
    rd, rk = ref.search(fps[:4], k=5)
    d, k = port.search(fps[:4], k=5)
    np.testing.assert_array_equal(d, np.asarray(rd))
    np.testing.assert_array_equal(k, rk)
