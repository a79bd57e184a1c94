"""rad_tpu_torch's beam search and visited sets against rad_tpu's (CPU).

Both packages build the same graph (edge-identical builders), then search
it with the same queries: distances and node ids must be array-equal, with
the dense visited map and with the hash table (forced by a zero
``DENSE_VISITED_BUDGET``, as tests/test_visited.py does), at two beam
widths and on a single-layer graph. The hash table's contents and ``seen``
masks must be array-equal after colliding inserts. The ``gpu`` test runs
the search on the card against the CPU.
"""

import dataclasses
import os
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import rad_tpu
import rad_tpu_torch
from rad_tpu.build.exact import build_hnsw_exact as ref_build
from rad_tpu.fp import random_fingerprints
from rad_tpu.search import knn as ref_knn
from rad_tpu.search import visited as ref_visited
from rad_tpu_torch.build.exact import build_hnsw_exact
from rad_tpu_torch.search import knn, visited

sys.path.insert(0, os.path.join(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__))), "examples"))


@pytest.fixture(scope="module")
def graphs():
    from enrichment_example import make_library
    fps = make_library(3000, 256, seed=5)[0]
    ref = ref_build(fps, connectivity=8, seed=1)
    port = build_hnsw_exact(fps, connectivity=8, seed=1, device="cpu")
    for a, b in zip(ref.neighbors, port.neighbors):
        np.testing.assert_array_equal(np.asarray(a), b)
    assert port.max_level >= 2
    rng = np.random.default_rng(3)
    # library members (distance-0 hits) and random rows
    queries = np.concatenate([
        fps[rng.choice(len(fps), 200, replace=False)],
        random_fingerprints(56, n_bits=256, density=0.15, seed=9)])
    return fps, ref, port, queries


@pytest.mark.parametrize("hashed", [False, True])
@pytest.mark.parametrize("ef", [16, 64])
def test_search_device_array_equal(graphs, monkeypatch, ef, hashed):
    _, ref, port, queries = graphs
    if hashed:
        monkeypatch.setattr(ref_visited, "DENSE_VISITED_BUDGET", 0)
        monkeypatch.setattr(visited, "DENSE_VISITED_BUDGET", 0)
    rd, ri = ref_knn.search_device(ref, queries, k=10, expansion_search=ef)
    d, i = knn.search_device(port, queries, k=10, expansion_search=ef,
                             device="cpu")
    assert d.shape == (len(queries), 10) and i.dtype == torch.int32
    np.testing.assert_array_equal(d.numpy(), np.asarray(rd))
    np.testing.assert_array_equal(i.numpy(), np.asarray(ri))


def test_search_single_layer_and_chunks(graphs):
    """max_level 0 (the beam starts at node 0 with no descent), an explicit
    hash capacity, and query chunks with a padded last chunk."""
    _, ref, port, queries = graphs
    ref0 = dataclasses.replace(ref, neighbors=ref.neighbors[:1],
                               levels=jnp.zeros_like(ref.levels))
    port0 = dataclasses.replace(port, neighbors=port.neighbors[:1],
                                levels=np.zeros_like(port.levels))
    assert port0.max_level == 0
    kw = dict(k=5, expansion_search=32, chunk_size=96, visited_capacity=1024)
    rd, ri = ref_knn.search_device(ref0, queries, **kw)
    d, i = knn.search_device(port0, queries, device="cpu", **kw)
    np.testing.assert_array_equal(d.numpy(), np.asarray(rd))
    np.testing.assert_array_equal(i.numpy(), np.asarray(ri))


def test_index_search_matches_reference(graphs):
    fps, _, _, queries = graphs
    keys = np.arange(len(fps), dtype=np.int64) * 3 + 11
    ref = rad_tpu.HNSWIndex(ndim=256, connectivity=8, expansion_search=40)
    port = rad_tpu_torch.HNSWIndex(ndim=256, connectivity=8,
                                   expansion_search=40, device="cpu")
    for idx in (ref, port):
        idx.add(keys, fps)
    ref.build(backend="exact")
    for ef in (None, 80):
        rd, rk = ref.search(queries, k=10, expansion_search=ef)
        d, k = port.search(queries, k=10, expansion_search=ef)
        np.testing.assert_array_equal(d, np.asarray(rd))
        np.testing.assert_array_equal(k, rk)
    assert k.dtype == np.int64 and k[0, 0] in keys
    with pytest.raises(NotImplementedError, match="Queue 1 item 8"):
        port.search(queries, prefix_filter=128)
    with pytest.raises(NotImplementedError, match="Queue 1 item 4"):
        knn.search_device(port.graph, queries, packed_adjacency=True,
                          device="cpu")


@pytest.mark.parametrize("cap,probes", [(16, 4), (64, 4), (64, 2)])
def test_hashset_array_equal_after_colliding_inserts(cap, probes):
    """Rounds of inserts into a small table: duplicate ids, invalid lanes,
    same-slot collisions inside one call (max wins) and full probe runs
    (fail open) — table and ``seen`` equal to the reference's."""
    rng = np.random.default_rng(cap + probes)
    ref_t = ref_visited.hashset_init(cap)
    t = visited.hashset_init(cap, device="cpu")
    assert t.shape == (cap + 1,)
    for _ in range(6):
        ids = rng.integers(0, 5 * cap, size=24).astype(np.int32)
        ids[rng.random(24) < 0.2] = ids[0]
        valid = rng.random(24) < 0.85
        ref_t, ref_seen = ref_visited.hashset_check_insert(
            ref_t, jnp.asarray(ids), jnp.asarray(valid), probes=probes)
        t, seen = visited.hashset_check_insert(
            t, torch.from_numpy(ids), torch.from_numpy(valid), probes=probes)
        np.testing.assert_array_equal(t[:-1].numpy(), np.asarray(ref_t))
        np.testing.assert_array_equal(seen.numpy(), np.asarray(ref_seen))
    # batched: each row its own table
    ids = rng.integers(0, 4 * cap, size=(3, 20)).astype(np.int32)
    valid = rng.random((3, 20)) < 0.9
    rb, rs = ref_visited.hashset_check_insert_batch(
        jnp.full((3, cap), -1, jnp.int32), jnp.asarray(ids),
        jnp.asarray(valid), probes=probes)
    tb, sb = visited.hashset_check_insert_batch(
        visited.hashset_init(cap, batch=3, device="cpu"), torch.from_numpy(ids),
        torch.from_numpy(valid), probes=probes)
    np.testing.assert_array_equal(tb[:, :-1].numpy(), np.asarray(rb))
    np.testing.assert_array_equal(sb.numpy(), np.asarray(rs))


def test_visited_sizing_helpers(monkeypatch):
    for ef, m0, n in ((16, 32, None), (128, 32, 10_000_000), (64, 16, 300),
                      (1, 1, 1)):
        assert visited.visited_capacity_for(ef, m0, n) == \
            ref_visited.visited_capacity_for(ef, m0, n)
    assert visited.use_dense_visited(500, 1_000_000) == \
        ref_visited.use_dense_visited(500, 1_000_000)
    assert not visited.use_dense_visited(500, 10_000_000)
    monkeypatch.setattr(visited, "DENSE_VISITED_BUDGET", 0)
    assert not visited.use_dense_visited(1, 1)


@pytest.mark.gpu
def test_cuda_search_equals_cpu_search(graphs, monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    _, _, port, queries = graphs
    for budget in (visited.DENSE_VISITED_BUDGET, 0):
        monkeypatch.setattr(visited, "DENSE_VISITED_BUDGET", budget)
        for ef in (16, 64):
            d, i = knn.search_device(port, queries, k=10,
                                     expansion_search=ef, device="cpu")
            dg, ig = knn.search_device(port, queries, k=10,
                                       expansion_search=ef, device="cuda")
            assert torch.equal(dg.cpu(), d) and torch.equal(ig.cpu(), i)
