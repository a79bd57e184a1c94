"""rad_tpu_torch's beam search and visited sets against rad_tpu's (CPU).

Both packages build the same graph (edge-identical builders), then search
it with the same queries: distances and node ids must be array-equal, with
the dense visited map and with the hash table (forced by a zero
``DENSE_VISITED_BUDGET``, as tests/test_visited.py does), at two beam
widths and on a single-layer graph. The hash table's contents and ``seen``
masks must be array-equal after colliding inserts. The two-stage prefix
screen is held to the reference at 64, 128 and 256 prefix bits, keeping
all of a wave or a quarter, dense and hashed, and over the packed
adjacency; on a clustered library, keeping all gives the unscreened
distances and a quarter keeps >= 0.9 of the unscreened ids, and where
keeping all moves a result on a library whose distances tie often,
``bench_prefix.full_keep_witness`` finds the tie (and reports a fault
put into the screened waves). The ``gpu`` test runs the search on the
card against the CPU.
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
    rd, rk = ref.search(queries, k=10, prefix_filter=128)
    d, k = port.search(queries, k=10, prefix_filter=128)
    np.testing.assert_array_equal(d, np.asarray(rd))
    np.testing.assert_array_equal(k, rk)
    for ef in (None, 80):      # the native host search, same graph
        rd, rk = ref.search(queries, k=10, expansion_search=ef,
                            backend="native")
        d, k = port.search(queries, k=10, expansion_search=ef,
                           backend="native")
        np.testing.assert_array_equal(d, rd)
        np.testing.assert_array_equal(k, rk)
    d_p, i_p = knn.search_device(port.graph, queries, packed_adjacency=True,
                                 device="cpu")
    d_u, i_u = knn.search_device(port.graph, queries, device="cpu")
    np.testing.assert_array_equal(d_p.numpy(), d_u.numpy())
    np.testing.assert_array_equal(i_p.numpy(), i_u.numpy())


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


E, M0 = 4, 16   # the search's expand width, the fixture graph's layer-0 row


@pytest.mark.parametrize("pf,keep,hashed", [
    (64, E * M0, False), (128, E * M0 // 4, False), (256, E * M0, True),
    (128, None, True), (256, E * M0 // 4, False), (64, E * M0 // 4, True)])
def test_prefix_screen_array_equal(graphs, monkeypatch, pf, keep, hashed):
    _, ref, port, queries = graphs
    if hashed:
        monkeypatch.setattr(ref_visited, "DENSE_VISITED_BUDGET", 0)
        monkeypatch.setattr(visited, "DENSE_VISITED_BUDGET", 0)
    kw = dict(k=10, expansion_search=32, expand_width=E, prefix_filter=pf,
              prefix_keep=keep)
    rd, ri = ref_knn.search_device(ref, queries, **kw)
    d, i = knn.search_device(port, queries, device="cpu", **kw)
    np.testing.assert_array_equal(d.numpy(), np.asarray(rd))
    np.testing.assert_array_equal(i.numpy(), np.asarray(ri))
    # the prefix copy is cached per device and width
    assert ("cpu", max(1, pf // 32)) in port.__dict__["_prefix_prep"]


def test_prefix_screen_over_packed_adjacency(graphs):
    _, ref, port, queries = graphs
    kw = dict(k=8, expansion_search=48, prefix_filter=64)
    rd, ri = ref_knn.search_device(ref, queries, packed_adjacency=True, **kw)
    d_p, i_p = knn.search_device(port, queries, packed_adjacency=True,
                                 device="cpu", **kw)
    d_u, i_u = knn.search_device(port, queries, device="cpu", **kw)
    np.testing.assert_array_equal(d_p.numpy(), np.asarray(rd))
    np.testing.assert_array_equal(i_p.numpy(), np.asarray(ri))
    np.testing.assert_array_equal(d_p.numpy(), d_u.numpy())
    np.testing.assert_array_equal(i_p.numpy(), i_u.numpy())


def test_prefix_screen_properties():
    """tests/test_search.py's properties, on the port alone: on a
    clustered analog library, keeping every candidate of a wave gives the
    unscreened distances (and over the full width the unscreened ids too),
    and a 128-bit screen keeping a quarter keeps >= 0.9 of the unscreened
    ids."""
    from enrichment_example import make_library
    fps, _, _ = make_library(4000, 1024, seed=11)
    g = build_hnsw_exact(fps, connectivity=8, seed=2, device="cpu")
    rng = np.random.default_rng(3)
    queries = np.asarray(g.packed)[rng.choice(4000, 24, replace=False)]
    m0, kw = 16, dict(k=10, expansion_search=48, expand_width=E,
                      device="cpu")
    d0, i0 = knn.search_device(g, queries, **kw)
    d1, _ = knn.search_device(g, queries, prefix_filter=128,
                              prefix_keep=E * m0, **kw)
    np.testing.assert_array_equal(d1.numpy(), d0.numpy())
    # over the full width the screen's order is the distance order, so
    # keeping the whole wave is the unscreened search, ties included
    d3, i3 = knn.search_device(g, queries, prefix_filter=1024,
                               prefix_keep=E * m0, **kw)
    np.testing.assert_array_equal(d3.numpy(), d0.numpy())
    np.testing.assert_array_equal(i3.numpy(), i0.numpy())
    _, i2 = knn.search_device(g, queries, prefix_filter=128,
                              prefix_keep=E * m0 // 4, **kw)
    i0, i2 = i0.numpy(), i2.numpy()
    overlap = np.mean([len(set(i2[q].tolist()) & set(i0[q].tolist())) / 10
                       for q in range(len(queries))])
    assert overlap >= 0.9, overlap


def test_full_keep_witness_explains_moves_by_ties(monkeypatch):
    """On 128-bit rows, whose distances tie often, the 32-bit screen that
    keeps the whole wave moves some results; the witness replays both
    searches and finds a tie at each query where the two first expand
    different ids, and no fault. A stage 2 that drops one candidate of
    each screened wave is reported as a fault."""
    from rad_tpu_torch.bench_prefix import full_keep_witness

    fps = random_fingerprints(3000, n_bits=128, density=0.2, seed=5)
    g = build_hnsw_exact(fps, connectivity=8, seed=2, device="cpu")
    queries = fps[np.random.default_rng(3).choice(3000, 64, replace=False)]
    res, (da, ia), (db, ib) = full_keep_witness(g, queries, 32, 10, 32, E,
                                                "cpu")
    d0, i0 = knn.search_device(g, queries, k=10, expansion_search=32,
                               expand_width=E, device="cpu")
    np.testing.assert_array_equal(da, d0.numpy())
    np.testing.assert_array_equal(ia, i0.numpy())
    assert not all(r["same"] for r in res)
    assert any(r["tie"] for r in res)
    for r in res:
        assert r["fault"] is None, r
        assert (r["step"] is None) == (r["tie"] is None), r

    query_dist, state = knn._query_dist, {"screen": False}

    def lossy(q, q_pop, packed, pops, ids, valid):
        if q.shape[1] < fps.shape[1]:
            state["screen"] = True          # a stage-1 call: screened run
        elif state["screen"] and ids.shape[1] > 1:
            valid = valid.clone()
            first = valid.int().argmax(1)
            valid[torch.arange(len(valid)), first] = False
        return query_dist(q, q_pop, packed, pops, ids, valid)

    monkeypatch.setattr(knn, "_query_dist", lossy)
    res, _, _ = full_keep_witness(g, queries, 32, 10, 32, E, "cpu")
    assert all(r["fault"] is not None for r in res)
