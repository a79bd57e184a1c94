"""rad_tpu_torch's partition-and-stitch builder against rad_tpu's (CPU).

``build_hnsw_partitioned`` must give edge-identical graphs (keys, levels
and every layer) on the cases of tests/test_partition.py: 600 x 256 bits
in 4 shards with the host and the exact shard builders, a 200-row slice
with the batched beam builder (dense and hashed visited sets), the plain
top-cap merge (``heuristic=False``), one shard, more shards than rows,
user keys, and ``builder_kwargs`` routing the exact shards through the
cluster-probed stage. The merge is held alone too, on edges whose
distances tie, with and without the heuristic. The ``gpu`` test builds on
the card against the CPU.
"""

import os
import sys

import numpy as np
import pytest
import torch

from rad_tpu.build import partition as ref_partition
from rad_tpu.fp import random_fingerprints
from rad_tpu_torch.build import partition
from rad_tpu_torch.build.reference import build_hnsw
from rad_tpu_torch.search.knn import search_device
from test_torch_build_device import force_hashed
from test_torch_reference import _assert_same_graph

N_SHARDS = 4


def both(packed, **kw):
    return (ref_partition.build_hnsw_partitioned(packed, **kw),
            partition.build_hnsw_partitioned(packed, device="cpu", **kw))


@pytest.fixture(scope="module")
def fps():
    return random_fingerprints(600, n_bits=256, density=0.2, seed=17)


@pytest.fixture(scope="module")
def part_graph(fps):
    return both(fps, n_shards=N_SHARDS, connectivity=8, expansion_add=48,
                seed=3, builder="host")


def test_partitioned_host_edge_identical(part_graph):
    _assert_same_graph(*part_graph, "600 rows, 4 host shards")


def test_partitioned_graph_valid(part_graph, fps):
    """tests/test_partition.py's properties, on the port's graph: valid
    tables, the key identity model, cross-shard edges on every layer, and
    recall@10 at ef 128 of at least 0.9 against brute force."""
    g = part_graph[1]
    assert (np.diff(g.levels) <= 0).all()
    shard = g.keys % N_SHARDS
    for l, t in enumerate(g.neighbors):
        assert t.shape == (g.layer_sizes[l], 2 * 8 if l == 0 else 8)
        assert (t[t >= 0] < g.layer_sizes[l]).all()
        assert (t != np.arange(t.shape[0])[:, None]).all(), "self loops"
        for r in range(0, t.shape[0], 23):
            row = t[r][t[r] >= 0]
            assert len(row) == len(set(row.tolist())), "duplicate edges"
        valid = t >= 0
        if valid.any():
            cross = (shard[np.maximum(t, 0)] != shard[:t.shape[0], None])
            assert (cross & valid).sum() / valid.sum() > 0.15, l
    assert sorted(g.keys.tolist()) == list(range(len(fps)))
    np.testing.assert_array_equal(g.packed, fps[g.keys])
    queries = random_fingerprints(24, n_bits=256, density=0.2, seed=71)
    from rad_tpu_torch.fp.kernels import tanimoto_matrix
    full = tanimoto_matrix(torch.from_numpy(queries.view(np.int32)),
                           torch.from_numpy(g.packed.view(np.int32))).numpy()
    truth = np.argsort(full, axis=1, kind="stable")[:, :10]
    _, ids = search_device(g, queries, k=10, expansion_search=128,
                           device="cpu")
    ids = ids.numpy()
    assert np.mean([len(set(ids[i].tolist()) & set(truth[i].tolist())) / 10
                    for i in range(24)]) >= 0.9


def test_partitioned_exact_builder_edge_identical(fps):
    stage_times = {}
    ref = ref_partition.build_hnsw_partitioned(
        fps, n_shards=N_SHARDS, connectivity=8, expansion_add=48, seed=3,
        builder="exact")
    port = partition.build_hnsw_partitioned(
        fps, n_shards=N_SHARDS, connectivity=8, expansion_add=48, seed=3,
        builder="exact", device="cpu", stage_times=stage_times)
    _assert_same_graph(ref, port, "600 rows, 4 exact shards")
    assert set(stage_times) == {"sub_builds", "stitch_search", "merge",
                                "stitch_upper"}
    assert all(v > 0 for v in stage_times.values()), stage_times


@pytest.mark.parametrize("hashed", [False, True])
def test_partitioned_device_builder_edge_identical(fps, monkeypatch,
                                                   hashed):
    force_hashed(monkeypatch, hashed)
    _assert_same_graph(*both(fps[:200], n_shards=3, connectivity=6,
                            expansion_add=24, seed=9, builder="device"),
                      f"200 rows, 3 device shards, hashed={hashed}")


@pytest.mark.parametrize("case", ["top_cap", "one_shard", "tiny", "keys"])
def test_partitioned_cases_edge_identical(fps, case):
    kw = dict(connectivity=6, expansion_add=24, builder="host")
    packed = fps[:300]
    if case == "top_cap":
        kw.update(n_shards=3, seed=5, heuristic=False)
    elif case == "one_shard":
        packed = fps[:150]
        kw.update(n_shards=1, seed=5)
    elif case == "tiny":
        packed = random_fingerprints(10, n_bits=64, seed=1)
        kw = dict(n_shards=16, connectivity=4, expansion_add=8,
                  builder="host")
    else:
        packed = fps[:200]
        kw.update(n_shards=2, keys=(np.arange(200) * 7 + 3).astype(np.int64),
                  stitch_k=4, stitch_ef=20, search_chunk=64)
    ref, port = both(packed, **kw)
    _assert_same_graph(ref, port, case)
    if case == "one_shard":
        _assert_same_graph(ref, build_hnsw(packed, connectivity=6,
                                          expansion_add=24, seed=5),
                          "one shard is the monolithic build")
    if case == "keys":
        ids = port.get_node_ids_from_keys([kw["keys"][0], kw["keys"][137]])
        np.testing.assert_array_equal(port.keys[ids],
                                      [kw["keys"][0], kw["keys"][137]])


def test_partitioned_exact_probed_builder_edge_identical():
    """``builder_kwargs`` forwards ``probes=`` to the exact shard builds:
    1,200 clustered rows in 2 shards, 64-row clusters. The port's exact
    builder is the reference's Pallas path (bucket reduction on layers of
    at least one block, tests/test_torch_build.py), which the reference
    takes off a TPU only when asked: its kwargs say so."""
    sys.path.insert(0, os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        "examples"))
    from enrichment_example import make_library

    packed = make_library(1200, 128, seed=11)[0]
    probed = dict(probes=2, probe_csize=64, q_block=64, col_block=64,
                  sel_block=64, probe_min_n=0)
    kw = dict(n_shards=2, connectivity=8, expansion_add=48, seed=3,
              builder="exact")
    _assert_same_graph(
        ref_partition.build_hnsw_partitioned(
            packed, builder_kwargs=dict(probed, use_pallas=True,
                                        interpret=True), **kw),
        partition.build_hnsw_partitioned(packed, builder_kwargs=probed,
                                         device="cpu", **kw),
        "probed exact shards")


@pytest.mark.parametrize("heuristic", [False, True])
@pytest.mark.parametrize("seed", [0, 1])
def test_merge_edges_on_tied_distances(heuristic, seed):
    """150 directed edges among 60 rows of five distinct fingerprints
    (every distance ties), repeated edges and edges already in the table
    included, merged into a half-filled table of width 6."""
    rng = np.random.default_rng(seed)
    base = random_fingerprints(5, n_bits=64, density=0.3, seed=seed)
    packed = base[rng.integers(0, 5, 60)]
    from rad_tpu_torch.fp.pack import popcount_rows_np
    pops = popcount_rows_np(packed)
    table = np.full((60, 6), -1, np.int32)
    for r in range(60):
        row = rng.choice(60, 3, replace=False)
        table[r, :2] = row[row != r][:2]
    src = rng.integers(0, 60, 150)
    dst = (src + rng.integers(1, 60, 150)) % 60
    src[-10:], dst[-10:] = src[:10], dst[:10]
    d = ref_partition._pair_dist_np(packed, pops, src, dst,
                                    np.ones(150, bool))
    np.testing.assert_array_equal(
        partition._pair_dist_np(packed, pops, src, dst, np.ones(150, bool)),
        d)
    ref = ref_partition._merge_edges_into_layer(
        table.copy(), packed, pops, src, dst, d, heuristic,
        heuristic_chunk=16)
    port = partition._merge_edges_into_layer(
        table.copy(), packed, pops, src, dst, d, heuristic,
        heuristic_chunk=16, device="cpu")
    np.testing.assert_array_equal(port, ref,
                                  err_msg=f"heuristic={heuristic}")


def test_resolve_builder(monkeypatch):
    from rad_tpu_torch import native
    from rad_tpu_torch.build.exact import build_hnsw_exact
    assert partition._resolve_builder("host", "cpu") is build_hnsw
    assert partition._resolve_builder("native", "cpu") is (
        native.build_hnsw_native)
    # "auto" is native where its library loads (g++ is on this host) and
    # the host builder only where it does not
    assert native.native_available()
    assert partition._resolve_builder("auto", "cpu") is (
        native.build_hnsw_native)
    monkeypatch.setattr(native, "native_available", lambda: False)
    assert partition._resolve_builder("auto", "cpu") is build_hnsw
    assert partition._resolve_builder(len, "cpu") is len
    exact = partition._resolve_builder("exact", "cpu")
    assert exact.func is build_hnsw_exact and exact.keywords == {
        "device": "cpu"}
    with pytest.raises(ValueError, match="unknown builder"):
        partition._resolve_builder("gpu", "cpu")
    with pytest.raises(ValueError, match="n_shards must be >= 1"):
        partition.build_hnsw_partitioned(np.zeros((4, 2), np.uint32),
                                         n_shards=0, device="cpu")


def test_partitioned_defaults_to_the_card(fps, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        partition.build_hnsw_partitioned(fps[:40], builder="exact")


@pytest.mark.gpu
@pytest.mark.parametrize("builder", ["exact", "device"])
def test_cuda_partitioned_equals_cpu(fps, builder):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    kw = dict(n_shards=N_SHARDS, connectivity=8, expansion_add=48, seed=3,
              builder=builder)
    _assert_same_graph(
        partition.build_hnsw_partitioned(fps, device="cpu", **kw),
        partition.build_hnsw_partitioned(fps, device="cuda", **kw),
        f"cuda vs cpu, {builder}")
