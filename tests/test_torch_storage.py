"""Graph files cross between rad_tpu and rad_tpu_torch with equal arrays."""

import dataclasses
import logging

import numpy as np
import pytest

from rad_tpu.build.reference import build_hnsw
from rad_tpu.fp import random_fingerprints
from rad_tpu.graph.storage import HNSWGraph as RefGraph
from rad_tpu_torch.graph.storage import (ArangeKeys, DerivedLevels,
                                         HNSWGraph)


@pytest.fixture(scope="module")
def ref_graph():
    fps = random_fingerprints(400, n_bits=128, density=0.2, seed=12)
    keys = np.arange(400, dtype=np.int64) * 3 + (1 << 35)
    return build_hnsw(fps, keys=keys, connectivity=6, expansion_add=24,
                      seed=4)


def _port_copy(g):
    return HNSWGraph(np.asarray(g.packed), np.asarray(g.popcounts),
                     np.asarray(g.keys), np.asarray(g.levels),
                     tuple(np.asarray(t) for t in g.neighbors), g.ndim,
                     g.connectivity)


def _assert_equal(a, b):
    for name in ("packed", "popcounts", "keys", "levels"):
        np.testing.assert_array_equal(np.asarray(getattr(a, name)),
                                      np.asarray(getattr(b, name)),
                                      err_msg=name)
    assert len(a.neighbors) == len(b.neighbors)
    for l, (x, y) in enumerate(zip(a.neighbors, b.neighbors)):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y),
                                      err_msg=f"layer {l}")
    assert (a.ndim, a.connectivity) == (b.ndim, b.connectivity)


@pytest.mark.parametrize("mmap", [True, False])
def test_reference_file_loads_in_port(ref_graph, tmp_path, caplog, mmap):
    path = str(tmp_path / "ref.npz")
    ref_graph.save(path)
    with caplog.at_level(logging.WARNING):
        g = HNSWGraph.load(path, mmap=mmap)
    assert "fingerprint format" not in caplog.text
    assert isinstance(g.neighbors[0], np.memmap) == mmap
    _assert_equal(ref_graph, g)


@pytest.mark.parametrize("mmap", [True, False])
def test_port_file_loads_in_reference(ref_graph, tmp_path, caplog, mmap):
    path = str(tmp_path / "port.npz")
    _port_copy(ref_graph).save(path)
    with caplog.at_level(logging.WARNING):
        g = RefGraph.load(path, mmap=mmap)
    assert "fingerprint format" not in caplog.text
    _assert_equal(ref_graph, g)


def test_v2_slim_file_loads_in_port(tmp_path):
    fps = random_fingerprints(200, n_bits=64, density=0.3, seed=2)
    ref = build_hnsw(fps, connectivity=4, expansion_add=16, seed=1)
    # the v2 serving format requires identity keys
    ref = dataclasses.replace(ref, keys=np.arange(len(ref), dtype=np.int64))
    path = str(tmp_path / "slim.npz")
    ref.save(path, exclude_vectors=True, slim=True)
    g = HNSWGraph.load(path)
    assert isinstance(g.keys, ArangeKeys)
    assert isinstance(g.levels, DerivedLevels)
    assert not g.has_vectors
    np.testing.assert_array_equal(np.asarray(g.levels),
                                  np.asarray(ref.levels))
    np.testing.assert_array_equal(np.asarray(g.keys), np.asarray(ref.keys))
    for x, y in zip(ref.neighbors, g.neighbors):
        np.testing.assert_array_equal(np.asarray(x), y)
    assert [s.edges for s in g.levels_stats()] == \
        [s.edges for s in ref.levels_stats()]


def test_exclude_vectors_roundtrip(ref_graph, tmp_path):
    path = str(tmp_path / "novec.npz")
    _port_copy(ref_graph).save(path, exclude_vectors=True)
    g = RefGraph.load(path)
    assert not g.has_vectors
    np.testing.assert_array_equal(np.asarray(g.keys),
                                  np.asarray(ref_graph.keys))


def test_introspection_parity(ref_graph):
    g = _port_copy(ref_graph)
    assert g.info() == ref_graph.info()
    assert g.get_top_level_nodes() == ref_graph.get_top_level_nodes()
    for node, level in ((0, 0), (5, 0), (0, ref_graph.max_level)):
        assert g.get_neighbors(node, level) == \
            ref_graph.get_neighbors(node, level)
    keys = np.asarray(ref_graph.keys)[[3, 77, 150]]
    assert g.get_node_ids_from_keys(keys) == \
        ref_graph.get_node_ids_from_keys(keys)
    assert g.levels_stats() == [type(g.levels_stats()[0])(**vars(s))
                                for s in ref_graph.levels_stats()]
    with pytest.raises(ValueError):
        g.get_neighbors(len(g), 0)
