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


def _read_meta(path):
    import json
    return json.loads(bytes(np.load(path)["meta_json"]).decode())


def _stream_write(writer_cls, path, graph, chunks: int = 3):
    """tests/test_graph.py's stream-writer recipe: keys and levels in one
    go, each neighbor table in ``chunks`` row chunks, no vectors."""
    w = writer_cls(path)
    w.write_array("keys", np.asarray(graph.keys))
    w.write_array("levels", np.asarray(graph.levels))
    for l, t in enumerate(graph.neighbors):
        t = np.asarray(t)
        with w.member(f"neighbors_{l}", t.shape, t.dtype) as mb:
            step = max(1, t.shape[0] // chunks)
            for i in range(0, t.shape[0], step):
                mb.write(t[i:i + step])
    w.close({"ndim": graph.ndim, "connectivity": graph.connectivity,
             "n_layers": len(graph.neighbors), "exclude_vectors": True,
             "version": 1})


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_stream_writer_files_cross(ref_graph, tmp_path, writer):
    """A file streamed by either package's NpzStreamWriter maps in place
    in both, with equal arrays and equal meta (``fp_format_version``
    added by ``close``)."""
    from rad_tpu.graph.storage import NpzStreamWriter as RefWriter
    from rad_tpu_torch.graph.storage import NpzStreamWriter

    path = str(tmp_path / f"{writer}.npz")
    _stream_write(NpzStreamWriter if writer == "port" else RefWriter, path,
                  ref_graph)
    other = str(tmp_path / "other.npz")
    _stream_write(RefWriter if writer == "port" else NpzStreamWriter, other,
                  ref_graph)
    assert _read_meta(path) == _read_meta(other)
    assert _read_meta(path)["fp_format_version"] == 3
    with open(path, "rb") as a, open(other, "rb") as b:
        assert a.read() == b.read()
    for cls in (HNSWGraph, RefGraph):
        g = cls.load(path, mmap=True)
        assert isinstance(g.levels, np.memmap), cls
        assert not g.has_vectors
        np.testing.assert_array_equal(np.asarray(g.keys),
                                      np.asarray(ref_graph.keys))
        np.testing.assert_array_equal(np.asarray(g.levels),
                                      np.asarray(ref_graph.levels))
        for x, y in zip(g.neighbors, ref_graph.neighbors):
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
        assert g.get_neighbors(0, 0) == ref_graph.get_neighbors(0, 0)


def test_stream_writer_shape_guards(tmp_path):
    from rad_tpu_torch.graph.storage import NpzStreamWriter

    w = NpzStreamWriter(str(tmp_path / "bad.npz"))
    with pytest.raises(ValueError, match="does not extend"):
        with w.member("a", (4, 3), np.int32) as mb:
            mb.write(np.zeros((2, 5), np.int32))
    with pytest.raises(ValueError, match="declared"):
        with w.member("b", (4, 3), np.int32) as mb:
            mb.write(np.zeros((2, 3), np.int32))


@pytest.mark.parametrize("saver", ["port", "reference"])
def test_save_slim_files_cross(ref_graph, tmp_path, saver):
    """``save(exclude_vectors=True, slim=True)`` by either package: the
    v2 file loads in both to virtual keys and levels with equal arrays,
    the meta's edge counts, and the same meta either way."""
    from rad_tpu.graph.storage import ArangeKeys as RefArangeKeys
    from rad_tpu.graph.storage import DerivedLevels as RefDerivedLevels

    ided = dataclasses.replace(
        ref_graph, keys=np.arange(len(ref_graph), dtype=np.int64))
    port_g = _port_copy(ided)
    path = str(tmp_path / f"{saver}.npz")
    other = str(tmp_path / "other.npz")
    first, second = (port_g, ided) if saver == "port" else (ided, port_g)
    first.save(path, exclude_vectors=True, slim=True)
    second.save(other, exclude_vectors=True, slim=True)
    meta = _read_meta(path)
    assert meta == _read_meta(other)
    assert meta["version"] == 2 and meta["identity_keys"] and \
        meta["derived_levels"]
    assert meta["edges_per_layer"] == [s.edges
                                       for s in ref_graph.levels_stats()]
    assert set(np.load(path).files) == set(np.load(other).files)
    for cls, keys_cls, levels_cls in (
            (HNSWGraph, ArangeKeys, DerivedLevels),
            (RefGraph, RefArangeKeys, RefDerivedLevels)):
        g = cls.load(path, mmap=True)
        assert isinstance(g.keys, keys_cls)
        assert isinstance(g.levels, levels_cls)
        np.testing.assert_array_equal(np.asarray(g.levels),
                                      np.asarray(ref_graph.levels))
        for x, y in zip(g.neighbors, ref_graph.neighbors):
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
        assert [vars(s) for s in g.levels_stats()] == \
            [vars(s) for s in ref_graph.levels_stats()]
        assert g.get_node_ids_from_keys([0, 5]) == [0, 5]


def test_save_slim_refuses_what_the_reference_refuses(ref_graph, tmp_path):
    """slim needs exclude_vectors, identity keys and derived levels."""
    g = _port_copy(ref_graph)
    path = str(tmp_path / "x.npz")
    with pytest.raises(ValueError, match="identity keys"):
        g.save(path, exclude_vectors=True, slim=True)
    with pytest.raises(ValueError, match="exclude_vectors"):
        g.save(path, slim=True)
    ided = dataclasses.replace(g, keys=np.arange(len(g), dtype=np.int64))
    bad = dataclasses.replace(ided, levels=np.zeros_like(ided.levels))
    with pytest.raises(ValueError, match="derived levels"):
        bad.save(path, exclude_vectors=True, slim=True)
    # a slim-loaded graph saves slim again (virtual keys and levels)
    ided.save(path, exclude_vectors=True, slim=True)
    again = str(tmp_path / "again.npz")
    HNSWGraph.load(path).save(again, exclude_vectors=True, slim=True)
    assert _read_meta(again) == _read_meta(path)
