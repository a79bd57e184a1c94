"""rad_tpu_torch's incremental insertion against rad_tpu's (CPU).

``insert_into_graph`` must give edge-identical graphs (renumbered keys,
levels and every layer) on the cases of tests/test_incremental.py: 100
rows into a 500-row host-built graph (600 x 256 bits, M 8, batch 32), 60
into a 200-row graph at M 6 (batch 16), with the dense visited map and
with the hash table, into a graph of the batched beam builder, with
default keys. Its ``ValueError`` messages are the reference's, and
``HNSWIndex.insert`` runs the reference's workflow (insert, search old
and new rows, key round trip, a later ``add``) to the same graphs. The
``gpu`` test inserts on the card against the CPU.
"""

import numpy as np
import pytest
import torch

import rad_tpu
import rad_tpu_torch
from rad_tpu.build import device as ref_device
from rad_tpu.build import incremental as ref_incremental
from rad_tpu.build import reference as ref_reference
from rad_tpu.fp import random_fingerprints
from rad_tpu_torch.build import device, incremental, reference
from test_torch_build_device import force_hashed
from test_torch_reference import _assert_same_graph


@pytest.fixture(scope="module")
def fps():
    return random_fingerprints(600, n_bits=256, density=0.2, seed=17)


@pytest.fixture(scope="module")
def bases(fps):
    """Host-built graphs of both packages (edge-identical,
    tests/test_torch_reference.py): 500 rows at M 8, 200 at M 6, 100 at
    M 6 and 100 at M 4."""
    out = {}
    for name, rows, kw in (
            ("500", 500, dict(connectivity=8, expansion_add=48, seed=3)),
            ("200", 200, dict(connectivity=6, expansion_add=24, seed=3)),
            ("100", 100, dict(connectivity=6, expansion_add=24, seed=3)),
            ("100m4", 100, dict(connectivity=4, expansion_add=20, seed=1))):
        out[name] = (ref_reference.build_hnsw(fps[:rows], **kw),
                     reference.build_hnsw(fps[:rows], **kw))
    return out


@pytest.fixture(scope="module")
def inc_graph(fps, bases):
    kw = dict(new_keys=np.arange(500, 600), expansion_add=48, seed=5,
              batch_size=32)
    ref_base, base = bases["500"]
    return (ref_incremental.insert_into_graph(ref_base, fps[500:], **kw),
            incremental.insert_into_graph(base, fps[500:], device="cpu",
                                          **kw))


def test_incremental_graph_edge_identical(inc_graph):
    _assert_same_graph(*inc_graph, "100 into 500, M 8, batch 32")


def test_incremental_graph_valid(inc_graph, fps):
    """tests/test_incremental.py's properties, on the port's graph."""
    g = inc_graph[1]
    assert len(g) == 600
    assert (np.diff(g.levels) <= 0).all()
    for l, t in enumerate(g.neighbors):
        assert (t[t >= 0] < g.layer_sizes[l]).all()
        assert (t != np.arange(t.shape[0])[:, None]).all(), "self loops"
    assert sorted(g.keys.tolist()) == list(range(600))
    np.testing.assert_array_equal(g.packed, fps[g.keys])
    new_deg = (g.neighbors[0][g.keys >= 500] >= 0).sum(axis=1)
    assert (new_deg > 0).all() and new_deg.mean() >= g.connectivity


@pytest.mark.parametrize("hashed", [False, True])
@pytest.mark.parametrize("case", ["slice", "default_keys", "no_stitch"])
def test_insert_into_graph_edge_identical(fps, bases, monkeypatch, case,
                                          hashed):
    force_hashed(monkeypatch, hashed)
    ref_base, base = bases["200"]
    kw = dict(new_keys=np.arange(200, 260), expansion_add=24, seed=9,
              batch_size=16)
    if case == "default_keys":
        kw.update(new_keys=None, batch_size=25, heuristic_k=10)
    elif case == "no_stitch":
        kw.update(stitch=False)
    _assert_same_graph(
        ref_incremental.insert_into_graph(ref_base, fps[200:260], **kw),
        incremental.insert_into_graph(base, fps[200:260], device="cpu",
                                      **kw),
        f"{case}, hashed={hashed}")


def test_insert_into_device_built_graph(fps):
    """Into a graph of the batched beam builder, then a second insert
    into the result (levels clamped to its hierarchy each time)."""
    kw = dict(connectivity=6, expansion_add=24, seed=4, batch_size=32)
    ref = ref_device.build_hnsw_device(fps[:150], **kw)
    port = device.build_hnsw_device(fps[:150], device="cpu", **kw)
    for lo, hi, seed in ((150, 190, 2), (190, 200, 7)):
        ikw = dict(expansion_add=24, seed=seed, batch_size=16)
        ref = ref_incremental.insert_into_graph(ref, fps[lo:hi], **ikw)
        port = incremental.insert_into_graph(port, fps[lo:hi],
                                             device="cpu", **ikw)
        _assert_same_graph(ref, port, f"rows {lo}:{hi}")


@pytest.mark.parametrize("case", ["duplicate", "lengths", "width"])
def test_insert_errors_match_reference(fps, bases, case):
    ref_base, base = bases["100"] if case != "lengths" else bases["100m4"]
    new, kw = fps[100:110], {}
    if case == "duplicate":
        kw = dict(new_keys=np.arange(10))      # collide with 0..99
    elif case == "lengths":
        kw = dict(new_keys=np.arange(5000, 5020), expansion_add=20)
    else:
        new = random_fingerprints(10, n_bits=128, seed=3)
    with pytest.raises(ValueError) as ref_err:
        ref_incremental.insert_into_graph(ref_base, new, **kw)
    with pytest.raises(ValueError) as err:
        incremental.insert_into_graph(base, new, device="cpu", **kw)
    assert str(err.value) == str(ref_err.value)


def test_index_insert_api(fps):
    """tests/test_incremental.py's index workflow on both packages."""
    kw = dict(ndim=256, connectivity=6, expansion_add=24, backend="host",
              seed=0)
    ref = rad_tpu.HNSWIndex(**kw)
    port = rad_tpu_torch.HNSWIndex(device="cpu", **kw)
    for idx in (ref, port):
        idx.add(np.arange(150), fps[:150])
        idx.build()
        idx.insert(np.arange(500, 520), fps[150:170], batch_size=16)
        assert len(idx) == 170
    _assert_same_graph(ref.graph, port.graph, "HNSWIndex.insert")
    for rows in (slice(0, 3), slice(150, 153)):
        rd, rk = ref.search(fps[rows], k=1)
        d, k = port.search(fps[rows], k=1)
        np.testing.assert_array_equal(k, rk)
        assert (d[:, 0] == 0).all() and (np.asarray(rd)[:, 0] == 0).all()
    assert set(k[:, 0].tolist()) <= set(range(500, 520))
    ids = port.get_node_ids_from_keys([500, 519, 0])
    assert ids == ref.get_node_ids_from_keys([500, 519, 0])
    np.testing.assert_array_equal(port.graph.keys[ids], [500, 519, 0])
    with pytest.raises(ValueError) as ref_err:
        ref.insert(np.arange(5), fps[170:175])
    with pytest.raises(ValueError) as err:
        port.insert(np.arange(5), fps[170:175])
    assert str(err.value) == str(ref_err.value)
    # a later add() keeps everything (rebuild path)
    for idx in (ref, port):
        idx.add(np.arange(900, 910), fps[170:180])
        assert len(idx) == 180 and len(idx.graph) == 180
    _assert_same_graph(ref.graph, port.graph, "add after insert")


def test_insert_into_graph_defaults_to_the_card(bases, fps, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        incremental.insert_into_graph(bases["100"][1], fps[100:110])


@pytest.mark.gpu
@pytest.mark.parametrize("hashed", [False, True])
def test_cuda_insert_equals_cpu_insert(fps, bases, monkeypatch, hashed):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    force_hashed(monkeypatch, hashed)
    base = bases["500"][1]
    kw = dict(new_keys=np.arange(500, 600), expansion_add=48, seed=5,
              batch_size=32)
    cpu = incremental.insert_into_graph(base, fps[500:], device="cpu", **kw)
    gpu = incremental.insert_into_graph(base, fps[500:], device="cuda",
                                        **kw)
    _assert_same_graph(cpu, gpu, f"cuda vs cpu, hashed={hashed}")
