"""rad_tpu_torch's bit-packed adjacency against rad_tpu's.

The cases of ``tests/test_adjpack.py`` on the port: packed words
array-equal to ``rad_tpu.graph.adjpack.pack_adjacency_numpy`` at every
field width (8, 17, 20, 28, 31: word-aligned and word-crossing) and odd
M0, exact round trips, and the engine, ``DeviceTraverser`` and the beam
search over a packed table identical to the int32 ones. Everything is integer
bookkeeping: all comparisons are exact. The port stores ``[R, W]`` (the
reference's group 1): ``adj_group_for`` answers XLA's padding of a device
array's minor dimension and has no counterpart here.
"""

import numpy as np
import pytest
import torch

from rad_tpu.build.reference import build_hnsw
from rad_tpu.fp import random_fingerprints
from rad_tpu.graph import adjpack as ref_adjpack
from rad_tpu_torch.fp.pack import to_torch_packed
from rad_tpu_torch.graph.adjpack import (adj_bits_for, pack_adjacency_numpy,
                                         pack_adjacency_rows,
                                         packed_adj_words,
                                         unpack_adjacency_rows)
from rad_tpu_torch.graph.storage import HNSWGraph
from rad_tpu_torch.search import knn
from rad_tpu_torch.store import InMemorySmilesStore
from rad_tpu_torch.traverse import device as dev
from rad_tpu_torch.traverse.driver import DeviceTraverser


def _random_adj(r, m0, n_ids, seed, frac_pad=0.3):
    rng = np.random.default_rng(seed)
    adj = rng.integers(0, n_ids, (r, m0), dtype=np.int64).astype(np.int32)
    adj[rng.random((r, m0)) < frac_pad] = -1
    return adj


def _port_graph(n, n_bits, connectivity, expansion_add, fp_seed, seed):
    fps = random_fingerprints(n, n_bits=n_bits, density=0.3, seed=fp_seed)
    ref = build_hnsw(fps, connectivity=connectivity,
                     expansion_add=expansion_add, seed=seed)
    return fps, HNSWGraph(
        np.asarray(ref.packed), np.asarray(ref.popcounts),
        np.asarray(ref.keys), np.asarray(ref.levels),
        tuple(np.asarray(t) for t in ref.neighbors), ref.ndim,
        ref.connectivity)


def _words(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint32)


@pytest.mark.parametrize("bits", [8, 17, 20, 28, 31])
def test_pack_roundtrip_and_reference_words(bits):
    m0 = 16
    n_ids = min((1 << bits) - 1, 10_000)
    adj = _random_adj(64, m0, n_ids, seed=bits)
    # ids at both ends of the field's range
    adj[0, :2] = [0, (1 << bits) - 2]
    want = ref_adjpack.pack_adjacency_numpy(adj, bits)
    assert want.shape == (64, packed_adj_words(m0, bits))
    assert packed_adj_words(m0, bits) == ref_adjpack.packed_adj_words(m0,
                                                                      bits)
    np.testing.assert_array_equal(pack_adjacency_numpy(adj, bits), want)
    packed_t = pack_adjacency_rows(torch.from_numpy(adj), bits)
    assert packed_t.dtype == torch.int32
    np.testing.assert_array_equal(_words(packed_t), want)
    back = unpack_adjacency_rows(packed_t, m0, bits)
    assert back.dtype == torch.int32
    np.testing.assert_array_equal(back.numpy(), adj)
    np.testing.assert_array_equal(
        back.numpy(),
        np.asarray(ref_adjpack.unpack_adjacency_rows(want, m0, bits)))


@pytest.mark.parametrize("m0", [1, 5, 12])
def test_pack_roundtrip_odd_m0(m0):
    adj = _random_adj(32, m0, 500, seed=m0)
    packed_t = pack_adjacency_rows(torch.from_numpy(adj), 10)
    np.testing.assert_array_equal(
        _words(packed_t), ref_adjpack.pack_adjacency_numpy(adj, 10))
    np.testing.assert_array_equal(
        unpack_adjacency_rows(packed_t, m0, 10).numpy(), adj)
    # leading dimensions pass through
    cube = torch.from_numpy(adj).reshape(4, 8, m0)
    np.testing.assert_array_equal(
        unpack_adjacency_rows(pack_adjacency_rows(cube, 10), m0, 10).numpy(),
        cube.numpy())


def test_adj_bits_for_sentinel_headroom():
    # the all-ones value is the -1 sentinel: n ids need n <= 2**bits - 1
    assert adj_bits_for(15) == 4      # ids 0..14, sentinel 15
    assert adj_bits_for(16) == 5      # id 15 would collide at 4 bits
    assert adj_bits_for(200_000_000) == 28
    assert adj_bits_for(1) == 1
    for n in (0, 1, 15, 16, 1_000_000, 2 ** 31 - 1):
        assert adj_bits_for(n) == ref_adjpack.adj_bits_for(n)


def test_pack_numpy_rejects_overflow():
    adj = np.full((2, 4), (1 << 8) - 1, np.int32)  # == the 8-bit sentinel
    with pytest.raises(ValueError):
        pack_adjacency_numpy(adj, 8)


def test_pack_device_graph_noop_when_wide():
    dg = dev.DeviceGraph(adj=torch.zeros((4, 2), dtype=torch.int32),
                         offsets=torch.zeros(3, dtype=torch.int32),
                         offsets_host=np.zeros(3, np.int32),
                         n_nodes=4, n_rows=4, m0=2, max_level=0)
    assert dev.pack_device_graph(dg, bits=32) is dg
    already = dev.pack_device_graph(dg, bits=8)
    assert already.adj_bits == 8 and already.adj.shape == (4, 1)
    assert dev.pack_device_graph(already, bits=8) is already


def test_prepare_device_graph_host_packing_matches_device_packing():
    """Packing on the host (the int32 table never reaches the device) and
    packing the uploaded table give the same words: rad_tpu's, row by
    row."""
    _, graph = _port_graph(500, 128, 5, 32, fp_seed=5, seed=2)
    dg = dev.prepare_device_graph(graph, "cpu")
    dg_host = dev.prepare_device_graph(graph, "cpu", packed_adjacency=True)
    dg_dev = dev.pack_device_graph(dg, chunk=64)
    assert dg_host.adj_bits == dg_dev.adj_bits == adj_bits_for(500) == 9
    assert dg_host.adj.dtype == torch.int32
    assert torch.equal(dg_host.adj, dg_dev.adj)
    np.testing.assert_array_equal(
        _words(dg_host.adj),
        ref_adjpack.pack_adjacency_numpy(dg.adj.numpy(), 9))
    rows = torch.arange(dg.n_rows)
    assert torch.equal(dev.adjacency_rows(dg_host, rows), dg.adj)


def test_prepare_device_graph_wide_bits_stays_unpacked():
    _, graph = _port_graph(300, 128, 6, 24, fp_seed=9, seed=1)
    for width in (32, 40):
        dg = dev.prepare_device_graph(graph, "cpu", packed_adjacency=width)
        assert dg.adj_bits == 32 and dg.adj.shape[1] == dg.m0


def test_packed_engine_bit_identical():
    """A full device-scored sweep over a packed DeviceGraph equals the
    int32 engine's: every field of the final state."""
    fps, graph = _port_graph(600, 64, 4, 24, fp_seed=31, seed=7)
    dg = dev.prepare_device_graph(graph, "cpu")
    dg_packed = dev.pack_device_graph(dg, chunk=128)
    assert dg_packed.adj_bits == 10
    assert dg_packed.adj.shape == (dg.n_rows, packed_adj_words(dg.m0, 10))
    packed = to_torch_packed(np.asarray(graph.packed), "cpu")
    pops = torch.from_numpy(np.asarray(graph.popcounts).astype(np.int32))
    target = to_torch_packed(fps[11:12], "cpu")[0]
    t_pop = int(np.bitwise_count(fps[11]).sum())
    n_top = graph.layer_sizes[graph.max_level]
    ids = torch.arange(n_top, dtype=torch.int32)
    from rad_tpu_torch.fp.tanimoto import tanimoto_rows_to_target
    seeds = tanimoto_rows_to_target(packed[:n_top], pops[:n_top], target,
                                    t_pop)

    def sweep(g, fused):
        st = dev.prime(dev.init_state(g), g, ids, seeds)
        return dev.fused_run(st, g, packed, pops, target, t_pop, 600,
                             batch=8, fused_candidates=fused)

    a = dev.state_to_reference_arrays(sweep(dg, False))
    assert int(a["n_scored"]) > 0
    for fused in (False, True):
        b = dev.state_to_reference_arrays(sweep(dg_packed, fused))
        for name in a:
            np.testing.assert_array_equal(a[name], b[name], err_msg=name)


def test_traverser_packed_adjacency_identical():
    """DeviceTraverser(packed_adjacency=True), the user-facing option,
    reproduces the unpacked engine's molecules and discovery order."""
    n = 150
    _, graph = _port_graph(n, 64, 4, 20, fp_seed=5, seed=2)
    keys = np.asarray(graph.keys)
    rng = np.random.default_rng(0)
    table = {int(k): float(s) for k, s in
             zip(keys, rng.permutation(n).astype(float))}
    store = InMemorySmilesStore({int(k): f"SMI_{int(k)}" for k in keys})

    mols = {}
    for packed in (False, True):
        tr = DeviceTraverser(graph, lambda s: table[int(s.split("_")[1])],
                             store, batch_size=4, n_score_threads=1,
                             packed_adjacency=packed, device="cpu")
        assert tr.dg.adj_bits == (adj_bits_for(n) if packed else 32)
        tr.prime()
        tr.traverse(n_to_score=10**9, timeout=120)
        mols[packed] = tr.get_molecules()
        tr.shutdown()
    assert mols[True] == mols[False]
    assert len(mols[True]) > 100


@pytest.mark.parametrize("packed_adjacency", [True, 12])
def test_search_device_packed_adjacency_identical(packed_adjacency):
    fps, graph = _port_graph(400, 128, 6, 32, fp_seed=3, seed=4)
    queries = fps[::37]
    want = knn.search_device(graph, queries, k=5, expansion_search=24,
                             device="cpu")
    got = knn.search_device(graph, queries, k=5, expansion_search=24,
                            packed_adjacency=packed_adjacency, device="cpu")
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    # each layout caches its own device graph
    assert len(graph.__dict__["_search_prep"]) == 2
