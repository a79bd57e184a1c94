"""rad_tpu_torch's batched beam builder against rad_tpu's (CPU).

``build_hnsw_device`` must give edge-identical graphs (keys, levels and
every layer) on the cases of tests/test_build_device.py (600 x 256 bits,
M 8, a 200-row slice at M 6, the 10-row tiny case), with the dense visited
map and with the hash table (forced by a zero ``DENSE_VISITED_BUDGET`` in
both packages), without the stitch and with user keys. The primitives are
held alone too: ``_beam_search_batch`` with and without
``extra_visible``, ``_apply_reverse_links`` and ``_stitch_batch`` on
libraries whose distances tie everywhere, and ``_select_neighbors`` with
either ``mxu_pairs``. ``HNSWIndex.build(backend="device")`` gives the
reference's graph. The ``gpu`` test builds on the card against the CPU.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import rad_tpu
import rad_tpu_torch
from rad_tpu.build import device as ref_device
from rad_tpu.fp import random_fingerprints
from rad_tpu.search import visited as ref_visited
from rad_tpu_torch.build import device
from rad_tpu_torch.search import visited
from rad_tpu_torch.search.knn import search_device
from test_torch_reference import _assert_same_graph


def force_hashed(monkeypatch, hashed: bool) -> None:
    """Both packages read the budget at call time."""
    if hashed:
        monkeypatch.setattr(ref_visited, "DENSE_VISITED_BUDGET", 0)
        monkeypatch.setattr(visited, "DENSE_VISITED_BUDGET", 0)


@pytest.fixture(scope="module")
def fps():
    return random_fingerprints(600, n_bits=256, density=0.2, seed=17)


@pytest.fixture(scope="module")
def dev_graph(fps):
    kw = dict(connectivity=8, expansion_add=48, seed=3, batch_size=64)
    ref = ref_device.build_hnsw_device(fps, **kw)
    port = device.build_hnsw_device(fps, device="cpu", **kw)
    return ref, port


def _tied_library(n: int, pool: int, seed: int) -> np.ndarray:
    """``n`` rows drawn from ``pool`` distinct fingerprints: distances tie
    everywhere."""
    rng = np.random.default_rng(seed)
    base = random_fingerprints(pool, n_bits=64, density=0.3, seed=seed)
    return base[rng.integers(0, pool, n)]


def _both(packed):
    """The same library for both packages: (jnp uint32, its popcounts) and
    (torch int32 view, popcounts)."""
    from rad_tpu.fp.pack import popcount_rows_np
    pops = popcount_rows_np(packed)
    return ((jnp.asarray(packed), jnp.asarray(pops)),
            (torch.from_numpy(packed.view(np.int32)), torch.from_numpy(pops)))


def _padded(table: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.concatenate(
        [table, np.full((1, table.shape[1]), -1, np.int32)]))


def test_device_graph_edge_identical(dev_graph):
    ref, port = dev_graph
    _assert_same_graph(ref, port, "600 x 256 bits, M 8, batch 64")


@pytest.mark.parametrize("hashed", [False, True])
@pytest.mark.parametrize("case", ["slice", "tiny", "no_stitch", "keys"])
def test_build_hnsw_device_edge_identical(fps, monkeypatch, case, hashed):
    force_hashed(monkeypatch, hashed)
    packed = fps[:200]
    kw = dict(connectivity=6, expansion_add=24, seed=9, batch_size=32)
    if case == "tiny":
        packed = random_fingerprints(10, n_bits=64, seed=1)
        kw = dict(connectivity=4, expansion_add=8, batch_size=4)
    elif case == "no_stitch":
        kw.update(stitch=False, heuristic_k=12)
    elif case == "keys":
        kw.update(keys=np.arange(200, dtype=np.int64) * 7 + (1 << 33),
                  ndim=250, connectivity=4, batch_size=50)
    ref = ref_device.build_hnsw_device(packed, **kw)
    port = device.build_hnsw_device(packed, device="cpu", **kw)
    _assert_same_graph(ref, port, f"{case}, hashed={hashed}")


def test_device_graph_hashed_edge_identical(fps, dev_graph, monkeypatch):
    force_hashed(monkeypatch, True)
    kw = dict(connectivity=8, expansion_add=48, seed=3, batch_size=64)
    port = device.build_hnsw_device(fps, device="cpu", **kw)
    _assert_same_graph(dev_graph[0], port, "600 rows, hashed")


def test_device_graph_valid_and_recall(fps, dev_graph):
    """tests/test_build_device.py's properties, on the port's graph."""
    g = dev_graph[1]
    assert (np.diff(g.levels) <= 0).all()
    for l, t in enumerate(g.neighbors):
        assert t.shape == (g.layer_sizes[l], 2 * 8 if l == 0 else 8)
        assert (t[t >= 0] < g.layer_sizes[l]).all()
        assert (t != np.arange(t.shape[0])[:, None]).all(), "self loops"
        for r in range(0, t.shape[0], 37):
            row = t[r][t[r] >= 0]
            assert len(row) == len(set(row.tolist()))
    t0 = g.neighbors[0]
    assert ((t0 >= 0).sum(axis=1) > 0).mean() > 0.99
    assert (t0 >= 0).sum(axis=1).mean() >= g.connectivity
    queries = random_fingerprints(24, n_bits=256, density=0.2, seed=71)
    from rad_tpu_torch.fp.kernels import tanimoto_matrix
    full = tanimoto_matrix(torch.from_numpy(queries.view(np.int32)),
                           torch.from_numpy(g.packed.view(np.int32))).numpy()
    truth = np.argsort(full, axis=1, kind="stable")[:, :10]
    _, ids = search_device(g, queries, k=10, expansion_search=128,
                           device="cpu")
    ids = ids.numpy()
    recall = np.mean([len(set(ids[i].tolist()) & set(truth[i].tolist()))
                      / 10 for i in range(len(queries))])
    assert recall >= 0.8, recall


@pytest.mark.parametrize("hashed", [False, True])
@pytest.mark.parametrize("extra", [False, True])
def test_beam_search_batch_array_equal(dev_graph, monkeypatch, hashed,
                                       extra):
    """One layer-0 beam over the built graph for 64 rows, the prefix at
    300, some rows inactive, seeds of one and of several entries; with
    ``extra_visible`` half of the ids past the prefix become visible."""
    force_hashed(monkeypatch, hashed)
    g = dev_graph[1]
    (rp, rpops), (pp, ppops) = _both(g.packed)
    adj = g.neighbors[0]
    rng = np.random.default_rng(4)
    q = np.arange(300, 364, dtype=np.int32)
    active = rng.random(64) < 0.8
    prefix = np.full(64, 300, np.int32)
    seeds = rng.integers(0, 300, (64, 3)).astype(np.int32)
    seeds[::5, 1:] = -1
    vis = rng.random(len(g)) < 0.5 if extra else None
    for s in (1, 3):
        ep = seeds[:, :s]
        ep_d = np.array(ref_device._dist_rows(
            rp, rpops, jnp.asarray(q), jnp.asarray(ep),
            jnp.asarray(ep >= 0)))
        for ef in (8, 40):
            rd, ri = ref_device._beam_search_batch(
                rp, rpops, jnp.asarray(adj), jnp.asarray(q),
                jnp.asarray(ep), jnp.asarray(ep_d), jnp.asarray(prefix),
                jnp.asarray(active), ef, len(g),
                extra_visible=None if vis is None else jnp.asarray(vis))
            d, i = device._beam_search_batch(
                pp, ppops, torch.from_numpy(adj), torch.from_numpy(q),
                torch.from_numpy(ep), torch.from_numpy(ep_d),
                torch.from_numpy(prefix), torch.from_numpy(active), ef,
                len(g), extra_visible=None if vis is None
                else torch.from_numpy(vis))
            what = f"seeds {s}, ef {ef}"
            np.testing.assert_array_equal(d.numpy(), np.asarray(rd),
                                          err_msg=what)
            np.testing.assert_array_equal(i.numpy(), np.asarray(ri),
                                          err_msg=what)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_reverse_links_on_tied_distances(seed):
    """Sixteen sources linking to 24 targets drawn from six distinct
    fingerprints: every (target, distance) group ties, so the merge's
    order is the sort's tie rule."""
    rng = np.random.default_rng(seed)
    packed = _tied_library(120, 6, seed)
    (rp, rpops), (pp, ppops) = _both(packed)
    cap = 6
    adj = np.full((120, cap), -1, np.int32)
    for r in range(120):
        row = rng.choice(120, rng.integers(0, cap + 1), replace=False)
        adj[r, :row.size] = row
    src = rng.choice(120, 16, replace=False).astype(np.int32)
    fwd = rng.integers(0, 24, (16, 4)).astype(np.int32)
    fwd[rng.random((16, 4)) < 0.2] = -1
    active = rng.random(16) < 0.9
    ref = np.asarray(ref_device._apply_reverse_links(
        rp, rpops, jnp.asarray(adj), jnp.asarray(fwd), jnp.asarray(src),
        cap, jnp.asarray(active)))
    port = device._apply_reverse_links(
        pp, ppops, _padded(adj), torch.from_numpy(fwd),
        torch.from_numpy(src), cap, torch.from_numpy(active))
    np.testing.assert_array_equal(port[:-1].numpy(), ref,
                                  err_msg=f"seed {seed}")


@pytest.mark.parametrize("m", [3, 8, 40])
def test_stitch_batch_on_tied_distances(m):
    """A 32-row batch of five distinct fingerprints: the peers' top-k is
    all ties (``lax.top_k`` keeps the lower index); ``m`` past the batch
    clamps to it."""
    rng = np.random.default_rng(m)
    packed = _tied_library(100, 5, m)
    (rp, rpops), (pp, ppops) = _both(packed)
    cap = 8
    adj = np.full((100, cap), -1, np.int32)
    adj[:, :3] = rng.integers(0, 100, (100, 3))
    batch = np.concatenate([np.arange(60, 92), [99, 99]]).astype(np.int32)
    active = np.ones(34, bool)
    active[-2:] = False
    active[5] = False
    ref = np.asarray(ref_device._stitch_batch(
        rp, rpops, jnp.asarray(adj), jnp.asarray(batch),
        jnp.asarray(active), m, cap))
    port = device._stitch_batch(pp, ppops, _padded(adj),
                                torch.from_numpy(batch),
                                torch.from_numpy(active), m, cap)
    np.testing.assert_array_equal(port[:-1].numpy(), ref, err_msg=f"m={m}")


@pytest.mark.parametrize("mxu", [False, True])
def test_select_neighbors_mxu_pairs(dev_graph, mxu):
    """``mxu_pairs`` is accepted and changes nothing: both values give the
    reference's picks (its own with the same flag)."""
    g = dev_graph[1]
    (rp, rpops), (pp, ppops) = _both(g.packed)
    rng = np.random.default_rng(8)
    q = rng.integers(0, len(g), 40).astype(np.int32)
    cand = rng.integers(-1, len(g), (40, 24)).astype(np.int32)
    d = np.asarray(ref_device._dist_rows(rp, rpops, jnp.asarray(q),
                                         jnp.asarray(cand),
                                         jnp.asarray(cand >= 0)))
    order = np.argsort(d, axis=1, kind="stable")
    d = np.take_along_axis(d, order, 1)
    cand = np.take_along_axis(cand, order, 1)
    active = rng.random(40) < 0.9
    ref = np.asarray(ref_device._select_neighbors(
        rp, rpops, jnp.asarray(q), jnp.asarray(d), jnp.asarray(cand), 6, 16,
        jnp.asarray(active), mxu_pairs=mxu))
    args = (pp, ppops, torch.from_numpy(q), torch.from_numpy(d),
            torch.from_numpy(cand), 6, 16, torch.from_numpy(active))
    port = device._select_neighbors(*args, mxu_pairs=mxu)
    np.testing.assert_array_equal(port.numpy(), ref, err_msg=f"mxu={mxu}")
    np.testing.assert_array_equal(
        port.numpy(), device._select_neighbors(*args).numpy())


def test_index_build_device_backend(fps):
    kw = dict(ndim=256, connectivity=6, expansion_add=24, seed=2)
    ref = rad_tpu.HNSWIndex(**kw)
    port = rad_tpu_torch.HNSWIndex(device="cpu", **kw)
    keys = np.arange(200, dtype=np.int64) + 1000
    for idx in (ref, port):
        idx.add(keys, fps[:200])
    _assert_same_graph(ref.build(backend="device", batch_size=32),
                      port.build(backend="device", batch_size=32),
                      "HNSWIndex.build(backend='device')")
    rd, rk = ref.search(fps[:8], k=5)
    d, k = port.search(fps[:8], k=5)
    np.testing.assert_array_equal(k, rk)
    np.testing.assert_array_equal(d, rd)


def test_build_hnsw_device_defaults_to_the_card(fps, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        device.build_hnsw_device(fps[:32])


@pytest.mark.gpu
@pytest.mark.parametrize("hashed", [False, True])
def test_cuda_device_build_equals_cpu_build(fps, monkeypatch, hashed):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    force_hashed(monkeypatch, hashed)
    kw = dict(connectivity=8, expansion_add=48, seed=3, batch_size=64)
    cpu = device.build_hnsw_device(fps, device="cpu", **kw)
    gpu = device.build_hnsw_device(fps, device="cuda", **kw)
    _assert_same_graph(cpu, gpu, f"cuda vs cpu, hashed={hashed}")
