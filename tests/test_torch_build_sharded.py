"""rad_tpu_torch's mesh-sharded exact build against rad_tpu's (CPU).

The 5 cases of ``tests/test_build_sharded.py``. The invariant:
``build_hnsw_exact(mesh=...)`` is edge-identical to the single-device
build (q-blocks and selection rows are independent, and the sharded
symmetrization's fold / all-to-all / merge is a lossless truncation at
every step). The port runs on a single-controller mesh of ``[cpu] * 8``
and is held, edge for edge, to its own single-device build and to
``rad_tpu``'s builds with ``use_pallas=True, interpret=True`` (the
bucket kernel in interpret mode; off a TPU the reference otherwise takes
its XLA path) on the conftest's 8 virtual CPU devices.

The reference's mesh padding unit (``8 * 128`` here) also moves its
bucket threshold, so with equal 128-row blocks its mesh build reduces
layer 1 (386 nodes) through the matrix path and its single-device build
through the bucket kernel: the two differ there. The port keeps the
bucket reduction on the layers it serves without a mesh, so its mesh
build equals the single-device builds of both packages at that setting;
against the reference's mesh build it is held where that build equals
its own single-device one (``col_block=1024``: one unit for both).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from rad_tpu.build import exact as ref_exact
from rad_tpu.build import exact_sharded as ref_xs
from rad_tpu.fp.pack import random_fingerprints
from rad_tpu.parallel import make_mesh as ref_make_mesh
from rad_tpu_torch.build import exact, exact_sharded as xs
from rad_tpu_torch.build.exact import build_hnsw_exact
from rad_tpu_torch.parallel import make_mesh

BUILD_KW = dict(connectivity=8, seed=11, q_block=128, col_block=128,
                sel_block=128)
CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def meshes():
    return ref_make_mesh(8), make_mesh(8, devices=[CPU] * 8)


@pytest.fixture(scope="module")
def fps():
    # layer 0 (and with M = 8, layer 1 at some settings) reaches the mesh
    # unit 8 * 128 = 1024, so the sharded path engages
    return random_fingerprints(3000, n_bits=128, density=0.2, seed=7)


def _assert_graphs_equal(a, b, what):
    assert a.layer_sizes == b.layer_sizes, what
    np.testing.assert_array_equal(np.asarray(a.levels), np.asarray(b.levels))
    np.testing.assert_array_equal(np.asarray(a.keys), np.asarray(b.keys))
    for l, (na, nb) in enumerate(zip(a.neighbors, b.neighbors)):
        np.testing.assert_array_equal(np.asarray(na), np.asarray(nb),
                                      err_msg=f"{what}: layer {l}")


def _ref(fps, mesh=None, **kw):
    return ref_exact.build_hnsw_exact(fps, use_pallas=True, interpret=True,
                                      mesh=mesh, **kw)


@pytest.mark.parametrize("col_block", [128, 1024])
def test_sharded_build_bit_identical(fps, meshes, col_block):
    rm, pm = meshes
    kw = dict(BUILD_KW, col_block=col_block)
    single = build_hnsw_exact(fps, device="cpu", **kw)
    mesh = build_hnsw_exact(fps, mesh=pm, **kw)
    _assert_graphs_equal(single, mesh, "port single vs port mesh")
    if col_block == 128:
        _assert_graphs_equal(_ref(fps, **kw), mesh,
                             "rad_tpu single vs port mesh")
    else:
        _assert_graphs_equal(_ref(fps, mesh=rm, **kw), mesh,
                             "rad_tpu mesh vs port mesh")


def test_sharded_probed_build_bit_identical(fps, meshes):
    rm, pm = meshes
    kw = dict(BUILD_KW, col_block=1024, probes=3, probe_csize=256,
              probe_min_n=0)
    stage = {}
    single = build_hnsw_exact(fps, device="cpu", stage_times=stage, **kw)
    assert stage["probed_layers"] == [0]
    mesh = build_hnsw_exact(fps, mesh=pm, **kw)
    _assert_graphs_equal(single, mesh, "port single vs port mesh")
    _assert_graphs_equal(_ref(fps, mesh=rm, **kw), mesh,
                         "rad_tpu mesh vs port mesh")


def test_sharded_build_small_library_falls_back(meshes):
    # n below the mesh unit: every layer keeps the lead-device path, and
    # mesh= still gives the identical graph
    _, pm = meshes
    fps = random_fingerprints(500, n_bits=128, density=0.2, seed=3)
    _assert_graphs_equal(build_hnsw_exact(fps, device="cpu", **BUILD_KW),
                         build_hnsw_exact(fps, mesh=pm, **BUILD_KW),
                         "small library")
    with pytest.raises(ValueError, match="axis"):
        build_hnsw_exact(fps, mesh=object(), **BUILD_KW)


def test_symmetrize_sharded_matches_global_sort(meshes):
    # mutual selections (the cross-shard duplicate (dst, src) case) by
    # construction; per-row destinations distinct and never self, and a
    # directed edge carries the true pair distance
    rm, pm = meshes
    rng = np.random.default_rng(5)
    n_pad, m, cap, n_real = 2048, 12, 8, 2000
    dist = rng.random((n_real, n_real), dtype=np.float32)
    dist = np.minimum(dist, dist.T)
    sel = np.full((n_pad, m), -1, np.int32)
    d = np.full((n_pad, m), np.inf, np.float32)
    for i in range(n_real):
        others = rng.choice(n_real - 1, size=m, replace=False)
        others = np.where(others >= i, others + 1, others)
        sel[i] = others
        d[i] = dist[i, others]
    for i in range(0, 512, 2):
        sel[i, 0], sel[i + 1, 0] = i + 1, i
        d[i, 0] = d[i + 1, 0] = dist[i, i + 1]
    oracle = exact._symmetrize(torch.from_numpy(sel), torch.from_numpy(d),
                               n_real, cap).numpy()
    rs = n_pad // 8
    got = xs.symmetrize_sharded(
        [torch.from_numpy(sel[s * rs:(s + 1) * rs]) for s in range(8)],
        [torch.from_numpy(d[s * rs:(s + 1) * rs]) for s in range(8)],
        n_real, cap, pm, "graph", edges_per_sort=4096).full()[:n_pad]
    np.testing.assert_array_equal(got.numpy(), oracle)
    ref = np.asarray(ref_xs.symmetrize_sharded(
        jnp.asarray(sel), jnp.asarray(d), n_real, cap, rm, "graph"))
    np.testing.assert_array_equal(got.numpy(), ref)


def test_sharded_rejects_unsplittable_shapes(meshes):
    rm, pm = meshes
    packed = torch.zeros((1024 + 128, 4), dtype=torch.int32)  # 9 q-blocks
    pops = torch.zeros(1024 + 128, dtype=torch.int32)
    with pytest.raises(ValueError, match="divide"):
        xs.allpairs_topk_sharded(xs.replicate(packed, pm),
                                 xs.replicate(pops, pm), 1000, 16, 128, 128,
                                 None, pm, "graph")
    with pytest.raises(ValueError, match="divide"):
        ref_xs.allpairs_topk_sharded(jnp.zeros((1024 + 128, 4), jnp.uint32),
                                     1000, 16, 128, 128, False, None, None,
                                     False, rm, "graph")
    cand = xs.allpairs_topk_sharded(
        xs.replicate(packed[:1024], pm), xs.replicate(pops[:1024], pm), 1000,
        16, 128, 128, None, pm, "graph")
    with pytest.raises(ValueError, match="sel_block"):
        xs.select_layer_sharded(xs.replicate(packed[:1024], pm),
                                xs.replicate(pops[:1024], pm), *cand, 1000,
                                8, 32, 256, pm, "graph")
