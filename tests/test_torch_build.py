"""rad_tpu_torch's exact builder against rad_tpu's, edge for edge (CPU).

The reference runs its Pallas kernels in interpret mode; the port runs the
kernels' plain twins. Keys, levels, layer sizes and every layer's
neighbor table must be identical, in the bucket form (big layers through
the fused bucket reduction) and in the matrix form.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from rad_tpu.build import exact as ref_exact
from rad_tpu.build.reference import sample_levels as ref_sample_levels
from rad_tpu.fp import random_fingerprints
from rad_tpu_torch.build import exact
from rad_tpu_torch.build.exact import build_hnsw_exact
from rad_tpu_torch.build.reference import sample_levels

BLOCKS = dict(q_block=512, col_block=512, sel_block=512)


@pytest.fixture(scope="module")
def fps():
    return random_fingerprints(1024, n_bits=256, density=0.15, seed=3)


def _assert_same_graph(ref, port, what):
    assert ref.layer_sizes == port.layer_sizes, what
    np.testing.assert_array_equal(np.asarray(ref.keys), port.keys,
                                  err_msg=f"{what}: keys")
    np.testing.assert_array_equal(np.asarray(ref.levels), port.levels,
                                  err_msg=f"{what}: levels")
    np.testing.assert_array_equal(np.asarray(ref.packed), port.packed,
                                  err_msg=f"{what}: packed")
    for l, (a, b) in enumerate(zip(ref.neighbors, port.neighbors)):
        np.testing.assert_array_equal(np.asarray(a), b,
                                      err_msg=f"{what}: layer {l}")


@pytest.mark.parametrize("bucket", [16, None])
def test_build_edge_identical(fps, bucket):
    ref = ref_exact.build_hnsw_exact(
        fps, connectivity=8, seed=1, use_pallas=True, interpret=True,
        block_bucket=bucket, **BLOCKS)
    times = {}
    port = build_hnsw_exact(fps, connectivity=8, seed=1,
                            block_bucket=bucket, stage_times=times,
                            device="cpu", **BLOCKS)
    # layer 0 takes the bucket path (when on), the upper layers the matrix
    assert ref.layer_sizes[0] >= BLOCKS["q_block"]
    assert len(ref.layer_sizes) >= 3
    _assert_same_graph(ref, port, f"bucket={bucket}")
    assert set(times) == {"candidates", "selection", "symmetrization"}


@pytest.mark.parametrize("n", [1, 2, 37, 300])
def test_small_libraries_edge_identical(n):
    f = random_fingerprints(n, n_bits=128, density=0.2, seed=n)
    keys = np.arange(n, dtype=np.int64) * 7 + (1 << 40)
    ref = ref_exact.build_hnsw_exact(f, keys=keys, connectivity=6, seed=2)
    port = build_hnsw_exact(f, keys=keys, connectivity=6, seed=2,
                            device="cpu")
    _assert_same_graph(ref, port, f"n={n}")


def test_sample_levels_same_draws():
    for n, m, seed in ((1000, 16, 0), (5000, 5, 9)):
        np.testing.assert_array_equal(sample_levels(n, m, seed),
                                      ref_sample_levels(n, m, seed))


def test_merge_topk_tie_order():
    rng = np.random.default_rng(0)
    d = rng.integers(0, 4, size=(16, 40)).astype(np.float32) / 4
    d[:, ::5] = np.inf
    ids = rng.permutation(640).reshape(16, 40).astype(np.int32)
    rd, ri = ref_exact._merge_topk(jnp.asarray(d), jnp.asarray(ids), 12)
    pd, pi = exact._merge_topk(torch.from_numpy(d), torch.from_numpy(ids),
                               12)
    np.testing.assert_array_equal(pd.numpy(), np.asarray(rd))
    np.testing.assert_array_equal(pi.numpy(), np.asarray(ri))


def test_symmetrize_matches_three_key_sort():
    # quantized distances force (dst, d) ties that only src can break
    rng = np.random.default_rng(5)
    n_pad, n_real, m = 96, 80, 6
    sel = rng.integers(-1, n_real, size=(n_pad, m)).astype(np.int32)
    sel_d = (rng.integers(0, 3, size=(n_pad, m)) / 3).astype(np.float32)
    sel_d[sel < 0] = np.inf
    for cap in (4, 12):
        ref = np.asarray(ref_exact._symmetrize(
            jnp.asarray(sel), jnp.asarray(sel_d), n_real, cap))
        out = exact._symmetrize(torch.from_numpy(sel),
                                torch.from_numpy(sel_d), n_real, cap)
        np.testing.assert_array_equal(out.numpy(), ref, err_msg=f"cap={cap}")


def test_unported_forms_raise(fps):
    # stream_select=True is ported: the streamed probed build equals
    # rad_tpu's streamed build (tests/test_torch_probe.py holds more cases)
    kw = dict(connectivity=8, seed=1, probes=2, probe_csize=128,
              probe_min_n=0, q_block=128, col_block=128, sel_block=128)
    ref = ref_exact.build_hnsw_exact(fps, stream_select=True,
                                     use_pallas=True, interpret=True, **kw)
    port = build_hnsw_exact(fps, stream_select=True, device="cpu", **kw)
    _assert_same_graph(ref, port, "stream_select=True")
    # the mesh form is ported: a mesh build equals the single-device
    # build (tests/test_torch_build_sharded.py holds more cases), and a
    # malformed mesh= still raises
    from rad_tpu_torch.parallel import make_mesh
    mesh_kw = dict(connectivity=8, seed=1, q_block=128, col_block=128,
                   sel_block=128)
    _assert_same_graph(
        build_hnsw_exact(fps, device="cpu", **mesh_kw),
        build_hnsw_exact(fps, mesh=make_mesh(2, devices=["cpu"] * 2),
                         **mesh_kw), "mesh=")
    with pytest.raises(ValueError, match="axis"):
        build_hnsw_exact(fps[:64], mesh=object(), device="cpu")
    with pytest.raises(NotImplementedError, match="not ported by design"):
        build_hnsw_exact(fps[:64], use_pallas=True, device="cpu")
    with pytest.raises(NotImplementedError, match="not ported by design"):
        build_hnsw_exact(fps[:64], symm_mode="chunked", device="cpu")
    with pytest.raises(TypeError):
        build_hnsw_exact(fps[:64], not_an_option=1, device="cpu")
    with pytest.raises(ValueError):
        build_hnsw_exact(fps[:64], q_block=300, device="cpu")
    with pytest.raises(ValueError):
        build_hnsw_exact(fps[:64], stream_select="always", device="cpu")


@pytest.mark.gpu
def test_cuda_build_equals_cpu_build(fps):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from rad_tpu_torch.fp import kernels

    launches = kernels.tanimoto_bucketmin.launches
    cpu = build_hnsw_exact(fps, connectivity=8, seed=1, block_bucket=16,
                           device="cpu", **BLOCKS)
    gpu = build_hnsw_exact(fps, connectivity=8, seed=1, block_bucket=16,
                           device="cuda", **BLOCKS)
    _assert_same_graph(cpu, gpu, "cuda vs cpu")
    assert kernels.tanimoto_bucketmin.launches > launches
