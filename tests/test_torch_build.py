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


def _bucket_layers(graph) -> int:
    """Layers of a BLOCKS build that take the bucket reduction."""
    return sum(1 for n in graph.layer_sizes if n >= BLOCKS["q_block"])


@pytest.mark.gpu
def test_cuda_build_equals_cpu_build(fps):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from rad_tpu_torch.fp import kernels

    launches = kernels.tanimoto_bucket_topk.launches
    cpu = build_hnsw_exact(fps, connectivity=8, seed=1, block_bucket=16,
                           device="cpu", **BLOCKS)
    gpu = build_hnsw_exact(fps, connectivity=8, seed=1, block_bucket=16,
                           device="cuda", **BLOCKS)
    _assert_same_graph(cpu, gpu, "cuda vs cpu")
    # one launch of the fused scan a bucket layer
    assert kernels.tanimoto_bucket_topk.launches == (
        launches + _bucket_layers(cpu))


# --- the bucket scan's running top-k against the column-block merge ------
TOPK_N = 2048


def _topk_library(kind: str) -> np.ndarray:
    """2,048 rows of 256 bits: random, tie-heavy (exact duplicates; a
    quarter all-zero rows) or a mutation tree at density 0.12."""
    if kind == "tree":
        from rad_tpu_torch.synthetic import make_library
        return make_library(TOPK_N, 256, seed=4)[0]
    f = random_fingerprints(TOPK_N, n_bits=256, density=0.15, seed=5)
    if kind == "duplicates":
        f[1::3] = f[0]
        f[2::5] = f[7]
    elif kind == "zeros":
        f[::4] = 0
    return f


@pytest.mark.parametrize("kind", ["random", "duplicates", "zeros", "tree"])
@pytest.mark.parametrize("k,bucket", [(32, 16), (64, 64), (128, 8),
                                      (32, 1), (64, 4)])
@pytest.mark.parametrize("approx", [False, True])
def test_bucket_topk_twin_equals_column_block_merge(kind, k, bucket,
                                                    approx):
    """The fused scan's twin, array-equal (distance bits and ids) to the
    per-column-block loop of stable merges at several column blocks: the
    (d, id) order, the self bucket and the boundary buckets that lose
    their runner-up to rows past ``n_real`` (which hold fingerprints of
    non-members, as on upper layers)."""
    from rad_tpu_torch.fp import kernels
    from rad_tpu_torch.fp.pack import popcount_rows, to_torch_packed

    p = to_torch_packed(_topk_library(kind), "cpu")
    pops = popcount_rows(p)
    for n_real, (q0, q1) in ((TOPK_N, (0, 512)),
                             (TOPK_N - 301, (1536, 2048))):
        d, i = kernels.tanimoto_bucket_topk_plain(p, q0, q1, n_real, k,
                                                  bucket, pops=pops,
                                                  approx=approx)
        assert d.shape == i.shape == (q1 - q0, k)
        for col_block in (max(bucket, 128), 512, TOPK_N):
            ld, li = exact._one_qblock_loop(p, pops, q0, n_real, k, q1 - q0,
                                            col_block, bucket, approx)
            what = f"{kind} n_real={n_real} col_block={col_block}"
            np.testing.assert_array_equal(d.view(torch.int32).numpy(),
                                          ld.view(torch.int32).numpy(),
                                          err_msg=what)
            np.testing.assert_array_equal(i.numpy(), li.numpy(),
                                          err_msg=what)


@pytest.mark.parametrize("bucket,candidates,counter", [
    (16, None, "build.bucket_topk"), (16, 300, "build.bucket_topk"),
    (4, None, "build.bucket_loop")])
def test_bucket_topk_takes_the_builds_bucket_layers(fps, bucket, candidates,
                                                    counter):
    """The counters that say which path each big layer took: the fused
    scan (here its twin, which serves any k) for buckets of 8 columns or
    more, ``build.bucket_loop`` below, with the same graph either way as
    rad_tpu."""
    from rad_tpu_torch.utils.profiling import recording

    kw = dict(connectivity=8, seed=3, block_bucket=bucket, **BLOCKS)
    with recording() as rec:
        port = build_hnsw_exact(fps, candidates=candidates, device="cpu",
                                **kw)
    assert rec.counters == {counter: _bucket_layers(port)}
    ref = ref_exact.build_hnsw_exact(fps, candidates=candidates,
                                     use_pallas=True, interpret=True, **kw)
    _assert_same_graph(ref, port, f"bucket={bucket} candidates={candidates}")


@pytest.mark.gpu
def test_cuda_build_past_the_largest_k_takes_the_loop(fps):
    """A bucket layer with k above the kernel's largest instance takes the
    column-block loop on the card (the bucket kernel, no fused scan) and
    builds the CPU build's graph."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from rad_tpu_torch.fp import kernels
    from rad_tpu_torch.utils.profiling import recording

    kw = dict(connectivity=8, seed=1, block_bucket=16, candidates=300,
              **BLOCKS)
    before = (kernels.tanimoto_bucket_topk.launches,
              kernels.tanimoto_bucketmin.launches)
    cpu = build_hnsw_exact(fps, device="cpu", **kw)
    with recording() as rec:
        gpu = build_hnsw_exact(fps, device="cuda", **kw)
    _assert_same_graph(cpu, gpu, "k=300 cuda vs cpu")
    assert rec.counters.get("build.bucket_loop") == _bucket_layers(cpu)
    assert "build.bucket_topk" not in rec.counters
    assert kernels.tanimoto_bucket_topk.launches == before[0]
    assert kernels.tanimoto_bucketmin.launches > before[1]
