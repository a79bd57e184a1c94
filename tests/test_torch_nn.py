"""rad_tpu_torch's 1-NN kernel and its A/B probes against the JAX package.

On the CPU the wrappers run their plain twins. ``tanimoto_nn`` is held to
``tanimoto_nn_pallas(..., interpret=True)``: array-equal with the exact
epilogue (the same f32 op order), and within the 2e-3 bounds of
tests/test_kernels.py with the fast one (the JAX CPU lowering of the
approximate reciprocal goes through bfloat16; the twin takes the f32
reciprocal). The floor and epilogue probes are held to
``benchmarks/bench_kernel_variants.py`` run with ``pallas_call`` patched
to interpret mode (its kernels take no ``interpret`` argument):
array-equal, except ``newton`` within 1e-4 (one Newton step refines the
bfloat16 reciprocal to ~2^-16). The ``gpu`` tests compare each CUDA
kernel with its twin on the card and skip without one.
"""

import functools

import numpy as np
import pytest
import torch

import jax.experimental.pallas
import jax.numpy as jnp

from benchmarks import bench_kernel_variants as ref_variants
from rad_tpu.fp import random_fingerprints
from rad_tpu.fp.kernels import tanimoto_nn_pallas
from rad_tpu.fp.tanimoto import tanimoto_matrix as ref_matrix
from rad_tpu_torch import bench_kernel_variants as variants
from rad_tpu_torch.fp import kernels
from rad_tpu_torch.fp.pack import to_torch_packed
from test_torch_kernels import RAGGED_WORDS, _pad_rows, ragged_case


@pytest.fixture(scope="module", params=[256, 1024])
def data(request):
    bits = request.param
    db = random_fingerprints(1024, n_bits=bits, density=0.1, seed=41)
    q = random_fingerprints(256, n_bits=bits, density=0.1, seed=42)
    db[9] = q[4]     # an exact match, and a tie across tiles
    db[700] = q[4]
    db[300] = db[301] = q[7]   # a tie inside one tile
    return q, db


def _cpu(*arrays):
    return [to_torch_packed(a, "cpu") for a in arrays]


def test_exact_nn_array_equal_to_pallas(data):
    q, db = data
    rd, ri = tanimoto_nn_pallas(jnp.asarray(q), jnp.asarray(db), q_tile=128,
                                n_tile=256, interpret=True)
    before = kernels.tanimoto_nn.launches
    d, i = kernels.tanimoto_nn(*_cpu(q, db), n_tile=256)
    assert kernels.tanimoto_nn.launches == before   # twin: no launch
    assert d.dtype == torch.float32 and i.dtype == torch.int32
    np.testing.assert_array_equal(d.numpy(), np.asarray(rd))
    np.testing.assert_array_equal(i.numpy(), np.asarray(ri))
    assert i[4] == 9 and i[7] == 300   # ties go to the first id


@pytest.mark.parametrize("n_tile", [256, None])
def test_fast_nn_within_pallas_bounds(data, n_tile):
    q, db = data
    true = np.asarray(ref_matrix(jnp.asarray(q), jnp.asarray(db)))
    true_min = true.min(axis=1)
    rows = np.arange(len(q))
    rd, ri = tanimoto_nn_pallas(jnp.asarray(q), jnp.asarray(db), q_tile=128,
                                n_tile=n_tile, interpret=True, approx=True)
    before = kernels.tanimoto_nn.approx_launches
    d, i = kernels.tanimoto_nn(*_cpu(q, db), n_tile=n_tile, approx=True)
    assert kernels.tanimoto_nn.approx_launches == before
    for dd, ii in ((d.numpy(), i.numpy()), (np.asarray(rd), np.asarray(ri))):
        np.testing.assert_allclose(dd, true_min, atol=2e-3)
        np.testing.assert_allclose(true[rows, ii], true_min, atol=2e-3)
    np.testing.assert_allclose(d.numpy(), np.asarray(rd), atol=2e-3)
    # the packed key's tie rule: the larger index inside its tile wins
    # (rows 300/301 share a tile; 9 and 700 sit at tile indices 9 and 188
    # with n_tile 256, 9 and 700 with 1024)
    assert i[7] == 301 and i[4] == 700


def test_self_query_finds_itself():
    db = random_fingerprints(1024, n_bits=1024, density=0.1, seed=5)
    tq, tdb = _cpu(db[:256], db)
    d, i = kernels.tanimoto_nn(tq, tdb)
    np.testing.assert_array_equal(d.numpy(), 0.0)
    np.testing.assert_array_equal(i.numpy(), np.arange(256))
    d, i = kernels.tanimoto_nn(tq, tdb, approx=True)
    np.testing.assert_allclose(d.numpy(), 0.0, atol=2e-3)
    np.testing.assert_array_equal(i.numpy(), np.arange(256))


def test_nn_arguments():
    q, db = _cpu(random_fingerprints(64, 256, seed=1),
                 random_fingerprints(384, 256, seed=2))
    assert kernels.default_n_tile(384) == 128
    assert kernels.default_n_tile(1 << 20) == 2048
    with pytest.raises(ValueError, match="n_tile"):
        kernels.tanimoto_nn(q, db, n_tile=256)
    with pytest.raises(ValueError, match="n_tile"):
        kernels.tanimoto_nn(q, db, n_tile=96)
    # q_tile and compute_dtype change no result
    a = kernels.tanimoto_nn(q, db, approx=True)
    b = kernels.tanimoto_nn(q, db, q_tile=8, compute_dtype=torch.bfloat16,
                            approx=True)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    # the twin scans in blocks: any block size gives the same keys
    keys = kernels._nn_keys_plain(q, db, None, None, kernels._NN_FAST, 128)
    assert torch.equal(keys, kernels._nn_keys_plain(
        q, db, None, None, kernels._NN_FAST, 128, block=100))


@pytest.fixture
def interpret_pallas(monkeypatch):
    orig = jax.experimental.pallas.pallas_call
    monkeypatch.setattr(jax.experimental.pallas, "pallas_call",
                        functools.partial(orig, interpret=True))


@pytest.fixture(scope="module")
def probe_data():
    db = random_fingerprints(512, n_bits=1024, density=0.1, seed=11)
    q = random_fingerprints(256, n_bits=1024, density=0.1, seed=12)
    db[17] = q[3]
    return q, db


@pytest.mark.parametrize("mode", list(variants.FLOOR_MODES[:3]) + ["unpack"])
def test_floor_probe_array_equal_to_tpu_probe(probe_data, interpret_pallas,
                                              mode):
    q, db = probe_data
    ref = np.asarray(ref_variants.make_floor_kernel(
        128, 256, jnp.int8, mode=mode)(jnp.asarray(q), jnp.asarray(db)))
    before = kernels.nn_floor.launches
    out = variants.make_floor_kernel(128, 256, mode=mode)(*_cpu(q, db))
    assert kernels.nn_floor.launches == before
    assert out.shape == (256, 1) and out.dtype == torch.int32
    np.testing.assert_array_equal(out.numpy(), ref)


@pytest.mark.parametrize("mode", ["exact-pk", "newton"])
def test_epilogue_probe_matches_tpu_probe(probe_data, interpret_pallas,
                                          mode):
    q, db = probe_data
    ref = np.asarray(ref_variants.make_epilogue_probe(
        128, 256, jnp.int8, mode=mode)(jnp.asarray(q), jnp.asarray(db)))
    before = kernels.nn_epilogue_probe.launches
    out = variants.make_epilogue_probe(128, 256, mode=mode)(*_cpu(q, db))
    assert kernels.nn_epilogue_probe.launches == before
    assert out.shape == (256, 1)
    if mode == "exact-pk":
        np.testing.assert_array_equal(out.numpy(), ref)
    else:
        np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=1e-4)
        exact = kernels.tanimoto_nn(*_cpu(q, db))[0].numpy()
        np.testing.assert_allclose(out.numpy()[:, 0], exact, atol=1e-6)


def test_probe_arguments(probe_data):
    q, db = _cpu(*probe_data)
    with pytest.raises(ValueError, match="q_tile"):
        variants.make_floor_kernel(96, 256)(q, db)
    with pytest.raises(ValueError, match="exceeds"):
        variants.make_floor_kernel(2048, 256, mode="unpack")(
            torch.cat([q] * 8), db)
    with pytest.raises(ValueError, match="unknown"):
        variants.make_floor_kernel(128, 256, mode="floor-x")
    with pytest.raises(ValueError, match="unknown"):
        variants.make_epilogue_probe(128, 256, mode="exact")


@pytest.mark.parametrize("w", [*RAGGED_WORDS, kernels.NN_MAX_WORDS + 1])
@pytest.mark.parametrize("nq,nn", [(1, 128), (65, 384), (130, 640)])
def test_nn_twin_matches_pallas_at_ragged_shapes(w, nq, nn):
    """The exact twin that the CUDA kernel is held to, against the
    interpret-mode Pallas kernel with the query rows padded to its tile:
    distances and ids array-equal, planted copies found at distance 0; also
    one word past the CUDA kernel's resident query tile (its wide
    instance)."""
    q, db = ragged_case(nq, nn, w)
    rd, ri = tanimoto_nn_pallas(jnp.asarray(_pad_rows(q, 8)), jnp.asarray(db),
                                q_tile=8, n_tile=128, interpret=True)
    d, i = kernels.tanimoto_nn(*_cpu(q, db), n_tile=128)
    np.testing.assert_array_equal(d.numpy(), np.asarray(rd)[:nq])
    np.testing.assert_array_equal(i.numpy(), np.asarray(ri)[:nq])
    assert d[0] == 0 and d[nq - 1] == 0


@pytest.mark.parametrize("approx", [False, True])
def test_nn_matches_pallas_at_1025_words(approx):
    """One word past the branch-free divide's range (the CUDA kernel's wide
    instance with the IEEE divide), a few queries x 256 rows: exact
    distances and ids array-equal to the interpret-mode Pallas kernel, the
    fast epilogue within the 2e-3 bounds of tests/test_kernels.py."""
    w = kernels.DIV_CHECKED_WORDS + 1
    q, db = ragged_case(5, 256, w)
    rd, ri = tanimoto_nn_pallas(jnp.asarray(_pad_rows(q, 8)), jnp.asarray(db),
                                q_tile=8, n_tile=128, interpret=True,
                                approx=approx)
    rd, ri = np.asarray(rd)[:5], np.asarray(ri)[:5]
    d, i = kernels.tanimoto_nn(*_cpu(q, db), n_tile=128, approx=approx)
    if not approx:
        np.testing.assert_array_equal(d.numpy(), rd)
        np.testing.assert_array_equal(i.numpy(), ri)
        assert d[0] == 0 and d[4] == 0
        return
    true = np.asarray(ref_matrix(jnp.asarray(q), jnp.asarray(db)))
    rows = np.arange(5)
    for dd, ii in ((d.numpy(), i.numpy()), (rd, ri)):
        np.testing.assert_allclose(dd, true.min(axis=1), atol=2e-3)
        np.testing.assert_allclose(true[rows, ii], true.min(axis=1),
                                   atol=2e-3)


def test_widest_rows_on_the_cpu():
    """Rows wider than the CUDA kernel's resident query tile
    (``NN_MAX_WORDS``) are the twin's on the CPU, and agree with the matrix
    twin's row minima."""
    w = kernels.NN_MAX_WORDS + 1
    q, db = _cpu(*ragged_case(5, 128, w))
    d, i = kernels.tanimoto_nn(q, db, n_tile=64)
    full = kernels.tanimoto_matrix(q, db)
    assert torch.equal(d, full.amin(dim=1))
    assert torch.equal(i.long(), full.argmin(dim=1))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda:0")


@pytest.mark.gpu
@pytest.mark.parametrize("w", RAGGED_WORDS)
@pytest.mark.parametrize("nq,nn", [(1, 128), (65, 384), (130, 4224),
                                   (300, 64 * 1031)])
def test_cuda_nn_every_epilogue_at_ragged_shapes(cuda, w, nq, nn):
    """All five epilogues of the tensor-core 1-NN kernel against their
    twins with Q and N off the 128-row tiles (N a multiple of n_tile = 64
    only), one db run a block and many, 16-byte and 4-byte staging."""
    q, db = ragged_case(nq, nn, w)
    tq, tdb = to_torch_packed(q, cuda), to_torch_packed(db, cuda)
    d, i = kernels.tanimoto_nn(tq, tdb, n_tile=64)
    torch.cuda.synchronize()
    pd, pi = kernels.tanimoto_nn_plain(tq, tdb, n_tile=64)
    assert torch.equal(d, pd) and torch.equal(i, pi)
    assert float(d[0]) == 0 and float(d[nq - 1]) == 0
    assert torch.equal(kernels.nn_floor(tq, tdb, 1, 64),
                       kernels.nn_floor_plain(tq, tdb, 1, 64))
    assert torch.equal(kernels.nn_epilogue_probe(tq, tdb, 64, "exact-pk"),
                       kernels.nn_epilogue_probe_plain(tq, tdb, 64,
                                                       "exact-pk"))
    got = kernels.nn_epilogue_probe(tq, tdb, 64, "newton")
    want = kernels.nn_epilogue_probe_plain(tq, tdb, 64, "newton")
    assert float((got - want).abs().max()) <= 1e-6
    fd, fi = kernels.tanimoto_nn(tq, tdb, n_tile=64, approx=True)
    pfd, _ = kernels.tanimoto_nn_plain(tq, tdb, n_tile=64, approx=True)
    assert float((fd - pfd).abs().max()) <= 2.0 ** -12
    true = kernels.tanimoto_matrix_plain(tq, tdb)
    chosen = true.gather(1, fi.long()[:, None])[:, 0]
    assert float((chosen - true.amin(dim=1)).abs().max()) <= 2.0 ** -12


@pytest.mark.gpu
@pytest.mark.parametrize("w", [kernels.NN_MAX_WORDS, kernels.NN_MAX_WORDS + 1,
                               kernels.DIV_CHECKED_WORDS,
                               kernels.DIV_CHECKED_WORDS + 1])
def test_cuda_nn_at_the_widest_rows(cuda, w):
    """``NN_MAX_WORDS`` words a row (nine resident query chunks, the
    kernel's largest shared-memory request), one word more (the wide
    instance), and the last width of the branch-free divide and one past it
    (the IEEE divide, 64-bit filter products): exact, floor and exact-pk
    equal the twins, fast within 2^-12, newton within 1e-6, with 128-row
    and 64-row n tiles."""
    q, db = ragged_case(130, 640, w)
    tq, tdb = to_torch_packed(q, cuda), to_torch_packed(db, cuda)
    before = kernels.tanimoto_nn.launches
    for n_tile in (64, 128):
        d, i = kernels.tanimoto_nn(tq, tdb, n_tile=n_tile)
        torch.cuda.synchronize()
        pd, pi = kernels.tanimoto_nn_plain(tq, tdb, n_tile=n_tile)
        assert torch.equal(d, pd) and torch.equal(i, pi)
        assert float(d[0]) == 0 and float(d[-1]) == 0
        assert torch.equal(kernels.nn_floor(tq, tdb, 1, n_tile),
                           kernels.nn_floor_plain(tq, tdb, 1, n_tile))
        assert torch.equal(
            kernels.nn_epilogue_probe(tq, tdb, n_tile, "exact-pk"),
            kernels.nn_epilogue_probe_plain(tq, tdb, n_tile, "exact-pk"))
        got = kernels.nn_epilogue_probe(tq, tdb, n_tile, "newton")
        want = kernels.nn_epilogue_probe_plain(tq, tdb, n_tile, "newton")
        assert float((got - want).abs().max()) <= 1e-6
        fd, _ = kernels.tanimoto_nn(tq, tdb, n_tile=n_tile, approx=True)
        pfd, _ = kernels.tanimoto_nn_plain(tq, tdb, n_tile=n_tile,
                                           approx=True)
        assert float((fd - pfd).abs().max()) <= 2.0 ** -12
    assert kernels.tanimoto_nn.launches == before + 2


@pytest.mark.gpu
@pytest.mark.parametrize("w", [289, 290, 292, 1024, 1025, 2048])
@pytest.mark.parametrize("nq,nn", [(130, 640), (1000, 64 * 1031)])
def test_cuda_nn_wide_instance_every_epilogue(cuda, w, nq, nn):
    """The wide instance (rows of more than ``NN_MAX_WORDS`` words) against
    the twins: rows staged 4 bytes a copy (289, 290, 1,025 words) and 16
    (292, 1,024, 2,048), the branch-free divide (up to 1,024) and the IEEE
    one; Q and N off the 128-row query and 256-row db tiles (640 = 2.5 db
    tiles: a last half wholly past N; 65,984: one 64 rows deep); one db
    tile a block (130 x 640) and runs of 17 (1000 x 65,984 on 132 SMs). Exact,
    floor and exact-pk array-equal, fast within 2^-12 (n_tile 128 where it
    divides N), newton within 1e-6; each launch counted as wide."""
    q, db = ragged_case(nq, nn, w)
    tq, tdb = to_torch_packed(q, cuda), to_torch_packed(db, cuda)
    before = kernels.tanimoto_nn.wide_launches
    d, i = kernels.tanimoto_nn(tq, tdb, n_tile=64)
    torch.cuda.synchronize()
    pd, pi = kernels.tanimoto_nn_plain(tq, tdb, n_tile=64)
    assert torch.equal(d, pd) and torch.equal(i, pi)
    assert float(d[0]) == 0 and float(d[-1]) == 0
    assert torch.equal(kernels.nn_floor(tq, tdb, 1, 64),
                       kernels.nn_floor_plain(tq, tdb, 1, 64))
    assert torch.equal(kernels.nn_epilogue_probe(tq, tdb, 64, "exact-pk"),
                       kernels.nn_epilogue_probe_plain(tq, tdb, 64,
                                                       "exact-pk"))
    got = kernels.nn_epilogue_probe(tq, tdb, 64, "newton")
    want = kernels.nn_epilogue_probe_plain(tq, tdb, 64, "newton")
    assert float((got - want).abs().max()) <= 1e-6
    n_tiles = [n_tile for n_tile in (64, 128) if nn % n_tile == 0]
    for n_tile in n_tiles:  # 128: the 32-bit max a half tile
        fd, _ = kernels.tanimoto_nn(tq, tdb, n_tile=n_tile, approx=True)
        pfd, _ = kernels.tanimoto_nn_plain(tq, tdb, n_tile=n_tile,
                                           approx=True)
        assert float((fd - pfd).abs().max()) <= 2.0 ** -12
    assert kernels.tanimoto_nn.wide_launches == before + 4 + len(n_tiles)


@pytest.mark.gpu
@pytest.mark.parametrize("n_bits,nq,nn", [(1024, 300, 8192), (256, 64, 640),
                                         (2048, 70, 1152)])
def test_cuda_nn_kernels_equal_twins(cuda, n_bits, nq, nn):
    q = random_fingerprints(nq, n_bits=n_bits, density=0.12, seed=1)
    db = random_fingerprints(nn, n_bits=n_bits, density=0.12, seed=2)
    db[3] = db[nn - 1] = q[0]
    tq, tdb = to_torch_packed(q, cuda), to_torch_packed(db, cuda)
    before = (kernels.tanimoto_nn.launches, kernels.nn_floor.launches,
              kernels.nn_epilogue_probe.launches)
    d, i = kernels.tanimoto_nn(tq, tdb, n_tile=128)
    torch.cuda.synchronize()
    pd, pi = kernels.tanimoto_nn_plain(tq, tdb, n_tile=128)
    assert torch.equal(d, pd) and torch.equal(i, pi)
    assert int(i[0]) == 3
    assert torch.equal(kernels.nn_floor(tq, tdb, 1, 128),
                       kernels.nn_floor_plain(tq, tdb, 1, 128))
    assert torch.equal(kernels.nn_floor(tq, tdb, 1, 128, mode="unpack"),
                       kernels.nn_floor_plain(tq, tdb, 1, 128, mode="unpack"))
    for n_tile in (64, 128):
        assert torch.equal(
            kernels.nn_epilogue_probe(tq, tdb, n_tile, "exact-pk"),
            kernels.nn_epilogue_probe_plain(tq, tdb, n_tile, "exact-pk"))
    got = kernels.nn_epilogue_probe(tq, tdb, 128, "newton")
    want = kernels.nn_epilogue_probe_plain(tq, tdb, 128, "newton")
    assert float((got - want).abs().max()) <= 1e-6
    assert (kernels.tanimoto_nn.launches, kernels.nn_floor.launches,
            kernels.nn_epilogue_probe.launches) == (
        before[0] + 1, before[1] + 2, before[2] + 3)


@pytest.mark.gpu
@pytest.mark.parametrize("n_tile", [128, 1024])
def test_cuda_fast_nn_within_twin_bounds(cuda, n_tile):
    q = random_fingerprints(512, n_bits=1024, density=0.1, seed=3)
    db = random_fingerprints(8192, n_bits=1024, density=0.1, seed=4)
    db[5] = q[1]
    tq, tdb = to_torch_packed(q, cuda), to_torch_packed(db, cuda)
    before = kernels.tanimoto_nn.approx_launches
    d, i = kernels.tanimoto_nn(tq, tdb, n_tile=n_tile, approx=True)
    torch.cuda.synchronize()
    assert kernels.tanimoto_nn.approx_launches == before + 1
    pd, _ = kernels.tanimoto_nn_plain(tq, tdb, n_tile=n_tile, approx=True)
    assert float((d - pd).abs().max()) <= 2.0 ** -12
    true = kernels.tanimoto_matrix_plain(tq, tdb)
    chosen = true.gather(1, i.long()[:, None])[:, 0]
    assert float((chosen - true.amin(dim=1)).abs().max()) <= 2.0 ** -12
