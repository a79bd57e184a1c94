"""rad_tpu_torch Tanimoto kernels against the Pallas kernels.

On the CPU the wrappers run their plain twins; the JAX side runs the
Pallas kernels in interpret mode, as tests/test_kernels.py does. Bucket
keys must be array-equal (they are the bits of the f32 similarity); the
distance matrix is held to atol 1e-6 — the f32 operation order is the
same, so equality is expected, and the tolerance only absorbs one ulp
should XLA's CPU code reorder. The approximate-reciprocal bucket epilogue
is held to the 2e-3 bounds of tests/test_kernels.py: the interpret-mode
Pallas kernel lowers its approximate reciprocal through bfloat16, the
twin takes the f32 reciprocal. The ``gpu`` tests compare each CUDA kernel
with its twin on the card and skip without one; the ragged cases (rows of
1 to 1,025 words, Q and N off the 128-row tiles, every bucket size) hold
the twins to the interpret-mode Pallas kernels on the CPU first.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from rad_tpu.fp import random_fingerprints
from rad_tpu.fp.kernels import (decode_bucket_keys as ref_decode,
                                tanimoto_bucketmin_pallas,
                                tanimoto_matrix_pallas)
from rad_tpu.fp.tanimoto import tanimoto_matrix as ref_swar_matrix
from rad_tpu_torch.fp import kernels
from rad_tpu_torch.fp.pack import popcount_rows, to_torch_packed
from test_kernels import _ref_bucket_keys


@pytest.fixture(scope="module")
def data():
    db = random_fingerprints(1024, n_bits=256, density=0.15, seed=41)
    q = random_fingerprints(256, n_bits=256, density=0.15, seed=42)
    db[9] = q[4]          # exact duplicates and empties hit the edge cases
    db[10] = 0
    q[5] = 0
    return q, db


@pytest.mark.parametrize("bucket", [32, 64])
def test_bucket_keys_array_equal_to_pallas_and_model(data, bucket):
    q, db = data
    ref = np.asarray(tanimoto_bucketmin_pallas(
        jnp.asarray(q), jnp.asarray(db), bucket=bucket, q_tile=128,
        n_tile=256, interpret=True))
    before = kernels.tanimoto_bucketmin.launches
    out = kernels.tanimoto_bucketmin(to_torch_packed(q, "cpu"),
                                     to_torch_packed(db, "cpu"), bucket)
    assert kernels.tanimoto_bucketmin.launches == before  # twin: no launch
    assert out.shape == (256, 1024 // bucket) and out.dtype == torch.int32
    np.testing.assert_array_equal(out.numpy(), ref, err_msg=f"b={bucket}")
    np.testing.assert_array_equal(out.numpy(), _ref_bucket_keys(q, db,
                                                                bucket))
    d, gid = kernels.decode_bucket_keys(out, bucket)
    rd, rgid = ref_decode(jnp.asarray(ref), bucket)
    np.testing.assert_array_equal(d.numpy(), np.asarray(rd))
    np.testing.assert_array_equal(gid.numpy(), np.asarray(rgid))


def test_matrix_matches_pallas_and_swar(data):
    q, db = data
    ref = np.asarray(tanimoto_matrix_pallas(
        jnp.asarray(q[:128]), jnp.asarray(db[:512]), q_tile=128,
        n_tile=256, interpret=True))
    tq, tdb = to_torch_packed(q[:128], "cpu"), to_torch_packed(db[:512],
                                                               "cpu")
    before = kernels.tanimoto_matrix.launches
    out = kernels.tanimoto_matrix(tq, tdb, popcount_rows(tq),
                                  popcount_rows(tdb))
    assert kernels.tanimoto_matrix.launches == before
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=1e-6)
    swar = np.asarray(ref_swar_matrix(jnp.asarray(q[:128]),
                                      jnp.asarray(db[:512])))
    np.testing.assert_array_equal(out.numpy(), swar)


def test_wrapper_validation(data):
    q, db = data
    tq, tdb = to_torch_packed(q, "cpu"), to_torch_packed(db, "cpu")
    with pytest.raises(ValueError):
        kernels.tanimoto_bucketmin(tq, tdb, bucket=48)
    before = kernels.tanimoto_bucketmin.approx_launches
    assert kernels.tanimoto_bucketmin(tq, tdb, approx=True).shape == (256, 16)
    assert kernels.tanimoto_bucketmin.approx_launches == before  # twin
    with pytest.raises(TypeError):
        kernels.tanimoto_matrix(tq.to(torch.int64), tdb.to(torch.int64))
    with pytest.raises(ValueError):
        kernels.tanimoto_matrix(tq, tdb[:, :4])


def _true_dists(q, db):
    return np.asarray(ref_swar_matrix(jnp.asarray(q), jnp.asarray(db)))


def test_bucket_approx_twin_within_pallas_bounds(data):
    """Both approximate epilogues pick an entry whose true distance is
    within 2e-3 of the bucket minimum, decode within 2e-3 of it, and
    agree with each other within 2e-3; ids stay in their bucket."""
    q, db = data
    bucket = 64
    ref_keys = tanimoto_bucketmin_pallas(
        jnp.asarray(q), jnp.asarray(db), bucket=bucket, q_tile=128,
        n_tile=256, interpret=True, approx=True)
    rd, rgid = (np.asarray(a) for a in ref_decode(ref_keys, bucket))
    keys = kernels.tanimoto_bucketmin(to_torch_packed(q, "cpu"),
                                      to_torch_packed(db, "cpu"), bucket,
                                      approx=True)
    d, gid = (a.numpy() for a in kernels.decode_bucket_keys(keys, bucket))
    true = _true_dists(q, db)
    bucket_min = true.reshape(true.shape[0], -1, bucket).min(axis=2)
    rows = np.arange(true.shape[0])[:, None]
    col = np.arange(keys.shape[1]) * bucket
    for dd, g in ((d, gid), (rd, rgid)):
        chosen = true[rows, g]
        np.testing.assert_allclose(chosen, bucket_min, atol=2e-3)
        np.testing.assert_allclose(dd, chosen, atol=2e-3)
        assert ((g >= col) & (g < col + bucket)).all()
    np.testing.assert_allclose(d, rd, atol=2e-3)
    # the f32 reciprocal is within an ulp of the divide: the twin's
    # winners are the exact epilogue's up to truncation-boundary near-ties
    exact_gid = kernels.decode_bucket_keys(kernels.tanimoto_bucketmin(
        to_torch_packed(q, "cpu"), to_torch_packed(db, "cpu"), bucket),
        bucket)[1].numpy()
    np.testing.assert_allclose(true[rows, gid], true[rows, exact_gid],
                               atol=1e-6)


def test_exact_fp32_matmul_restores_flags():
    before = (torch.backends.cuda.matmul.allow_tf32,
              torch.backends.cudnn.allow_tf32)
    with kernels.exact_fp32_matmul():
        assert not torch.backends.cuda.matmul.allow_tf32
        assert not torch.backends.cudnn.allow_tf32
    assert (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32) == before


RAGGED_WORDS = [1, 6, 8, 32, 64]   # packed words a row (6: a 166-bit key set)


def ragged_case(nq, nn, w, seed=0):
    """``[nq, w]`` and ``[nn, w]`` uint32 rows that give a wrong
    accumulator map no symmetric case to hide behind: random query rows, a
    db with copies of the first and last query rows planted, an empty row
    and an all-ones row, and one empty query row."""
    rng = np.random.default_rng(seed + 1000 * w + nq + nn)

    def draw(n):
        bits = rng.random((n, w * 32)) < 0.15
        return np.packbits(bits, axis=1, bitorder="little").view(np.uint32)

    q, db = draw(nq), draw(nn)
    db[min(3, nn - 1)] = q[0]
    db[nn - 1] = q[nq - 1]
    db[nn // 2] = 0
    db[nn // 3] = 0xFFFFFFFF
    if nq > 2:
        q[nq // 2] = 0
    return q, db


def _pad_rows(a, multiple):
    pad = -a.shape[0] % multiple
    return np.concatenate([a, np.zeros((pad, a.shape[1]), a.dtype)])


@pytest.mark.parametrize("w", RAGGED_WORDS)
@pytest.mark.parametrize("nq,nn", [(1, 64), (65, 200), (130, 64)])
def test_matrix_twin_matches_pallas_at_ragged_shapes(w, nq, nn):
    """The twin that the CUDA kernel is held to, against the interpret-mode
    Pallas kernel on the same rows padded with zero rows to its tiles."""
    q, db = ragged_case(nq, nn, w)
    ref = np.asarray(tanimoto_matrix_pallas(
        jnp.asarray(_pad_rows(q, 8)), jnp.asarray(_pad_rows(db, 128)),
        q_tile=8, n_tile=128, interpret=True))[:nq, :nn]
    out = kernels.tanimoto_matrix(to_torch_packed(q, "cpu"),
                                  to_torch_packed(db, "cpu"))
    assert out.shape == (nq, nn)
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(
        out.numpy(), np.asarray(ref_swar_matrix(jnp.asarray(q),
                                                jnp.asarray(db))))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda:0")


@pytest.mark.gpu
def test_cuda_div_counts_is_the_ieee_divide(cuda):
    """Exhaustive: the kernels' branch-free divide gives the bits of
    ``__fdiv_rn`` for every pair of counts in the range they use it."""
    assert kernels.div_counts_mismatches(cuda) == 0


def test_kernel_resources_reads_the_ptxas_log():
    """``_cuda.kernel_resources`` on a log as ``nvcc -Xptxas=-v`` writes
    it: registers of the kernels, spill bytes of every function."""
    from rad_tpu_torch import _cuda
    log = "\n".join([
        "nvcc -c tanimoto.cu",
        "ptxas info    : 0 bytes gmem",
        "ptxas info    : Compiling entry function '_Z2nnILi0EEvPx' for "
        "'sm_90a'",
        "ptxas info    : Function properties for _Z2nnILi0EEvPx",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Function properties for _Z4slowf",
        "    8 bytes stack frame, 4 bytes spill stores, 12 bytes spill loads",
        "ptxas info    : Used 105 registers, used 1 barriers",
        "ptxas info    : Compiling entry function '_Z6bucketPi' for 'sm_90a'",
        "ptxas info    : Function properties for _Z6bucketPi",
        "    16 bytes stack frame, 24 bytes spill stores, 28 bytes spill "
        "loads",
        "ptxas info    : Used 40 registers, used 1 barriers, 16 bytes "
        "cumulative stack size, 17408 bytes smem",
    ])
    assert _cuda.kernel_resources(log) == {
        "_Z2nnILi0EEvPx": dict(registers=105, spill_stores=0, spill_loads=0),
        "_Z4slowf": dict(spill_stores=4, spill_loads=12),
        "_Z6bucketPi": dict(registers=40, spill_stores=24, spill_loads=28),
    }
    assert _cuda.kernel_resources("") == {}


def test_div_counts_check_needs_the_card():
    with pytest.raises(ValueError, match="CUDA"):
        kernels.div_counts_mismatches("cpu")


@pytest.mark.gpu
@pytest.mark.parametrize("w", RAGGED_WORDS)
@pytest.mark.parametrize("nq,nn", [(1, 64), (65, 200), (130, 64), (130, 201),
                                   (64, 2500), (300, 129)])
def test_cuda_matrix_equals_twin_at_ragged_shapes(cuda, w, nq, nn):
    """Every (row, column) of the tensor-core kernel's accumulator map, at
    Q and N off the 128-row tiles, even N (8-byte stores) and odd N (4-byte
    stores), 16-byte staging (W % 4 == 0) and 4-byte staging."""
    q, db = ragged_case(nq, nn, w)
    tq, tdb = to_torch_packed(q, cuda), to_torch_packed(db, cuda)
    before = kernels.tanimoto_matrix.launches
    out = kernels.tanimoto_matrix(tq, tdb)
    torch.cuda.synchronize()
    assert kernels.tanimoto_matrix.launches == before + 1
    assert torch.equal(out, kernels.tanimoto_matrix_plain(tq, tdb))
    # rows that start off a 16-byte boundary (a slice of the same storage)
    if nq > 1:
        assert torch.equal(kernels.tanimoto_matrix(tq[1:], tdb[1:]),
                           out[1:, 1:])


@pytest.mark.gpu
def test_cuda_matrix_at_the_widest_rows(cuda):
    """``DIV_CHECKED_WORDS`` words a row, the edge of the range on which the
    kernel's branch-free divide is checked, and one word more, where the
    kernel takes the IEEE divide: both equal the twin."""
    for w in (kernels.DIV_CHECKED_WORDS, kernels.DIV_CHECKED_WORDS + 1):
        q, db = ragged_case(65, 200, w)
        tq, tdb = to_torch_packed(q, cuda), to_torch_packed(db, cuda)
        before = kernels.tanimoto_matrix.launches
        out = kernels.tanimoto_matrix(tq, tdb)
        torch.cuda.synchronize()
        assert kernels.tanimoto_matrix.launches == before + 1
        assert torch.equal(out, kernels.tanimoto_matrix_plain(tq, tdb)), w


def test_widest_rows_on_the_cpu():
    """Rows wider than the divide's checked range are the twin's on the
    CPU, equal to the reference's distances."""
    w = kernels.DIV_CHECKED_WORDS + 1
    q, db = ragged_case(3, 5, w)
    out = kernels.tanimoto_matrix(to_torch_packed(q, "cpu"),
                                  to_torch_packed(db, "cpu"))
    np.testing.assert_array_equal(
        out.numpy(), np.asarray(ref_swar_matrix(jnp.asarray(q),
                                                jnp.asarray(db))))


# The bucket kernel's ragged cases: W from one word to one past the divide's
# checked range (the IEEE-divide instance), Q and N off the 128-row tiles
# (N % 128 != 0 at 64 and 192), every bucket size the kernel reduces
# differently (a pair, a lane pair, the quad, blocks of 8 folded in the
# lane, the whole tile).
BUCKET_WORDS = RAGGED_WORDS + [kernels.DIV_CHECKED_WORDS + 1]
BUCKET_QS = (1, 65, 130, 300)
BUCKET_NS = (64, 192, 640)
BUCKETS = (1, 2, 4, 8, 64, 128)


@pytest.mark.parametrize("w,nq,nn,bucket", [
    (1, 1, 64, 1), (1, 300, 640, 128), (6, 65, 192, 2), (6, 130, 640, 64),
    (8, 130, 64, 4), (8, 1, 192, 64), (32, 300, 192, 8), (32, 65, 640, 1),
    (64, 65, 64, 64), (64, 130, 640, 128), (1025, 65, 192, 4),
    (1025, 1, 64, 64)])
def test_bucket_twin_matches_pallas_at_ragged_shapes(w, nq, nn, bucket):
    """The twin that the CUDA bucket kernel is held to, against the
    interpret-mode Pallas kernel (one db tile of N rows; queries padded
    with zero rows to a multiple of 8), at the ragged cases of the
    kernel's tests."""
    q, db = ragged_case(nq, nn, w)
    qp = _pad_rows(q, 8)
    ref = np.asarray(tanimoto_bucketmin_pallas(
        jnp.asarray(qp), jnp.asarray(db), bucket=bucket, q_tile=qp.shape[0],
        n_tile=nn, interpret=True))[:nq]
    out = kernels.tanimoto_bucketmin(to_torch_packed(q, "cpu"),
                                     to_torch_packed(db, "cpu"), bucket)
    assert out.shape == (nq, nn // bucket)
    np.testing.assert_array_equal(out.numpy(), ref,
                                  err_msg=f"w={w} {nq}x{nn} b={bucket}")


def test_bucket_wrapper_rules_on_the_cpu():
    """The twin takes every power-of-two bucket that divides N (256 too);
    the card's kernel takes buckets of up to ``BUCKET_MAX`` = 128 (its db
    tile) and any W, and refuses larger buckets before it allocates or
    launches anything."""
    q, db = ragged_case(3, 256, 6)
    tq, tdb = to_torch_packed(q, "cpu"), to_torch_packed(db, "cpu")
    assert kernels.tanimoto_bucketmin(tq, tdb, 256).shape == (3, 1)
    for bucket in (3, 48, 512):
        with pytest.raises(ValueError, match="power of two"):
            kernels.tanimoto_bucketmin(tq, tdb, bucket)
    assert kernels.BUCKET_MAX == 128
    for bucket in (1, 2, 64, 128):
        kernels._check_bucket_kernel(bucket)
    with pytest.raises(ValueError, match="up to 128"):
        kernels._check_bucket_kernel(256)


def _off16(x: torch.Tensor) -> torch.Tensor:
    """The same rows at a storage offset of one word: rows that start off
    a 16-byte boundary whatever W (the kernel's 4-byte staging)."""
    buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
    buf[1:] = x.reshape(-1)
    return buf[1:].view(x.shape)


@pytest.mark.gpu
@pytest.mark.parametrize("w", BUCKET_WORDS)
@pytest.mark.parametrize("nq", BUCKET_QS)
@pytest.mark.parametrize("nn", BUCKET_NS)
def test_cuda_bucket_equals_twin_at_ragged_shapes(cuda, w, nq, nn):
    """Every bucket size that divides N, both epilogues, rows on and off a
    16-byte boundary: exact keys array-equal to the twin; approximate keys
    decoded within 2^-14 of the twin's, their entries' true distances
    within 1e-6."""
    q, db = ragged_case(nq, nn, w)
    tq, tdb = to_torch_packed(q, cuda), to_torch_packed(db, cuda)
    true = kernels.tanimoto_matrix_plain(tq, tdb)
    before = (kernels.tanimoto_bucketmin.launches,
              kernels.tanimoto_bucketmin.approx_launches)
    calls = 0
    for bucket in (b for b in BUCKETS if nn % b == 0):
        want = kernels.tanimoto_bucketmin_plain(tq, tdb, bucket)
        want_a = kernels.tanimoto_bucketmin_plain(tq, tdb, bucket,
                                                  approx=True)
        pd, pgid = kernels.decode_bucket_keys(want_a, bucket)
        for a, b in ((tq, tdb), (_off16(tq), _off16(tdb))):
            keys = kernels.tanimoto_bucketmin(a, b, bucket)
            torch.cuda.synchronize()
            assert torch.equal(keys, want), (bucket, a.data_ptr() % 16)
            d, gid = kernels.decode_bucket_keys(
                kernels.tanimoto_bucketmin(a, b, bucket, approx=True), bucket)
            assert float((d - pd).abs().max()) <= 2.0 ** -14, bucket
            diff = true.gather(1, gid.long()) - true.gather(1, pgid.long())
            assert float(diff.abs().max()) <= 1e-6, bucket
            calls += 1
    assert (kernels.tanimoto_bucketmin.launches,
            kernels.tanimoto_bucketmin.approx_launches) == (
        before[0] + calls, before[1] + calls)


@pytest.mark.gpu
@pytest.mark.parametrize("n_bits,nq,nn", [(1024, 300, 4096), (256, 64, 640),
                                         (2048, 70, 192)])
def test_cuda_kernels_equal_twins(cuda, n_bits, nq, nn):
    q = random_fingerprints(nq, n_bits=n_bits, density=0.12, seed=1)
    db = random_fingerprints(nn, n_bits=n_bits, density=0.12, seed=2)
    db[3] = q[0]
    tq, tdb = to_torch_packed(q, cuda), to_torch_packed(db, cuda)
    launches = (kernels.tanimoto_matrix.launches,
                kernels.tanimoto_bucketmin.launches)
    out = kernels.tanimoto_matrix(tq, tdb)
    torch.cuda.synchronize()
    plain = kernels.tanimoto_matrix_plain(tq, tdb)
    assert torch.equal(out, plain)
    assert torch.equal(out[:, :nn - 1].contiguous(),
                       kernels.tanimoto_matrix(tq, tdb[:nn - 1].contiguous()))
    for bucket in (1, 16, 32, 64):
        keys = kernels.tanimoto_bucketmin(tq, tdb, bucket)
        torch.cuda.synchronize()
        assert torch.equal(keys, kernels.tanimoto_bucketmin_plain(
            tq, tdb, bucket)), bucket
    assert kernels.tanimoto_matrix.launches == launches[0] + 2
    assert kernels.tanimoto_bucketmin.launches == launches[1] + 4


@pytest.mark.gpu
@pytest.mark.parametrize("n_bits,nq,nn", [(1024, 4096, 8192), (256, 64, 640)])
def test_cuda_bucket_approx_within_twin_bounds(cuda, n_bits, nq, nn):
    """The rcp.approx epilogue against the f32-reciprocal twin on the
    card: decoded distances within 2^-14, and the chosen entries' true
    distances within 1e-6 of each other."""
    q = random_fingerprints(nq, n_bits=n_bits, density=0.12, seed=5)
    db = random_fingerprints(nn, n_bits=n_bits, density=0.12, seed=6)
    db[7] = q[1]
    tq, tdb = to_torch_packed(q, cuda), to_torch_packed(db, cuda)
    before = kernels.tanimoto_bucketmin.approx_launches
    for bucket in (16, 64):
        keys = kernels.tanimoto_bucketmin(tq, tdb, bucket, approx=True)
        torch.cuda.synchronize()
        plain = kernels.tanimoto_bucketmin_plain(tq, tdb, bucket,
                                                 approx=True)
        d, gid = kernels.decode_bucket_keys(keys, bucket)
        pd, pgid = kernels.decode_bucket_keys(plain, bucket)
        assert float((d - pd).abs().max()) <= 2.0 ** -14, bucket
        true = kernels.tanimoto_matrix_plain(tq, tdb)
        diff = (true.gather(1, gid.long()) - true.gather(1, pgid.long()))
        assert float(diff.abs().max()) <= 1e-6, bucket
    assert kernels.tanimoto_bucketmin.approx_launches == before + 2


# The bucket top-k's cases: a layer of N rows (copies of the first query
# row planted, an empty and an all-ones row), query rows [q0, q1) of it off
# the 128-row tiles, rows past n_real that hold fingerprints, each instance
# of k (and k between instances), buckets that the kernel takes apart
# differently, rows up to the widest each instance keeps resident.
TOPK_KS = (1, 20, 32, 64, 100, 128, 200, 256)
TOPK_CASES = [  # (w, n, bucket)
    (1, 192, 8), (6, 640, 32), (8, 1000, 8), (32, 1536, 16), (3, 384, 128),
    (32, 4096, 64), (32, 2048, 128)]


def _topk_layer(n, w, seed=0):
    q, db = ragged_case(n // 2, n - n // 2, w, seed)
    return np.concatenate([q, db])


@pytest.mark.gpu
@pytest.mark.parametrize("k", TOPK_KS)
@pytest.mark.parametrize("approx", [False, True])
def test_cuda_bucket_topk_equals_twin(cuda, k, approx):
    """Every instance of k, both epilogues: distances (bits) and ids
    array-equal to the twin (exact), or to the builder's column-block loop
    over the card's bucket kernel (approx: the twin's f32 reciprocal is
    not the card's ``rcp.approx``), whole layers and ragged query ranges,
    one launch a call; the widest resident rows of each instance; no
    bucket under 8 columns."""
    from rad_tpu_torch import _cuda
    from rad_tpu_torch.build import exact

    lib = _cuda.load_library()
    assert [lib.rad_bucket_topk_max_words(k, b) for b in (1, 2, 4)] == [0] * 3
    widest = lib.rad_bucket_topk_max_words(k, 64)
    assert widest >= 32 and widest % 32 == 0
    assert lib.rad_bucket_topk_max_words(k, 8) == widest
    counter = "approx_launches" if approx else "launches"
    before = getattr(kernels.tanimoto_bucket_topk, counter)
    calls = 0
    for w, n, bucket in TOPK_CASES + [(widest, 1024, 32)]:
        if w > widest:
            continue
        p = to_torch_packed(_topk_layer(n, w), cuda)
        pops = popcount_rows(p)
        for q0, q1, n_real in ((0, n, n), (5, n - 130, n - 77)):
            d, i = kernels.tanimoto_bucket_topk(p, q0, q1, n_real, k, bucket,
                                                pops=pops, approx=approx)
            torch.cuda.synchronize()
            if approx:
                pd, pi = exact._one_qblock_loop(p, pops, q0, n_real, k,
                                                q1 - q0, max(bucket, 256),
                                                bucket, True)
            else:
                pd, pi = kernels.tanimoto_bucket_topk_plain(
                    p, q0, q1, n_real, k, bucket, pops=pops)
            what = f"w={w} n={n} b={bucket} [{q0}, {q1}) n_real={n_real}"
            assert torch.equal(d.view(torch.int32), pd.view(torch.int32)), what
            assert torch.equal(i, pi), what
            calls += 1
    assert getattr(kernels.tanimoto_bucket_topk, counter) == before + calls
    for w, bucket in ((widest + 1, 64), (1, 4)):
        p = torch.zeros((256, w), dtype=torch.int32, device=cuda)
        assert not kernels.bucket_topk_serves(p, k, bucket)
        with pytest.raises(ValueError, match="bucket_topk_max_words"):
            kernels.tanimoto_bucket_topk(p, 0, 256, 256, k, bucket)


@pytest.mark.gpu
def test_cuda_bucket_topk_one_layer_against_split_qblocks(cuda):
    """A 65,536-row layer in one launch (no scratch, so no split) equals
    its q-blocks scanned with scratch for split columns and a merge, and
    the twin; nothing of the call's scratch grows with the columns."""
    n = 1 << 16
    f = random_fingerprints(n, n_bits=1024, density=0.12, seed=9)
    f[1::97] = f[0]
    p = to_torch_packed(f, cuda)
    pops = popcount_rows(p)
    out = 2 * 64 * 4  # a row's distances and ids
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(cuda)
    base = torch.cuda.memory_allocated(cuda)
    d, i = kernels.tanimoto_bucket_topk(p, 0, n, n - 1000, 64, 64, pops=pops)
    torch.cuda.synchronize()
    assert torch.cuda.max_memory_allocated(cuda) - base <= n * out
    for q0 in (0, n - 4096):
        torch.cuda.reset_peak_memory_stats(cuda)
        base = torch.cuda.memory_allocated(cuda)
        bd, bi = kernels.tanimoto_bucket_topk(p, q0, q0 + 4096, n - 1000, 64,
                                              64, pops=pops)
        torch.cuda.synchronize()
        assert 4096 * out < torch.cuda.max_memory_allocated(cuda) - base <= (
            4096 * out + kernels._TOPK_SCRATCH_BYTES)
        assert torch.equal(bd, d[q0:q0 + 4096]) and torch.equal(
            bi, i[q0:q0 + 4096]), q0
        pd, pi = kernels.tanimoto_bucket_topk_plain(
            p, q0, q0 + 4096, n - 1000, 64, 64, pops=pops)
        assert torch.equal(bd.view(torch.int32), pd.view(torch.int32))
        assert torch.equal(bi, pi)
